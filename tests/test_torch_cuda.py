"""K1 (with and without its LSE), K2, K3, K4 and K5 on the GPU against
their plain versions, the batched engine's decode block and the
single-request generator's decode step captured as CUDA graphs against the
same work run eagerly, and ``decode_attention`` over the cache as stored
(skipped without a CUDA card).

Run on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
``conftest.py`` imports JAX, which that machine need not have). K1's cases
run under both of its tile shapes (64 and 128 query rows per block); K2's
and K3's in the regime the call gets and in the mma.sync one forced.
Tolerances on the same bf16 inputs:
- K1 rounds P (before PV) and O to bf16, so
  |K1 − plain| ≤ 1e-2 + 1e-2·|plain|;
- K1's LSE is fp32 from the same fp32 scores, |err| ≤ 1e-3;
- K2 and K3 round dS and P to bf16 before their products with K, Q and dO
  (2^-9 relative each, summed over the sequence in another order) and the
  output to bf16, so |kernel − plain| ≤ 2e-2·|plain| + 1e-2·max|plain|;
- K4 and K5 round their output to bf16 (2^-9 relative) and sum in fp32 in
  another order, so |kernel − plain| ≤ 1e-2·|plain| + 1e-3·max|plain|;
- δ (``attention_delta``, one batched product with fp32 output on the
  card) sums exact fp32 products in another order than the fp32 formula,
  so |err| ≤ 1e-5·Σ_d |o·dO|;
- K1 f32, K4 f32 and K5 f32 (fp32 operands) are held to fp32 accuracy:
  ``K1_F32_TOL`` and ``QUANT_F32_TOL`` below, each beside a one-pass TF32
  control that must fail it; K1 f32's LSE, K2 f32 and K3 f32 (the fp32
  backward) too: ``K1_F32_TOL``·max|plain| (the LSE ·max(1, max|lse|)),
  the one-pass control failing it at the training paths' shapes and at
  every edge above D = 160.
"""

import pytest
import torch

import importlib

import mllm_npu_tpu_torch.ops as port_ops

from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.ops.flash_attention import (
    FlashAttention, SegmentIds, attention_delta, flash_attention,
    flash_attention_reference, flash_bwd_dkv, flash_bwd_dkv_reference,
    flash_bwd_dq, flash_bwd_dq_reference)

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(params=fa.K1_BLOCK_Q, ids=lambda bq: f"block_q{bq}")
def block_q(request, monkeypatch):
    """Each K1 case under both tile shapes, whatever the call would pick."""
    monkeypatch.setattr(fa, "k1_block_q", lambda *a, **k: request.param)
    return request.param


def _k1_inputs(dev, B, Sq, Sk, Hq, Hkv, D, seg, layout="bshd", seed=0,
               dtype=torch.bfloat16):
    """q, k, v in ``dtype`` (``layout`` "fused": q, k and v strided views of
    one [B, S, 3, H, D] tensor) and segment ids: None; an int n, the last
    row right-padded from n (queries and keys of the padding in segments of
    their own, so those rows are fully masked); "packed", segments of 5 to
    40 tokens that change inside tiles and a padded tail."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if layout == "fused":
        qkv = torch.randn(B, Sq, 3, Hq, D, device=dev, generator=g).to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(B, Sq, Hq, D, device=dev, generator=g).to(dtype)
        k = torch.randn(B, Sk, Hkv, D, device=dev, generator=g).to(dtype)
        v = torch.randn(B, Sk, Hkv, D, device=dev, generator=g).to(dtype)
    if seg is None:
        return q, k, v, None
    qs = torch.ones(B, Sq, dtype=torch.int32)
    if seg == "packed":
        gen = torch.Generator().manual_seed(seed)
        for b in range(B):
            pos, sid = 0, 1
            while pos < Sq:
                n = int(torch.randint(5, 41, (1,), generator=gen))
                qs[b, pos:pos + n] = sid
                pos, sid = pos + n, sid + 1
        qs[-1, Sq - Sq // 7:] = 0
        ks = qs.clone()
    else:
        qs[-1, seg:] = 0
        ks = torch.ones(B, Sk, dtype=torch.int32)
        ks[-1, seg:] = -1
    return q, k, v, SegmentIds(q=qs.to(dev), kv=ks.to(dev))


# the paths' shapes, then the edges of the Hopper design: D from 8 to 128
# (TMA's zero fill of the columns past D, the 128-byte / 32-byte swizzle
# split), lengths below one tile and off the tile (1, 63, 65, 129, 729),
# causal with Sq != Sk, GQA 32/8 and 8/1, segments that change inside a
# tile, right-padded rows, and q, k, v as strided views of a fused tensor
K1_CASES = [
    (1, 341, 341, 32, 8, 128, True, None, "bshd"),
    (2, 341, 341, 32, 8, 128, True, 284, "bshd"),
    (5, 729, 729, 16, 16, 72, False, None, "bshd"),
    (5, 64, 729, 32, 32, 128, False, None, "bshd"),
    (1, 77, 77, 4, 2, 32, True, 50, "bshd"),
    (2, 100, 130, 8, 2, 104, False, None, "bshd"),
    (1, 129, 129, 8, 1, 8, True, None, "bshd"),
    (1, 129, 129, 8, 1, 16, False, None, "bshd"),
    (2, 65, 65, 8, 1, 24, True, 40, "bshd"),
    (1, 129, 129, 32, 8, 80, False, None, "bshd"),
    (1, 1, 1, 4, 1, 128, True, None, "bshd"),
    (1, 1, 729, 4, 4, 72, False, None, "bshd"),
    (2, 63, 65, 8, 2, 72, False, None, "bshd"),
    (2, 65, 63, 8, 2, 128, True, None, "bshd"),
    (2, 129, 729, 32, 8, 128, True, None, "bshd"),
    (1, 729, 129, 8, 1, 64, True, None, "bshd"),
    (2, 600, 600, 32, 8, 128, True, "packed", "bshd"),
    (2, 200, 200, 8, 8, 72, True, "packed", "fused"),
    (1, 300, 300, 4, 4, 128, False, None, "fused"),
    # SEED-X: Qwen-ViT-G (q, k, v views of its fused in_proj, D = 104),
    # its attention pool, the input projector (D = 160), the output
    # projector, the Llama-2-13B prefill (MHA 40/40); head dims past 128
    (5, 1024, 1024, 16, 16, 104, False, None, "fused"),
    (5, 256, 1024, 32, 32, 128, False, None, "bshd"),
    (5, 64, 256, 32, 32, 160, False, None, "bshd"),
    (1, 64, 64, 32, 32, 128, False, None, "bshd"),
    (1, 341, 341, 40, 40, 128, True, None, "bshd"),
    (2, 129, 129, 8, 2, 136, True, 100, "bshd"),
    (1, 300, 300, 4, 4, 152, False, None, "fused"),
    (2, 65, 63, 8, 8, 160, True, None, "bshd"),
    # the SDXL UNet at 1024² (CFG batch 2, D = 64): self-attention at the
    # 64×64 and 32×32 levels, cross-attention over the resampler's 64 tokens
    (2, 4096, 4096, 10, 10, 64, False, None, "bshd"),
    (2, 1024, 1024, 20, 20, 64, False, None, "bshd"),
    (2, 4096, 64, 10, 10, 64, False, None, "bshd"),
    (2, 1024, 64, 20, 20, 64, False, None, "bshd"),
    # the de-tokenizer's variants: SEED-X-Edit's three-way batch of 3;
    # SD-2.1 at 768² (S = 9216 over 5 heads of 64); SD-1.5 with the
    # IP-Adapter at 512²: D = 40, 80, 160, 77 text keys, 16 image keys
    (3, 4096, 4096, 10, 10, 64, False, None, "bshd"),
    (3, 1024, 64, 20, 20, 64, False, None, "bshd"),
    (3, 9216, 9216, 5, 5, 64, False, None, "bshd"),
    (2, 4096, 4096, 8, 8, 40, False, None, "bshd"),
    (2, 4096, 77, 8, 8, 40, False, None, "bshd"),
    (2, 1024, 1024, 8, 8, 80, False, None, "bshd"),
    (2, 1024, 16, 8, 8, 80, False, None, "bshd"),
    (2, 256, 77, 8, 8, 160, False, None, "bshd"),
    (2, 64, 64, 8, 8, 160, False, None, "bshd"),
]
# head dims above 160, which the kernel computes at 192 or 256 (TMA
# zero-filling the columns past D): every multiple of 8 from 168 to 256
# causal with segments that change inside a tile and a padded tail, then
# the reference's bench shape (B32 H8 S256 D256), a causal GQA 16/8 shape
# with packed segments, causal Sq != Sk with GQA 16/4, a right-padded row,
# q, k, v as views of a fused tensor, and one key
K1_WIDE_CASES = [(2, 129, 129, 8, 2, D, True, "packed", "bshd")
                 for D in range(168, 257, 8)] + [
    (32, 256, 256, 8, 8, 256, False, None, "bshd"),
    (2, 1000, 1000, 16, 8, 256, True, "packed", "bshd"),
    (2, 65, 63, 16, 4, 192, True, None, "bshd"),
    (2, 63, 65, 16, 4, 256, True, 40, "bshd"),
    (1, 300, 300, 4, 4, 200, False, None, "fused"),
    (1, 1, 1, 4, 1, 256, True, None, "bshd"),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg,layout",
                         K1_CASES + K1_WIDE_CASES)
def test_k1_matches_plain(cuda, block_q, B, Sq, Sk, Hq, Hkv, D, causal, seg,
                          layout):
    q, k, v, sids = _k1_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg, layout)
    before = flash_attention.launches
    if fa.k1_smem_bytes(block_q, D) > fa.K1_MAX_SMEM:
        # a tile the plan never picks at this head dim: refused, not run
        with pytest.raises(ValueError, match="shared memory"):
            flash_attention(q, k, v, causal=causal, segment_ids=sids)
        assert flash_attention.launches == before
        return
    out = flash_attention(q, k, v, causal=causal, segment_ids=sids)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q, k, v, causal=causal,
                                    segment_ids=sids).float()
    assert torch.isfinite(out.float()).all()
    assert ((out.float() - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all()
    if isinstance(seg, int):
        assert (out[-1, seg:] == 0).all()       # fully masked rows give 0


def test_k1_fully_masked_row_is_zero(cuda):
    q = torch.randn(1, 64, 2, 128, device=cuda).bfloat16()
    qs = torch.ones(1, 64, dtype=torch.int32, device=cuda)
    ks = torch.ones(1, 64, dtype=torch.int32, device=cuda)
    qs[0, 3] = 5
    out = flash_attention(q, q, q, segment_ids=SegmentIds(q=qs, kv=ks))
    assert (out[0, 3] == 0).all() and torch.isfinite(out.float()).all()


def test_k1_rejects_what_it_does_not_take(cuda):
    n = flash_attention.launches
    q = torch.randn(1, 8, 2, 64, device=cuda).half()
    with pytest.raises(TypeError):
        flash_attention(q, q, q)                       # fp16
    qb = torch.randn(1, 8, 2, 264, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="up to 256"):
        flash_attention(qb, qb, qb)                    # D > 256
    flat = torch.randn(2 * 8 * 2 * 64 + 8, device=cuda).bfloat16()
    shifted = flat[1:1 + 2 * 8 * 2 * 64].view(2, 8, 2, 64)
    with pytest.raises(ValueError):
        flash_attention(shifted, shifted, shifted)     # base not 16-byte
    wide = torch.randn(1, 8, 2, 68, device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)              # stride 68, not 8k
    assert flash_attention.launches == n


# K1 f32 (fp32 operands): the paths' shapes (the 8B prefill padded to batch
# 2 with segments, SigLIP, the resampler, the fp32 UNet's self- and
# cross-attention at D = 64, Qwen-ViT-G's D = 104 through its fused
# in_proj, the input projector's D = 160), then the edges: one key, lengths
# off the 64-row and 32-key tiles, causal with Sq != Sk, GQA 8/1, packed
# segments, D = 8 and 24
K1_F32_CASES = [
    (2, 341, 341, 32, 8, 128, True, 284, "bshd"),
    (5, 729, 729, 16, 16, 72, False, None, "bshd"),
    (5, 64, 729, 32, 32, 128, False, None, "bshd"),
    (2, 4096, 4096, 10, 10, 64, False, None, "bshd"),
    (2, 1024, 1024, 20, 20, 64, False, None, "bshd"),
    (2, 4096, 64, 10, 10, 64, False, None, "bshd"),
    (2, 1024, 64, 20, 20, 64, False, None, "bshd"),
    (5, 1024, 1024, 16, 16, 104, False, None, "fused"),
    (5, 64, 256, 32, 32, 160, False, None, "bshd"),
    (1, 1, 1, 4, 1, 128, True, None, "bshd"),
    (2, 63, 65, 8, 2, 72, False, None, "bshd"),
    (2, 65, 63, 8, 2, 128, True, None, "bshd"),
    (1, 729, 129, 8, 1, 64, True, None, "bshd"),
    (2, 600, 600, 32, 8, 128, True, "packed", "bshd"),
    (2, 200, 200, 8, 8, 72, True, "packed", "fused"),
    (1, 129, 129, 8, 1, 8, True, None, "bshd"),
    (2, 65, 65, 8, 1, 24, True, 40, "bshd"),
    (2, 65, 63, 8, 8, 160, True, None, "bshd"),
]
# K1 f32's tolerance against the fp32 plain version, |err| ≤ 1e-4·max|plain|:
# split TF32 drops only the small·small term (about 2^-22 of a product),
# and the tensor cores' fp32 sums are not IEEE-rounded (on an H100 80GB
# HBM3, 700 W: at most 2.9e-5·max|plain| over the paths' shapes); one-pass
# TF32 (2^-11 relative on each operand) lands outside it (at least
# 3.4e-4·max|plain| there), which each case checks
K1_F32_TOL = 1e-4


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg,layout", K1_F32_CASES)
def test_k1_f32_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, seg,
                              layout):
    q, k, v, sids = _k1_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg, layout,
                               dtype=torch.float32)
    before, bf16 = flash_attention.f32_launches, flash_attention.launches
    kw = dict(causal=causal, segment_ids=sids)
    out = flash_attention(q, k, v, **kw)
    control = fa.flash_attention_f32_one_pass(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.f32_launches == before + 1
    assert flash_attention.launches == bf16
    assert out.dtype == torch.float32 and out.shape == q.shape
    ref = flash_attention_reference(q, k, v, **kw)
    tol = K1_F32_TOL * ref.abs().max()
    assert (out - ref).abs().max() <= tol
    assert (control - ref).abs().max() > tol     # the tolerance has power
    if isinstance(seg, int):
        assert (out[-1, seg:] == 0).all()       # fully masked rows give 0


def test_k1_f32_rejects_what_it_does_not_take(cuda):
    n = (flash_attention.f32_launches, flash_attention.f32_lse_launches)
    q = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)            # mixed dtypes
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q, return_lse=True)
    wide = torch.randn(1, 8, 2, 66, device=cuda)[..., :64]
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)              # stride 66, not 4k
    for D in (264, 512):        # the reference takes 512; fp32 stops at 256
        with pytest.raises(ValueError, match="up to 256; fp32 .*gap 2"):
            flash_attention(*(torch.randn(1, 8, 2, D, device=cuda),) * 3)
    assert (flash_attention.f32_launches,
            flash_attention.f32_lse_launches) == n


# K1 f32 with its LSE, K2 f32 and K3 f32: the fp32 training paths' shapes
# (the SDXL UNet at 1024² at batch 2: self-attention at 4096 and 1024
# positions, cross-attention over the resampler's 64 tokens; SD-1.5's IP
# UNet at 512²: D = 40, 80, 160 over 77 text and 16 image keys), marked
# True where the one-pass control must miss the bar; then the edges: head
# dims 8 to 160, lengths off the 64-row and 32-row tiles, causal with
# Sq != Sk, GQA 8/1 and 32/8, packed segments that change inside a tile,
# rows with no visible key, q, k, v as strided views of a fused tensor, one
# query row; then F32_WIDE_CASES above D = 160
F32_BWD_CASES = [  # B, Sq, Sk, Hq, Hkv, D, causal, seg, layout, power
    (2, 4096, 4096, 10, 10, 64, False, None, "bshd", True),
    (2, 1024, 1024, 20, 20, 64, False, None, "bshd", True),
    (2, 4096, 64, 10, 10, 64, False, None, "bshd", True),
    (2, 1024, 64, 20, 20, 64, False, None, "bshd", True),
    (2, 4096, 4096, 8, 8, 40, False, None, "bshd", True),
    (2, 1024, 77, 8, 8, 80, False, None, "bshd", True),
    (2, 256, 256, 8, 8, 160, False, None, "bshd", True),
    (2, 64, 16, 8, 8, 160, False, None, "bshd", False),
    (1, 129, 129, 8, 1, 8, True, None, "bshd", False),
    (2, 65, 65, 8, 1, 24, True, 40, "bshd", False),
    (2, 63, 65, 8, 2, 72, False, None, "bshd", False),
    (2, 65, 63, 8, 2, 128, True, None, "bshd", False),
    (1, 729, 129, 8, 1, 64, True, None, "bshd", False),
    (1, 100, 300, 4, 2, 96, True, None, "bshd", False),
    (2, 600, 600, 32, 8, 128, True, "packed", "bshd", False),
    (2, 200, 200, 8, 8, 72, True, "packed", "fused", False),
    (2, 300, 300, 16, 16, 104, False, "packed", "fused", False),
    (1, 129, 129, 8, 2, 136, True, None, "bshd", False),
    (2, 65, 63, 8, 8, 152, True, None, "bshd", False),
    (1, 1, 37, 4, 1, 128, False, None, "bshd", False),
]


# above D = 160, at the padded 192 (168, 192) and 256 (200, 240, 256; K2
# f32's and K3 f32's streamed tiles 16 rows there): causal with Sq != Sk
# both ways, GQA 16/4, packed segments that change inside a tile with a
# padded tail, rows with no visible key, q, k, v as strided views of a
# fused tensor, and one key; the one-pass control must miss the bar in
# each (over one key, in dV alone: see _one_key_sizes)
F32_WIDE_EDGES = [  # B, Sq, Sk, Hq, Hkv, causal, seg, layout
    (2, 65, 63, 8, 2, True, None, "bshd"),
    (1, 63, 130, 8, 2, True, None, "bshd"),
    (2, 129, 129, 16, 4, True, "packed", "bshd"),
    (2, 100, 100, 8, 8, False, 40, "bshd"),
    (2, 200, 200, 8, 8, True, "packed", "fused"),
    (2, 65, 1, 8, 2, False, None, "bshd"),
]
F32_WIDE_CASES = [(B, Sq, Sk, Hq, Hkv, D, causal, seg, layout, True)
                  for D in (168, 192, 200, 240, 256)
                  for B, Sq, Sk, Hq, Hkv, causal, seg, layout
                  in F32_WIDE_EDGES]


def _f32_bwd_inputs(dev, B, Sq, Sk, Hq, Hkv, D, seg, layout, seed=0):
    q, k, v, sids = _k1_inputs(dev, B, Sq, Sk, Hq, Hkv, D, seg, layout,
                               seed=seed, dtype=torch.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    do = torch.randn(B, Sq, Hq, D, device=dev, generator=g)
    return q, k, v, do, sids


def _f32_err(got, ref, size=0.0):
    """max|got − ref| over max(max|ref|, size) (0 for an all-zero ref)."""
    return (got - ref).abs().max().item() / max(ref.abs().max().item(),
                                                 size, 1e-30)


def _one_key_sizes(q, k, v, do):
    """Over one key P is 1 and dS = P∘(dP − δ) is 0 but for rounding, so
    dQ and dK are rounding noise: the sizes they would have
    (scale·max|dP|·max|k|, ·max|q|, with max|dP| ≤ max Σ|dO|·max|v|), which
    their errors are measured against, and no control is held to them."""
    dp = (do.abs().sum(-1).max() * v.abs().max()).item()
    scale = q.shape[-1] ** -0.5
    return {"dq": scale * dp * k.abs().max().item(),
            "dk": scale * dp * q.abs().max().item()}


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg,layout,power",
                         F32_BWD_CASES + F32_WIDE_CASES)
def test_k1_f32_lse_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, seg,
                                  layout, power):
    """K1 f32 with its LSE against the fp32 plain version, its output the
    same bits as without the LSE; where ``power``, the one-pass control
    misses the bar."""
    q, k, v, _, sids = _f32_bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg,
                                       layout)
    kw = dict(causal=causal, segment_ids=sids)
    n = (flash_attention.f32_launches, flash_attention.f32_lse_launches)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.f32_launches,
            flash_attention.f32_lse_launches) == (n[0], n[1] + 1)
    assert torch.equal(out, flash_attention(q, k, v, **kw))
    ref, rlse = flash_attention_reference(q, k, v, return_lse=True, **kw)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert torch.isfinite(lse).all() and torch.isfinite(out).all()
    assert (lse - rlse).abs().max() <= K1_F32_TOL * max(
        1.0, rlse.abs().max().item())
    assert _f32_err(out, ref) <= K1_F32_TOL
    if power:
        control = fa.flash_attention_f32_one_pass(q, k, v, **kw)
        assert _f32_err(control, ref) > K1_F32_TOL
    if isinstance(seg, int):      # rows with no visible key: 0 and LSE 0
        assert (out[-1, seg:] == 0).all() and (lse[-1, :, seg:] == 0).all()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg,layout,power",
                         F32_BWD_CASES + F32_WIDE_CASES)
def test_k2_k3_f32_match_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, seg,
                               layout, power):
    """K2 f32 and K3 f32 against their fp32 plain versions on K1 f32's
    LSE, within K1_F32_TOL·max|plain|; beside them the one-pass control,
    which must miss that bar where ``power``; a repeat bit-identical."""
    q, k, v, do, sids = _f32_bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg,
                                        layout)
    kw = dict(causal=causal, segment_ids=sids)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    delta = attention_delta(o, do)
    n = (flash_bwd_dq.f32_launches, flash_bwd_dkv.f32_launches,
         flash_bwd_dq.launches, flash_bwd_dkv.launches)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    one = (fa.flash_bwd_dq_f32_one_pass(q, k, v, do, lse, delta, **kw),
           *fa.flash_bwd_dkv_f32_one_pass(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert (flash_bwd_dq.f32_launches, flash_bwd_dkv.f32_launches,
            flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        n[0] + 1, n[1] + 1, n[2], n[3])
    refs = (flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
            *flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
    sizes = _one_key_sizes(q, k, v, do) if Sk == 1 else {}
    for name, got, ctl, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), one,
                                   refs):
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        err = _f32_err(got, ref, sizes.get(name, 0.0))
        assert err <= K1_F32_TOL, (name, err)
        if power and name not in sizes:
            assert _f32_err(ctl, ref) > K1_F32_TOL, (name, _f32_err(ctl, ref))
    if isinstance(seg, int):      # rows with no visible key: zero gradients
        assert (dq[-1, seg:] == 0).all()
    again = (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    assert all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again))


# K2 f32 and K3 f32 on their wgmma route (padded head dims up to 128): the
# IP UNet's D = 40 and 80, the SDXL UNet's 64 and 128, over 64, 77 and 1000
# keys with Sq off a multiple of 64, causal with Sq != Sk, GQA 8/2, packed
# segments with a padded tail, and q, k, v as strided views of a fused
# tensor
F32_WGMMA_CASES = [  # B, Sq, Sk, Hq, Hkv, D, causal, seg, layout
    (B, Sq, Sk, Hq, Hkv, D, causal, seg, layout)
    for D in (40, 64, 80, 128)
    for B, Sq, Sk, Hq, Hkv, causal, seg, layout in (
        (2, 200, 64, 8, 2, False, None, "bshd"),
        (2, 130, 77, 8, 2, True, None, "bshd"),
        (1, 1000, 1000, 8, 2, True, "packed", "bshd"),
        (2, 1000, 1000, 4, 4, False, None, "fused"))]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg,layout",
                         F32_WGMMA_CASES)
def test_k2_k3_f32_wgmma_route_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D,
                                             causal, seg, layout):
    """The wgmma route within K1_F32_TOL·max|plain|, its one-pass control
    outside, a repeat bit-identical, one ``f32_launches`` a call (the body
    of :func:`test_k2_k3_f32_match_plain`)."""
    assert fa.k23_f32_plan(D).route == "wgmma"
    test_k2_k3_f32_match_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, seg,
                               layout, True)


@pytest.mark.parametrize("Sq,Sk", [(0, 64), (64, 0)])
def test_k2_k3_f32_empty_lengths(cuda, Sq, Sk):
    """Sk = 0: every row is fully masked, zero dQ; Sq = 0: no query sees a
    key, zero dK and dV; neither launches a kernel."""
    q, k, v, do, _ = _f32_bwd_inputs(cuda, 2, max(Sq, 1), max(Sk, 1), 4, 2,
                                     64, None, "bshd")
    q, do, k, v = q[:, :Sq], do[:, :Sq], k[:, :Sk], v[:, :Sk]
    lse = torch.zeros(2, 4, Sq, device=cuda)
    delta = torch.zeros(2, 4, Sq, device=cuda)
    n = (flash_bwd_dq.f32_launches, flash_bwd_dkv.f32_launches)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    assert (flash_bwd_dq.f32_launches, flash_bwd_dkv.f32_launches) == n
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    for t in (dq, dk, dv):
        assert (t == 0).all()


def test_flash_function_f32_gradients_match_plain(cuda):
    """FlashAttention on fp32 operands (K1 f32 with its LSE, K2 f32, K3
    f32) through ``multi_head_attention``'s routing, against autograd
    through the fp32 plain forward, on a strided dO."""
    q, k, v, do, sids = _f32_bwd_inputs(cuda, 2, 300, 300, 8, 2, 64,
                                        "packed", "bshd")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n = (flash_attention.f32_lse_launches, flash_bwd_dq.f32_launches,
         flash_bwd_dkv.f32_launches, flash_attention.f32_launches)
    o = port_ops.multi_head_attention(*leaves, causal=True, segment_ids=sids)
    o.backward(do.transpose(1, 2).contiguous().transpose(1, 2))
    torch.cuda.synchronize()
    assert (flash_attention.f32_lse_launches, flash_bwd_dq.f32_launches,
            flash_bwd_dkv.f32_launches, flash_attention.f32_launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1, n[3])
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = flash_attention_reference(*plain, causal=True, segment_ids=sids)
    ref.backward(do)
    assert _f32_err(o.detach(), ref.detach()) <= K1_F32_TOL
    for a, b in zip(leaves, plain):
        assert _f32_err(a.grad, b.grad) <= K1_F32_TOL


def test_k2_k3_f32_reject_what_they_do_not_take(cuda):
    q, k, v, do, _ = _f32_bwd_inputs(cuda, 1, 64, 64, 4, 2, 64, None,
                                     "bshd")
    o, lse = flash_attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(o, do)
    n = (flash_bwd_dq.f32_launches, flash_bwd_dkv.f32_launches)
    with pytest.raises(TypeError):
        flash_bwd_dq(q, k.bfloat16(), v, do, lse, delta)    # mixed dtypes
    with pytest.raises(TypeError):
        flash_bwd_dkv(q, k, v, do.bfloat16(), lse, delta)   # bf16 dO
    with pytest.raises(ValueError):
        flash_bwd_dq(q, k, v, do, lse[:, :, :32], delta)    # short lse
    with pytest.raises(TypeError):                          # bf16 control
        fa.flash_bwd_dq_f32_one_pass(*(t.bfloat16() for t in (q, k, v, do)),
                                     lse, delta)
    d264 = torch.zeros(1, 64, 4, 264, device=cuda)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="up to 256; fp32 .*gap 2"):
            fn(d264, d264, d264, d264, lse, delta)          # D > 256
    wide = torch.randn(1, 64, 4, 66, device=cuda)[..., :64]
    with pytest.raises(ValueError):
        flash_bwd_dkv(wide, k, v, do, lse, delta)           # stride 66
    assert (flash_bwd_dq.f32_launches, flash_bwd_dkv.f32_launches) == n


@pytest.fixture(params=("planned", "mma_sync"))
def k23_regime(request, monkeypatch):
    """Each K2/K3 case in the regime the call gets (the Hopper kernels from
    D = 32) and in the mma.sync one forced (the first design, which the
    bench times beside them)."""
    if request.param == "mma_sync":
        monkeypatch.setattr(fa, "k23_regime", lambda D: "mma_sync")
    return request.param


def _bwd_inputs(dev, B, Sq, Sk, Hq, Hkv, D, seg_kind, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, do = (torch.randn(B, Sq, Hq, D, device=dev, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Sk, Hkv, D, device=dev, generator=g).bfloat16()
            for _ in range(2))
    seg = None
    if seg_kind is not None:
        qs = torch.ones(B, Sq, dtype=torch.int32, device=dev)
        ks = torch.ones(B, Sk, dtype=torch.int32, device=dev)
        if seg_kind == "packed":            # two segments and a padded tail
            qs[:, Sq // 2:] = 2
            qs[-1, Sq - Sq // 5:] = 0
            ks = qs.clone()
        elif seg_kind == "masked_row":      # rows whose keys are all masked
            qs[0, [1, Sq // 2]] = 9
        elif seg_kind == "nonmonotone":     # ids out of order, padded tail
            gen = torch.Generator().manual_seed(seed)
            for b in range(B):
                pos = 0
                while pos < Sq:
                    n = int(torch.randint(20, 90, (1,), generator=gen))
                    qs[b, pos:pos + n] = int(torch.randint(1, 4, (1,),
                                                           generator=gen))
                    pos += n
            qs[-1, Sq - Sq // 6:] = 0
            ks = qs.clone()
        seg = SegmentIds(q=qs, kv=ks)
    return q, k, v, do, seg


def _close(out, ref, rtol, atol_frac):
    out, ref = out.float(), ref.float()
    diff = (out - ref).abs()
    assert torch.isfinite(out).all()
    assert (diff <= rtol * ref.abs() + atol_frac * ref.abs().max()).all(), \
        diff.max().item()


BWD_CASES = [
    (2, 600, 600, 32, 8, 128, True, "packed"),   # the Llama training layer
    (3, 64, 729, 32, 32, 128, False, None),      # the resampler
    (2, 729, 729, 16, 16, 72, False, None),      # SigLIP, unfrozen
    (1, 77, 77, 4, 2, 32, True, "packed"),       # tiny, D=32
    (2, 100, 130, 8, 2, 104, False, None),       # ragged S, Sq != Sk
    (1, 70, 70, 8, 1, 64, True, "masked_row"),   # fully masked rows, G=8
    (2, 300, 300, 8, 2, 128, True, "nonmonotone"),  # ids like 2 2 1 1 3
    (2, 520, 520, 8, 8, 72, False, "packed"),    # segment skips, D=72
    (1, 100, 100, 4, 2, 16, True, "packed"),     # D=16: mma.sync regime
]
# every case above the mma.sync one again at head dims 144 and 160 (one
# K2/K3 block per SM, K3 with two consumer warpgroups), and SEED-X's input
# projector: 64 queries over 256 keys, 32 heads of 160
WIDE_BWD_CASES = [c[:5] + (D,) + c[6:] for D in (144, 160)
                  for c in BWD_CASES if c[5] >= 32] + [
    (24, 64, 256, 32, 32, 160, False, None),
]


# the de-tokenizer's training (D = 64): the SDXL UNet's self-attention at
# 64² and 32² latents and its cross-attention over the resampler's tokens
UNET_BWD_CASES = [
    (2, 4096, 4096, 10, 10, 64, False, None),
    (2, 1024, 1024, 20, 20, 64, False, None),
    (2, 4096, 64, 10, 10, 64, False, None),
    (2, 1024, 64, 20, 20, 64, False, None),
]


# head dims above 160 (the kernels at 192 or 256; one block per SM, K2
# without setmaxnreg, K3 split with 232-register consumers): the
# reference's bench shape, a causal GQA 16/8 shape with packed segments at
# wide public models' head dims, and the edges at 168, 192, 200 and 256
ABOVE_160_BWD_CASES = [
    (32, 256, 256, 8, 8, 256, False, None),
    (2, 1000, 1000, 16, 8, 256, True, "packed"),
    (2, 600, 600, 32, 8, 192, True, "packed"),
    (2, 100, 130, 8, 2, 192, False, None),
    (1, 70, 70, 8, 1, 256, True, "masked_row"),
    (2, 300, 300, 8, 2, 256, True, "nonmonotone"),
    (2, 130, 100, 4, 4, 168, True, None),
    (2, 64, 256, 8, 8, 200, False, None),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind",
                         BWD_CASES + WIDE_BWD_CASES + UNET_BWD_CASES
                         + ABOVE_160_BWD_CASES)
def test_k1_lse_matches_plain(cuda, block_q, B, Sq, Sk, Hq, Hkv, D, causal,
                              seg_kind):
    q, k, v, _, seg = _bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg_kind)
    kw = dict(causal=causal, segment_ids=seg)
    before = flash_attention.launches
    if fa.k1_smem_bytes(block_q, D) > fa.K1_MAX_SMEM:
        # a 128-row tile does not fit at D = 160: refused, never launched
        with pytest.raises(ValueError, match="shared memory"):
            flash_attention(q, k, v, return_lse=True, **kw)
        assert flash_attention.launches == before
        return
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref, ref_lse = flash_attention_reference(q, k, v, return_lse=True, **kw)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    assert torch.isfinite(lse).all()
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    _close(out, ref, 1e-2, 1e-2)
    if seg_kind == "masked_row":
        assert (lse[0, :, 1] == 0).all()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind",
                         BWD_CASES + WIDE_BWD_CASES + UNET_BWD_CASES)
def test_k2_k3_match_plain(cuda, k23_regime, B, Sq, Sk, Hq, Hkv, D, causal,
                           seg_kind):
    q, k, v, do, seg = _bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg_kind)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = flash_attention_reference(q, k, v, return_lse=True, **kw)
    delta = attention_delta(o, do)
    n2, n3 = flash_bwd_dq.launches, flash_bwd_dkv.launches
    w2, w3 = flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (n2 + 1,
                                                               n3 + 1)
    hopper = int(k23_regime == "planned" and D >= fa.K23_MIN_HEAD_DIM)
    assert (flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches) == (
        w2 + hopper, w3 + hopper)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    rdq = flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    rdk, rdv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        _close(got, ref, 2e-2, 1e-2)
    if seg_kind == "masked_row":
        assert (dq[0, 1] == 0).all() and (dq[0, Sq // 2] == 0).all()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind",
                         ABOVE_160_BWD_CASES)
def test_k2_k3_above_160_match_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal,
                                     seg_kind):
    """K2 and K3 at head dims above 160, where only the Hopper kernels
    run (the mma.sync design refuses them), against their plain versions,
    and a repeat bit-identical."""
    q, k, v, do, seg = _bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg_kind)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    delta = attention_delta(o, do)
    w2, w3 = flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches
    first = (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    second = (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
              *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert (flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches) == (
        w2 + 2, w3 + 2)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    rdq = flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    rdk, rdv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    for got, ref in zip(first, (rdq, rdk, rdv)):
        _close(got, ref, 2e-2, 1e-2)
    if seg_kind == "masked_row":
        assert (first[0][0, 1] == 0).all()
    with pytest.MonkeyPatch.context() as mp:     # mma.sync stops at 160
        mp.setattr(fa, "k23_regime", lambda D: "mma_sync")
        n = flash_bwd_dq.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        assert flash_bwd_dq.launches == n


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind", [
    (8, 600, 600, 32, 8, 128, True, "packed"),   # the Llama training layer
    (56, 64, 729, 32, 32, 128, False, None),     # the resampler's, batch 8
    (24, 64, 256, 32, 32, 160, False, None),     # SEED-X's input projector
    (2, 600, 600, 40, 40, 160, True, "packed"),  # D = 160, causal, MHA
])
def test_k2_k3_repeat_bit_identical(cuda, k23_regime, B, Sq, Sk, Hq, Hkv, D,
                                    causal, seg_kind):
    """No atomics, a fixed order of every sum: two launches give the same
    bits, at the training shapes, in both regimes."""
    q, k, v, do, seg = _bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg_kind)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    delta = attention_delta(o, do)
    w2, w3 = flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches
    hopper = 2 * int(k23_regime == "planned")
    first = (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
             *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    second = (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
              *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    assert (flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches) == (
        w2 + hopper, w3 + hopper)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    rdq = flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    _close(first[0], rdq, 2e-2, 1e-2)


@pytest.mark.parametrize("shape", [(8, 600, 32, 128), (3, 64, 32, 128),
                                   (2, 77, 4, 72)])
def test_attention_delta_matches_the_fp32_formula(cuda, shape):
    """δ by one batched product with fp32 output against the fp32 formula
    on the same bf16 o and dO: the products are exact in fp32 and only the
    order of the fp32 sum differs, so |err| <= 1e-5·Σ_d |o·dO|."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    o, do = (torch.randn(*shape, device=cuda, generator=g).bfloat16()
             for _ in range(2))
    got = attention_delta(o, do)
    prod = o.float() * do.float()
    ref = prod.sum(-1).transpose(1, 2)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.is_contiguous()
    assert ((got - ref).abs()
            <= 1e-5 * prod.abs().sum(-1).transpose(1, 2)).all()


def test_flash_function_gradients_match_plain(cuda):
    """FlashAttention (K1 with LSE, K2, K3) against autograd through the
    plain forward, on a strided (non-contiguous) dO."""
    q, k, v, do, seg = _bwd_inputs(cuda, 2, 300, 300, 8, 2, 128, "packed")
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n = (flash_attention.launches, flash_bwd_dq.launches,
         flash_bwd_dkv.launches)
    o = FlashAttention.apply(*leaves, True, seg, 128 ** -0.5)
    do_strided = do.transpose(1, 2).contiguous().transpose(1, 2)
    o.backward(do_strided)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    plain = [x.clone().float().requires_grad_() for x in (q, k, v)]
    ref = flash_attention_reference(*plain, causal=True, segment_ids=seg)
    ref.backward(do.float())
    _close(o, ref, 1e-2, 1e-2)
    for a, b in zip(leaves, plain):
        _close(a.grad, b.grad, 2e-2, 1e-2)


def test_k2_k3_reject_what_they_do_not_take(cuda):
    q, k, v, do, _ = _bwd_inputs(cuda, 1, 64, 64, 4, 2, 64, None)
    o, lse = flash_attention_reference(q, k, v, return_lse=True)
    delta = attention_delta(o, do)
    n = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    with pytest.raises(TypeError):
        flash_bwd_dq(q.float(), k, v, do, lse, delta)       # fp32 q
    with pytest.raises(ValueError):
        flash_bwd_dkv(q, k, v, do, lse.double(), delta)     # fp64 lse
    with pytest.raises(ValueError):
        flash_bwd_dq(q, k, v, do, lse[:, :, :32], delta)    # short lse
    wide = torch.zeros(1, 64, 4, 512, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        flash_bwd_dkv(wide, wide[:, :, :2], wide[:, :, :2], wide,
                      lse, delta)                           # D > 256
    d264 = torch.zeros(1, 64, 4, 264, device=cuda).bfloat16()
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="up to 256"):
            fn(d264, d264, d264, d264, lse, delta)          # D > 256
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == n


def test_tiny_train_step_kernels_match_plain(cuda):
    """One training step's gradients of a tiny bf16 assembly (LoRA, remat
    'dots', segment ids from a padded row) with K1/K2/K3 against the same
    step with the plain attention forward and backward: cos ≥ 0.99 over
    the LoRA and the projector gradients, and the launch counts."""
    from mllm_npu_tpu_torch.train.train import batch_to_device, mllm_loss
    from mllm_npu_tpu_torch.train.train_state import (compute_grads,
                                                      trainable_parameters)
    from mllm_npu_tpu_torch.utils.testing import (TinySpec, build_tiny_mllm,
                                                  synthetic_batch)
    spec = TinySpec(dtype=torch.bfloat16)
    model, lm_cfg, vis_cfg = build_tiny_mllm(
        spec, device=cuda, train=True, llama_kw=dict(
            lora_rank=4, lora_alpha=8.0, remat=True, remat_policy="dots"))
    model.train()
    batch = synthetic_batch(spec, batch=2, seq=96, max_images=2,
                            cmp_images=2)
    batch["attention_mask"][1, 70:] = 0
    batch = batch_to_device(batch, cuda)
    grads = {}
    for route in ("kernels", "plain"):
        fns = (flash_attention, port_ops.flash_attention_trainable)
        if route == "plain":
            port_ops.flash_attention = flash_attention_reference
            port_ops.flash_attention_trainable = flash_attention_reference
        n = (flash_attention.launches, flash_bwd_dq.launches,
             flash_bwd_dkv.launches)
        try:
            loss, _ = compute_grads(model, mllm_loss, [batch])
        finally:
            port_ops.flash_attention, port_ops.flash_attention_trainable = fns
        torch.cuda.synchronize()
        got = (flash_attention.launches - n[0], flash_bwd_dq.launches - n[1],
               flash_bwd_dkv.launches - n[2])
        L = lm_cfg.num_hidden_layers
        expect = ((vis_cfg.num_hidden_layers + 1 + 2 * L, L + 1, L + 1)
                  if route == "kernels" else (0, 0, 0))
        assert got == expect, (route, got, expect)
        assert torch.isfinite(loss)
        grads[route] = {k: p.grad.float().clone()
                        for k, p in trainable_parameters(model)}
    for part in ("lora_", "projector."):
        a = torch.cat([g.flatten() for k, g in grads["kernels"].items()
                       if part in k])
        b = torch.cat([g.flatten() for k, g in grads["plain"].items()
                       if part in k])
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        assert cos >= 0.99, (part, cos)


# K4 / K5: decode (M ≤ 16: 1, 5) and prefill (M > 16: 17, 339) regimes,
# ragged N (odd, and the lm_head's 128587), a ragged K tail for int8
# (K % 64 ≠ 0), G = 256 and G = K for int4; then the prefill kernel at the
# Llama's four projection shapes at the image prompt's M = 339, the batched
# worker's chunks (M = 128, 512) and M = 17, 63 (one X tile, split K)
QUANT_CASES = [
    (8, 1, 4096, 4096, None), (8, 5, 256, 77, None),
    (8, 339, 512, 1000, None), (8, 17, 208, 130, None),
    (8, 1, 4096, 128587, None), (8, 339, 4096, 14336, None),
    (4, 1, 4096, 4096, 256), (4, 5, 256, 77, 256),
    (4, 339, 512, 1000, 128), (4, 17, 384, 130, 384),
    (4, 1, 4096, 128587, 256), (4, 339, 14336, 4096, 256),
    (8, 339, 4096, 4096, None), (8, 339, 4096, 1024, None),
    (8, 339, 14336, 4096, None),
    (4, 339, 4096, 4096, 256), (4, 339, 4096, 1024, 256),
    (4, 339, 4096, 14336, 256),
    (8, 128, 4096, 4096, None), (8, 512, 4096, 14336, None),
    (4, 128, 4096, 14336, 256), (4, 512, 4096, 4096, 256),
    (8, 17, 4096, 1024, None), (8, 63, 14336, 4096, None),
    (4, 17, 4096, 4096, 256), (4, 63, 4096, 1024, 256),
] + [
    # the int8 / int4 SDXL UNet at 1024² (CFG batch 2): its projections at
    # the 64² level (M = 8192; K = 640 takes one int4 group of 640), the
    # 32² level (M = 2048) and the cross-attention's k/v over 2 × 64
    # context rows
    (bits, M, K, N, (640 if K == 640 else 256) if bits == 4 else None)
    for bits in (8, 4)
    for M, K, N in ((8192, 640, 640), (8192, 640, 5120), (8192, 2560, 640),
                    (2048, 1280, 10240), (2048, 5120, 1280),
                    (128, 2048, 1280))
] + [
    # the fused projections' N (qkv 6144, gate_up 28672) at the rows of
    # sampled and speculative serving: decode (1), the single-request
    # verify (5), a worker step (8), the worker's verify at k = 4
    # (8 × 5 = 40) and at k = 63 (8 × 64 = 512)
    (bits, M, 4096, N, 256 if bits == 4 else None) for bits in (8, 4)
    for N in (6144, 28672) for M in (1, 5, 8, 40, 512)
] + [
    # Llama-2-13B (SEED-X): q/k/v/o, gate/up, down and the lm_head (its
    # 32330 vocab) at decode (1), a worker step (8) and the image prefill
    (bits, M, K, N, 256 if bits == 4 else None) for bits in (8, 4)
    for K, N in ((5120, 5120), (5120, 13824), (13824, 5120), (5120, 32330))
    for M in (1, 8, 339)
]


def _quantized(bits, N, K, G, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = (torch.randn(N, K, device=dev, generator=g) * 0.02).bfloat16()
    if bits == 8:
        return tq.quantize_int8(w), tq.int8_matmul, tq.int8_matmul_reference
    return (tq.quantize_int4(w, G), tq.int4_matmul,
            tq.int4_matmul_reference)


@pytest.mark.parametrize("bits,M,K,N,G", QUANT_CASES)
def test_quant_kernels_match_plain(cuda, bits, M, K, N, G):
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x = torch.randn(M, K, device=cuda, generator=g).bfloat16()
    before = kernel.launches
    out = kernel(x, *qt)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    ref = plain(x, *qt).float()
    diff = (out.float() - ref).abs()
    assert torch.isfinite(out.float()).all()
    assert (diff <= 1e-2 * ref.abs() + 1e-3 * ref.abs().max()).all(), \
        diff.max().item()


# the split-K sums run in a fixed order: two launches give the same bits
@pytest.mark.parametrize("bits,M,K,N,G", [
    (8, 339, 4096, 1024, None), (8, 17, 4096, 4096, None),
    (4, 339, 4096, 1024, 256), (4, 128, 14336, 4096, 256),
])
def test_quant_prefill_repeats_bit_identical(cuda, bits, M, K, N, G):
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    assert tq.prefill_plan(bits, M, N, K, G or 0,
                           tq._sms(cuda)).splits > 1
    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    x = torch.randn(M, K, device=cuda, generator=g).bfloat16()
    before = kernel.prefill_launches
    first = kernel(x, *qt)
    second = kernel(x, *qt)
    torch.cuda.synchronize()
    assert kernel.prefill_launches == before + 2
    assert torch.equal(first, second)
    ref = plain(x, *qt).float()
    assert ((first.float() - ref).abs()
            <= 1e-2 * ref.abs() + 1e-3 * ref.abs().max()).all()


@pytest.mark.parametrize("bits,M,K,N,G", [
    (8, 2400, 5120, 13824, None), (4, 2400, 13824, 5120, 256),
    (4, 2048, 5120, 32330, 256), (8, 77, 256, 130, None),
    (4, 77, 256, 130, 128),
])
def test_quant_matmul_function_matches_plain(cuda, bits, M, K, N, G):
    """``QuantMatmul`` (QLoRA's product) on the card: the forward is K4 / K5
    (one launch, within K4/K5's tolerance of the plain product) and dx is
    g·dequant(W) with W dequantized in g's dtype (bf16, as the reference's
    backward) and fp32 sums, against the fp32 product of the same bf16 g
    and dequantized W (|err| <= 1e-2·|ref| + 1e-3·max|ref|: the output's
    bf16 rounding and the order of the sums); the values and scales get no
    gradient. Shapes: SEED-X's training rows (batch × 600 or 512) at its
    projections and lm_head, and a small ragged one."""
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    x = torch.randn(M, K, device=cuda, generator=g).bfloat16()
    gy = torch.randn(M, N, device=cuda, generator=g).bfloat16()
    xg = x.clone().requires_grad_()
    n = kernel.launches
    y = tq.quant_matmul(xg, *qt, bits)
    y.backward(gy)
    torch.cuda.synchronize()
    assert kernel.launches == n + 1
    _close(y, plain(x, *qt), 1e-2, 1e-3)
    deq = (tq.dequantize_int8 if bits == 8 else tq.dequantize_int4)(
        qt, torch.bfloat16)
    _close(xg.grad, gy.float() @ deq.float(), 1e-2, 1e-3)
    assert xg.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("bits,M,K,N,G", [
    (8, 2048, 640, 640, None), (4, 2048, 640, 640, 128),
    (8, 77, 256, 130, None),
])
def test_quant_matmul_function_f32_matches_plain(cuda, bits, M, K, N, G):
    """``QuantMatmul`` on fp32 x and g (fp32 training): the forward is K4
    f32 / K5 f32, dx the fp32 product of g and the weight dequantized to
    fp32, both within QUANT_F32_TOL·max|plain| of the fp32 plain products,
    dx in fp32."""
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(8)
    x = torch.randn(M, K, device=cuda, generator=g)
    gy = torch.randn(M, N, device=cuda, generator=g)
    xg = x.clone().requires_grad_()
    n = (kernel.f32_launches, kernel.launches)
    y = tq.quant_matmul(xg, *qt, bits)
    y.backward(gy)
    torch.cuda.synchronize()
    assert (kernel.f32_launches, kernel.launches) == (n[0] + 1, n[1])
    ref = plain(x, *qt)
    assert (y - ref).abs().max() <= QUANT_F32_TOL * ref.abs().max()
    deq = (tq.dequantize_int8 if bits == 8 else tq.dequantize_int4)(
        qt, torch.float32)
    rdx = gy @ deq
    assert xg.grad.dtype == torch.float32
    assert (xg.grad - rdx).abs().max() <= QUANT_F32_TOL * rdx.abs().max()


@pytest.mark.parametrize("bits,K", [(8, 640), (4, 640), (4, 1280)])
def test_biased_quant_linear_matches_plain(cuda, bits, K):
    """``Int8Linear`` / ``Int4Linear`` with a bias (the UNet's projections),
    quantized once on the CPU: on the card one K4 / K5 launch, then the
    bias in bf16, against the same module on the CPU (the plain product),
    within K4/K5's tolerance with one more bf16 rounding (the bias's)."""
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(320, K, generator=g) * 0.02).bfloat16()
    b = torch.randn(320, generator=g).bfloat16()
    x = torch.randn(2, 77, K, generator=g).bfloat16()
    if bits == 8:
        m = tq.Int8Linear.from_weight(w, torch.bfloat16, bias=b)
    else:
        m = tq.Int4Linear.from_weight(w, 256, torch.bfloat16, bias=b)
    kernel = tq.int8_matmul if bits == 8 else tq.int4_matmul
    with torch.no_grad():
        ref = m(x).float()
        before = kernel.launches
        out = m.to(cuda)(x.to(cuda)).float().cpu()
    assert kernel.launches == before + 1
    assert ((out - ref).abs() <= 2e-2 * ref.abs()
            + 1e-3 * ref.abs().max()).all(), (out - ref).abs().max()


def test_quant_kernels_take_leading_dims(cuda):
    qt, kernel, plain = _quantized(8, 64, 128, None, cuda)
    x = torch.randn(2, 3, 128, device=cuda).bfloat16()
    out = kernel(x, *qt)
    assert out.shape == (2, 3, 64)
    ref = plain(x, *qt).float()
    assert ((out.float() - ref).abs()
            <= 1e-2 * ref.abs() + 1e-3 * ref.abs().max()).all()


def test_quant_kernels_reject_what_they_do_not_take(cuda):
    q8, _, _ = _quantized(8, 64, 256, None, cuda)
    q4, _, _ = _quantized(4, 64, 256, 128, cuda)
    x = torch.randn(3, 256, device=cuda)
    n8, n4 = tq.int8_matmul.launches, tq.int4_matmul.launches
    with pytest.raises(TypeError):
        tq.int8_matmul(x.half(), *q8)                   # fp16 x
    with pytest.raises(TypeError):
        tq.int4_matmul(x.half(), *q4)
    xb = x.bfloat16()
    with pytest.raises(ValueError):                     # K % G != 0
        tq.int4_matmul(xb, q4.values, torch.ones(3, 64, device=cuda))
    with pytest.raises(ValueError):                     # G not a multiple
        tq.int4_matmul(xb, q4.values, torch.ones(4, 64, device=cuda))
    with pytest.raises(ValueError):                     # weight on the CPU
        tq.int8_matmul(xb, q8.values.cpu(), q8.scale)
    with pytest.raises(ValueError):                     # odd K
        tq.int4_matmul(torch.zeros(3, 255, device=cuda).bfloat16(), *q4)
    assert (tq.int8_matmul.launches, tq.int4_matmul.launches) == (n8, n4)


# K4 f32 / K5 f32 (fp32 x): the 8B's projections and lm_head at decode (1),
# a worker step (8) and the image prefill (339), and a ragged small shape
QUANT_F32_CASES = [
    (bits, M, K, N, 256 if bits == 4 else None) for bits in (8, 4)
    for K, N in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128587))
    for M in (1, 8, 339)
] + [(8, 77, 256, 130, None), (4, 17, 256, 130, 128), (4, 3, 640, 320, 128)]
# K4 f32 / K5 f32 against the fp32 plain products: x in three bf16 parts
# times the exact integer weights, summed in the tensor cores' fp32 (not
# IEEE-rounded) over a 16-k chunk or a ring stage, then in IEEE fp32, so
# |err| ≤ 2e-5·max|plain|; the plain product in one-pass TF32 (cuBLAS
# with allow_tf32) lands outside it (at least 1.9e-4·max|plain| on an
# H100 80GB HBM3, 700 W)
QUANT_F32_TOL = 2e-5


@pytest.mark.parametrize("bits,M,K,N,G", QUANT_F32_CASES)
def test_quant_f32_kernels_match_plain(cuda, bits, M, K, N, G):
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    x = torch.randn(M, K, device=cuda, generator=g)
    before, bf16 = kernel.f32_launches, kernel.launches
    out = kernel(x, *qt)
    torch.cuda.synchronize()
    assert (kernel.f32_launches, kernel.launches) == (before + 1, bf16)
    assert out.shape == (M, N) and out.dtype == torch.float32
    ref = plain(x, *qt)
    tol = QUANT_F32_TOL * ref.abs().max()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max() <= tol, (out - ref).abs().max().item()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        control = plain(x, *qt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if M * K >= 4096 * 8:      # enough terms for TF32's rounding to show
        assert (control - ref).abs().max() > tol


@pytest.mark.parametrize("bits", [8, 4])
def test_biased_quant_linear_f32_matches_plain(cuda, bits):
    """``Int8Linear`` / ``Int4Linear`` computing in fp32 with a bias: one
    K4 f32 / K5 f32 launch, the bias added in fp32, against the same module
    on the CPU."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(320, 640, generator=g) * 0.02
    b = torch.randn(320, generator=g)
    x = torch.randn(2, 77, 640, generator=g)
    if bits == 8:
        m = tq.Int8Linear.from_weight(w, torch.float32, bias=b)
    else:
        m = tq.Int4Linear.from_weight(w, 128, torch.float32, bias=b)
    kernel = tq.int8_matmul if bits == 8 else tq.int4_matmul
    with torch.no_grad():
        ref = m(x)
        before = kernel.f32_launches
        out = m.to(cuda)(x.to(cuda)).cpu()
    assert kernel.f32_launches == before + 1 and out.dtype == torch.float32
    assert (out - ref).abs().max() <= QUANT_F32_TOL * ref.abs().max()


@pytest.mark.parametrize("M,K", [(339, 4096), (8, 14336), (3, 640),
                                 (17, 256)])
def test_quant_f32_split_kernel_is_the_plain_split(cuda, M, K):
    """The pre-split kernel of K4 f32 / K5 f32's prefill against
    ``split_bf16x3`` bit for bit, on seeded x over many magnitudes (zeros,
    subnormals, up to 1e38) and on rows with a stride."""
    g = torch.Generator(device=cuda)
    g.manual_seed(M + K)
    x = (torch.randn(M, K + 8, device=cuda, generator=g)
         * torch.exp2(torch.randint(-140, 126, (M, K + 8), device=cuda,
                                    generator=g).float()))
    x[0, :4] = torch.tensor([0.0, -0.0, 1e38, -1e-40])
    x = x[:, 4:K + 4]                       # rows K + 8 apart
    got = tq.split_x3(x)
    assert got.shape == (3, M, K) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       tq.split_bf16x3(x).view(torch.int16))


# both routes of K4 f32 / K5 f32 at the rows where either may run, the
# 8B's gate_proj and down_proj
@pytest.mark.parametrize("bits,M,K,N", [
    (bits, M, K, N) for bits in (8, 4) for M in (1, 8, 16)
    for K, N in ((4096, 14336), (14336, 4096))])
def test_quant_f32_routes_match_plain(cuda, monkeypatch, bits, M, K, N):
    G = 256 if bits == 4 else None
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    x = torch.randn(M, K, device=cuda, generator=g)
    ref = plain(x, *qt)
    outs = []
    for limit in (tq.DECODE_MAX_M, 0):      # the decode route, the prefill
        monkeypatch.setattr(tq, "F32_DECODE_MAX_M", limit)
        assert tq.f32_prefill_route(M) == (limit == 0)
        outs.append(kernel(x, *qt))
    torch.cuda.synchronize()
    for out in outs:
        assert (out - ref).abs().max() <= QUANT_F32_TOL * ref.abs().max()


@pytest.mark.parametrize("bits,M,K,N", [
    (8, 1, 4096, 14336), (8, 339, 4096, 1024), (8, 339, 14336, 4096),
    (4, 1, 14336, 4096), (4, 8, 4096, 14336), (4, 339, 4096, 1024),
    (4, 339, 14336, 4096)])
def test_quant_f32_repeats_bit_identical(cuda, bits, M, K, N):
    """Repeated launches give the same bits (the parts and the split-K
    sums in a fixed order), the prefill shapes with splits of K among them;
    between launches the memory the parts' workspace is cut from is filled
    with NaN, so a decode that read the parts before the pre-split wrote
    them would show it."""
    G = 256 if bits == 4 else None
    qt, kernel, plain = _quantized(bits, N, K, G, cuda)
    x = torch.randn(M, K, device=cuda)
    before = kernel.f32_launches
    outs = []
    for _ in range(4):
        torch.full((3 * M * K,), float("nan"), dtype=torch.bfloat16,
                   device=cuda)
        outs.append(kernel(x, *qt))
    torch.cuda.synchronize()
    assert kernel.f32_launches == before + 4
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = plain(x, *qt)
    assert (outs[0] - ref).abs().max() <= QUANT_F32_TOL * ref.abs().max()


# -- head dims the flash kernels do not take: multi_head_attention pads --

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("D", [4, 36, 100])
def test_head_dim_padded_attention_matches_plain(cuda, D, dtype):
    """``multi_head_attention`` at a head dim off a multiple of 8: the
    forward (one K1 / K1 f32 launch at the padded D) and the trainable
    route (K1 with its LSE, K2, K3 once each), output and q/k/v gradients
    against autograd through the plain forward at the true D, within K1's
    and K2/K3's bf16 tolerances or K1_F32_TOL·max|plain|."""
    f32 = dtype == torch.float32
    if f32:
        q, k, v, do, seg = _f32_bwd_inputs(cuda, 2, 300, 300, 8, 2, D,
                                           "packed", "bshd")
    else:
        q, k, v, do, seg = _bwd_inputs(cuda, 2, 300, 300, 8, 2, D, "packed")
    fwd = "f32_launches" if f32 else "launches"
    fwd_lse = "f32_lse_launches" if f32 else "launches"
    bwd = "f32_launches" if f32 else "launches"
    kw = dict(causal=True, segment_ids=seg)
    n = getattr(flash_attention, fwd)
    with torch.no_grad():
        served = port_ops.multi_head_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert getattr(flash_attention, fwd) == n + 1
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n = (getattr(flash_attention, fwd_lse), getattr(flash_bwd_dq, bwd),
         getattr(flash_bwd_dkv, bwd))
    o = port_ops.multi_head_attention(*leaves, **kw)
    o.backward(do)
    torch.cuda.synchronize()
    assert (getattr(flash_attention, fwd_lse), getattr(flash_bwd_dq, bwd),
            getattr(flash_bwd_dkv, bwd)) == (n[0] + 1, n[1] + 1, n[2] + 1)
    plain = [x.clone().float().requires_grad_() for x in (q, k, v)]
    ref = flash_attention_reference(*plain, **kw)
    ref.backward(do.float())
    assert served.shape == o.shape == q.shape
    assert all(a.grad.shape == a.shape for a in leaves)
    if f32:
        for got in (served, o.detach()):
            assert _f32_err(got, ref.detach()) <= K1_F32_TOL
        for a, b in zip(leaves, plain):
            assert _f32_err(a.grad, b.grad) <= K1_F32_TOL
    else:
        _close(served, ref.detach(), 1e-2, 1e-2)
        _close(o.detach(), ref.detach(), 1e-2, 1e-2)
        for a, b in zip(leaves, plain):
            _close(a.grad, b.grad, 2e-2, 1e-2)


# -- the batched engine's decode block as a CUDA graph ---------------------

def _tiny_serving_model(dev, bits=None, seed=0):
    """The tiny assembly in bf16 on the card (int8 / int4 Llama with
    ``bits``), as the serving engines hold it."""
    from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
    from mllm_npu_tpu_torch.utils.weights import quantize_llama_
    model, _, _ = build_tiny_mllm(TinySpec(dtype=torch.bfloat16), device=dev,
                                  seed=seed)
    if bits is not None:
        quantize_llama_(model.language_model, bits=bits, group_size=128)
    return model


def _engine(model, **kw):
    from mllm_npu_tpu_torch.models.generation.sampler import (
        ImageTokenLadder)
    from mllm_npu_tpu_torch.serve.batched_engine import (
        ContinuousBatchingEngine)
    from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
    tok = FakeTokenizer()
    ladder = ImageTokenLadder(ids=tuple(
        [tok.special["<img>"]] + [tok.special[f"<img_{i:05d}>"]
                                  for i in range(4)]
        + [tok.special["</img>"]]))
    return ContinuousBatchingEngine(
        model, **dict(dict(num_slots=4, max_len=128, block_steps=4,
                           prompt_bucket=16, ladder=ladder), **kw))


def _prompts(n, seed=0, shortest=3):
    rs = torch.Generator().manual_seed(seed)
    return [torch.randint(3, 4000, (int(torch.randint(shortest, 40, (1,),
                                                      generator=rs)),),
                          generator=rs).tolist() for _ in range(n)]


def _drain(engine, prompts, T):
    reqs = [engine.submit(p, max_new_tokens=T) for p in prompts]
    engine.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_graphed_engine_matches_eager(cuda, bits):
    """Six requests over four slots (slots recycled, a ladder prompt among
    them), with and without chunked prefill: the graphed block gives the
    eager block's ids, and each tick was one replay."""
    model = _tiny_serving_model(cuda, bits)
    prompts = _prompts(5) + [[3, 17, 10]]           # the last ends in <img>
    for chunk in (None, 16):
        eager = _engine(model, cuda_graph=False, prefill_chunk=chunk)
        graphed = _engine(model, prefill_chunk=chunk)
        assert eager.replays == 0 and graphed.capture_s is not None
        want = _drain(eager, prompts, 20)
        got = _drain(graphed, prompts, 20)
        assert got == want, chunk
        assert graphed.replays == eager.eager_blocks > 0
        assert got[-1][:5] == [20, 21, 22, 23, 11]  # the forced ladder


def test_request_alone_equals_among_others(cuda):
    """Static decode shapes (every slot computes every step) and a per
    request prefill: a request's ids do not depend on what else is in
    flight."""
    model = _tiny_serving_model(cuda)
    engine = _engine(model)
    prompts = _prompts(7, seed=1)
    alone = _drain(engine, prompts[:1], 24)[0]
    among = _drain(engine, prompts, 24)
    assert among[0] == alone
    assert _drain(engine, prompts[3:4], 24)[0] == among[3]


def test_failed_capture_raises(cuda, monkeypatch):
    """A host read inside the block breaks the capture: the engine raises
    instead of falling back to eager."""
    from mllm_npu_tpu_torch.serve import batched_engine as be
    model = _tiny_serving_model(cuda)

    def syncing_sample(logits):
        torch.cuda.synchronize()
        return torch.argmax(logits, dim=-1) + int(logits[0, 0] > 1e30)
    monkeypatch.setattr(be, "_sample", syncing_sample)
    with pytest.raises(RuntimeError):
        _engine(model)
    monkeypatch.undo()
    assert _engine(model).capture_s is not None     # the card still works


@pytest.mark.parametrize("bits", [8, 4])
def test_replayed_block_launch_counts(cuda, bits):
    """The Python counters advance where a wrapper launches, i.e. at the
    capture's warm-up and at its recording: each holds block_steps × 225
    products (7 per layer and the lm_head, all at M = num_slots, the decode
    regime); a replay adds none, an admission's prefill adds one forward's
    (the bucket's M > 16 runs the prefill regime, the lm_head's last row
    the decode one)."""
    model = _tiny_serving_model(cuda, bits)
    kernel = getattr(tq, f"int{bits}_matmul")
    L = model.language_model.config.num_hidden_layers
    per_forward = 7 * L + 1
    kernel.launches = kernel.prefill_launches = 0
    engine = _engine(model, block_steps=6)
    assert engine.eager_blocks == 1
    assert kernel.launches == 2 * 6 * per_forward
    assert kernel.prefill_launches == 0
    kernel.launches = 0
    tokens = _drain(engine, _prompts(3, seed=2, shortest=17), 30)
    assert all(len(t) == 30 for t in tokens)
    assert engine.replays >= 5
    assert kernel.launches == 3 * per_forward
    assert kernel.prefill_launches == 3 * (per_forward - 1)


# -- the shapes of sampled, speculative and fused serving ------------------

@pytest.mark.parametrize("bits,M,N", [(8, 40, 6144), (8, 512, 28672),
                                      (8, 5, 6144), (4, 40, 28672),
                                      (4, 512, 6144), (8, 40, 128587)])
def test_quant_kernels_under_graph_capture(cuda, bits, M, N):
    """Inside a captured verify tick K4/K5's plan is made at capture and
    the split-K workspace comes from the graph's pool: replays on new
    inputs give the eager launch's bits."""
    qt, kernel, plain = _quantized(bits, N, 4096, 256, cuda)
    x = torch.zeros(M, 4096, device=cuda).bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(x, *qt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = kernel(x, *qt)
    for seed in (4, 5):
        g = torch.Generator(device=cuda)
        g.manual_seed(seed)
        x.copy_(torch.randn(M, 4096, device=cuda, generator=g).bfloat16())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, kernel(x, *qt))
        ref = plain(x, *qt).float()
        assert ((y.float() - ref).abs()
                <= 1e-2 * ref.abs() + 1e-3 * ref.abs().max()).all()


@pytest.mark.parametrize("bits,M,N", [(8, 1, 14336), (4, 8, 14336),
                                      (8, 40, 6144), (4, 40, 1024)])
def test_quant_f32_under_graph_capture(cuda, bits, M, N):
    """K4 f32 / K5 f32 captured in a CUDA graph (the fp32 engines' decode
    step and verify tick): the pre-split, then the decode kernel launched
    to overlap it (M <= 16) or the prefill kernel, the workspaces from the
    graph's pool; replays on new inputs give the eager launch's bits."""
    qt, kernel, plain = _quantized(bits, N, 4096, 256, cuda)
    x = torch.zeros(M, 4096, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kernel(x, *qt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = kernel(x, *qt)
    for seed in (4, 5):
        g = torch.Generator(device=cuda)
        g.manual_seed(seed)
        x.copy_(torch.randn(M, 4096, device=cuda, generator=g))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, kernel(x, *qt))
        ref = plain(x, *qt)
        assert (y - ref).abs().max() <= QUANT_F32_TOL * ref.abs().max()


def test_fp8_cast_and_scatter_match_the_cpu(cuda):
    """The fp8 cache write on the card: the same bytes as on the CPU for
    every edge value (saturating at ±448 above 464, as on the CPU), through
    the cast and through the per-row scatter into an fp8 cache."""
    from mllm_npu_tpu_torch.models.language_models.llama import (
        LlamaConfig, init_cache, to_cache, write_decode_column)
    vals = torch.tensor(
        [0.0, -0.0, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -10, 0.3, 1.0625,
         1.1875, -1.1875, 15.5, 17.0, 240.0, 248.0, 447.0, 448.0, -448.0,
         450.0, 456.0, 463.9, 464.0, -464.0, 465.0, 500.0, 1e4, -500.0,
         -1e4])
    want = to_cache(vals, torch.float8_e4m3fn).view(torch.uint8)
    got = to_cache(vals.to(cuda), torch.float8_e4m3fn).view(torch.uint8)
    assert torch.equal(got.cpu(), want)
    assert got[-5:].tolist() == [0x7E, 0x7E, 0x7E, 0xFE, 0xFE]
    n = vals.numel()
    cfg = LlamaConfig(num_hidden_layers=1, num_key_value_heads=n,
                      num_attention_heads=n, hidden_size=n)
    cache = init_cache(cfg, 2, 6, dtype=torch.float8_e4m3fn,
                       device=cuda)["k"]
    cache = cache[:, :, :, :, :1].contiguous()
    col = vals.to(cuda).bfloat16().reshape(1, 1, 1, n, 1).expand(
        cache.shape[0], 2, 3, n, 1).contiguous()
    write_decode_column(cache, col, torch.tensor([1, 3], device=cuda))
    b = cache.view(torch.uint8)
    want_b = to_cache(vals.bfloat16(), torch.float8_e4m3fn).view(torch.uint8)
    for row, start in ((0, 1), (1, 3)):
        for w in range(3):
            assert torch.equal(b[0, row, start + w, :, 0].cpu(), want_b)
    assert not b[0, 0, 0].any() and not b[0, 1, :3].any()


@pytest.mark.parametrize("bits,k", [(None, 4), (8, 4), (None, 9)])
def test_graphed_speculative_tick_matches_eager(cuda, bits, k):
    """The speculative verify tick captured as a CUDA graph: the eager
    tick's ids (six requests over four slots, a ladder prompt among them,
    repetitive prompts that accept), one replay a tick."""
    model = _tiny_serving_model(cuda, bits)
    prompts = _prompts(4) + [[7, 8, 9, 7, 8, 9, 7, 8], [3, 17, 10]]
    eager = _engine(model, cuda_graph=False, speculative_k=k)
    graphed = _engine(model, speculative_k=k)
    want = _drain(eager, prompts, 20)
    got = _drain(graphed, prompts, 20)
    assert got == want
    assert graphed.replays == eager.eager_blocks > 0
    assert got[-1][:5] == [20, 21, 22, 23, 11]


@pytest.mark.parametrize("k", [0, 4])
def test_graphed_sampled_rows_match_eager(cuda, k):
    """Sampled rows (seeded) beside greedy ones: the graphed engine gives
    the eager engine's ids, and a sampled request alone its ids among
    the others."""
    model = _tiny_serving_model(cuda)
    prompts = _prompts(6, seed=3)

    def run(engine, ps, idx):
        reqs = [engine.submit(p, max_new_tokens=16, do_sample=i % 2 == 0,
                              temperature=0.8, top_p=0.9, seed=i)
                for i, p in zip(idx, ps)]
        engine.run_until_idle()
        return [r.tokens for r in reqs]
    kw = dict(enable_sampling=True, speculative_k=k)
    want = run(_engine(model, cuda_graph=False, **kw), prompts, range(6))
    graphed = _engine(model, **kw)
    got = run(graphed, prompts, range(6))
    assert got == want
    assert run(graphed, prompts[2:3], [2]) == [got[2]]


# -- the single-request decode step as a CUDA graph ------------------------

def _generator(model, graphed, T=20):
    from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
    from mllm_npu_tpu_torch.models.generation.sampler import SamplingConfig
    from mllm_npu_tpu_torch.models.generation.sampler import (
        ImageTokenLadder)
    from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
    tok = FakeTokenizer()
    ladder = ImageTokenLadder(ids=tuple(
        [tok.special["<img>"]] + [tok.special[f"<img_{i:05d}>"]
                                  for i in range(4)]
        + [tok.special["</img>"]]))
    return MLLMGenerator(model, sampling=SamplingConfig(max_new_tokens=T),
                         ladder=ladder, cuda_graph=graphed,
                         cast_params_bf16=True)


@pytest.mark.parametrize("bits", [None, 8])
def test_graphed_single_request_decode_matches_eager(cuda, bits):
    """One generator replays a captured decode step, the other runs it
    eagerly, on the same model: the same ids and hidden states for single
    prompts (one ending in <img>: the forced ladder), a right-padded batch
    of two and sampled rows; a graph is captured once per (batch, cache
    bucket, greedy or sampled) by a call's first decode step, each later
    token is one replay, and other temperatures, top-p values and token
    budgets replay the same graph."""
    import dataclasses
    model = _tiny_serving_model(cuda, bits)
    g, e = _generator(model, True), _generator(model, False)
    prompts = _prompts(3, seed=4) + [[3, 17, 10]]
    for i, p in enumerate(prompts):
        ids = torch.tensor([p], device=cuda)
        got, want = g.generate(ids), e.generate(ids)
        assert got["generate_ids"].tolist() == want["generate_ids"].tolist()
        assert torch.equal(got["hidden_states"], want["hidden_states"])
        t = g.last_timings
        assert t["graph_captured"] == (i == 0)
        assert t["graph_replays"] + (i == 0) == t["decode_steps"] > 0
        assert e.last_timings["graph_replays"] == 0
    assert got["generate_ids"][0, :5].tolist() == [20, 21, 22, 23, 11]
    a, b = prompts[0], prompts[1]
    n = max(len(a), len(b))
    ids = torch.tensor([a + [0] * (n - len(a)), b + [0] * (n - len(b))],
                       device=cuda)
    pm = torch.tensor([[1] * len(a) + [0] * (n - len(a)),
                       [1] * len(b) + [0] * (n - len(b))], device=cuda)
    sampled = dataclasses.replace(g.sampling, do_sample=True,
                                  temperature=0.7, top_p=0.9)
    hotter = dataclasses.replace(sampled, temperature=1.3, top_p=0.8,
                                 max_new_tokens=12)
    for kw, captures in (
            (dict(prompt_mask=pm), True),
            (dict(prompt_mask=pm, sampling=sampled, seed=5), True),
            (dict(prompt_mask=pm, sampling=hotter, seed=6), False)):
        got, want = g.generate(ids, **kw), e.generate(ids, **kw)
        assert got["generate_ids"].tolist() == want["generate_ids"].tolist()
        assert g.last_timings["graph_captured"] == captures
    assert len(g._graphs) == 3


def test_decode_attention_reads_the_cache_as_stored(cuda):
    """A SEED-X-sized slot cache in bf16 (8 rows × 2048 × 40 heads × 128):
    the attention allocates nothing of the cache's size (the fp32 widening
    took two copies of twice its size), and agrees with the widened fp32
    products within the bf16 rounding of P (2e-3 on outputs of order 1)."""
    from mllm_npu_tpu_torch.ops.attention import decode_attention
    g = torch.Generator(device=cuda).manual_seed(0)
    B, Sk, H, D = 8, 2048, 40, 128
    k = torch.randn(B, Sk, H, D, device=cuda, generator=g).bfloat16()
    v = torch.randn(B, Sk, H, D, device=cuda, generator=g).bfloat16()
    q = torch.randn(B, 1, H, D, device=cuda, generator=g).bfloat16()
    kc = torch.randn(B, 1, H, D, device=cuda, generator=g).bfloat16()
    vc = torch.randn(B, 1, H, D, device=cuda, generator=g).bfloat16()
    lens = torch.randint(1, Sk, (B,), device=cuda, generator=g)
    am = (torch.arange(Sk, device=cuda)[None] < lens[:, None])[:, None, None]
    decode_attention(q, k, v, am, k_cur=kc, v_cur=vc)     # warm cuBLAS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = decode_attention(q, k, v, am, k_cur=kc, v_cur=vc)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra < 0.1 * k.numel() * k.element_size(), extra
    ref = decode_attention(q.cpu(), k.cpu(), v.cpu(), am.cpu(), k_cur=kc.cpu(),
                           v_cur=vc.cpu())
    assert ((out.float().cpu() - ref.float()).abs() <= 2e-3
            + 1e-2 * ref.float().abs()).all()


def test_decode_graph_follows_weights_changed_in_place(cuda):
    """A graph reads the weights at their captured addresses: after the
    Llama is quantized in place the generator drops its graphs and
    captures anew, so the graphed ids still equal the eager ones."""
    from mllm_npu_tpu_torch.utils.weights import quantize_llama_
    model = _tiny_serving_model(cuda)
    g, e = _generator(model, True), _generator(model, False)
    ids = torch.tensor([_prompts(1, seed=9)[0]], device=cuda)
    g.generate(ids)
    assert g.last_timings["graph_captured"]
    quantize_llama_(model.language_model, bits=8, group_size=128)
    got, want = g.generate(ids), e.generate(ids)
    assert g.last_timings["graph_captured"] and len(g._graphs) == 1
    assert got["generate_ids"].tolist() == want["generate_ids"].tolist()


def test_tiny_lm_loss_kernels_match_plain(cuda, tmp_path):
    """``EvalModel.lm_loss`` on a tiny bf16 assembly (two images, a prompt
    off the tile): K1 launched once a vision layer, once for the
    resampler and once a Llama layer; against K1's plain version every
    loss term (the CE at each position) within twice the bf16 control's
    largest reading, so the loss too."""
    import numpy as np
    from PIL import Image

    from mllm_npu_tpu_torch.data.processor import ImageProcessor
    from mllm_npu_tpu_torch.evaluate.evaluator import EvalModel
    from mllm_npu_tpu_torch.serve.engine import InferenceEngine
    from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
    from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
    model, lm_cfg, vis_cfg = build_tiny_mllm(TinySpec(dtype=torch.bfloat16),
                                             device=cuda)
    em = EvalModel(InferenceEngine(
        model=model, tokenizer=FakeTokenizer(),
        image_transform=ImageProcessor(height=56, width=56),
        resolution_grids=("1x1", "1x2", "2x1"), num_img_in_tokens=4,
        num_img_out_tokens=4, device=cuda))
    rs = np.random.RandomState(0)
    paths = []
    for i, (w, h) in enumerate(((60, 60), (120, 50))):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
            paths[-1])
    text = ("<img>first<img>\nQuestion: " + " ".join(
        f"w{rs.randint(1000)}" for _ in range(131)) + "\nAnswer: a dog")
    terms, orig = {}, model._lm_loss

    def recording(h, labels):
        logits = model.language_model.logits(h)[:, :-1].float()
        t = labels[:, 1:]
        nll = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), t.clamp(min=0), reduction="none")
        terms[route] = nll[t != -100]
        return orig(h, labels)
    model._lm_loss = recording
    losses = {}
    try:
        for route, fn in (("K1", flash_attention),
                          ("plain", flash_attention_reference),
                          ("control", fa.plain_attention_p_bf16)):
            port_ops.flash_attention = fn
            n = flash_attention.launches
            try:
                losses[route] = em.lm_loss(text, paths)
            finally:
                port_ops.flash_attention = flash_attention
            want = (vis_cfg.num_hidden_layers + 1 + lm_cfg.num_hidden_layers
                    if route == "K1" else 0)
            assert flash_attention.launches - n == want, route
    finally:
        del model._lm_loss
    S = len(em.loss_inputs(text, paths)["input_ids"][0])
    assert S % 64, S                                   # off the tile
    bound = 2 * (terms["control"] - terms["plain"]).abs().max().item()
    got = (terms["K1"] - terms["plain"]).abs().max().item()
    assert 0 < got <= bound, (got, bound)
    assert abs(losses["K1"] - losses["plain"]) <= bound
    assert abs(terms["K1"].mean().item() - losses["K1"]) < 1e-4
