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
  so |err| ≤ 1e-5·Σ_d |o·dO|.
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


def _k1_inputs(dev, B, Sq, Sk, Hq, Hkv, D, seg, layout="bshd", seed=0):
    """q, k, v (``layout`` "fused": q, k and v strided views of one
    [B, S, 3, H, D] tensor) and segment ids: None; an int n, the last row
    right-padded from n (queries and keys of the padding in segments of
    their own, so those rows are fully masked); "packed", segments of 5 to
    40 tokens that change inside tiles and a padded tail."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if layout == "fused":
        qkv = torch.randn(B, Sq, 3, Hq, D, device=dev, generator=g).bfloat16()
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(B, Sq, Hq, D, device=dev, generator=g).bfloat16()
        k = torch.randn(B, Sk, Hkv, D, device=dev, generator=g).bfloat16()
        v = torch.randn(B, Sk, Hkv, D, device=dev, generator=g).bfloat16()
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
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg,layout", K1_CASES)
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
    q = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)                       # fp32
    qb = torch.randn(1, 8, 2, 256, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        flash_attention(qb, qb, qb)                    # D > 160
    flat = torch.randn(2 * 8 * 2 * 64 + 8, device=cuda).bfloat16()
    shifted = flat[1:1 + 2 * 8 * 2 * 64].view(2, 8, 2, 64)
    with pytest.raises(ValueError):
        flash_attention(shifted, shifted, shifted)     # base not 16-byte
    wide = torch.randn(1, 8, 2, 68, device=cuda).bfloat16()[..., :64]
    with pytest.raises(ValueError):
        flash_attention(wide, wide, wide)              # stride 68, not 8k
    assert flash_attention.launches == n


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


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind", BWD_CASES)
def test_k1_lse_matches_plain(cuda, block_q, B, Sq, Sk, Hq, Hkv, D, causal,
                              seg_kind):
    q, k, v, _, seg = _bwd_inputs(cuda, B, Sq, Sk, Hq, Hkv, D, seg_kind)
    kw = dict(causal=causal, segment_ids=seg)
    before = flash_attention.launches
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


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind", BWD_CASES)
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


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg_kind", [
    (8, 600, 600, 32, 8, 128, True, "packed"),   # the Llama training layer
    (56, 64, 729, 32, 32, 128, False, None),     # the resampler's, batch 8
])
def test_k2_k3_repeat_bit_identical(cuda, k23_regime, B, Sq, Sk, Hq, Hkv, D,
                                    causal, seg_kind):
    """No atomics, a fixed order of every sum: two launches give the same
    bits, at the two training shapes, in both regimes."""
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
    wide = torch.zeros(1, 64, 4, 256, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        flash_bwd_dkv(wide, wide[:, :, :2], wide[:, :, :2], wide,
                      lse, delta)                           # D > 128
    d160 = torch.zeros(1, 64, 4, 160, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="item 13b"):
        flash_bwd_dq(d160, d160, d160, d160, lse, delta)    # K1 takes it
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
        tq.int8_matmul(x, *q8)                          # fp32 x
    with pytest.raises(TypeError):
        tq.int4_matmul(x, *q4)
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
                         ladder=ladder, cuda_graph=graphed)


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
