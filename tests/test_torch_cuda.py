"""K1, K4 and K5 on the GPU against their plain versions (skipped without
a CUDA card).

Run on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
``conftest.py`` imports JAX, which that machine need not have).
Tolerances on the same bf16 inputs:
- K1 rounds P (before PV) and O to bf16, so
  |K1 − plain| ≤ 1e-2 + 1e-2·|plain|;
- K4 and K5 round their output to bf16 (2^-9 relative) and sum in fp32 in
  another order, so |kernel − plain| ≤ 1e-2·|plain| + 1e-3·max|plain|.
"""

import pytest
import torch

from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.ops.flash_attention import (SegmentIds,
                                                    flash_attention,
                                                    flash_attention_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,pad", [
    (1, 341, 341, 32, 8, 128, True, None),
    (2, 341, 341, 32, 8, 128, True, 284),
    (5, 729, 729, 16, 16, 72, False, None),
    (5, 64, 729, 32, 32, 128, False, None),
    (1, 77, 77, 4, 2, 32, True, 50),
    (2, 100, 130, 8, 2, 104, False, None),
])
def test_k1_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal, pad):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    q = torch.randn(B, Sq, Hq, D, device=cuda, generator=g).bfloat16()
    k = torch.randn(B, Sk, Hkv, D, device=cuda, generator=g).bfloat16()
    v = torch.randn(B, Sk, Hkv, D, device=cuda, generator=g).bfloat16()
    seg = None
    if pad is not None:
        pm = torch.ones(B, Sq, dtype=torch.int32, device=cuda)
        pm[-1, pad:] = 0
        seg = SegmentIds(q=pm, kv=pm)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q, k, v, causal=causal,
                                    segment_ids=seg).float()
    assert torch.isfinite(out.float()).all()
    assert ((out.float() - ref).abs() <= 1e-2 + 1e-2 * ref.abs()).all()


def test_k1_fully_masked_row_is_zero(cuda):
    q = torch.randn(1, 64, 2, 128, device=cuda).bfloat16()
    qs = torch.ones(1, 64, dtype=torch.int32, device=cuda)
    ks = torch.ones(1, 64, dtype=torch.int32, device=cuda)
    qs[0, 3] = 5
    out = flash_attention(q, q, q, segment_ids=SegmentIds(q=qs, kv=ks))
    assert (out[0, 3] == 0).all() and torch.isfinite(out.float()).all()


def test_k1_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)                       # fp32
    qb = torch.randn(1, 8, 2, 256, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        flash_attention(qb, qb, qb)                    # D > 128


# K4 / K5: decode (M ≤ 16: 1, 5) and prefill (M > 16: 17, 339) regimes,
# ragged N (odd, and the lm_head's 128587), a ragged K tail for int8
# (K % 64 ≠ 0), G = 256 and G = K for int4
QUANT_CASES = [
    (8, 1, 4096, 4096, None), (8, 5, 256, 77, None),
    (8, 339, 512, 1000, None), (8, 17, 208, 130, None),
    (8, 1, 4096, 128587, None), (8, 339, 4096, 14336, None),
    (4, 1, 4096, 4096, 256), (4, 5, 256, 77, 256),
    (4, 339, 512, 1000, 128), (4, 17, 384, 130, 384),
    (4, 1, 4096, 128587, 256), (4, 339, 14336, 4096, 256),
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
