"""K1 on the GPU against its plain version (skipped without a CUDA card).

Run on the GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (the suite's
``conftest.py`` imports JAX, which that machine need not have).
Tolerance: the kernel rounds P (before PV) and O to bf16, so
|K1 − plain| ≤ 1e-2 + 1e-2·|plain| on the same bf16 inputs.
"""

import pytest
import torch

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
