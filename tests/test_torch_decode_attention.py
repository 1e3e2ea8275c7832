"""``ops.decode_attention`` against the JAX package's on the CPU, for the
bf16, fp8 (e4m3) and fp32 caches, one token and verify windows, GQA and
MHA, per-row masks; its CPU path pinned to the exact fp32 widening it had
before the products over the cache as stored came in on the GPU; and that
GPU path's layout (one strided batched product per row) run on the CPU in
fp32 by patching the path's predicate.

Tolerances: the reference takes q·Kᵀ and P·V in the compute dtype with
fp32 accumulation; the port widens exactly and sums in fp32 in another
order, so the logits agree to fp32 rounding, but P is rounded to the
compute dtype on both sides and a probability within that rounding of a
bf16 boundary moves by one bf16 ulp (2^-8 relative) of its share: 2e-3
absolute on outputs of order 1 for the bf16 and fp8 caches, 1e-5 for the
fp32 cache. The CPU path against its earlier form and the patched GPU
layout against the CPU path: exact, and 1e-5 (fp32 sums in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.ops.attention import decode_attention as j_decode
from mllm_npu_tpu_torch.ops import attention as tatt
from mllm_npu_tpu_torch.ops.attention import (DEFAULT_MASK_VALUE,
                                              decode_attention)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16, 2e-3),
          "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn, 2e-3),
          "f32": (torch.float32, jnp.float32, 1e-5)}


def _inputs(B, Sq, Hq, Hkv, D, Sk, W, seed):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    q, k, v = f(B, Sq, Hq, D), f(B, Sk, Hkv, D), f(B, Sk, Hkv, D)
    kc, vc = f(B, W, Hkv, D), f(B, W, Hkv, D)
    lens = rs.randint(1, Sk + 1, size=B)
    mask = (np.arange(Sk)[None] < lens[:, None])[:, None, None, :]
    return q, k, v, kc, vc, mask


def _widened(q, k, v, attn_mask, k_cur, v_cur, scale=None):
    """The CPU path as it stood before the stored-dtype GPU path: every
    operand widened to fp32 exactly before each product."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    comp = torch.bfloat16 if k.element_size() == 1 else k.dtype
    kc, vc = k.to(comp).float(), v.to(comp).float()
    qg = (q.float() * scale).to(comp).float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc)
    am = torch.broadcast_to(attn_mask, (B, 1, 1, Sk)).reshape(B, 1, 1, 1, Sk)
    logits = logits.masked_fill(~am, DEFAULT_MASK_VALUE)
    self_logit = torch.einsum("bqhgd,bshd->bhgqs", qg, k_cur.to(comp).float())
    W = k_cur.shape[1]
    if W > 1 or Sq > 1:
        cm = torch.arange(Sq)[:, None] >= torch.arange(W)[None, :]
        self_logit = self_logit.masked_fill(~cm, DEFAULT_MASK_VALUE)
    logits = torch.cat([logits, self_logit], dim=-1)
    probs = torch.softmax(logits, dim=-1).to(comp).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs[..., :Sk], vc)
    out = out + torch.einsum("bhgqs,bshd->bqhgd", probs[..., Sk:],
                             v_cur.to(comp).float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


SHAPES = [  # B, Sq (= W), Hq, Hkv, D, Sk
    (3, 1, 8, 2, 16, 40),     # one token, GQA
    (2, 1, 4, 4, 32, 33),     # one token, MHA
    (2, 5, 8, 4, 16, 24),     # a verify window of 5
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_attention_matches_reference(dtype, shape):
    B, Sq, Hq, Hkv, D, Sk = shape
    tdt, jdt, atol = DTYPES[dtype]
    q, k, v, kc, vc, mask = _inputs(B, Sq, Hq, Hkv, D, Sk, Sq, seed=Sk)
    # the cache and the window in the cache's dtype on both sides
    k8, v8 = (torch.from_numpy(a).to(tdt) for a in (k, v))
    kc8, vc8 = (torch.from_numpy(a).to(tdt) for a in (kc, vc))
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    ref = j_decode(jnp.asarray(q), as_j(k8), as_j(v8), jnp.asarray(mask),
                   k_cur=as_j(kc8), v_cur=as_j(vc8))
    tq = torch.from_numpy(q)
    got = decode_attention(tq, k8, v8, torch.from_numpy(mask), k_cur=kc8,
                           v_cur=vc8)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=0)
    # the CPU path is the exact widening it was
    torch.testing.assert_close(
        got, _widened(tq, k8, v8, torch.from_numpy(mask), kc8, vc8),
        rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_stored_dtype_path_layout_on_cpu(monkeypatch, shape):
    """The GPU path's arithmetic (per-row batched products over the
    cache's strided view, the query block (g, s) per KV head) in fp32 on
    the CPU: equal to the widened path up to summation order, and no copy
    of the cache made for it."""
    B, Sq, Hq, Hkv, D, Sk = shape
    q, k, v, kc, vc, mask = (torch.from_numpy(a) for a in _inputs(
        B, Sq, Hq, Hkv, D, Sk, Sq, seed=7))
    want = decode_attention(q, k, v, mask, k_cur=kc, v_cur=vc)
    seen = []
    bmm = torch.bmm

    def spy(a, b, **kw):
        seen.append(b)
        return bmm(a, b, **kw)

    monkeypatch.setattr(tatt, "_products_on_stored", lambda t: True)
    monkeypatch.setattr(torch, "bmm", spy)
    got = decode_attention(q, k, v, mask, k_cur=kc, v_cur=vc)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert len(seen) == 2 * B            # q·Kᵀ and P·V, one per row
    caches = {k.untyped_storage().data_ptr(), v.untyped_storage().data_ptr()}
    for b in seen:                        # views of the cache, not copies
        assert b.untyped_storage().data_ptr() in caches
