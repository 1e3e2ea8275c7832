"""Port ops vs the JAX reference on the CPU: K1's plain version against the
Pallas kernel in interpret mode, the eager and decode attention, the
attention dispatch, norms and RoPE. Inputs come from numpy seeds; every
comparison is in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu import ops as jops
from mllm_npu_tpu.ops import flash_attention_padded as j_flash_padded
from mllm_npu_tpu.ops.attention import decode_attention as j_decode
from mllm_npu_tpu.ops.attention import dot_product_attention as j_dpa
from mllm_npu_tpu.ops.flash_attention import SegmentIds as JSeg
from mllm_npu_tpu.ops.flash_attention import flash_attention as j_flash
from mllm_npu_tpu_torch import ops
from mllm_npu_tpu_torch.ops.flash_attention import (SegmentIds,
                                                    flash_attention,
                                                    flash_attention_reference)

ATOL_ATTN = 1e-5      # fp32 attention: summation order only
ATOL_ELEMWISE = 1e-6  # fp32 norms / RoPE


def _qkv(seed, B, Sq, Sk, Hq, Hkv, D):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, Sq, Hq, D).astype(np.float32),
            rs.randn(B, Sk, Hkv, D).astype(np.float32),
            rs.randn(B, Sk, Hkv, D).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_flash_plain_matches_pallas_interpret(causal, hq, hkv):
    q, k, v = _qkv(0, 1, 128, 128, hq, hkv, 128)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, interpret=True, block_q=128, block_k=128)
    out = flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_segments_right_padded_row(causal):
    """A right-padded row as the prefill makes it: the port passes the raw
    mask as segment ids; the padded JAX wrapper shifts them by +1. Real
    positions must agree; padded query rows attend only to padding."""
    B, S = 2, 200
    q, k, v = _qkv(1, B, S, S, 4, 2, 72)
    pm = np.ones((B, S), np.int32)
    pm[1, 150:] = 0
    ref = j_flash_padded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, segment_ids=JSeg(
                             q=jnp.asarray(pm), kv=jnp.asarray(pm)),
                         interpret=True)
    seg = torch.from_numpy(pm)
    out = flash_attention(*_t(q, k, v), causal=causal,
                          segment_ids=SegmentIds(q=seg, kv=seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


@pytest.mark.parametrize("shape", [(2, 200, 200, 4, 4, 72),
                                   (1, 64, 200, 4, 4, 128),
                                   (1, 37, 37, 4, 2, 32)])
def test_flash_plain_awkward_shapes_match_padded(shape):
    B, Sq, Sk, Hq, Hkv, D = shape
    q, k, v = _qkv(2, B, Sq, Sk, Hq, Hkv, D)
    ref = j_flash_padded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=False, interpret=True)
    out = flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


def test_flash_plain_fully_masked_row_is_zero():
    q, k, v = _qkv(3, 1, 128, 128, 2, 2, 128)
    qs = np.ones((1, 128), np.int32)
    ks = np.ones((1, 128), np.int32)
    qs[0, 5] = 7                      # no key has segment 7
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  segment_ids=JSeg(q=jnp.asarray(qs), kv=jnp.asarray(ks)),
                  interpret=True, block_q=128, block_k=128)
    out = flash_attention(*_t(q, k, v), segment_ids=SegmentIds(
        q=torch.from_numpy(qs), kv=torch.from_numpy(ks)))
    assert np.all(out.numpy()[0, 5] == 0)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


def test_flash_plain_explicit_scale():
    q, k, v = _qkv(4, 1, 40, 40, 2, 1, 72)
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=True, scale=0.3)
    out = flash_attention_reference(*_t(q, k, v), causal=True, scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


@pytest.mark.parametrize("mask_kind", ["none", "causal_offset", "2d", "4d_hq",
                                       "4d_one", "5d"])
def test_dot_product_attention_masks(mask_kind):
    B, Sq, Sk, Hq, Hkv, D = 2, 6, 10, 4, 2, 16
    q, k, v = _qkv(5, B, Sq, Sk, Hq, Hkv, D)
    rs = np.random.RandomState(6)
    kw_j, kw_t = {}, {}
    if mask_kind == "causal_offset":
        kw_j = kw_t = dict(causal=True, q_offset=4)
    elif mask_kind != "none":
        shape = {"2d": (B, Sk), "4d_hq": (B, Hq, Sq, Sk),
                 "4d_one": (B, 1, Sq, Sk),
                 "5d": (B, Hkv, Hq // Hkv, Sq, Sk)}[mask_kind]
        m = rs.rand(*shape) > 0.3
        m[..., 0] = True
        kw_j = dict(attn_mask=jnp.asarray(m))
        kw_t = dict(attn_mask=torch.from_numpy(m))
    ref = j_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw_j)
    out = ops.dot_product_attention(*_t(q, k, v), **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 3])
def test_decode_attention_with_current_columns(cache_dtype, window):
    B, Sk, Hq, Hkv, D = 2, 12, 4, 2, 32
    q, k, v = _qkv(7, B, window, Sk, Hq, Hkv, D)
    _, kc, vc = _qkv(8, B, window, window, Hq, Hkv, D)
    valid = np.arange(Sk)[None, :] < np.array([[7], [12]])
    am = valid[:, None, None, :]
    jd = getattr(jnp, cache_dtype)
    td = getattr(torch, cache_dtype)
    ref = j_decode(jnp.asarray(q), jnp.asarray(k, jd), jnp.asarray(v, jd),
                   jnp.asarray(am), k_cur=jnp.asarray(kc),
                   v_cur=jnp.asarray(vc))
    out = ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(td),
        torch.from_numpy(v).to(td), torch.from_numpy(am),
        k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)


@pytest.mark.parametrize("case", ["flash_causal_seg", "flash_noncausal",
                                  "dense_mask", "q_offset"])
def test_multi_head_attention_dispatch_cpu(case, monkeypatch):
    """On the CPU every call computes the reference's function; calls that
    qualify for K1 go through the flash wrapper (its plain version here)
    and leave the launch counter alone."""
    B, S, Hq, Hkv, D = 1, 20, 4, 2, 32
    q, k, v = _qkv(9, B, S, S, Hq, Hkv, D)
    seg = np.ones((B, S), np.int32)
    seg[0, 15:] = 0
    calls = []
    import mllm_npu_tpu_torch.ops as port_ops
    real = port_ops.flash_attention
    monkeypatch.setattr(port_ops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    kw_t, kw_j = {}, {}
    if case == "flash_causal_seg":
        kw_t = dict(causal=True, segment_ids=SegmentIds(
            q=torch.from_numpy(seg), kv=torch.from_numpy(seg)))
        kw_j = dict(causal=True, segment_ids=JSeg(q=jnp.asarray(seg),
                                                  kv=jnp.asarray(seg)))
    elif case == "dense_mask":
        m = np.tril(np.ones((S, S), bool))[None, None]
        kw_t = dict(attn_mask=torch.from_numpy(m))
        kw_j = dict(attn_mask=jnp.asarray(m))
    elif case == "q_offset":
        kw_t = kw_j = dict(causal=True, q_offset=3)
    before = flash_attention.launches
    out = port_ops.multi_head_attention(*_t(q, k, v), **kw_t)
    ref = jops.multi_head_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw_j)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_ATTN)
    assert len(calls) == (1 if case.startswith("flash") else 0)
    assert flash_attention.launches == before


def test_flash_wrapper_rejects_other_devices():
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(dtype):
    rs = np.random.RandomState(10)
    x = rs.randn(3, 5, 64).astype(np.float32)
    w = rs.randn(64).astype(np.float32)
    b = rs.randn(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    # bf16: both round the same fp32 statistics at the same points, so the
    # outputs are bit-identical
    atol = ATOL_ELEMWISE if dtype == "float32" else 0.0
    ref = jops.rms_norm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-5)
    out = ops.rms_norm(torch.from_numpy(x).to(td),
                       torch.from_numpy(w).to(td), 1e-5)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)
    ref = jops.layer_norm(jnp.asarray(x, jd), jnp.asarray(w, jd),
                          jnp.asarray(b, jd), 1e-6)
    out = ops.layer_norm(torch.from_numpy(x).to(td),
                         torch.from_numpy(w).to(td),
                         torch.from_numpy(b).to(td), 1e-6)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("scaling", [(None, 1.0), ("linear", 2.0),
                                     ("dynamic", 2.0)])
def test_rope_matches(scaling):
    kind, factor = scaling
    rs = np.random.RandomState(11)
    B, S, H, D = 2, 48, 2, 32
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1)) + 3
    q = rs.randn(B, S, H, D).astype(np.float32)
    k = rs.randn(B, S, H, D).astype(np.float32)
    kw = dict(theta=500000.0, scaling_type=kind, scaling_factor=factor,
              max_position_embeddings=32)   # dynamic: S > window rescales
    jc, js = jops.rope_cos_sin(jnp.asarray(pos), D, **kw)
    tc, ts = ops.rope_cos_sin(torch.from_numpy(pos), D, **kw)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL_ELEMWISE)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL_ELEMWISE)
    jq, jk = jops.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = ops.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=ATOL_ELEMWISE)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL_ELEMWISE)
