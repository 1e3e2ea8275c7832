"""The flash-attention forward's LSE and the backward (K2, K3) of the port
against the JAX package, on the CPU in fp32.

On CPU tensors the port's wrappers run their plain versions, so these
tests hold the plain forward-with-LSE and :class:`FlashAttention`'s plain
backward against the reference's Pallas kernels in interpret mode
(``_fwd(..., save_lse=True)`` and ``jax.vjp`` of ``flash_attention``), on
the inputs of ``tests/test_flash_attention.py:55-100``: D=128, S=256,
causal or not, segment ids, GQA (4,4), (4,2) and (8,1). Tolerance: atol
1e-5 in fp32 (the two sum in other orders, and the reference runs its
softmax in base 2 on q pre-scaled by scale·log2(e)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.ops.flash_attention import SegmentIds as JSeg
from mllm_npu_tpu.ops.flash_attention import _fwd as j_fwd
from mllm_npu_tpu.ops.flash_attention import flash_attention as j_flash
from mllm_npu_tpu_torch.ops import multi_head_attention
from mllm_npu_tpu_torch.ops.flash_attention import (
    FlashAttention, SegmentIds, flash_attention, flash_attention_bwd_reference,
    flash_attention_reference, flash_bwd_dkv, flash_bwd_dq)

ATOL = 1e-5


def _inputs(B, S, Hq, Hkv, D=128, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, S, Hq, D).astype(np.float32)
    k = rs.randn(B, S, Hkv, D).astype(np.float32)
    v = rs.randn(B, S, Hkv, D).astype(np.float32)
    do = rs.randn(B, S, Hq, D).astype(np.float32)
    return q, k, v, do


def _segments(B, S, padded_tail=True):
    seg = np.zeros((B, S), np.int32)
    seg[:, :100] = 1
    seg[:, 100:200] = 2
    if not padded_tail:
        seg[:, 200:] = 3
    return seg


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("causal,seg", [(False, False), (True, False),
                                        (True, True)])
def test_forward_lse_matches_reference_kernel(causal, seg):
    B, S, Hq, Hkv = 2, 256, 4, 2
    q, k, v, _ = _inputs(B, S, Hq, Hkv)
    sid = _segments(B, S) if seg else None
    jo, jl = j_fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                   None if sid is None else JSeg(jnp.asarray(sid),
                                                 jnp.asarray(sid)),
                   128 ** -0.5, causal, 128, 128, True, save_lse=True)
    ts = None if sid is None else SegmentIds(_t(sid), _t(sid))
    o, lse = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             segment_ids=ts, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0],
                               atol=ATOL)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               atol=ATOL)


def _grads_jax(q, k, v, do, causal, sid):
    ids = None if sid is None else JSeg(jnp.asarray(sid), jnp.asarray(sid))

    def f(q, k, v):
        return j_flash(q, k, v, causal=causal, segment_ids=ids,
                       interpret=True, block_q=128, block_k=128)

    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _grads_port(q, k, v, do, causal, sid, via_dispatch=False):
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    ts = None if sid is None else SegmentIds(_t(sid), _t(sid))
    if via_dispatch:
        o = multi_head_attention(qt, kt, vt, causal=causal, segment_ids=ts)
    else:
        o = FlashAttention.apply(qt, kt, vt, causal, ts, 128 ** -0.5)
    o.backward(_t(do))
    return o.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_flash_gradients_match_reference_kernels(causal, hq, hkv):
    q, k, v, do = _inputs(1, 256, hq, hkv, seed=2)
    jo, jg = _grads_jax(q, k, v, do, causal, None)
    to, tg = _grads_port(q, k, v, do, causal, None)
    np.testing.assert_allclose(to, jo, atol=ATOL)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_flash_gradients_with_segment_ids(hq, hkv):
    """Two packed segments and a padded tail (segment 0), causal, through
    ``multi_head_attention``'s dispatch (q needs a gradient → the
    Function)."""
    q, k, v, do = _inputs(2, 256, hq, hkv, seed=3)
    sid = _segments(2, 256)
    jo, jg = _grads_jax(q, k, v, do, True, sid)
    to, tg = _grads_port(q, k, v, do, True, sid, via_dispatch=True)
    np.testing.assert_allclose(to, jo, atol=ATOL)
    for a, b, name in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [144, 160, 192, 256])
@pytest.mark.parametrize("shape", ["resampler", "causal_segments"])
def test_wide_head_gradients_match_reference(shape, D):
    """Head dims 144 to 256 (SEED-X's input projector attends at 160, the
    reference's bench shape at 256; K2 and K3 take them on the card, at
    192 and 256 in the kernels' widest instantiations): the plain
    backward of :class:`FlashAttention` against ``jax.vjp`` of the
    reference's ``flash_attention_padded`` (the head dim zero-padded to
    256, the Pallas kernels in interpret mode), at the input projector's
    shape (64 queries over 256 keys) and causal with GQA, two packed
    segments and a padded tail."""
    from mllm_npu_tpu.ops import flash_attention_padded as j_padded
    if shape == "resampler":
        B, Sq, Sk, hq, hkv, causal, sid = 2, 64, 256, 4, 4, False, None
    else:
        B, Sq, Sk, hq, hkv, causal = 2, 256, 256, 4, 2, True
        sid = _segments(B, Sq)
    rs = np.random.RandomState(D)
    q = rs.randn(B, Sq, hq, D).astype(np.float32)
    k = rs.randn(B, Sk, hkv, D).astype(np.float32)
    v = rs.randn(B, Sk, hkv, D).astype(np.float32)
    do = rs.randn(B, Sq, hq, D).astype(np.float32)
    ids = None if sid is None else JSeg(jnp.asarray(sid), jnp.asarray(sid))

    def f(q, k, v):
        return j_padded(q, k, v, causal=causal, segment_ids=ids,
                        interpret=True)
    jo, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    ts = None if sid is None else SegmentIds(_t(sid), _t(sid))
    o = FlashAttention.apply(qt, kt, vt, causal, ts, D ** -0.5)
    o.backward(_t(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=ATOL)
    for a, b, name in zip((qt.grad, kt.grad, vt.grad), jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL,
                                   err_msg=f"d{name}")


def test_head_dim_256_matches_unpadded_reference():
    """D = 256, a multiple of 128 that the reference's ``flash_attention``
    takes unpadded: the plain forward with its LSE against ``_fwd(...,
    save_lse=True)`` in interpret mode, and :class:`FlashAttention`'s
    plain gradients against ``jax.vjp`` of ``flash_attention(...,
    interpret=True)``, causal with GQA 4/2 and two packed segments, at
    B1 S128."""
    B, S, Hq, Hkv, D = 1, 128, 4, 2, 256
    q, k, v, do = _inputs(B, S, Hq, Hkv, D=D, seed=7)
    sid = np.ones((B, S), np.int32)
    sid[:, 50:] = 2
    ids = JSeg(jnp.asarray(sid), jnp.asarray(sid))
    jo, jl = j_fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                   ids, D ** -0.5, True, 128, 128, True, save_lse=True)
    ts = SegmentIds(_t(sid), _t(sid))
    o, lse = flash_attention(_t(q), _t(k), _t(v), causal=True,
                             segment_ids=ts, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl)[..., 0],
                               atol=ATOL)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(jo).transpose(0, 2, 1, 3),
                               atol=ATOL)

    def f(q, k, v):
        return j_flash(q, k, v, causal=True, segment_ids=ids,
                       interpret=True, block_q=128, block_k=128)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    FlashAttention.apply(qt, kt, vt, True, ts, D ** -0.5).backward(_t(do))
    for a, b, name in zip((qt.grad, kt.grad, vt.grad), jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", ["causal_gqa", "masked_rows", "ragged_d72"])
def test_plain_backward_matches_autograd(case):
    """``flash_attention_bwd_reference`` (P recomputed from the LSE) against
    autograd through the plain forward, including rows whose keys are all
    masked (their gradients are 0, not NaN)."""
    rs = np.random.RandomState(5)
    B, Sq, Sk, Hq, Hkv, D, causal = 2, 37, 37, 4, 2, 32, True
    if case == "ragged_d72":
        B, Sq, Sk, Hq, Hkv, D, causal = 1, 21, 45, 2, 2, 72, False
    q = _t(rs.randn(B, Sq, Hq, D).astype(np.float32)).requires_grad_()
    k = _t(rs.randn(B, Sk, Hkv, D).astype(np.float32)).requires_grad_()
    v = _t(rs.randn(B, Sk, Hkv, D).astype(np.float32)).requires_grad_()
    do = _t(rs.randn(B, Sq, Hq, D).astype(np.float32))
    seg = None
    if case == "masked_rows":
        qs = np.ones((B, Sq), np.int32)
        ks = np.ones((B, Sk), np.int32)
        qs[0, [3, 10]] = 7          # no key carries segment 7
        ks[1, 20:] = 2
        seg = SegmentIds(_t(qs), _t(ks))
    kw = dict(causal=causal, segment_ids=seg)
    o = flash_attention_reference(q, k, v, **kw)
    o.backward(do)
    with torch.no_grad():
        o2, lse = flash_attention_reference(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd_reference(q, k, v, o2, lse, do, **kw)
    for a, b, name in zip(got, (q.grad, k.grad, v.grad), "qkv"):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL,
                                   err_msg=f"d{name}")
    if case == "masked_rows":
        assert float(lse[0, :, 3].abs().max()) == 0.0
        assert float(got[0][0, [3, 10]].abs().max()) == 0.0


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the K2/K3 wrappers run their plain versions and
    count nothing: only a kernel launch counts."""
    q, k, v, do = (_t(x) for x in _inputs(1, 64, 4, 2, D=32))
    o, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    before = (flash_attention.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    delta = (o * do).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=True)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=True)
    assert dq.shape == q.shape and dk.shape == k.shape == dv.shape
    assert (flash_attention.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == before


def test_no_grad_calls_keep_the_forward_only_route(monkeypatch):
    """Under ``no_grad`` (serving, the frozen tower) the dispatch calls K1
    without the LSE; with a gradient wanted it calls the Function."""
    import mllm_npu_tpu_torch.ops as port_ops
    calls = []
    monkeypatch.setattr(port_ops, "flash_attention",
                        lambda *a, **k: calls.append("fwd") or a[0])
    monkeypatch.setattr(port_ops, "flash_attention_trainable",
                        lambda *a, **k: calls.append("grad") or a[0])
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        multi_head_attention(q, q, q)
    multi_head_attention(q, q, q)
    multi_head_attention(q.detach(), q.detach(), q.detach())
    assert calls == ["fwd", "grad", "fwd"]
