"""fp32 attention at head dims above 160 in the port against the JAX
package, on the CPU.

On CPU tensors the port's flash wrappers run their plain versions, so
these tests hold what the card's fp32 path computes at D in (160, 256]
(K1 f32 with its LSE, K2 f32 and K3 f32 at a padded 192 or 256 there)
against the reference:

- the fp32 forward and backward through the port's
  ``multi_head_attention`` (:class:`FlashAttention`) against ``jax.vjp``
  of the reference's ``flash_attention_padded`` (its Pallas kernels in
  interpret mode, D padded to 256 and the lengths to 128 by the
  reference) at D = 168, 192, 200 and 256, non-causal and causal, with
  GQA and Sq != Sk: atol 1e-5 (fp32 sums in other orders, the reference's
  softmax in base 2 on q pre-scaled by scale·log2 e);
- K1 f32's plan (``k1_f32_plan``) and K2 f32's and K3 f32's
  (``k23_f32_plan``) at every head dim from 8 to 256, against the shared
  memory of ``csrc/flash_fwd_f32.cu`` and ``csrc/flash_bwd_f32.cu`` and
  under the card's 227 KB;
- the walks at a padded 256's 16-row tiles (``k2_f32_kv_tiles``,
  ``k3_f32_q_tiles``) against the dense mask, and run with the plain
  arithmetic tile by tile against the plain backward (1e-5);
- the port's ``AttentionResampler`` built in fp32 with heads of 256
  (embed_dim 512, two heads), forward and backward, against the JAX
  resampler with the same weights (``utils/weights.py``): the output and
  the input's gradient within 1e-5, every parameter's gradient within
  1e-5·max(1, its largest value) (the query's, summed through its
  LayerNorm over 512 columns, reaches 28, where fp32's own spacing is
  2e-6).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.multimodal_projector.attention_resampler import (
    AttentionResampler as JResampler)
from mllm_npu_tpu.ops import flash_attention_padded as j_padded
from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
    import AttentionResampler
from mllm_npu_tpu_torch.ops import multi_head_attention
from mllm_npu_tpu_torch.utils.weights import resampler_from_jax

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

ATOL = 1e-5
WIDE_DIMS = (168, 192, 200, 256)


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, Hq, D).astype(np.float32)
    k = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    v = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    do = rs.randn(B, Sq, Hq, D).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", WIDE_DIMS)
def test_fp32_wide_head_matches_reference_kernels(D, causal):
    """GQA 4/2 with Sq != Sk (more keys than queries when causal, as a
    prefill over a cache, fewer otherwise)."""
    B, Hq, Hkv = 1, 4, 2
    Sq, Sk = (40, 56) if causal else (56, 40)
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=D + causal)

    def f(q, k, v):
        return j_padded(q, k, v, causal=causal, interpret=True)

    jo, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = multi_head_attention(*leaves, causal=causal)
    assert o.dtype == torch.float32 and o.shape == (B, Sq, Hq, D)
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=ATOL)
    for leaf, ref, name in zip(leaves, jg, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("D", range(8, 257, 8))
def test_k1_f32_plan_fits_for_every_head_dim(D):
    """K1 f32: Q (64 rows) resident, two stages of K (32 rows, + 4 floats)
    and V (+ 8), a 16 × 36 patch of P for each of four warps, two stages
    of 32 key ids, at the padded head dim."""
    plan = fa.k1_f32_plan(D)
    assert plan.dp == fa.padded_head_dim(D) >= D
    assert plan.dp == (-(-D // 16) * 16 if D <= 160 else
                       192 if D <= 192 else 256)
    assert plan.warps == 4
    assert plan.smem == 4 * ((64 + 2 * 32) * (plan.dp + 4)
                             + 2 * 32 * (plan.dp + 8)
                             + 4 * 16 * 36 + 2 * 32)
    assert plan.smem <= fa.K1_MAX_SMEM


@pytest.mark.parametrize("D", range(8, 257, 8))
def test_k23_f32_plan_covers_every_head_dim_to_256(D):
    """K2 f32 / K3 f32 on mma.sync above a padded 128 (the wgmma route
    below, ``test_k23_f32_plan_fits_for_every_head_dim``): 32-row streamed
    tiles up to a padded 192, 16-row ones at 256 (32 would need 275,712 /
    285,440 bytes there), K3 split into eight warps, each block under 227
    KB."""
    plan = fa.k23_f32_plan(D)
    assert plan.dp == fa.padded_head_dim(D) == fa.k1_f32_plan(D).dp
    if plan.dp <= 128:
        assert plan.route == "wgmma"
        return
    assert plan.route == "mma_sync"
    assert plan.k2_tile == plan.k3_tile == (16 if plan.dp == 256 else 32)
    assert plan.k2_rows == plan.k3_rows == 64 and plan.k3_warps == 8
    T, row = plan.k2_tile, 4 * (plan.dp + 4)
    patch = 4 * 16 * (T + 4)
    assert plan.k2_smem == (2 * 64 + 4 * T) * row + 4 * patch + 2 * T * 4
    assert plan.k3_smem == (2 * 64 + 4 * T) * row \
        + plan.k3_warps * patch + 3 * 2 * T * 4
    assert max(plan.k2_smem, plan.k3_smem) <= fa.K1_MAX_SMEM
    if plan.dp == 256:      # the 32-row tiles would not fit
        assert (2 * 64 + 4 * 32) * row + 8 * 4 * 16 * 36 > fa.K1_MAX_SMEM


@pytest.mark.parametrize("D", [264, 384, 512])
def test_f32_plans_refuse_head_dims_above_256(D):
    """The reference takes any multiple of 128; above 256 the fp32 kernels
    raise, naming ROADMAP.md's gap 2."""
    for plan in (fa.k1_f32_plan, fa.k23_f32_plan):
        with pytest.raises(ValueError, match="up to 256; fp32 .*gap 2"):
            plan(D)


def _dense_mask(Sq, Sk, causal, qs, ks):
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= np.tril(np.ones((Sq, Sk), bool))
    if qs is not None:
        mask &= qs[:, None] == ks[None, :]
    return mask


def _segments(Sq, Sk, seed):
    rs = np.random.RandomState(seed)
    qs = np.repeat(np.arange(1, Sq + 1), rs.randint(5, 41, Sq))[:Sq]
    return qs, qs[:Sk].copy()


# (Sq, Sk, causal, segments): lengths off the 64-row blocks and 16-row
# tiles, Sq != Sk both ways, causal, packed segments and a padded tail
WIDE_WALKS = [(1, 1, True, False), (17, 15, True, False),
              (65, 63, True, False), (63, 200, True, False),
              (200, 63, True, False), (129, 129, False, True),
              (300, 300, True, True), (100, 37, False, False)]


@pytest.mark.parametrize("Sq,Sk,causal,segs", WIDE_WALKS)
def test_k23_f32_wide_walks_cover_the_dense_mask(Sq, Sk, causal, segs):
    """At a padded 256: every visible (query, key) pair lies in a 16-key
    tile K2 f32 visits for its 64-row block and in a 16-row query tile K3
    f32 visits for its 64-key block; a tile K3 skips ends before the
    block's first key."""
    T, Bk = fa.k23_f32_plan(256).k2_tile, fa.K23_F32_BLOCK
    qs = ks = None
    if segs:
        qs, ks = _segments(Sq, Sk, Sq + Sk)
        qs[Sq - Sq // 5:] = -1
    mask = _dense_mask(Sq, Sk, causal, qs, ks)
    for q0 in range(0, Sq, Bk):
        tiles = fa.k2_f32_kv_tiles(q0, Sq, Sk, causal, T)
        seen = np.zeros(Sk, bool)
        for j in tiles:
            seen[j * T:(j + 1) * T] = True
        assert not mask[q0:q0 + Bk][:, ~seen].any()
        assert tiles == sorted(set(tiles))
    for k0 in range(0, Sk, Bk):
        tiles = fa.k3_f32_q_tiles(k0, Sq, causal, T)
        seen = np.zeros(Sq, bool)
        for i in tiles:
            seen[i * T:(i + 1) * T] = True
        assert not mask[~seen, k0:k0 + Bk].any()
        if causal:
            assert all(min((i + 1) * T, Sq) - 1 < k0
                       for i in range(-(-Sq // T)) if i not in tiles)


@pytest.mark.parametrize("Sq,Sk,causal,segs", WIDE_WALKS)
def test_k23_f32_wide_walks_with_plain_arithmetic_match_the_plain_backward(
        Sq, Sk, causal, segs):
    """dQ summed over K2 f32's 16-key tiles and dK, dV over K3 f32's
    16-row query tiles (each tile masked, in fp32) at D = 200 (a padded
    256) against the plain backward: the walks lose no term."""
    B, Hq, Hkv, D = 1, 4, 2, 200
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(
        B, Sq, Sk, Hq, Hkv, D, seed=Sq * Sk))
    seg = None
    if segs:
        qs, ks = _segments(Sq, Sk, Sq)
        seg = fa.SegmentIds(torch.from_numpy(qs)[None],
                            torch.from_numpy(ks)[None])
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention_reference(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(o, do)
    p, ds = fa._dscores(q, k, v, do, lse, delta, causal, seg, D ** -0.5)
    T, Bk, G = fa.k23_f32_plan(D).k2_tile, fa.K23_F32_BLOCK, Hq // Hkv
    kf = k.reshape(B, Sk, Hkv, 1, D)
    dq = torch.zeros(B, Hkv, G, Sq, D)
    for q0 in range(0, Sq, Bk):
        for j in fa.k2_f32_kv_tiles(q0, Sq, Sk, causal, T):
            cols = slice(j * T, (j + 1) * T)
            dq[..., q0:q0 + Bk, :] += torch.einsum(
                "bhgqk,bkhgd->bhgqd", ds[..., q0:q0 + Bk, cols],
                kf[:, cols].expand(-1, -1, -1, G, -1))
    dk = torch.zeros(B, Hkv, Sk, D)
    dv = torch.zeros(B, Hkv, Sk, D)
    qf = q.reshape(B, Sq, Hkv, G, D)
    dof = do.reshape(B, Sq, Hkv, G, D)
    for k0 in range(0, Sk, Bk):
        for i in fa.k3_f32_q_tiles(k0, Sq, causal, T):
            rows, keys = slice(i * T, (i + 1) * T), slice(k0, k0 + Bk)
            dk[:, :, keys] += torch.einsum("bhgqk,bqhgd->bhkd",
                                           ds[..., rows, keys], qf[:, rows])
            dv[:, :, keys] += torch.einsum("bhgqk,bqhgd->bhkd",
                                           p[..., rows, keys], dof[:, rows])
    scale = D ** -0.5
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                **kw)
    got_dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    np.testing.assert_allclose(got_dq.numpy(), ref_dq.numpy(), atol=ATOL)
    np.testing.assert_allclose((dk * scale).transpose(1, 2).numpy(),
                               ref_dk.numpy(), atol=ATOL)
    np.testing.assert_allclose(dv.transpose(1, 2).numpy(), ref_dv.numpy(),
                               atol=ATOL)


def test_fp32_resampler_at_head_dim_256_matches_jax():
    """The port's ``AttentionResampler`` in fp32 with 256-wide heads (its
    attention through ``FlashAttention``) against the JAX resampler with
    the same weights: the output and the input's gradient within 1e-5,
    every parameter's gradient within 1e-5 of max(1, its largest
    value)."""
    E, H, kv_dim, B, L = 512, 2, 48, 2, 9
    rs = np.random.RandomState(20)
    x = rs.randn(B, L, kv_dim).astype(np.float32)
    g = rs.randn(B, 4, E).astype(np.float32)
    jm = JResampler(grid_size=2, embed_dim=E, num_heads=H, kv_dim=kv_dim)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))

    def loss(p, x):
        return jnp.sum(jm.apply(p, x) * jnp.asarray(g))

    ref = jm.apply(params, jnp.asarray(x))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = AttentionResampler(grid_size=2, embed_dim=E, num_heads=H,
                            kv_dim=kv_dim, dtype=torch.float32)
    tm.load_state_dict(resampler_from_jax(jax.tree_util.tree_map(
        np.asarray, params["params"])), strict=True)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert E // H == 256
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=ATOL)
    want = resampler_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jgp["params"]))
    for name, p in tm.named_parameters():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(ref).max()),
                                   err_msg=name)
