"""fp32 training in the port against the JAX package, on the CPU.

On CPU tensors the port's flash wrappers run their plain versions, so
these tests hold what the card's fp32 training path computes (K1 f32 with
its LSE, K2 f32, K3 f32 there) against the reference:

- the plain fp32 backward (:class:`FlashAttention` through
  ``multi_head_attention``) against ``jax.vjp`` of the reference's
  ``flash_attention_padded`` with fp32 operands (its Pallas kernels in
  interpret mode, the head dim padded to 128 and the lengths to 128 by the
  reference), at the UNet's D = 64 (self-attention, and over 64 keys) and
  SD-1.5's D = 40, 80 and 160: atol 1e-5 (fp32 sums in other orders, the
  reference's softmax in base 2 on q pre-scaled by scale·log2 e);
- K2 f32's and K3 f32's plans for every head dim from 8 to 256
  (``k23_f32_plan``: the route by padded head dim, wgmma up to 128 and
  mma.sync above, and the shared memory of ``csrc/flash_bwd_f32.cuh``,
  under the card's 227 KB) and their walks (``k2_f32_kv_tiles``,
  ``k3_f32_q_tiles``) at every plan's block and tile rows against the
  dense mask, and run with the plain arithmetic tile by tile against the
  plain backward (1e-5);
- the wgmma route's permuted transposed tiles (``k23_f32_tile_perm``):
  an accumulator fragment of dS, Pᵀ or dSᵀ read as the next product's A
  fragment against the permuted Kᵀ, dOᵀ or Qᵀ gives dS·K, Pᵀ·dO or dSᵀ·Q
  (seeded numpy, float64);
- one AdamW step of the port's ``build_sdxl_adapter(param_dtype=
  torch.float32)`` against the reference's ``build_sdxl_adapter()`` (its
  default, fp32), both tiny under ``DEBUG_FLAG``, the reference's weights
  drawn by numpy at the shapes its factory builds (``jax.eval_shape``; its
  initialisers would compile three modules) and carried over by
  ``utils/weights.py``: the loss within
  1e-5, every trainable gradient within 1e-5 of the reference's, the
  updated trainable weights within 1e-5 and the frozen
  ones unchanged.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.ops import flash_attention_padded as j_padded
from mllm_npu_tpu_torch.ops import multi_head_attention

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

ATOL = 1e-5


def _inputs(B, Sq, Sk, H, D, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Sq, H, D).astype(np.float32)
    k = rs.randn(B, Sk, H, D).astype(np.float32)
    v = rs.randn(B, Sk, H, D).astype(np.float32)
    do = rs.randn(B, Sq, H, D).astype(np.float32)
    return q, k, v, do


# (B, Sq, Sk, H, D): the SDXL UNet's self-attention and cross-attention
# over the resampler's 64 tokens at D = 64; the SD-1.5 IP UNet's D = 40,
# 80 and 160, self and over its 77 text and 16 image keys
BWD_SHAPES = [
    (2, 256, 256, 2, 64), (2, 256, 64, 2, 64),
    (2, 64, 64, 2, 40), (2, 64, 77, 2, 80), (1, 16, 16, 2, 160),
    (2, 64, 16, 2, 160),
]


@pytest.mark.parametrize("B,Sq,Sk,H,D", BWD_SHAPES)
def test_fp32_backward_matches_reference_kernels(B, Sq, Sk, H, D):
    q, k, v, do = _inputs(B, Sq, Sk, H, D, seed=Sq + Sk + D)

    def f(q, k, v):
        return j_padded(q, k, v, interpret=True)

    jo, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    jg = vjp(jnp.asarray(do))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = multi_head_attention(*leaves)
    assert o.dtype == torch.float32
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=ATOL)
    for leaf, ref, name in zip(leaves, jg, "qkv"):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=ATOL, err_msg=f"d{name}")


def _wgmma_bytes(dp, groups, T, k3):
    # the resident pair, split (4 parts of 64·groups rows); the tile's
    # split copies (K2: K, V, Kᵀ; K3: Q, dO, Qᵀ, dOᵀ; two parts each); the
    # raw tile (two tensors, rows padded by 4); two stages of T ids (K3:
    # LSEs, δs and ids)
    return 4 * (4 * 64 * groups * dp + (8 if k3 else 6) * T * dp
                + 2 * T * (dp + fa.K23_F32_PAD) + (3 if k3 else 1) * 2 * T)


@pytest.mark.parametrize("D", range(8, 257, 8))
def test_k23_f32_plan_fits_for_every_head_dim(D):
    plan = fa.k23_f32_plan(D)
    assert plan.dp == fa.padded_head_dim(D) and plan.dp >= D
    assert plan.dp == (-(-D // 16) * 16 if D <= 160 else
                       192 if D <= 192 else 256)
    assert max(plan.k2_smem, plan.k3_smem) <= fa.K1_MAX_SMEM
    if plan.dp > 128:
        assert plan.route == "mma_sync" and plan.k3_warps == 8
        T = plan.k2_tile
        assert T == plan.k3_tile == (fa.K23_F32_WIDE_TILE if plan.dp == 256
                                     else fa.K23_F32_TILE)
        row = 4 * (plan.dp + fa.K23_F32_PAD)
        patch = 4 * 16 * (T + fa.K23_F32_PAD)
        # K2: Q and dO resident, two stages of K and V, 4 patches, 2×T ids
        assert plan.k2_smem == (2 * 64 + 4 * T) * row + 4 * patch + 2 * T * 4
        # K3: K and V resident, two stages of Q and dO, a patch a warp,
        # two stages of T LSEs, δs and query ids
        assert plan.k3_smem == (2 * 64 + 4 * T) * row \
            + plan.k3_warps * patch + 3 * 2 * T * 4
        return
    # the wgmma route: two consumer warpgroups with 32-row tiles where
    # they fit, else one, else 16-row tiles (the UNet's D = 64 takes two
    # in both kernels)
    assert plan.route == "wgmma"
    for k3, rows, T, smem in ((False, plan.k2_rows, plan.k2_tile,
                               plan.k2_smem),
                              (True, plan.k3_rows, plan.k3_tile,
                               plan.k3_smem)):
        groups = rows // 64
        assert rows in (64, 128) and T in (16, 32)
        assert smem == _wgmma_bytes(plan.dp, groups, T, k3)
        wider = ([(2, 32)] if groups == 1 else []) \
            + ([(groups, 32)] if T == 16 else [])
        assert all(_wgmma_bytes(plan.dp, g, t, k3) > fa.K1_MAX_SMEM
                   for g, t in wider)
    assert plan.k3_warps == plan.k3_rows // 16
    if plan.dp <= 64:
        assert plan.k2_rows == plan.k3_rows == 128


@pytest.mark.parametrize("D", [0, 4, 12, 264, 512])
def test_k23_f32_plan_refuses_other_head_dims(D):
    gap = "; fp32 .*gap 2" if D > 256 else ""
    with pytest.raises(ValueError, match="multiples of 8 up to 256" + gap):
        fa.k23_f32_plan(D)


def _dense_mask(Sq, Sk, causal, qs, ks):
    mask = np.ones((Sq, Sk), bool)
    if causal:
        mask &= np.tril(np.ones((Sq, Sk), bool))
    if qs is not None:
        mask &= qs[:, None] == ks[None, :]
    return mask


# (Sq, Sk, causal, segments): lengths off the 64-row blocks and 32-row
# tiles, Sq != Sk both ways, causal, packed segments and a padded tail
WALKS = [(1, 1, True, False), (64, 64, False, False), (65, 63, True, False),
         (63, 200, True, False), (200, 63, True, False),
         (129, 129, False, True), (300, 300, True, True),
         (100, 37, False, False)]


# (K2 rows, K2 tile, K3 rows, K3 tile) of every plan from 8 to 256
BLOCKINGS = sorted({(p.k2_rows, p.k2_tile, p.k3_rows, p.k3_tile)
                    for p in map(fa.k23_f32_plan, range(8, 257, 8))})


@pytest.mark.parametrize("Sq,Sk,causal,segs", WALKS)
def test_k23_f32_walks_cover_the_dense_mask(Sq, Sk, causal, segs):
    """Every visible (query, key) pair lies in a tile each kernel visits,
    at every plan's blocking: K2 f32's key tiles per block of query rows,
    K3 f32's query tiles per block of keys; every tile either skips holds
    no visible pair."""
    rs = np.random.RandomState(Sq + Sk)
    qs = ks = None
    if segs:
        qs = np.repeat(np.arange(1, Sq + 1), rs.randint(5, 41, Sq))[:Sq]
        ks = qs[:Sk].copy()
        qs[Sq - Sq // 5:] = -1
    mask = _dense_mask(Sq, Sk, causal, qs, ks)
    for R2, T2, R3, T3 in BLOCKINGS:
        for q0 in range(0, Sq, R2):
            tiles = fa.k2_f32_kv_tiles(q0, Sq, Sk, causal, T2, R2)
            seen = np.zeros(Sk, bool)
            for j in tiles:
                seen[j * T2:(j + 1) * T2] = True
            assert not mask[q0:q0 + R2][:, ~seen].any()
            assert tiles == sorted(set(tiles))
        for k0 in range(0, Sk, R3):
            tiles = fa.k3_f32_q_tiles(k0, Sq, causal, T3)
            seen = np.zeros(Sq, bool)
            for i in tiles:
                seen[i * T3:(i + 1) * T3] = True
            assert not mask[~seen, k0:k0 + R3].any()
            if causal:  # a skipped tile ends before the block's first key
                assert all(min((i + 1) * T3, Sq) - 1 < k0
                           for i in range(-(-Sq // T3)) if i not in tiles)


@pytest.mark.parametrize("Sq,Sk,causal,segs", WALKS)
def test_k23_f32_walks_with_plain_arithmetic_match_the_plain_backward(
        Sq, Sk, causal, segs):
    """dQ summed tile by tile over K2 f32's walk and dK, dV over K3 f32's
    (each tile masked, in fp32) against the plain backward: the walks lose
    no term."""
    B, Hq, Hkv, D = 1, 4, 2, 24
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(B, Sq, Sk, Hq, D,
                                                        seed=Sq * Sk))
    k, v = k[:, :, :Hkv].contiguous(), v[:, :, :Hkv].contiguous()
    seg = None
    if segs:
        rs = np.random.RandomState(Sq)
        qs = np.repeat(np.arange(1, Sq + 1), rs.randint(5, 41, Sq))[:Sq]
        ks = qs[:Sk].copy()
        seg = fa.SegmentIds(torch.from_numpy(qs)[None],
                            torch.from_numpy(ks)[None])
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention_reference(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(o, do)
    p, ds = fa._dscores(q, k, v, do, lse, delta, causal, seg, D ** -0.5)
    G = Hq // Hkv
    kf = k.reshape(B, Sk, Hkv, 1, D)
    qf = q.reshape(B, Sq, Hkv, G, D)
    dof = do.reshape(B, Sq, Hkv, G, D)
    scale = D ** -0.5
    ref_dq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    ref_dk, ref_dv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                **kw)
    for R2, T2, R3, T3 in BLOCKINGS:
        dq = torch.zeros(B, Hkv, G, Sq, D)
        for q0 in range(0, Sq, R2):
            for j in fa.k2_f32_kv_tiles(q0, Sq, Sk, causal, T2, R2):
                cols = slice(j * T2, (j + 1) * T2)
                dq[..., q0:q0 + R2, :] += torch.einsum(
                    "bhgqk,bkhgd->bhgqd", ds[..., q0:q0 + R2, cols],
                    kf[:, cols].expand(-1, -1, -1, G, -1))
        dk = torch.zeros(B, Hkv, Sk, D)
        dv = torch.zeros(B, Hkv, Sk, D)
        for k0 in range(0, Sk, R3):
            for i in fa.k3_f32_q_tiles(k0, Sq, causal, T3):
                rows, keys = slice(i * T3, (i + 1) * T3), slice(k0, k0 + R3)
                dk[:, :, keys] += torch.einsum(
                    "bhgqk,bqhgd->bhkd", ds[..., rows, keys], qf[:, rows])
                dv[:, :, keys] += torch.einsum(
                    "bhgqk,bqhgd->bhkd", p[..., rows, keys], dof[:, rows])
        got_dq = (dq * scale).permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
        np.testing.assert_allclose(got_dq.numpy(), ref_dq.numpy(),
                                   atol=ATOL)
        np.testing.assert_allclose((dk * scale).transpose(1, 2).numpy(),
                                   ref_dk.numpy(), atol=ATOL)
        np.testing.assert_allclose(dv.transpose(1, 2).numpy(),
                                   ref_dv.numpy(), atol=ATOL)


def _fragment_product(acc, y, perm):
    """acc (64 × T, the accumulator of S, Pᵀ or dSᵀ) times y (T × D) the
    way the wgmma route takes it: each thread's accumulator registers of
    an 8-wide chunk become its TF32 A fragment (c0 → a0, c2 → a1, c1 → a2,
    c3 → a3; a0 at row g, k = t, a1 at row g + 8, a2 at k = t + 4, a3 at
    both), against B = the permuted transpose, slot s holding row perm[s]
    of y. → (the A operand as the tensor cores see it, the product)."""
    M, T = acc.shape
    a = np.full((M, T), np.nan)
    for warp in range(M // 16):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            r = 16 * warp + g
            for kk in range(T // 8):
                c = [acc[r, 8 * kk + 2 * t], acc[r, 8 * kk + 2 * t + 1],
                     acc[r + 8, 8 * kk + 2 * t],
                     acc[r + 8, 8 * kk + 2 * t + 1]]
                frag = (c[0], c[2], c[1], c[3])
                a[r, 8 * kk + t] = frag[0]
                a[r + 8, 8 * kk + t] = frag[1]
                a[r, 8 * kk + t + 4] = frag[2]
                a[r + 8, 8 * kk + t + 4] = frag[3]
    return a, a @ y[perm]


@pytest.mark.parametrize("product", ["dS·K", "Pᵀ·dO", "dSᵀ·Q"])
@pytest.mark.parametrize("T", [16, 32])
def test_k23_f32_tile_perm_feeds_the_a_fragment(product, T):
    """The permuted transposed tile (``k23_f32_tile_perm``, the mirror of
    ``split_cols``) makes the accumulator's registers the A fragment of the
    next product: read that way, dS against the permuted Kᵀ gives dS·K (K2
    f32), Pᵀ against dOᵀ gives Pᵀ·dO and dSᵀ against Qᵀ gives dSᵀ·Q (K3
    f32), every term once."""
    rs = np.random.RandomState(T + len(product))
    acc = rs.randn(64, T)           # 64 rows (queries or keys) × T
    y = rs.randn(T, 64)             # the tile: K, dO or Q rows × D
    perm = fa.k23_f32_tile_perm(T)
    assert sorted(perm) == list(range(T))
    a, got = _fragment_product(acc, y, perm)
    np.testing.assert_array_equal(a, acc[:, perm])
    np.testing.assert_allclose(got, acc @ y, rtol=1e-12, atol=1e-12)


def _adapter_batch(cfg, B=2, L=6, seed=11):
    rs = np.random.RandomState(seed)
    S = cfg.sample_size
    return {
        "noisy_latents": rs.randn(B, S, S, cfg.in_channels).astype(
            np.float32),
        "timesteps": np.array([31.0, 655.0], np.float32)[:B],
        "image_embeds": rs.randn(B, L, 128).astype(np.float32),
        "noise": rs.randn(B, S, S, 4).astype(np.float32),
        "time_ids": np.tile(np.array([[S * 8, S * 8, 0, 0, S * 8, S * 8]],
                                     np.float32), (B, 1)),
    }


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _seeded_init(orig, seed):
    """A stand-in for flax's ``Module.init``: the tree's shapes from
    ``jax.eval_shape`` (no compile), every leaf drawn by numpy from
    ``seed``: kernels normal over √fan-in, norm scales around 1, the rest
    normal × 0.05."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        x = rs.randn(*s.shape)
        if len(s.shape) >= 2:
            x /= np.sqrt(np.prod(s.shape[:-1]))
        else:
            x *= 0.05
        if jax.tree_util.keystr(path).endswith("['scale']"):
            x += 1.0
        return jnp.asarray(x.astype(s.dtype))

    def init(self, rngs, *args, **kw):
        shapes = jax.eval_shape(lambda *a: orig(self, rngs, *a, **kw), *args)
        return jax.tree_util.tree_map_with_path(fill, shapes)
    return init


def test_fp32_adapter_step_matches_reference_factory(monkeypatch):
    """One AdamW step of ``SDXLAdapter.loss_fn`` over
    ``adapter_trainable_patterns()`` on the port's fp32 factory build
    against the reference factory's default build (fp32), each tiny, the
    reference's weights (drawn at the shapes its factory builds) in both."""
    import flax.linen as nn
    import optax

    from mllm_npu_tpu.models.factory import build_sdxl_adapter as j_build
    from mllm_npu_tpu.models.generation import adapter_modules as ja
    from mllm_npu_tpu.train import train_state as jts
    from mllm_npu_tpu_torch.models.factory import build_sdxl_adapter
    from mllm_npu_tpu_torch.models.generation import adapter_modules as ta
    from mllm_npu_tpu_torch.train import train_state as tts
    from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                                  perceiver_from_jax,
                                                  unet_from_jax)
    monkeypatch.setenv("DEBUG_FLAG", "True")
    monkeypatch.setattr(nn.Module, "init", _seeded_init(nn.Module.init, 3))
    jad = j_build()
    monkeypatch.undo()
    monkeypatch.setenv("DEBUG_FLAG", "True")
    ad = build_sdxl_adapter(device="cpu", param_dtype=torch.float32)
    trees = {"unet": jad.unet_params, "resampler": jad.resampler_params}
    for name, tree in trees.items():
        getattr(ad, name).load_state_dict(from_jax_params(
            jax.tree_util.tree_map(np.asarray, tree["params"])), strict=True)
    assert {p.dtype for p in ad.parts.parameters()} == {torch.float32}

    batch = _adapter_batch(jad.unet_module.config)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jad.loss_fn(p, b)[0]))(
        trees, jax.tree_util.tree_map(jnp.asarray, batch))
    opt = dict(lr=1e-5, warmup_steps=0, total_steps=10, max_grad_norm=1.0)
    tx, _ = jts.build_optimizer(jts.OptimizerConfig(
        frozen_patterns=ja.adapter_trainable_patterns(), **opt), trees)
    updates, _ = tx.update(grads, tx.init(trees), trees)
    new = optax.apply_updates(trees, updates)

    def port_names(tree):
        return {**{f"unet.{k}": v for k, v in unet_from_jax(
            tree["unet"]["params"]).items()},
            **{f"resampler.{k}": v for k, v in perceiver_from_jax(
                tree["resampler"]["params"]).items()}}

    tts.apply_frozen_patterns(ad.parts, ta.adapter_trainable_patterns())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb.update(noisy_latents=_nchw(batch["noisy_latents"]),
              noise=_nchw(batch["noise"]))
    before = {n: p.detach().clone() for n, p in ad.parts.named_parameters()}
    trainable = tts.trainable_parameters(ad.parts)
    optimizer = tts.AdamW(trainable, tts.OptimizerConfig(**opt))
    got, _ = ad.loss_fn(tb)
    got.backward()
    assert abs(got.item() - float(loss)) <= ATOL
    want = port_names(grads)
    for name, p in trainable:
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=0, err_msg=name)
    optimizer.step()
    after = port_names(new)
    trained = {n for n, _ in trainable}
    assert any(n.startswith("resampler.") for n in trained)
    assert any(".attn2.to_k." in n for n in trained)
    for name, p in ad.parts.named_parameters():
        if name in trained:
            np.testing.assert_allclose(p.detach().numpy(),
                                       after[name].numpy(), atol=ATOL,
                                       rtol=0, err_msg=name)
            assert not torch.equal(p.detach(), before[name]), name
        else:
            assert torch.equal(p.detach(), before[name]), name
