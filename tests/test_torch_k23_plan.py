"""The Python side of K2's and K3's Hopper design (``ops/flash_attention.py``):
the regime a call gets (``k23_regime``), and the mirror of the kernels'
tile walks (K2's K/V tiles per query tile, K3's query tiles
per key tile, with the causal bounds, the segment-range skip and the
"needs a mask" rule), held against the dense mask of the plain version on
seeded shapes, then run with the plain arithmetic against the plain
backward and the JAX package's interpret-mode kernels. Runs on the CPU.

Tolerance of the arithmetic walks: 1e-4 absolute in fp32 (the walk sums
tile by tile in base 2, the plain versions and the JAX kernels in other
orders; a wrong skip or a missing mask is an O(1) error).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.ops.flash_attention import SegmentIds as JSeg
from mllm_npu_tpu.ops.flash_attention import flash_attention as j_flash

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

TILE, WARP = fa.K23_TILE, fa.K23_WARP_ROWS
LOG2E = 1.4426950408889634
ATOL = 1e-4


@pytest.mark.parametrize("D", range(8, 129, 8))
def test_k23_regime_by_head_dim(D):
    """The Hopper regime takes every head dim from 32 (the training shapes'
    128 and 72 among them) with K1's swizzle split; below 32 the mma.sync
    one."""
    assert fa.k23_regime(D) == ("wgmma" if D >= 32 else "mma_sync")
    hi, lo = fa.k1_head_split(D)
    assert hi + lo == -(-D // 16) * 16 and lo in (0, 16, 32, 48)


def test_training_shapes_take_the_hopper_regime():
    # the Llama layer and the resampler (D = 128), SigLIP (D = 72)
    for D in (128, 72):
        assert fa.k23_regime(D) == "wgmma"


def _segments(kind, B, Sq, Sk, rs):
    """int32 q and kv ids [B, S] or None: "packed" (two segments a row and
    the last row's tail padded with 0, the Llama training layout),
    "runs" (seeded run lengths, ids out of order such as 2 2 1 1 3, a
    padded tail), "masked_rows" (rows whose keys are all masked)."""
    if kind is None:
        return None
    if kind == "packed":
        q = np.ones((B, Sq), np.int32)
        q[:, Sq // 2:] = 2
        q[-1, Sq - Sq // 6:] = 0
        kv = q.copy() if Sq == Sk else np.ones((B, Sk), np.int32)
    elif kind == "runs":
        q = np.zeros((B, Sq), np.int32)
        for b in range(B):
            pos = 0
            while pos < Sq:
                n = int(rs.randint(10, 90))
                q[b, pos:pos + n] = rs.randint(1, 4)
                pos += n
        q[-1, Sq - Sq // 7:] = 0
        kv = q[:, :Sk].copy() if Sk <= Sq else np.concatenate(
            [q, np.zeros((B, Sk - Sq), np.int32)], 1)
    elif kind == "masked_rows":
        q = np.ones((B, Sq), np.int32)
        kv = np.ones((B, Sk), np.int32)
        q[0, rs.choice(Sq, size=min(3, Sq), replace=False)] = 9
    else:
        raise ValueError(kind)
    return fa.SegmentIds(q=torch.from_numpy(q), kv=torch.from_numpy(kv))


WALK_CASES = [
    # B, Sq, Sk, Hq, Hkv, causal, segments
    (8, 600, 600, 32, 8, True, "packed"),     # the Llama training layer
    (56, 64, 729, 32, 32, False, None),       # the resampler's, batch 8
    (2, 300, 300, 8, 1, True, "runs"),        # ids 2 2 1 1 3 ..., GQA 8/1
    (2, 130, 100, 32, 8, True, "runs"),       # Sq != Sk, ragged tails
    (2, 100, 130, 8, 2, False, "packed"),
    (1, 65, 63, 4, 2, True, None),
    (2, 129, 729, 8, 2, True, None),          # causal, Sq < Sk
    (1, 729, 129, 8, 1, True, None),          # causal, Sq > Sk
    (2, 70, 70, 8, 1, True, "masked_rows"),   # fully masked rows
    (1, 1, 1, 4, 1, True, None),
]


def _dense_mask(B, Sq, Sk, causal, seg):
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(B, Sq, 1, 8).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, Sk, 1, 8).astype(np.float32))
    _, mask = fa._masked_logits(q, k, causal, seg, 1.0)
    return mask.reshape(-1, Sq, Sk).expand(B, Sq, Sk)


def _ids(seg, b):
    return {} if seg is None else dict(q_ids=seg.q[b], kv_ids=seg.kv[b])


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,kind", WALK_CASES)
def test_k2_walk_covers_the_dense_mask(B, Sq, Sk, Hq, Hkv, causal, kind):
    """K2: every visible pair of a work tile's rows lies in a K/V tile it
    visits, once; every tile it skips is fully masked for those rows;
    every tile a warp takes unmasked is fully visible to the warp's rows;
    the segment skip fires at the Llama layout."""
    seg = _segments(kind, B, Sq, Sk, np.random.RandomState(Sq + Sk))
    mask = _dense_mask(B, Sq, Sk, causal, seg)
    seg_skips = unmasked = 0
    for b in range(B):
        for q0 in range(0, Sq, TILE):
            rows = slice(q0, min(q0 + TILE, Sq))
            tiles = fa.k2_kv_tiles(q0, Sq, Sk, causal, **_ids(seg, b))
            bounded = fa.k2_kv_tiles(q0, Sq, Sk, causal)
            assert tiles and tiles == sorted(set(tiles))
            assert set(tiles) <= set(bounded)
            seg_skips += len(bounded) - len(tiles)
            seen = torch.zeros(Sk, dtype=torch.bool)
            for j in tiles:
                seen[j * TILE:(j + 1) * TILE] = True
            assert not mask[b, rows][:, ~seen].any()
            for j in tiles:
                k0 = j * TILE
                keys = slice(k0, min(k0 + TILE, Sk))
                for r0 in range(q0, min(q0 + TILE, Sq), WARP):
                    wrows = slice(r0, min(r0 + WARP, Sq))
                    ids = {} if seg is None else dict(
                        q_ids=seg.q[b, wrows], kv_ids=seg.kv[b, keys])
                    if not fa.k1_needs_mask(r0, k0, TILE, Sk, causal, **ids):
                        unmasked += 1
                        assert mask[b, wrows, keys].all(), (b, r0, k0)
    if kind == "packed" and Sq == 600:
        assert seg_skips > 0        # the segment skip fires
    if Sq >= 300 and kind != "runs":
        assert unmasked > 0         # the rule is not "mask every tile"


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,kind", WALK_CASES)
def test_k3_walk_covers_the_dense_mask(B, Sq, Sk, Hq, Hkv, causal, kind):
    """K3: every visible pair of a work tile's keys lies in a query tile it
    visits (each once per query head of the group), every skipped query
    tile is fully masked for those keys, every tile a warp takes unmasked
    is fully visible to the warp's keys; the segment skip fires at the
    Llama layout."""
    seg = _segments(kind, B, Sq, Sk, np.random.RandomState(Sq + Sk))
    mask = _dense_mask(B, Sq, Sk, causal, seg)
    seg_skips = unmasked = 0
    for b in range(B):
        for k0 in range(0, Sk, TILE):
            keys = slice(k0, min(k0 + TILE, Sk))
            tiles = fa.k3_q_tiles(k0, Sq, Sk, causal, **_ids(seg, b))
            bounded = fa.k3_q_tiles(k0, Sq, Sk, causal)
            assert tiles and tiles == sorted(set(tiles))
            assert set(tiles) <= set(bounded)
            seg_skips += len(bounded) - len(tiles)
            seen = torch.zeros(Sq, dtype=torch.bool)
            for i in tiles:
                seen[i * TILE:(i + 1) * TILE] = True
            assert not mask[b, ~seen][:, keys].any()
            for i in tiles:
                q0 = i * TILE
                rows = slice(q0, min(q0 + TILE, Sq))
                for kw in range(k0, min(k0 + TILE, Sk), WARP):
                    wkeys = slice(kw, min(kw + WARP, Sk))
                    ids = {} if seg is None else dict(
                        kv_ids=seg.kv[b, wkeys], q_ids=seg.q[b, rows])
                    if not fa.k3_needs_mask(kw, q0, Sq, causal, **ids):
                        unmasked += 1
                        assert mask[b, rows, wkeys].all(), (b, kw, q0)
    if kind == "packed" and Sq == 600:
        assert seg_skips > 0
    if Sq >= 300 and kind != "runs":
        assert unmasked > 0


def test_needs_mask_rules():
    one16 = torch.ones(16, dtype=torch.int32)
    one64 = torch.ones(64, dtype=torch.int32)
    # K3: a full query tile after the warp's keys, one segment: no mask
    assert not fa.k3_needs_mask(64, 128, 339, True, kv_ids=one16,
                                q_ids=one64)
    assert not fa.k3_needs_mask(64, 48, 339, False)
    # the ragged last query tile, the diagonal, a second segment
    assert fa.k3_needs_mask(0, 320, 339, False)
    assert fa.k3_needs_mask(64, 64, 339, True)
    assert fa.k3_needs_mask(64, 72, 339, True)       # key 79 > row 72
    two = one64.clone()
    two[10:] = 2
    assert fa.k3_needs_mask(64, 128, 339, True, kv_ids=one16, q_ids=two)
    # K3's segment skip: disjoint ranges skip, overlapping ones do not,
    # whatever the order of the ids
    q_ids = torch.tensor([2] * 64 + [1] * 64 + [3] * 64, dtype=torch.int32)
    kv_ids = torch.tensor([3] * 64 + [1] * 128, dtype=torch.int32)
    assert fa.k3_q_tiles(0, 192, 192, False, q_ids, kv_ids) == [2]
    assert fa.k3_q_tiles(64, 192, 192, False, q_ids, kv_ids) == [1]
    assert fa.k3_q_tiles(128, 192, 192, False, q_ids, kv_ids) == [1]
    assert fa.k2_kv_tiles(0, 192, 192, False, q_ids, kv_ids) == [2]
    assert fa.k2_kv_tiles(64, 192, 192, False, q_ids, kv_ids) == [1, 2]
    assert fa.k2_kv_tiles(128, 192, 192, False, q_ids, kv_ids) == [0]
    # nothing kept: the last tile, which the mask zeroes
    assert fa.k2_kv_tiles(0, 64, 192, False, q_ids[:64] * 0 + 7,
                          kv_ids) == [2]
    assert fa.k3_q_tiles(128, 64, 192, True) == [0]       # keys past rows


# ---- the walks with the plain arithmetic ---------------------------------

def _rows(x, idx):
    """x[:, idx] with rows past the end as zeros (TMA's fill)."""
    out = torch.zeros((x.shape[0], len(idx)) + tuple(x.shape[2:]),
                      dtype=x.dtype)
    ok = idx < x.shape[1]
    out[:, ok] = x[:, idx[ok]]
    return out


def _vec(x, idx):
    out = torch.zeros(len(idx), dtype=x.dtype)
    ok = idx < x.shape[0]
    out[ok] = x[idx[ok]]
    return out


def walk_dq(q, k, v, do, lse, delta, causal, seg, scale):
    """dQ computed in K2's order: work tiles of 64 rows, the K/V tiles
    ``k2_kv_tiles`` keeps, each warp's 16 rows masked only where
    ``k1_needs_mask`` says, P in base 2 from the LSE."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, c = Hq // Hkv, scale * LOG2E
    dq = torch.zeros(B, Sq, Hq, D)
    for b in range(B):
        qids = None if seg is None else seg.q[b]
        kids = None if seg is None else seg.kv[b]
        for h in range(Hq):
            hk = h // G
            for q0 in range(0, Sq, TILE):
                tiles = fa.k2_kv_tiles(q0, Sq, Sk, causal, qids, kids)
                for r0 in range(q0, min(q0 + TILE, Sq), WARP):
                    r = torch.arange(r0, r0 + WARP)
                    qw, dow = _rows(q[b:b + 1, :, h], r)[0], \
                        _rows(do[b:b + 1, :, h], r)[0]
                    l2 = _vec(lse[b, h], r) * LOG2E
                    dl = _vec(delta[b, h], r)
                    acc = torch.zeros(WARP, D)
                    for j in tiles:
                        kk = torch.arange(j * TILE, (j + 1) * TILE)
                        kt = _rows(k[b:b + 1, :, hk], kk)[0]
                        vt = _rows(v[b:b + 1, :, hk], kk)[0]
                        p = torch.exp2(qw @ kt.T * c - l2[:, None])
                        ids = {} if seg is None else dict(
                            q_ids=qids[r0:min(r0 + WARP, Sq)],
                            kv_ids=kids[j * TILE:min((j + 1) * TILE, Sk)])
                        if fa.k1_needs_mask(r0, j * TILE, TILE, Sk, causal,
                                            **ids):
                            vis = (kk < Sk)[None].expand(WARP, TILE).clone()
                            if causal:
                                vis &= kk[None] <= r[:, None]
                            if seg is not None:
                                vis &= _vec(qids, r)[:, None] == \
                                    _vec(kids, kk)[None]
                            p = torch.where(vis, p, torch.zeros(()))
                        ds = p * (dow @ vt.T - dl[:, None])
                        acc += ds @ kt
                    n = min(WARP, Sq - r0)
                    dq[b, r0:r0 + n, h] = acc[:n] * scale
    return dq


def walk_dkv(q, k, v, do, lse, delta, causal, seg, scale):
    """dK and dV computed in K3's order: work tiles of 64 keys, the query
    tiles ``k3_q_tiles`` keeps, each for every head of the group, each
    warp's 16 keys masked only where ``k3_needs_mask`` says."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G, c = Hq // Hkv, scale * LOG2E
    dk, dv = torch.zeros(B, Sk, Hkv, D), torch.zeros(B, Sk, Hkv, D)
    for b in range(B):
        qids = None if seg is None else seg.q[b]
        kids = None if seg is None else seg.kv[b]
        for hk in range(Hkv):
            for k0 in range(0, Sk, TILE):
                tiles = fa.k3_q_tiles(k0, Sq, Sk, causal, qids, kids)
                for kw in range(k0, min(k0 + TILE, Sk), WARP):
                    kr = torch.arange(kw, kw + WARP)
                    kt = _rows(k[b:b + 1, :, hk], kr)[0]
                    vt = _rows(v[b:b + 1, :, hk], kr)[0]
                    acc_k, acc_v = torch.zeros(WARP, D), torch.zeros(WARP, D)
                    for i in tiles:
                        r = torch.arange(i * TILE, (i + 1) * TILE)
                        ids = {} if seg is None else dict(
                            kv_ids=kids[kw:min(kw + WARP, Sk)],
                            q_ids=qids[i * TILE:min((i + 1) * TILE, Sq)])
                        need = fa.k3_needs_mask(kw, i * TILE, Sq, causal,
                                                **ids)
                        for g in range(G):
                            h = hk * G + g
                            qt = _rows(q[b:b + 1, :, h], r)[0]
                            dot = _rows(do[b:b + 1, :, h], r)[0]
                            l2 = _vec(lse[b, h], r) * LOG2E
                            dl = _vec(delta[b, h], r)
                            p = torch.exp2(kt @ qt.T * c - l2[None])
                            if need:
                                vis = (r < Sq)[None].expand(WARP,
                                                            TILE).clone()
                                if causal:
                                    vis &= kr[:, None] <= r[None]
                                if seg is not None:
                                    vis &= _vec(kids, kr)[:, None] == \
                                        _vec(qids, r)[None]
                                p = torch.where(vis, p, torch.zeros(()))
                            ds = p * (vt @ dot.T - dl[None])
                            acc_v += p @ dot
                            acc_k += ds @ qt
                    n = min(WARP, Sk - kw)
                    dk[b, kw:kw + n, hk] = acc_k[:n] * scale
                    dv[b, kw:kw + n, hk] = acc_v[:n]
    return dk, dv


def _inputs(B, Sq, Sk, Hq, Hkv, D, seed):
    rs = np.random.RandomState(seed)
    q = torch.from_numpy(rs.randn(B, Sq, Hq, D).astype(np.float32))
    k = torch.from_numpy(rs.randn(B, Sk, Hkv, D).astype(np.float32))
    v = torch.from_numpy(rs.randn(B, Sk, Hkv, D).astype(np.float32))
    do = torch.from_numpy(rs.randn(B, Sq, Hq, D).astype(np.float32))
    return q, k, v, do


ARITH_CASES = [
    # B, Sq, Sk, Hq, Hkv, D, causal, segments
    (2, 150, 150, 4, 2, 32, True, "packed"),
    (1, 200, 200, 2, 1, 72, True, "runs"),
    (1, 100, 130, 2, 2, 104, False, "runs"),
    (2, 130, 90, 4, 1, 32, True, None),
    (2, 70, 70, 2, 1, 32, True, "masked_rows"),
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,kind", ARITH_CASES)
def test_walks_match_the_plain_backward(B, Sq, Sk, Hq, Hkv, D, causal, kind):
    """The walks in fp32 (skips, and masks only where the rule says)
    against ``flash_bwd_dq_reference`` / ``flash_bwd_dkv_reference``."""
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hkv, D, seed=Sq + D)
    seg = _segments(kind, B, Sq, Sk, np.random.RandomState(Sq))
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention_reference(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(o, do)
    scale = D ** -0.5
    dq = walk_dq(q, k, v, do, lse, delta, causal, seg, scale)
    dk, dv = walk_dkv(q, k, v, do, lse, delta, causal, seg, scale)
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    for got, ref, name in ((dq, rdq, "dq"), (dk, rdk, "dk"), (dv, rdv, "dv")):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal,hq,hkv", [(True, 4, 2), (False, 2, 1)])
def test_walks_match_the_reference_kernels(causal, hq, hkv):
    """The walks against ``jax.vjp`` of
    the JAX package's flash attention with its Pallas backward kernels in
    interpret mode, on two packed segments and a padded tail (segment
    0)."""
    B, S, D = 2, 256, 128
    q, k, v, do = _inputs(B, S, S, hq, hkv, D, seed=11)
    sid = np.zeros((B, S), np.int32)
    sid[:, :100], sid[:, 100:200] = 1, 2
    ids = JSeg(jnp.asarray(sid), jnp.asarray(sid))

    def f(q, k, v):
        return j_flash(q, k, v, causal=causal, segment_ids=ids,
                       interpret=True, block_q=128, block_k=128)
    _, vjp = jax.vjp(f, *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(jnp.asarray(do.numpy())))
    seg = fa.SegmentIds(torch.from_numpy(sid), torch.from_numpy(sid))
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                          segment_ids=seg, return_lse=True)
    delta = fa.attention_delta(o, do)
    dq = walk_dq(q, k, v, do, lse, delta, causal, seg, D ** -0.5)
    dk, dv = walk_dkv(q, k, v, do, lse, delta, causal, seg, D ** -0.5)
    for got, ref, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, err_msg=name)
