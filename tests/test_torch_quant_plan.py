"""The Python side of K4/K5's prefill design (``ops/quant.py``): the plan
that cuts Y [M, N] into work units (weight tile, split of K, X tile), and
a walk of that plan in the kernel's own index arithmetic, held against the
plain versions and the JAX package's interpret-mode kernels. Runs on the
CPU.

The walk mirrors ``qmm_prefill`` in ``csrc/quant_matmul.cu``: units
decoded as ``PrefillPlan.unit`` (the kernel's ``unit_of``), 64 weight
bytes a ring stage, the X columns each stage pairs with from
``stage_runs`` (int4: the low nibbles' run at gG + j0 and the high
nibbles' at gG + G/2 + j0), zeros past M, N and K as TMA fills them, each
int4 group's partial sum scaled in fp32 when its last stage is in, int8's
scale applied to the unit's sum, and the splits' fp32 partials added in
the order 0, 1, .... fp32 inputs; tolerance 1e-5 · max|ref| (the same
fp32 products summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.ops import quant as jq
from mllm_npu_tpu_torch.ops import quant as tq

REL = 1e-5
PREFILL_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
PREFILL_M = [17, 128, 339, 512]


def _stages(bits, K):
    return -(-K // 64) if bits == 8 else K // 128


def stage_runs(bits, c, G=0):
    """The K columns of X that ring stage ``c`` pairs with the stage's 64
    weight bytes a row (bytes 64c to 64c + 63 of each weight row), as the
    kernel's producer loads them: [(first X column, nibble)], nibble None
    for int8, "lo" / "hi" for int4. Int4's stage c lies in group
    c // (G/128), packed offset j0 = 64·(c mod G/128) in it."""
    if bits == 8:
        return [(64 * c, None)]
    grp, j0 = divmod(c, G // 128)
    return [(grp * G + 64 * j0, "lo"), (grp * G + G // 2 + 64 * j0, "hi")]


def _check_cover(plan, M, N, K, G):
    """Every output element lies in exactly one tile, and every tile's
    splits walk the stages of K once, in runs that start on int4 group
    boundaries."""
    assert plan.stages == _stages(plan.bits, K)
    assert plan.bx in tq.PREFILL_BX[plan.bits]
    rows = sorted((x * plan.bx, min(M, (x + 1) * plan.bx))
                  for x in range(plan.x_tiles))
    cols = sorted((n * tq.PREFILL_BN, min(N, (n + 1) * tq.PREFILL_BN))
                  for n in range(plan.n_tiles))
    for spans, size in ((rows, M), (cols, N)):
        assert spans[0][0] == 0 and spans[-1][1] == size
        assert all(a < b for a, b in spans)              # no empty tile
        assert all(spans[i][1] == spans[i + 1][0]
                   for i in range(len(spans) - 1))       # no gap, no overlap
    walked = {}
    for u in range(plan.units):
        n, x, s, c0, c1 = plan.unit(u)
        assert 0 <= n < plan.n_tiles and 0 <= x < plan.x_tiles
        assert 0 <= s < plan.splits and c0 < c1
        walked.setdefault((n, x), []).append((c0, c1))
        if plan.bits == 4:
            assert c0 % (G // 128) == 0 and c1 % (G // 128) == 0
    assert len(walked) == plan.n_tiles * plan.x_tiles
    for runs in walked.values():
        runs.sort()
        assert runs[0][0] == 0 and runs[-1][1] == plan.stages
        assert all(runs[i][1] == runs[i + 1][0]
                   for i in range(len(runs) - 1))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", PREFILL_M)
@pytest.mark.parametrize("K,N", PREFILL_KN)
def test_prefill_plan_covers_every_output_once(bits, M, K, N):
    plan = tq.prefill_plan(bits, M, N, K, 256)
    _check_cover(plan, M, N, K, 256)
    assert plan.splits <= tq.PREFILL_MAX_SPLITS
    if plan.splits > 1:
        assert plan.split_stages >= tq.PREFILL_MIN_SPLIT_STAGES


@pytest.mark.parametrize("bits,M,K,N,G", [
    (8, 339, 4096, 1000, 0),       # ragged N
    (8, 17, 4096, 128587, 0),      # the lm_head's width
    (8, 339, 208, 130, 0),         # int8's ragged K tail (K % 64 != 0)
    (8, 600, 4160, 77, 0),         # more X rows than one tile of 256
    (4, 339, 512, 1000, 128),
    (4, 17, 4096, 128587, 256),
    (4, 339, 384, 130, 384),       # G = K
])
def test_prefill_plan_ragged_shapes(bits, M, K, N, G):
    _check_cover(tq.prefill_plan(bits, M, N, K, G), M, N, K, G)


@pytest.mark.parametrize("K,G", [(4096, 256), (14336, 256), (4096, 4096),
                                 (14336, 14336), (1024, 128)])
def test_int4_splits_fall_on_group_boundaries(K, G):
    for M in PREFILL_M:
        for N in (1024, 4096):
            plan = tq.prefill_plan(4, M, N, K, G)
            step = G // 128
            assert plan.split_stages % step == 0
            for u in range(plan.units):
                _, _, _, c0, c1 = plan.unit(u)
                assert c0 % step == 0 and c1 % step == 0


def test_prefill_plan_rules():
    # the decode regime has no plan; int4 groups must be multiples of 128
    with pytest.raises(ValueError):
        tq.prefill_plan(8, tq.DECODE_MAX_M, 4096, 4096)
    with pytest.raises(ValueError):
        tq.prefill_plan(4, 339, 4096, 4096, 192)
    # few output tiles are split along K to fill the card, many are not
    assert tq.prefill_plan(8, 339, 1024, 4096, num_sms=132).splits > 1
    assert tq.prefill_plan(8, 339, 14336, 4096, num_sms=132).splits == 1
    # the stage runs: int8 pairs 64 bytes with 64 columns; int4 stage 3 of
    # G = 256 is group 1, packed offset 64
    assert stage_runs(8, 5) == [(320, None)]
    assert stage_runs(4, 3, 256) == [(256 + 64, "lo"), (256 + 128 + 64, "hi")]


def walk(plan, x, values, scale, G=0):
    """Y from the plan, in the kernel's arithmetic (module docstring)."""
    M, K = x.shape
    N, kw = values.shape
    bx, bn = plan.bx, tq.PREFILL_BN
    # zeros past M, N and K, as TMA fills the boxes
    xp = np.zeros((plan.x_tiles * bx, K + 64), np.float32)
    xp[:M, :K] = x
    wp = np.zeros((plan.n_tiles * bn, plan.stages * 64), np.int32)
    wp[:N, :kw] = values.astype(np.int32)
    ws = np.zeros((plan.splits, M, N), np.float32)
    for u in range(plan.units):
        n, xt, s, c0, c1 = plan.unit(u)
        r0, n0 = xt * bx, n * bn
        acc = np.zeros((bn, bx), np.float32)       # Yᵀ: weight rows × X rows
        part = np.zeros_like(acc)
        for c in range(c0, c1):
            wb = wp[n0:n0 + bn, 64 * c:64 * c + 64]
            for k0, nib in stage_runs(plan.bits, c, G):
                if nib is None:
                    a = wb
                elif nib == "lo":
                    a = ((wb & 0xF) ^ 8) - 8
                else:
                    a = wb >> 4
                xb = xp[r0:r0 + bx, k0:k0 + 64]
                part += a.astype(np.float32) @ xb.T
            if plan.bits == 8:
                acc += part
                part[:] = 0
            elif (c + 1) % (G // 128) == 0:        # the group is in
                g = c // (G // 128)
                sc = np.zeros(bn, np.float32)
                sc[:min(bn, N - n0)] = scale[g, n0:n0 + bn]
                acc += part * sc[:, None]
                part[:] = 0
        if plan.bits == 8:
            sc = np.zeros(bn, np.float32)
            sc[:min(bn, N - n0)] = scale[n0:n0 + bn]
            acc *= sc[:, None]
        m1, n1 = min(M, r0 + bx), min(N, n0 + bn)
        ws[s, r0:m1, n0:n1] = acc[:n1 - n0, :m1 - r0].T
    y = ws[0].copy()
    for s in range(1, plan.splits):
        y = y + ws[s]
    return y


def _close(got, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref,
                               atol=REL * np.abs(ref).max(), rtol=0)


# small shapes whose plans still take every path: several X tiles, ragged
# M and N, splits of K, int8's ragged K tail, G = 128, 256 and K
WALK_CASES = [
    # bits, M, K, N, G, num_sms
    (8, 339, 512, 200, 0, 132),
    (8, 17, 1024, 128, 0, 132),
    (8, 300, 208, 130, 0, 8),
    (8, 129, 2048, 256, 0, 132),
    (4, 339, 1024, 200, 256, 132),
    (4, 140, 1024, 130, 128, 132),
    (4, 33, 512, 256, 512, 132),
    (4, 128, 2048, 128, 256, 132),
]


@pytest.mark.parametrize("bits,M,K,N,G,sms", WALK_CASES)
def test_plan_walk_matches_the_references(bits, M, K, N, G, sms):
    rs = np.random.RandomState(M * 7 + K + N)
    w = rs.normal(0, 0.05, (K, N)).astype(np.float32)
    x = rs.normal(0, 1.0, (M, K)).astype(np.float32)
    plan = tq.prefill_plan(bits, M, N, K, G, num_sms=sms)
    wt = torch.from_numpy(w.T.copy())
    if bits == 8:
        qt = tq.quantize_int8(wt)
        plain = tq.int8_matmul_reference
        jref = jq.int8_matmul(jnp.asarray(x), jq.quantize_int8(jnp.asarray(w)),
                              interpret=True)
    else:
        qt = tq.quantize_int4(wt, G)
        plain = tq.int4_matmul_reference
        jref = jq.int4_matmul(jnp.asarray(x),
                              jq.quantize_int4(jnp.asarray(w), group_size=G),
                              interpret=True)
    got = walk(plan, x, qt.values.numpy(), qt.scale.numpy(), G)
    _close(got, plain(torch.from_numpy(x), *qt).numpy())
    _close(got, np.asarray(jref))
    if (bits, M, K) in ((8, 339, 512), (8, 300, 208), (4, 339, 1024)):
        assert plan.x_tiles > 1
    if (bits, M, K, N) in ((8, 17, 1024, 128), (4, 128, 2048, 128)):
        assert plan.splits > 1
