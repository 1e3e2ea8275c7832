"""K4 f32 / K5 f32's arithmetic (``csrc/quant_matmul_f32.cu``) on the CPU:
fp32 x split into three bf16 parts (``ops/quant.py split_bf16x3``, the
plain twin of the pre-split kernel), each part's product with the integer
weights, and the fp32 prefill plans.

- The split recombines to x exactly in fp64 wherever its parts stay in
  bf16's normal range, and within half of bf16's subnormal spacing
  (2^-134) below it; its rounding is round-to-nearest-even, held against
  a bit-level numpy rounding.
- The three-part product, emulated in fp32 the way the kernels group it
  (parts l, m, h, each a product with the integer weights, per int4
  group), is within QUANT_F32_TOL·max|plain| of ``int8_matmul_reference``
  / ``int4_matmul_reference`` and of the JAX package's interpret-mode
  kernels on fp32 x; x as one bf16 part (bf16's 2^-9) lands outside.
- Every fp32 plan over the Llama-3-8B's products fits the card's shared
  memory with a ring of at least 4 stages, takes its tile width from the
  fp32 set, and covers every output once (as ``test_torch_quant_plan.py``
  holds the bf16 plans).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.ops import quant as jq
from mllm_npu_tpu_torch.ops import quant as tq

# the kernels' tolerance on the card (tests/test_torch_cuda.py)
QUANT_F32_TOL = 2e-5
# the Llama-3-8B's (K, N): q/o, k/v, gate/up, down, the lm_head
LLAMA8B_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 128587)]


def _bf16_rne_bits(x: np.ndarray) -> np.ndarray:
    """fp32 → bf16 bits by round-to-nearest-even on the bit pattern (finite
    x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _seeded_x(n=4096, seed=0):
    rs = np.random.RandomState(seed)
    mags = np.exp2(rs.uniform(-125, 126, n)) * rs.uniform(1, 2, n)
    x = (mags * rs.choice([-1.0, 1.0], n)).astype(np.float32)
    tiny = np.finfo(np.float32).smallest_subnormal
    special = np.array([0.0, -0.0, tiny, -tiny, 3 * tiny, 1e-40, -2.5e-39,
                        1.1754942e-38, 1e38, -1e38, 2.5e38, 1.0, -1.0,
                        1 + 2.0 ** -23, 1 - 2.0 ** -24, 65504.0],
                       np.float32)
    subnormals = (rs.uniform(-1, 1, 256) * 2.0 ** -126).astype(np.float32)
    return np.concatenate([x, special, subnormals])


def test_split_recombines_to_x():
    x = _seeded_x()
    parts = tq.split_bf16x3(torch.from_numpy(x))
    assert parts.shape == (3, x.size) and parts.dtype == torch.bfloat16
    h, m, l = (p.float().double().numpy() for p in parts)
    xd = x.astype(np.float64)
    err = np.abs(h + m + l - xd)
    # x's 24 bits in three parts of 8: exact while l stays a normal bf16
    exact = np.abs(xd) >= 2.0 ** -100
    assert (err[exact] == 0).all()
    assert (err <= np.maximum(2.0 ** -24 * np.abs(xd), 2.0 ** -134)).all()
    # each part is the round-to-nearest-even bf16 of what is left
    np.testing.assert_array_equal(parts[0].view(torch.int16).numpy()
                                  .view(np.uint16), _bf16_rne_bits(x))
    r = (x - parts[0].float().numpy()).astype(np.float32)
    np.testing.assert_array_equal(parts[1].view(torch.int16).numpy()
                                  .view(np.uint16), _bf16_rne_bits(r))
    # ±0 splits into zeros of its sign
    assert torch.equal(tq.split_bf16x3(torch.tensor([0.0, -0.0])).float(),
                       torch.tensor([[0.0, -0.0]] * 3))


def test_split_x3_on_the_cpu_is_the_plain_split():
    x = torch.from_numpy(_seeded_x(512, seed=1)[:512].reshape(2, 4, 64))
    assert torch.equal(tq.split_x3(x), tq.split_bf16x3(x.reshape(8, 64)))


def _weights(bits, N, K, G, seed):
    """A seeded [K, N] weight (the reference's layout), its port
    quantization and the integer weights [N, K] in k order."""
    w = np.random.RandomState(seed).normal(0, 0.05, (K, N)).astype(np.float32)
    wt = torch.from_numpy(w.T.copy())
    if bits == 8:
        qt = tq.quantize_int8(wt)
        return w, qt, qt.values.float()
    qt = tq.quantize_int4(wt, G)
    lo, hi, _ = tq._unpack_groups(qt)                 # [N, K/G, G/2]
    return w, qt, torch.cat([lo, hi], dim=2).reshape(N, K).float()


def emulated_parts_product(parts, w_int, scale, G):
    """Σ over the parts l, m, h of part · W_intᵀ (K4: scaled at the end; K5:
    each group's sum scaled and added), in fp32."""
    M, K = parts.shape[1:]
    if G is None:
        y = sum(parts[p].float() @ w_int.t() for p in (2, 1, 0))
        return y * scale
    y = torch.zeros(M, w_int.shape[0])
    for g in range(K // G):
        ks = slice(g * G, (g + 1) * G)
        part = sum(parts[p, :, ks].float() @ w_int[:, ks].t()
                   for p in (2, 1, 0))
        y = y + part * scale[g]
    return y


@pytest.mark.parametrize("bits,M,K,N,G", [
    (8, 17, 256, 96, None), (8, 5, 512, 130, None),
    (4, 17, 256, 96, 128), (4, 5, 512, 130, 256),
])
def test_three_part_product_is_fp32(bits, M, K, N, G):
    rs = np.random.RandomState(M + K)
    x = rs.normal(0, 1.0, (M, K)).astype(np.float32)
    w, qt, w_int = _weights(bits, N, K, G, seed=K + N)
    xt = torch.from_numpy(x)
    plain = (tq.int8_matmul_reference if bits == 8
             else tq.int4_matmul_reference)(xt, *qt)
    tol = QUANT_F32_TOL * plain.abs().max().item()
    got = emulated_parts_product(tq.split_bf16x3(xt), w_int, qt.scale, G)
    assert (got - plain).abs().max().item() <= tol
    # the JAX package's kernel (interpret mode) on the same fp32 x
    if bits == 8:
        jref = jq.int8_matmul(jnp.asarray(x), jq.quantize_int8(
            jnp.asarray(w)), interpret=True)
    else:
        jref = jq.int4_matmul(jnp.asarray(x), jq.quantize_int4(
            jnp.asarray(w), group_size=G), interpret=True)
    jref = torch.from_numpy(np.array(jref, np.float32))
    assert (got - jref).abs().max().item() <= tol
    # one part (x rounded to bf16) is not an fp32 product
    one = torch.stack([xt.bfloat16(), torch.zeros_like(xt).bfloat16(),
                       torch.zeros_like(xt).bfloat16()])
    control = emulated_parts_product(one, w_int, qt.scale, G)
    assert (control - plain).abs().max().item() > tol


def _check_cover(plan, M, N):
    assert plan.x_tiles * plan.bx >= M > (plan.x_tiles - 1) * plan.bx
    assert plan.n_tiles == -(-N // tq.PREFILL_BN)
    runs = {}
    for u in range(plan.units):
        n, x, s, c0, c1 = plan.unit(u)
        runs.setdefault((n, x), []).append((c0, c1))
    assert len(runs) == plan.n_tiles * plan.x_tiles
    for r in runs.values():
        r.sort()
        assert r[0][0] == 0 and r[-1][1] == plan.stages
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))


@pytest.mark.parametrize("bits", [8, 4])
def test_f32_plans_fit_shared_memory(bits):
    G = 256 if bits == 4 else 0
    for dtype in tq.PREFILL_BX:
        for bx in tq.PREFILL_BX[dtype][bits]:
            stages, smem = tq.prefill_ring(bits, bx, dtype)
            assert stages >= 4 and smem <= tq.SMEM_MAX
    seen = set()
    for K, N in LLAMA8B_KN:
        for M in (1, 8, 16, 17, 40, 128, 339, 512, 2048):
            plan = tq.prefill_plan(bits, M, N, K, G, dtype=torch.float32)
            assert plan.dtype == torch.float32
            assert plan.bx in tq.PREFILL_BX[torch.float32][bits]
            assert tq.prefill_ring(bits, plan.bx, torch.float32)[1] \
                <= tq.SMEM_MAX
            assert plan.splits <= tq.PREFILL_MAX_SPLITS
            if bits == 4:
                assert plan.split_stages % (G // 128) == 0
            if M <= 512 and N < 128587:
                _check_cover(plan, M, N)
            seen.add(plan.bx)
    assert seen == set(tq.PREFILL_BX[torch.float32][bits])
    # the bf16 tile widths an fp32 ring cannot hold 4 stages of
    for bx in set(tq.PREFILL_BX[torch.bfloat16][bits]) - seen:
        parts = 3 * (1 if bits == 8 else 2) * bx * 128
        assert 4 * (parts + tq.PREFILL_BN * 64) > tq.SMEM_MAX - 1024


def test_f32_route_threshold():
    assert 1 <= tq.F32_DECODE_MAX_M <= tq.DECODE_MAX_M
    assert not tq.f32_prefill_route(1)
    assert not tq.f32_prefill_route(tq.F32_DECODE_MAX_M)
    assert tq.f32_prefill_route(tq.F32_DECODE_MAX_M + 1)
    with pytest.raises(ValueError):
        tq.prefill_plan(8, tq.DECODE_MAX_M, 4096, 4096)    # bf16: decode
    with pytest.raises(TypeError):
        tq.prefill_plan(8, 339, 4096, 4096, dtype=torch.float16)
