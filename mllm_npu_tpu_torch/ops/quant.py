"""Weight-only int8 / int4 storage and products (twin of
``mllm_npu_tpu/ops/quant.py``), with K4 and K5 as hand-written CUDA
kernels for Hopper.

Storage follows the torch ``Linear`` convention, the transpose of the
reference's ``[K, N]`` kernels: values are ``[N, K]`` int8, or ``[N, K/2]``
int8 holding two int4 nibbles per byte, K contiguous. Scales keep the
reference's orientation: ``[N]`` for int8, ``[K/G, N]`` for int4. For the
same weight, ``values`` here are the reference's ``values.T`` byte for
byte, and the scales are equal.

Int4 keeps the reference's group-half nibble layout along K
(``quant.py:274-281``): byte r of group g in row n holds W[n, gG+r] in its
low nibble and W[n, gG+G/2+r] in its high nibble. A K that the group size
does not divide falls back to one group of G = K.

:func:`int8_matmul` (K4, replaces ``quant.py:50 _matmul_kernel``) and
:func:`int4_matmul` (K5, replaces ``quant.py:330 _matmul4_kernel``)
launch ``csrc/quant_matmul.cu`` for bf16 x on CUDA and count the launch
(``launches``; ``prefill_launches`` those with M > 16, which run the
prefill kernel on the plan :func:`prefill_plan` makes), and for fp32 x
K4 f32 / K5 f32 (``csrc/quant_matmul_f32.cu``: x split into three bf16
parts, :func:`split_bf16x3`, on the tensor cores over the exact integer
weights; the prefill kernel's body shared through
``csrc/quant_matmul.cuh``, a decode kernel of its own; fp32 out; counted
in ``f32_launches``), the reference's product in x's dtype; for CPU
tensors they compute the same function with their plain versions.
There is no shape fallback for CUDA tensors (the reference's ``aligned``
tests were TPU tiling limits): what the kernel does not take raises.

:class:`QuantMatmul` (:func:`quant_matmul`) is the product with its
gradient for training through a frozen quantized base (QLoRA; twin of the
reference's ``quant_matmul`` ``custom_vjp``, ``quant.py:446-485``): the
forward is K4 or K5, the backward dx = g·dequant(W) as one plain product
(fp32 sums and output) on the weight dequantized in g's dtype, and no
gradient for the frozen values and scales. :class:`Int8Linear` and
:class:`Int4Linear` compute through it, with an optional bias added to the
kernel's output (the reference's ``QuantDense``, ``quant.py:578``: the
vision towers' and the UNet's biased layers); :func:`quantize_dense_params`
turns a float state_dict into theirs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import nn

from mllm_npu_tpu_torch.ops.flash_attention import _sms

KERNEL = "quant_matmul"
F32_KERNEL = "quant_matmul_f32"    # K4 f32 / K5 f32, fp32 x
INT4_GROUP_MULTIPLE = 128   # the kernel's unit along K for int4 groups

# The prefill regime (M > DECODE_MAX_M) of K4/K5: a block owns PREFILL_BN
# weight rows (two consumer warpgroups of 64) and one tile of ``bx`` rows
# of X, and walks K in ring stages of 64 weight bytes a row (64 k for
# int8, 128 for int4). The kernel instantiates the tile widths in
# PREFILL_BX, per x dtype: fp32 x brings three bf16 parts a stage, so only
# the widths whose ring keeps 4 stages in the card's 227 KB.
DECODE_MAX_M = 16
# K4 f32 / K5 f32 run the decode kernel up to this M (at most
# DECODE_MAX_M) and the prefill kernel above it: the crossing of the two
# routes at gate_proj (K 4096, N 14336) in chip_smoke.py phase 17b's sweep
F32_DECODE_MAX_M = 16
PREFILL_BN = 128
PREFILL_BX = {torch.bfloat16: {8: (64, 128, 176, 256), 4: (64, 128)},
              torch.float32: {8: (64, 128), 4: (64,)}}
PREFILL_MAX_SPLITS = 8
PREFILL_MIN_SPLIT_STAGES = 4    # a split walks at least this many stages
# The plan's cost model. One ring stage of a unit takes a fixed time (the
# conversion of its 128 × 64 weight bytes, its barriers and the wait for
# its products) plus a time per X row of the tile (the products and the
# X bytes streamed from L2): seconds, fitted to the prefill kernel's
# stage times on an H100 80GB HBM3 at 700 W (bench_quant_prefill.py
# --sweep times the plans around the chosen one; ``--f32`` the fp32
# kernel's, whose stage carries three X parts). The split sums pay the
# workspace's bytes at the memory rate and a second launch.
_STAGE_S = {torch.bfloat16: {8: (0.35e-6, 0.0019e-6),
                             4: (0.50e-6, 0.0035e-6)},
            torch.float32: {8: (0.36e-6, 0.0054e-6),
                            4: (1.25e-6, 0.0)}}   # one width: all fixed
_BYTES_PER_S = 3.35e12
_FILL_STAGES = 2
_REDUCE_LAUNCH_S = 2e-6
# the card's shared memory for one block (227 KB), and the prefill ring's
# budget of it per x dtype (PCfg's SMEM_BUDGET in csrc/quant_matmul.cuh)
SMEM_MAX = 232448
_RING_BUDGET = {torch.bfloat16: 200 * 1024,
                torch.float32: SMEM_MAX - 1024 - 16 * 8}


class QuantizedTensor(NamedTuple):
    values: torch.Tensor   # int8 [N, K]
    scale: torch.Tensor    # f32 [N]


class QuantizedTensor4(NamedTuple):
    values: torch.Tensor   # int8 [N, K/2], two nibbles per byte
    scale: torch.Tensor    # f32 [K/G, N]


def quantize_int8(w: torch.Tensor) -> QuantizedTensor:
    """Symmetric per-output-channel int8 quantization of ``w`` [N, K]."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return QuantizedTensor(q.to(torch.int8), scale)


def dequantize_int8(qt: QuantizedTensor, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    return (qt.values.float() * qt.scale[:, None]).to(dtype)


def group_size_for(K: int, group_size: int) -> int:
    """The reference's rule: ``group_size`` if it divides K, else K."""
    return group_size if K % group_size == 0 else K


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """lo/hi int values in [-8, 7] → int8 bytes (lo in bits 0-3). Packed in
    int32 and mapped to [-128, 127] before the cast, as the reference."""
    v = (lo.to(torch.int32) & 0xF) | ((hi.to(torch.int32) & 0xF) << 4)
    return torch.where(v >= 128, v - 256, v).to(torch.int8)


def _unpack_lo_hi(packed: torch.Tensor):
    """int8 bytes → (lo, hi) sign-extended int32 nibbles."""
    p = packed.to(torch.int32)
    return ((p & 0xF) ^ 8) - 8, p >> 4


def quantize_int4(w: torch.Tensor, group_size: int = 256) -> QuantizedTensor4:
    """Symmetric group-wise int4 quantization of ``w`` [N, K]: scales per
    (K-group, N), values nibble-packed into [N, K/2] in the group-half
    layout (module docstring)."""
    w = w.float()
    N, K = w.shape
    G = group_size_for(K, group_size)
    if G % 2:
        raise ValueError(f"int4 group size must be even, got {G} (K={K})")
    wg = w.reshape(N, K // G, G)
    amax = wg.abs().amax(dim=2)                               # [N, K/G]
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 7.0)
    q = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7)
    q = q.reshape(N, K // G, 2, G // 2)
    packed = _pack_nibbles(q[:, :, 0], q[:, :, 1]).reshape(N, K // 2)
    return QuantizedTensor4(packed, scale.t().contiguous())


def _unpack_groups(qt: QuantizedTensor4):
    """→ (lo, hi) int32 [N, K/G, G/2] and G."""
    N, Kh = qt.values.shape
    n_g = qt.scale.shape[0]
    lo, hi = _unpack_lo_hi(qt.values.reshape(N, n_g, Kh // n_g))
    return lo, hi, 2 * Kh // n_g


def dequantize_int4(qt: QuantizedTensor4, dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """→ [N, K]."""
    lo, hi, _ = _unpack_groups(qt)
    v = torch.stack([lo, hi], dim=2).float()        # [N, n_g, 2, G/2]
    v = v * qt.scale.t()[:, :, None, None]
    return v.reshape(lo.shape[0], -1).to(dtype)


# -- plain versions (the Pallas kernels' formulas) --------------------------

def int8_matmul_reference(x: torch.Tensor, values: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``(x · W_qᵀ) ∘ scale`` in fp32, returned in x's dtype."""
    y = (x.float() @ values.float().t()) * scale
    return y.to(x.dtype)


def int4_matmul_reference(x: torch.Tensor, values: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """``Σ_g (x_g,lo · lo_gᵀ + x_g,hi · hi_gᵀ) ∘ scale[g]`` in fp32: each
    group's partial sum is scaled in fp32, as ``_matmul4_kernel``."""
    lo, hi, G = _unpack_groups(QuantizedTensor4(values, scale))
    *lead, K = x.shape
    n_g = scale.shape[0]
    xg = x.float().reshape(-1, n_g, 2, G // 2)
    part = (torch.einsum("mgh,ngh->mgn", xg[:, :, 0], lo.float())
            + torch.einsum("mgh,ngh->mgn", xg[:, :, 1], hi.float()))
    y = (part * scale[None]).sum(dim=1)
    return y.reshape(*lead, -1).to(x.dtype)


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """fp32 x → its three bf16 parts [3, *x.shape]: h = bf16(x), m =
    bf16(x − h), l = bf16(x − h − m), each rounded to nearest even, the
    differences exact in fp32. For a finite x below bf16's largest
    (3.39e38) h + m + l == x exactly, down to bf16's subnormal spacing
    (2^-133): a subnormal x loses what lies below it. The plain twin of
    ``csrc/quant_matmul_f32.cu``'s pre-split kernel (:func:`split_x3`),
    bit for bit; the fp32 kernels multiply each part with the integer
    weights, which bf16 holds exactly."""
    x = x.float()
    h = x.to(torch.bfloat16)
    r = x - h.float()
    m = r.to(torch.bfloat16)
    return torch.stack([h, m, (r - m.float()).to(torch.bfloat16)])


# -- the prefill plan --------------------------------------------------------

class PrefillPlan(NamedTuple):
    """How K4/K5's prefill kernel covers Y [M, N]: ``n_tiles`` × ``x_tiles``
    output tiles of PREFILL_BN weight rows by ``bx`` rows of X, each cut
    along K into ``splits`` runs of ``split_stages`` ring stages (the last
    run may be shorter; for int4 every run starts on a group boundary).
    Work unit u is (n tile, split, x tile) with the x tile fastest, so the
    blocks that read one weight tile run together and share it in L2. With more than one split each unit writes its fp32
    partial to a workspace [splits, M, N] and a second kernel sums the
    splits in order 0, 1, ...: the same bits on every run."""
    bits: int
    bx: int
    x_tiles: int
    n_tiles: int
    stages: int
    splits: int
    split_stages: int
    dtype: torch.dtype = torch.bfloat16   # x's: fp32 for K4 f32 / K5 f32

    @property
    def units(self) -> int:
        return self.n_tiles * self.splits * self.x_tiles

    def unit(self, u: int):
        """→ (n tile, x tile, split, first stage, end stage) of unit u, as
        the kernel's ``unit_of`` decodes it."""
        x = u % self.x_tiles
        r = u // self.x_tiles
        s = r % self.splits
        c0 = s * self.split_stages
        return (r // self.splits, x, s, c0,
                min(self.stages, c0 + self.split_stages))


def prefill_ring(bits: int, bx: int, dtype=torch.bfloat16):
    """(stages, shared-memory bytes) of the prefill kernel's instantiation
    for ``bits``, tile width ``bx`` and x's dtype, as ``PCfg`` computes
    them: a stage holds the weight box (128 rows × 64 bytes) and one X run
    (int8) or two (int4) of [bx rows × 64 bf16] boxes, one a part (fp32 x:
    three); up to 8 stages fill the ring's budget, then the barriers and
    the 1024-byte alignment."""
    parts = 3 if dtype == torch.float32 else 1
    stage = (1 if bits == 8 else 2) * parts * bx * 128 + PREFILL_BN * 64
    stages = min(8, _RING_BUDGET[dtype] // stage)
    return stages, stages * stage + 16 * stages + 1024


def prefill_plan(bits: int, M: int, N: int, K: int, G: int = 0,
                 num_sms: int = 132,
                 dtype: torch.dtype = torch.bfloat16) -> PrefillPlan:
    """The tile width, x tiles and split of K for a prefill call on x of
    ``dtype`` (bf16, or fp32 for K4 f32 / K5 f32), chosen by a cost model:
    the units the busiest of ``num_sms`` persistent blocks walks × (stages
    a unit walks + the ring's fill) × one stage's time, plus, with splits,
    the workspace traffic of the split sums and their launch. Splits fall
    on int4 group boundaries and walk at least PREFILL_MIN_SPLIT_STAGES
    stages. bf16 x has no plan at M <= DECODE_MAX_M (its C entry runs the
    decode kernel there); fp32 x has one at any M, the route being
    F32_DECODE_MAX_M's."""
    if dtype not in PREFILL_BX:
        raise TypeError(f"no prefill kernel for {dtype} x")
    if M < 1 or (dtype == torch.bfloat16 and M <= DECODE_MAX_M):
        raise ValueError(f"M={M} is the decode regime (M <= {DECODE_MAX_M})")
    if bits == 8:
        stages, step = -(-K // 64), 1
    else:
        if G % INT4_GROUP_MULTIPLE or K % G:
            raise ValueError(f"int4 prefill needs G % 128 == 0 and K % G "
                             f"== 0, got K={K}, G={G}")
        stages, step = K // 128, G // 128
    n_tiles = -(-N // PREFILL_BN)
    fixed, per_row = _STAGE_S[dtype][bits]
    best = None
    for bx in PREFILL_BX[dtype][bits]:
        x_tiles = -(-M // bx)
        stage_s = fixed + per_row * bx
        for s in range(1, PREFILL_MAX_SPLITS + 1):
            per = -(-(-(-stages // s)) // step) * step
            if -(-stages // per) != s:
                continue        # the same runs as a smaller count
            if s > 1 and per < PREFILL_MIN_SPLIT_STAGES:
                break
            waves = -(-(n_tiles * x_tiles * s) // num_sms)
            t = waves * (per + _FILL_STAGES) * stage_s
            if s > 1:
                t += (8 * s + 2) * M * N / _BYTES_PER_S + _REDUCE_LAUNCH_S
            if best is None or t < best[0]:
                best = (t, PrefillPlan(bits, bx, x_tiles, n_tiles, stages,
                                       s, per, dtype))
    return best[1]


# -- K4 / K5 ----------------------------------------------------------------

def _check(name, x, values, scale, kw):
    if not (x.is_cuda and values.is_cuda and scale.is_cuda):
        raise ValueError(f"{name}: x, the weight and its scales must all be "
                         "on the GPU")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} kernel takes bf16 or fp32 x, got {x.dtype}")
    if values.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name}: weight must be int8 and scales fp32, got "
                        f"{values.dtype}, {scale.dtype}")
    if values.ndim != 2 or values.shape[1] != kw or not values.is_contiguous():
        raise ValueError(f"{name}: weight must be contiguous [N, {kw}], got "
                         f"{tuple(values.shape)}")
    if values.data_ptr() % 16 or kw % 16:
        raise ValueError(f"{name}: weight rows must be 16-byte aligned "
                         f"(16-byte loads), got row of {kw} bytes")
    if not scale.is_contiguous():
        raise ValueError(f"{name}: scales must be contiguous")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] → [M, K] with 16-byte aligned rows, or raise."""
    x2 = x.reshape(-1, x.shape[-1])
    per = 16 // x2.element_size()
    if x2.stride(1) != 1 or x2.stride(0) % per or x2.data_ptr() % 16:
        raise ValueError("x rows must be contiguous, 16-byte aligned and a "
                         f"multiple of {per} elements apart (16-byte loads), "
                         f"got strides {tuple(x2.stride())}")
    return x2


_kernel_fns: dict = {}


def _library(bits: int):
    """The kernel's C entry point for ``bits``, built, loaded and typed on
    first use."""
    if bits not in _kernel_fns:
        from mllm_npu_tpu_torch.utils.cuda_build import load
        lib = load(KERNEL)
        # x, w, scale, y, ws; M, N, K (and G); ldx; the plan; the stream
        n_int = 3 if bits == 8 else 4
        fn = getattr(lib, f"int{bits}_matmul_bf16")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * n_int
                       + [ctypes.c_longlong] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_fns[bits] = fn
    return _kernel_fns[bits]


def _library_f32(bits: int):
    """K4 f32 / K5 f32's C entry point (``csrc/quant_matmul_f32.cu``), built,
    loaded and typed on first use; ``bits`` 0: the pre-split alone."""
    key = ("f32", bits)
    if key not in _kernel_fns:
        from mllm_npu_tpu_torch.utils.cuda_build import load
        lib = load(F32_KERNEL)
        if bits == 0:
            fn = lib.split_bf16x3_f32
            # x, xs; M, K; ldx; the stream
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                           + [ctypes.c_longlong, ctypes.c_void_p])
        else:
            fn = getattr(lib, f"int{bits}_matmul_f32")
            # x, w, scale, y, xs, ws; M, N, K (and G); ldx; the route and
            # the plan; the stream
            fn.argtypes = ([ctypes.c_void_p] * 6
                           + [ctypes.c_int] * (3 if bits == 8 else 4)
                           + [ctypes.c_longlong] + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_fns[key] = fn
    return _kernel_fns[key]


def f32_prefill_route(M: int) -> bool:
    """Whether K4 f32 / K5 f32 take the prefill kernel at M rows."""
    return M > min(F32_DECODE_MAX_M, DECODE_MAX_M)


def _launch_f32(bits, x2, values, scale, y, M, N, K, G):
    """One call of K4 f32 / K5 f32: the pre-split of x into a bf16
    workspace [3, M, K], then the decode kernel or (above F32_DECODE_MAX_M)
    the prefill kernel on its plan, the workspaces allocated here. Raises on
    a refused launch."""
    plan_args, ws = [0, 0, 0, 0], None
    prefill = f32_prefill_route(M)
    if prefill:
        plan = prefill_plan(bits, M, N, K, G, _sms(x2.device),
                            dtype=torch.float32)
        plan_args = [plan.bx, plan.x_tiles, plan.splits, plan.split_stages]
        if plan.splits > 1:
            ws = torch.empty(plan.splits * M * N, dtype=torch.float32,
                             device=x2.device)
    xs = torch.empty(3 * M * K, dtype=torch.bfloat16, device=x2.device)
    shape = [M, N, K] + ([G] if bits == 4 else [])
    err = _library_f32(bits)(
        x2.data_ptr(), values.data_ptr(), scale.data_ptr(), y.data_ptr(),
        xs.data_ptr(), None if ws is None else ws.data_ptr(), *shape,
        x2.stride(0),
        int(prefill), *plan_args,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int{bits}_matmul_f32 launch failed: CUDA error "
                           f"{err}")


def split_x3(x: torch.Tensor) -> torch.Tensor:
    """The pre-split of K4 f32 / K5 f32 alone: fp32 x [..., K]
    → [3, M, K] bf16 (h, m, l), the kernel on a CUDA tensor (K % 8 == 0,
    rows 16-byte aligned), :func:`split_bf16x3` on a CPU one. Not counted:
    it runs inside every call of the two kernels."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.device.type == "cpu":
        return split_bf16x3(x2)
    if x.dtype != torch.float32:
        raise TypeError(f"split_x3 takes fp32 x, got {x.dtype}")
    x2 = _rows(x2)
    M, K = x2.shape
    xs = torch.empty((3, M, K), dtype=torch.bfloat16, device=x.device)
    if M and K:
        err = _library_f32(0)(x2.data_ptr(), xs.data_ptr(), M, K,
                              x2.stride(0),
                              torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"split_bf16x3_f32 launch failed: CUDA error "
                               f"{err}")
    return xs


def _launch(fn, bits, x2, values, scale, y, M, N, K, G):
    """One call of the C entry for ``bits``: the decode kernel for
    M <= DECODE_MAX_M, else the prefill kernel on its plan, with the split
    workspace allocated here. Raises on a refused launch; returns whether
    it was the prefill regime."""
    plan_args, ws = [0, 0, 0, 0], None
    prefill = M > DECODE_MAX_M
    if prefill:
        plan = prefill_plan(bits, M, N, K, G, _sms(x2.device))
        plan_args = [plan.bx, plan.x_tiles, plan.splits, plan.split_stages]
        if plan.splits > 1:
            ws = torch.empty(plan.splits * M * N, dtype=torch.float32,
                             device=x2.device)
    shape = [M, N, K] + ([G] if bits == 4 else [])
    err = fn(x2.data_ptr(), values.data_ptr(), scale.data_ptr(),
             y.data_ptr(), None if ws is None else ws.data_ptr(), *shape,
             x2.stride(0), *plan_args,
             torch.cuda.current_stream(x2.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int{bits}_matmul_bf16 launch failed: CUDA error "
                           f"{err}")
    return prefill


def int8_matmul(x: torch.Tensor, values: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 W [N, K] with per-N scales → [..., N] (x's dtype).
    K4 on the GPU (bf16 x, K % 16 == 0), K4 f32 for fp32 x."""
    if x.device.type == "cpu":
        return int8_matmul_reference(x, values, scale)
    *lead, K = x.shape
    _check("int8_matmul", x, values, scale, K)
    N = values.shape[0]
    if scale.shape != (N,):
        raise ValueError(f"int8_matmul: scale must be [{N}], got "
                         f"{tuple(scale.shape)}")
    x2 = _rows(x)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if x.dtype == torch.float32:
        _launch_f32(8, x2, values, scale, y, M, N, K, 0)
        int8_matmul.f32_launches += 1
        return y.reshape(*lead, N)
    prefill = _launch(_library(8), 8, x2, values, scale, y, M, N, K, 0)
    int8_matmul.launches += 1
    int8_matmul.prefill_launches += prefill
    return y.reshape(*lead, N)


int8_matmul.launches = 0
int8_matmul.prefill_launches = 0   # of those, the prefill regime (M > 16)
int8_matmul.f32_launches = 0       # K4 f32 (fp32 x)


def int4_matmul(x: torch.Tensor, values: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ packed-int4 W [N, K/2] with group scales [K/G, N] →
    [..., N] (x's dtype); G = K / scale.shape[0]. K5 on the GPU (bf16 x,
    G a multiple of 128), K5 f32 for fp32 x."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, values, scale)
    *lead, K = x.shape
    if K % 2:
        raise ValueError(f"int4_matmul: K must be even, got {K}")
    _check("int4_matmul", x, values, scale, K // 2)
    N = values.shape[0]
    n_g = scale.shape[0]
    if scale.ndim != 2 or scale.shape[1] != N or K % n_g:
        raise ValueError(f"int4_matmul: scales must be [K/G, {N}] with G "
                         f"dividing K={K}, got {tuple(scale.shape)}")
    G = K // n_g
    if G % INT4_GROUP_MULTIPLE:
        raise ValueError(f"int4_matmul: the kernel takes groups that are "
                         f"multiples of {INT4_GROUP_MULTIPLE}, got G={G}")
    x2 = _rows(x)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if x.dtype == torch.float32:
        _launch_f32(4, x2, values, scale, y, M, N, K, G)
        int4_matmul.f32_launches += 1
        return y.reshape(*lead, N)
    prefill = _launch(_library(4), 4, x2, values, scale, y, M, N, K, G)
    int4_matmul.launches += 1
    int4_matmul.prefill_launches += prefill
    return y.reshape(*lead, N)


int4_matmul.launches = 0
int4_matmul.prefill_launches = 0   # of those, the prefill regime (M > 16)
int4_matmul.f32_launches = 0       # K5 f32 (fp32 x)


# -- the product with its gradient (QLoRA) ------------------------------------

class QuantMatmul(torch.autograd.Function):
    """``x · dequant(W)ᵀ`` for a frozen int8 (``bits`` 8, per-channel
    scales) or packed int4 (``bits`` 4, group scales) W: K4 / K5 forward;
    backward dx = g·dequant(W), the weight dequantized in g's dtype, summed
    and returned in fp32, then cast to g's dtype (the reference's
    ``_quant_matmul_bwd``: ``preferred_element_type=f32``); nothing for the
    values and scales. On the GPU that is one cuBLAS product with an fp32
    output: with a bf16 output cuBLAS may sum split-K partials in bf16
    (0.074 off at K = 32330 on an H100 80GB HBM3, past the bound that
    ``tests/test_torch_cuda.py`` holds the fp32-output product to)."""

    @staticmethod
    def forward(ctx, x, values, scale, bits):
        ctx.save_for_backward(values, scale)
        ctx.bits = bits
        return (int8_matmul if bits == 8 else int4_matmul)(x, values, scale)

    @staticmethod
    def backward(ctx, g):
        values, scale = ctx.saved_tensors
        if ctx.bits == 8:
            w = dequantize_int8(QuantizedTensor(values, scale), g.dtype)
        else:
            w = dequantize_int4(QuantizedTensor4(values, scale), g.dtype)
        g2 = g.reshape(-1, g.shape[-1])
        dx = (torch.mm(g2, w, out_dtype=torch.float32) if g.is_cuda
              else g2.float() @ w.float())
        return (dx.to(g.dtype).reshape(*g.shape[:-1], w.shape[1]), None,
                None, None)


def quant_matmul(x: torch.Tensor, values: torch.Tensor, scale: torch.Tensor,
                 bits: int) -> torch.Tensor:
    """:class:`QuantMatmul` (x's dtype; on the GPU bf16 x)."""
    return QuantMatmul.apply(x, values, scale, bits)


# -- modules ----------------------------------------------------------------

def _bias_after(y: torch.Tensor, bias) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


class Int8Linear(nn.Module):
    """Linear with int8 storage and per-channel scales (twin of
    ``Int8Dense``, and with ``bias`` of ``QuantDense(quantization="int8")``:
    the bias is added to K4's output, in its dtype). ``weight_q`` [N, K]
    int8 and ``scale`` [N] fp32 are buffers, not parameters, so a cast of
    the parameters never reaches the scales; ``bias`` [N] is a parameter."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16, bias: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_weight(cls, w: torch.Tensor, dtype,
                    bias: torch.Tensor = None) -> "Int8Linear":
        """Quantize ``w`` [N, K] on its device (``bias`` kept as it is)."""
        qt = quantize_int8(w)
        with torch.device("meta"):
            m = cls(w.shape[1], w.shape[0], dtype, bias=bias is not None)
        m.weight_q, m.scale = qt.values, qt.scale
        if bias is not None:
            m.bias = nn.Parameter(bias, requires_grad=bias.requires_grad)
        return m

    def forward(self, x):
        return _bias_after(quant_matmul(x.to(self.compute_dtype),
                                        self.weight_q, self.scale, 8),
                           self.bias)


class Int4Linear(nn.Module):
    """Linear with packed int4 storage and group-wise scales (twin of
    ``Int4Dense``, and with ``bias`` of ``QuantDense(quantization="int4")``,
    the bias added to K5's output). ``weight_q`` [N, K/2] int8 and
    ``scale_g`` [K/G, N] fp32 are buffers; G is ``group_size`` when it
    divides K, else K."""

    def __init__(self, in_features: int, out_features: int,
                 group_size: int = 256, dtype: torch.dtype = torch.bfloat16,
                 bias: bool = False):
        super().__init__()
        G = group_size_for(in_features, group_size)
        if in_features % 2 or G % 2:
            raise ValueError(f"int4 needs even K and G, got K={in_features}"
                             f", G={G}")
        self.compute_dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features // 2, dtype=torch.int8))
        self.register_buffer("scale_g", torch.ones(in_features // G,
                                                   out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    @classmethod
    def from_weight(cls, w: torch.Tensor, group_size: int, dtype,
                    bias: torch.Tensor = None) -> "Int4Linear":
        """Quantize ``w`` [N, K] on its device (``bias`` kept as it is)."""
        qt = quantize_int4(w, group_size)
        with torch.device("meta"):
            m = cls(w.shape[1], w.shape[0], group_size, dtype,
                    bias=bias is not None)
        m.weight_q, m.scale_g = qt.values, qt.scale
        if bias is not None:
            m.bias = nn.Parameter(bias, requires_grad=bias.requires_grad)
        return m

    def forward(self, x):
        return _bias_after(quant_matmul(x.to(self.compute_dtype),
                                        self.weight_q, self.scale_g, 4),
                           self.bias)


def quantize_dense_params(state: dict, *, skip=("embed",), bits: int = 8,
                          group_size: int = 256) -> dict:
    """A float state_dict → the one :class:`Int8Linear` / :class:`Int4Linear`
    modules hold (twin of ``quantize_dense_params``, ``quant.py:543``):
    every 2-D ``….weight`` [N, K] whose key has none of ``skip`` becomes
    ``….weight_q`` with ``….scale`` (int8) or ``….scale_g`` (int4, groups of
    ``group_size`` along K, or K where that does not divide it), quantized
    on its device; everything else, biases among it, as it is. The caller
    picks what ``skip`` keeps float (``unet.UNET_QUANT_SKIP``)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = {}
    for key, w in state.items():
        if key.endswith(".weight") and w.ndim == 2 \
                and not any(s in key for s in skip):
            mod = key[:-len(".weight")]
            if bits == 8:
                qt = quantize_int8(w)
                out[f"{mod}.weight_q"], out[f"{mod}.scale"] = qt
            else:
                qt = quantize_int4(w, group_size)
                out[f"{mod}.weight_q"], out[f"{mod}.scale_g"] = qt
        else:
            out[key] = w
    return out
