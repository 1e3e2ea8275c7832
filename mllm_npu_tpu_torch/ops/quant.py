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
launch ``csrc/quant_matmul.cu`` for CUDA tensors and count the launch
(``launches``; ``prefill_launches`` those with M > 16, which run the
prefill kernel on the plan :func:`prefill_plan` makes); for CPU tensors
they compute the same function with their plain versions.
There is no shape fallback for CUDA tensors (the reference's ``aligned``
tests were TPU tiling limits): what the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import nn

from mllm_npu_tpu_torch.ops.flash_attention import _sms

KERNEL = "quant_matmul"
INT4_GROUP_MULTIPLE = 128   # the kernel's unit along K for int4 groups

# The prefill regime (M > DECODE_MAX_M) of K4/K5: a block owns PREFILL_BN
# weight rows (two consumer warpgroups of 64) and one tile of ``bx`` rows
# of X, and walks K in ring stages of 64 weight bytes a row (64 k for
# int8, 128 for int4). The kernel instantiates the tile widths in
# PREFILL_BX.
DECODE_MAX_M = 16
PREFILL_BN = 128
PREFILL_BX = {8: (64, 128, 176, 256), 4: (64, 128)}
PREFILL_MAX_SPLITS = 8
PREFILL_MIN_SPLIT_STAGES = 4    # a split walks at least this many stages
# The plan's cost model. One ring stage of a unit takes a fixed time (the
# conversion of its 128 × 64 weight bytes, its barriers and the wait for
# its products) plus a time per X row of the tile (the products and the
# X bytes streamed from L2): seconds, fitted to the prefill kernel's
# stage times on an H100 80GB HBM3 at 700 W (bench_quant_prefill.py
# --sweep times the plans around the chosen one). The split sums pay the
# workspace's bytes at the memory rate and a second launch.
_STAGE_S = {8: (0.35e-6, 0.0019e-6), 4: (0.50e-6, 0.0035e-6)}
_BYTES_PER_S = 3.35e12
_FILL_STAGES = 2
_REDUCE_LAUNCH_S = 2e-6


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


def prefill_plan(bits: int, M: int, N: int, K: int, G: int = 0,
                 num_sms: int = 132) -> PrefillPlan:
    """The tile width, x tiles and split of K for a prefill call, chosen by
    a cost model: the units the busiest of ``num_sms`` persistent blocks
    walks × (stages a unit walks + the ring's fill) × one stage's time,
    plus, with splits, the workspace traffic of the split sums and their
    launch. Splits fall on int4 group boundaries and walk at least
    PREFILL_MIN_SPLIT_STAGES stages."""
    if M <= DECODE_MAX_M:
        raise ValueError(f"M={M} is the decode regime (M <= {DECODE_MAX_M})")
    if bits == 8:
        stages, step = -(-K // 64), 1
    else:
        if G % INT4_GROUP_MULTIPLE or K % G:
            raise ValueError(f"int4 prefill needs G % 128 == 0 and K % G "
                             f"== 0, got K={K}, G={G}")
        stages, step = K // 128, G // 128
    n_tiles = -(-N // PREFILL_BN)
    fixed, per_row = _STAGE_S[bits]
    best = None
    for bx in PREFILL_BX[bits]:
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
                                       s, per))
    return best[1]


# -- K4 / K5 ----------------------------------------------------------------

def _check(name, x, values, scale, kw):
    if not (x.is_cuda and values.is_cuda and scale.is_cuda):
        raise ValueError(f"{name}: x, the weight and its scales must all be "
                         "on the GPU")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} kernel takes bf16 x, got {x.dtype}")
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
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        raise ValueError("x rows must be contiguous, 16-byte aligned and a "
                         "multiple of 8 elements apart (16-byte loads), got "
                         f"strides {tuple(x2.stride())}")
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
    K4 on the GPU (bf16 x, K % 16 == 0)."""
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
    prefill = _launch(_library(8), 8, x2, values, scale, y, M, N, K, 0)
    int8_matmul.launches += 1
    int8_matmul.prefill_launches += prefill
    return y.reshape(*lead, N)


int8_matmul.launches = 0
int8_matmul.prefill_launches = 0   # of those, the prefill regime (M > 16)


def int4_matmul(x: torch.Tensor, values: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ packed-int4 W [N, K/2] with group scales [K/G, N] →
    [..., N] (x's dtype); G = K / scale.shape[0]. K5 on the GPU (bf16 x,
    G a multiple of 128)."""
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
    prefill = _launch(_library(4), 4, x2, values, scale, y, M, N, K, G)
    int4_matmul.launches += 1
    int4_matmul.prefill_launches += prefill
    return y.reshape(*lead, N)


int4_matmul.launches = 0
int4_matmul.prefill_launches = 0   # of those, the prefill regime (M > 16)


# -- modules ----------------------------------------------------------------

class Int8Linear(nn.Module):
    """Bias-free Linear with int8 storage and per-channel scales (twin of
    ``Int8Dense``). ``weight_q`` [N, K] int8 and ``scale`` [N] fp32 are
    buffers, not parameters, so a cast of the parameters never reaches the
    scales."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))

    @classmethod
    def from_weight(cls, w: torch.Tensor, dtype) -> "Int8Linear":
        """Quantize ``w`` [N, K] on its device."""
        qt = quantize_int8(w)
        with torch.device("meta"):
            m = cls(w.shape[1], w.shape[0], dtype)
        m.weight_q, m.scale = qt.values, qt.scale
        return m

    def forward(self, x):
        return int8_matmul(x.to(self.compute_dtype), self.weight_q,
                           self.scale)


class Int4Linear(nn.Module):
    """Bias-free Linear with packed int4 storage and group-wise scales
    (twin of ``Int4Dense``). ``weight_q`` [N, K/2] int8 and ``scale_g``
    [K/G, N] fp32 are buffers; G is ``group_size`` when it divides K, else
    K."""

    def __init__(self, in_features: int, out_features: int,
                 group_size: int = 256, dtype: torch.dtype = torch.bfloat16):
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

    @classmethod
    def from_weight(cls, w: torch.Tensor, group_size: int,
                    dtype) -> "Int4Linear":
        """Quantize ``w`` [N, K] on its device."""
        qt = quantize_int4(w, group_size)
        with torch.device("meta"):
            m = cls(w.shape[1], w.shape[0], group_size, dtype)
        m.weight_q, m.scale_g = qt.values, qt.scale
        return m

    def forward(self, x):
        return int4_matmul(x.to(self.compute_dtype), self.weight_q,
                           self.scale_g)
