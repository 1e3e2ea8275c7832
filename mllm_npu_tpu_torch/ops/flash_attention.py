"""Flash attention on the GPU: K1 (forward), K2 and K3 (backward), hand-
written CUDA kernels for Hopper.

K1 replaces ``mllm_npu_tpu/ops/flash_attention.py:100 _fwd_kernel``
(launched by ``_fwd`` :211, API ``flash_attention`` :697). It computes
``O = softmax(scale·QKᵀ + mask)·V`` with GQA (query head h reads KV head
``h·Hkv/Hq``), an optional causal mask (top-left aligned, as the
reference) and an optional segment-id mask (``q_seg == kv_seg``). A fully
masked row gives 0. With ``return_lse`` it also writes each row's
natural-log log-sum-exp (0 for a fully masked row), which the backward
needs. Layout is the reference's public ``[B, S, H, D]``, read through
strides.

K2 (``flash_bwd_dq``) and K3 (``flash_bwd_dkv``) replace ``_bwd_dq_kernel``
(:333) and ``_bwd_dkv_kernel`` (:407), launched by ``_bwd`` (:502): they
recompute P from the saved LSE and return dQ, and dK/dV summed over each
KV head's query heads. :class:`FlashAttention` ties the three together as
an autograd Function, the twin of ``_flash`` with its ``custom_vjp`` rules
(:672-694): the forward launches K1 with the LSE, the backward computes
δ = rowsum(dO∘O) in fp32 as a plain op (the reference does so outside its
kernels, :513) and launches K2 and K3.

The kernels live in ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (with
the Hopper helpers they share in ``csrc/hopper.cuh``); their design notes
(bound on the H100 and what the design does about it) are at the top of
each file. All three are Hopper kernels (TMA into mbarrier rings, wgmma, a
producer warp and consumer warpgroups); the Python side of their design is
here: K1's tile shape and its shared memory (:func:`k1_plan`,
:func:`k1_block_q`, :func:`k1_smem_bytes`), the head dim the kernels
compute at (:func:`padded_head_dim`) and its split between the two
swizzles of the tensor maps (:func:`k1_head_split`), K2's and K3's regime
(:func:`k23_regime`; head dims 8 to 256) and, mirrored
for the tests, which
tiles each kernel visits and which of them it masks (:func:`k1_kv_tiles`,
:func:`k1_needs_mask`, :func:`k2_kv_tiles`, :func:`k3_q_tiles`,
:func:`k3_needs_mask`). Each wrapper launches its
kernel for CUDA tensors and counts the launch (``flash_attention.launches``,
``flash_bwd_dq.launches``, ``flash_bwd_dkv.launches``, and of the last two
those in the Hopper regime, ``.wgmma_launches``); for CPU tensors it
computes the same function with its plain fp32 version
(:func:`flash_attention_reference`, :func:`flash_bwd_dq_reference`,
:func:`flash_bwd_dkv_reference`). There is no fallback for CUDA tensors: a
shape or type a kernel does not take raises.

K1 f32 (``csrc/flash_fwd_f32.cu``) is K1 for fp32 q/k/v, which the
reference's kernel takes as it takes bf16 (it computes in the operands'
dtype): both products in split TF32 on the tensor cores, accurate to
fp32, the output fp32, and with ``return_lse`` the same LSE as K1's; head
dims up to 256 (``F32_MAX_HEAD_DIM``), computed at
:func:`padded_head_dim` as bf16 K1's; its plan (shared memory, warps) is
:func:`k1_f32_plan`.
:func:`flash_attention` routes fp32 operands to it and counts them in
``flash_attention.f32_launches`` (no LSE) and ``.f32_lse_launches`` (with
it). K2 f32 and K3 f32 (``csrc/flash_bwd_f32.cu`` and
``csrc/flash_bwd_dkv_f32.cu``, sharing ``csrc/flash_bwd_f32.cuh``) are K2
and K3 for fp32 operands (head dims up to 256, as K1 f32), every product
in split TF32, P and dS in fp32, fp32 outputs: :func:`flash_bwd_dq` and
:func:`flash_bwd_dkv` route fp32 operands to them and count them in
``.f32_launches``; their plan (the route by padded head dim: wgmma up to
128, mma.sync above; shared memory, a block's and a streamed tile's rows,
warps) is :func:`k23_f32_plan`, their walks :func:`k2_f32_kv_tiles` and
:func:`k3_f32_q_tiles`. So :class:`FlashAttention` trains on fp32
operands through K1 f32, K2 f32 and K3 f32. Each fp32 kernel has a
one-pass TF32 control (``*_f32_one_pass``), never on a path and not
counted.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

KERNEL = "flash_fwd"
# K1, K2 and K3 take head dims in multiples of 8 up to this (Qwen-ViT-G's
# 104, the SEED-X input projector's 160, the reference's bench shape's 256)
MAX_HEAD_DIM = 256
K23_MAX_HEAD_DIM = 256
# up to a padded 160 the kernels compute at D rounded up to 16; above it
# at 192 or 256, their only instantiations there (TMA fills the columns
# past D with zeros, as the reference pads D to 256)
NARROW_HEAD_DIM = 160
WIDE_HEAD_DIMS = (192, 256)
# K1 f32, K2 f32 and K3 f32 (fp32 operands) take head dims up to this
F32_MAX_HEAD_DIM = 256
# K2's and K3's first (mma.sync) design takes head dims up to this (its C
# entry refuses more)
MMA_SYNC_MAX_HEAD_DIM = 160
# what a head dim above each limit is, in ROADMAP.md
BF16_GAP = ("head dims above 256 (the reference's kernel takes any "
            "multiple of 128) are ROADMAP.md queue 2's domain gap 2")
F32_GAP = ("fp32 operands at head dims above 256 (the reference's kernel "
           "takes any multiple of 128) are ROADMAP.md queue 2's domain gap "
           "2")


class SegmentIds(NamedTuple):
    q: torch.Tensor   # int [B, Sq]
    kv: torch.Tensor  # int [B, Sk]


def _masked_logits(q, k, causal, segment_ids, scale):
    """fp32 logits [B, Hkv, G, Sq, Sk] with -inf where masked, and the
    mask [B|1, 1, 1, Sq, Sk]."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (torch.arange(Sq, device=q.device)[:, None]
                       >= torch.arange(Sk, device=q.device)[None, :])
    if segment_ids is not None:
        mask = mask & (segment_ids.q[:, :, None] == segment_ids.kv[:, None, :])
    mask = mask[:, None, None]
    return logits.masked_fill(~mask, float("-inf")), mask


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              segment_ids: Optional[SegmentIds] = None,
                              scale: Optional[float] = None,
                              return_lse: bool = False,
                              p_bf16: bool = False):
    """The plain version of K1, in fp32: same masks, same GQA mapping, and
    0 for a fully masked row. Returns q's dtype; with ``return_lse`` also
    the fp32 [B, Hq, Sq] natural-log LSE (0 for a fully masked row). With
    ``p_bf16`` P is rounded to bf16 before P·V, where K1 rounds it (see
    ``plain_attention_p_bf16``)."""
    B, Sq, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    logits, _ = _masked_logits(q, k, causal, segment_ids, scale)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    if p_bf16:
        p = p.bfloat16().float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), 0.0)
    return out, lse.reshape(B, Hq, Sq)


def plain_attention_p_bf16(q, k, v, **kw):
    """The bf16 control: K1's plain version with P rounded to bf16 before
    P·V, where K1 rounds it. Against the plain version it shows what that
    rounding alone moves, beside what K1 moves."""
    return flash_attention_reference(q, k, v, p_bf16=True, **kw)


def _probs(q, k, lse, causal, segment_ids, scale):
    """P [B, Hkv, G, Sq, Sk] recomputed from the LSE, 0 where masked."""
    B, Sq, Hq, _ = q.shape
    Hkv = k.shape[2]
    logits, mask = _masked_logits(q, k, causal, segment_ids, scale)
    p = torch.exp(logits - lse.float().reshape(B, Hkv, Hq // Hkv, Sq, 1))
    return p.masked_fill(~mask, 0.0)


def _dscores(q, k, v, do, lse, delta, causal, segment_ids, scale):
    """(P, dS = P∘(dO·Vᵀ − δ)), both [B, Hkv, G, Sq, Sk] fp32."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    p = _probs(q, k, lse, causal, segment_ids, scale)
    dof = do.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    ds = p * (dp - delta.float().reshape(B, Hkv, Hq // Hkv, Sq, 1))
    return p, ds


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal: bool = False,
                           segment_ids: Optional[SegmentIds] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of K2, in fp32: dQ = scale·dS·K. Returns q's
    dtype."""
    B, Sq, Hq, D = q.shape
    if scale is None:
        scale = D ** -0.5
    _, ds = _dscores(q, k, v, do, lse, delta, causal, segment_ids, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    return dq.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *,
                            causal: bool = False,
                            segment_ids: Optional[SegmentIds] = None,
                            scale: Optional[float] = None):
    """The plain version of K3, in fp32: dK = scale·Σ dSᵀ·Q and
    dV = Σ Pᵀ·dO over each KV head's query heads. Returns k's and v's
    dtypes."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    p, ds = _dscores(q, k, v, do, lse, delta, causal, segment_ids, scale)
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    dof = do.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO∘O) in fp32, [B, Hq, Sq] (the reference's ``di``).

    On the GPU, for bf16 or fp16 o and dO, one batched product per
    position, O[b, s] (Hq × D) · dO[b, s]ᵀ with fp32 output, whose diagonal
    is δ: the products of two bf16 values are exact in fp32 and sum in
    fp32, as the reference's, and neither tensor is copied to fp32 (the
    Hq× extra flops cost less than those copies' bytes)."""
    if o.is_cuda and o.dtype in (torch.bfloat16, torch.float16) \
            and do.dtype == o.dtype:
        B, S, H, D = o.shape
        m = torch.bmm(o.reshape(B * S, H, D),
                      do.reshape(B * S, H, D).transpose(1, 2),
                      out_dtype=torch.float32)
        return m.diagonal(dim1=1, dim2=2).reshape(B, S, H).transpose(
            1, 2).contiguous()
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = False,
                                  segment_ids: Optional[SegmentIds] = None,
                                  scale: Optional[float] = None):
    """The plain twin of K2 + K3: (dq, dk, dv) from the forward's output
    and LSE, with P recomputed from the LSE."""
    kw = dict(causal=causal, segment_ids=segment_ids, scale=scale)
    delta = attention_delta(o, do)
    dq = flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


def padded_head_dim(D: int) -> int:
    """The head dim K1, K2 and K3 compute at for D (a multiple of 8): D
    rounded up to 16, the wgmma k-granule, up to 160; above, 192 or 256
    (the mirror of ``padded_dp`` in ``csrc/hopper.cuh``)."""
    if D <= NARROW_HEAD_DIM:
        return -(-D // 16) * 16
    return next(w for w in WIDE_HEAD_DIMS if D <= w)


def _check(q, k, v, segment_ids, name="flash_attention",
           dtype=torch.bfloat16):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{name}: q, k, v must all be on the GPU")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        _check_bshd(t, nm, name, dtype)
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % "
                         f"{k.shape[2]}")
    if dtype == torch.float32:
        _check_head_dim(D, F32_MAX_HEAD_DIM, name, F32_GAP)
    else:
        _check_head_dim(D, MAX_HEAD_DIM, name, BF16_GAP)
    if segment_ids is not None:
        if (segment_ids.q.shape != (B, Sq)
                or segment_ids.kv.shape != (B, k.shape[1])):
            raise ValueError("segment ids must be [B, Sq] and [B, Sk]")


def _check_head_dim(D, max_head_dim, name, gap):
    if D % 8 or not 8 <= D <= max_head_dim:
        raise ValueError(f"head dim {D}: {name} takes multiples of 8 up to "
                         f"{max_head_dim}" + (f"; {gap}" if D > max_head_dim
                                              else ""))


def _check_bshd(t, nm, name, dtype=torch.bfloat16):
    if t.dtype != dtype:
        raise TypeError(f"{name} kernel takes {dtype}, got {nm}.dtype="
                        f"{t.dtype}")
    if t.ndim != 4 or t.stride(3) != 1:
        raise ValueError(f"{nm} must be [B, S, H, D] with unit last stride, "
                         f"got {tuple(t.shape)} strides {t.stride()}")
    # 16 bytes: 8 bf16 or 4 fp32 elements
    per = 16 // t.element_size()
    if any(s % per for s in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{nm}: strides must be multiples of {per} and the "
                         "base 16-byte aligned (16-byte loads, TMA tensor "
                         "maps)")


def _segments(segment_ids, device):
    """int32 contiguous (q, kv) segment ids, or (None, None)."""
    if segment_ids is None:
        return None, None
    return (segment_ids.q.to(device=device, dtype=torch.int32).contiguous(),
            segment_ids.kv.to(device=device, dtype=torch.int32).contiguous())


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


_entry: dict = {}


def _fn(library: str, symbol: str, argtypes):
    """A kernel's C entry point, built, loaded and typed on first use."""
    key = (library, symbol)
    if key not in _entry:
        from mllm_npu_tpu_torch.utils.cuda_build import load
        fn = getattr(load(library), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry[key] = fn
    return _entry[key]


_FWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# K1's two tile shapes: query rows per block, which are also the keys per
# K/V tile (64 rows for each consumer warpgroup)
K1_BLOCK_Q = (64, 128)
K1_WARP_ROWS = 16   # query rows per consumer warp
# the shared memory one block may use on an H100 (227 KB)
K1_MAX_SMEM = 232448


def k1_smem_bytes(block_q: int, D: int) -> int:
    """Shared memory of one K1 block (the mirror of ``Cfg::SMEM`` in
    ``csrc/flash_fwd.cu``): two Q stages and two stages each of K and V,
    ``block_q`` rows of the padded head dim (:func:`padded_head_dim`) in
    bf16, then each K stage's segment ids and their min and max, the
    mbarriers, and 1024 bytes to align the base for the 128-byte
    swizzle."""
    tile = block_q * padded_head_dim(D) * 2
    seg = (2 * (block_q + 2) * 4 + 7) // 8 * 8
    return 2 * tile + 4 * tile + seg + 8 * (4 + 4 * 2) + 1024


def k1_block_q(B: int, Sq: int, Hq: int, num_sms: int, D: int = 128) -> int:
    """K1's tile shape for a call: 128 query rows per block (two consumer
    warpgroups, one block per SM, 128-key tiles) where that grid fills the
    card's SMs and its shared memory fits (not at D > 144), else 64 (one
    warpgroup, 64-key tiles; two blocks per SM where they fit), so that a
    short or narrow call still spreads over the card."""
    if (Sq > 64 and B * Hq * -(-Sq // 128) >= num_sms
            and k1_smem_bytes(128, D) <= K1_MAX_SMEM):
        return 128
    return 64


def k1_plan(B: int, Sq: int, Hq: int, D: int, num_sms: int):
    """K1's plan for a call: (query rows a block, shared memory a block in
    bytes). Raises for a head dim the kernel does not take and for a tile
    shape whose shared memory does not fit."""
    _check_head_dim(D, MAX_HEAD_DIM, "flash_attention", BF16_GAP)
    block_q = k1_block_q(B, Sq, Hq, num_sms, D)
    smem = k1_smem_bytes(block_q, D)
    if smem > K1_MAX_SMEM:
        raise ValueError(f"flash_attention: {block_q} query rows a block at "
                         f"head dim {D} need {smem} bytes of shared memory, "
                         f"over {K1_MAX_SMEM}")
    return block_q, smem


def k1_head_split(D: int):
    """(hi, lo): the head-dim columns K1 loads in 64-column boxes under the
    128-byte swizzle and in 16-column boxes under the 32-byte swizzle.
    ``hi + lo`` is the padded head dim (:func:`padded_head_dim`); TMA
    fills the columns past D with zeros (72 → 64 + 16, 168 → 192 + 0)."""
    dp = padded_head_dim(D)
    return dp // 64 * 64, dp % 64


def k1_kv_tiles(q0: int, block_q: int, Sq: int, Sk: int,
                causal: bool) -> int:
    """K/V tiles a block of query rows [q0, q0 + block_q) loads: all of
    them, or with ``causal`` up to the one that holds the diagonal of its
    last row."""
    n = -(-Sk // block_q)
    if causal:
        n = min(n, (min(q0 + block_q, Sq) - 1) // block_q + 1)
    return n


def k1_needs_mask(row0: int, k0: int, block_k: int, Sk: int, causal: bool,
                  q_ids: Optional[torch.Tensor] = None,
                  kv_ids: Optional[torch.Tensor] = None) -> bool:
    """Whether K1 runs the elementwise mask for one warp's query rows
    [row0, row0 + 16) on the K/V tile [k0, k0 + block_k): the tile holds
    keys past Sk, crosses the causal diagonal of the warp's rows, or (with
    segment ids: ``q_ids`` of the warp's rows below Sq, ``kv_ids`` of the
    tile's keys below Sk) holds any segment but the warp's single one. The
    mirror of the test in ``csrc/flash_fwd.cu``; every other tile takes
    the unmasked path."""
    if k0 + block_k > Sk or (causal and k0 + block_k - 1 > row0):
        return True
    if q_ids is None:
        return False
    if q_ids.numel() == 0:
        return True
    lo = int(q_ids.min())
    return not (lo == int(q_ids.max()) == int(kv_ids.min())
                == int(kv_ids.max()))


_num_sms: dict = {}


def _sms(device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _num_sms:
        _num_sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _num_sms[index]


def flash_attention(q, k, v, *, causal: bool = False,
                    segment_ids: Optional[SegmentIds] = None,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """GQA flash attention forward; q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
    → [B, Sq, Hq, D], and with ``return_lse`` also the fp32 [B, Hq, Sq]
    LSE. ``scale`` defaults to ``D ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         segment_ids=segment_ids,
                                         scale=scale, return_lse=return_lse)
    if q.dtype == torch.float32:
        return _flash_f32(q, k, v, causal, segment_ids, scale,
                          return_lse=return_lse, passes=3)
    _check(q, k, v, segment_ids)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    block_q, _ = k1_plan(B, Sq, Hq, D, _sms(q.device))
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and Sq and not Sk:         # no key: every row is fully masked
        out.zero_()
        if lse is not None:
            lse.zero_()
    elif B and Sq:
        qseg, kseg = _segments(segment_ids, q.device)
        err = _fn(KERNEL, "flash_fwd_bf16", _FWD_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(lse), _ptr(qseg), _ptr(kseg),
            B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3],
            float(scale), int(bool(causal)), block_q,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error "
                               f"{err}")
        flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.f32_launches = 0       # K1 f32 (fp32 operands), no LSE
flash_attention.f32_lse_launches = 0   # K1 f32 writing its LSE (training)

F32_KERNEL = "flash_fwd_f32"
_F32_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])

# K1 f32 (``csrc/flash_fwd_f32.cu``): query rows a block, keys a K/V tile,
# warps a block (16 query rows each, the whole of O's columns), the row
# padding of its Q and K tiles and of its V tiles (floats)
K1_F32_BLOCK = 64
K1_F32_TILE = 32
K1_F32_WARPS = 4
K1_F32_PAD = 4
K1_F32_V_PAD = 8


class K1F32Plan(NamedTuple):
    dp: int          # the head dim the kernel computes at
    warps: int       # warps a block
    smem: int        # bytes of shared memory a block takes


def k1_f32_plan(D: int) -> K1F32Plan:
    """K1 f32's plan for head dim D (a multiple of 8 up to 256, or
    raise), the mirror of ``smem_floats`` in ``csrc/flash_fwd_f32.cu``:
    Q (64 rows) resident, two stages of K (32 rows, D padded plus 4 floats)
    and of V (plus 8), a 16 × 36 patch of P a warp and two stages of 32 key
    ids, at :func:`padded_head_dim`. The wrapper hands ``smem`` to the
    kernel, which refuses a plan that differs from its own."""
    _check_head_dim(D, F32_MAX_HEAD_DIM, "flash_attention (fp32)", F32_GAP)
    dp = padded_head_dim(D)
    floats = ((K1_F32_BLOCK + 2 * K1_F32_TILE) * (dp + K1_F32_PAD)
              + 2 * K1_F32_TILE * (dp + K1_F32_V_PAD)
              + K1_F32_WARPS * 16 * (K1_F32_TILE + K1_F32_PAD)
              + 2 * K1_F32_TILE)
    plan = K1F32Plan(dp, K1_F32_WARPS, 4 * floats)
    if plan.smem > K1_MAX_SMEM:
        raise ValueError(f"flash_attention (fp32): head dim {D} needs "
                         f"{plan.smem} bytes of shared memory a block, over "
                         f"{K1_MAX_SMEM}")
    return plan


def _flash_f32(q, k, v, causal, segment_ids, scale, *, return_lse: bool,
               passes: int):
    """One launch of K1 f32 (``csrc/flash_fwd_f32.cu``) on CUDA tensors:
    fp32 q/k/v [B, S, H, D] (strides multiples of 4, 16-byte aligned
    bases) → fp32 [B, Sq, Hq, D], and with ``return_lse`` the fp32
    [B, Hq, Sq] natural-log LSE (0 for a row with no visible key).
    ``passes`` 3 is split TF32, fp32-accurate (the kernel); 1 is one-pass
    TF32, the control that ``chip_smoke.py`` and the card tests hold
    against the tolerance, never a serving or training path, whose
    launches are not counted."""
    _check(q, k, v, segment_ids, dtype=torch.float32)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B and Sq and not Sk:         # no key: every row is fully masked
        out.zero_()
        if lse is not None:
            lse.zero_()
    elif B and Sq:
        qseg, kseg = _segments(segment_ids, q.device)
        err = _fn(F32_KERNEL, "flash_fwd_f32", _F32_ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _ptr(lse), _ptr(qseg), _ptr(kseg), B, Sq, Sk, Hq, Hkv, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], float(scale), int(bool(causal)), passes,
            k1_f32_plan(D).smem,
            torch.cuda.current_stream(q.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flash_fwd_f32 launch failed: CUDA error "
                               f"{err}")
        if passes == 3 and return_lse:
            flash_attention.f32_lse_launches += 1
        elif passes == 3:
            flash_attention.f32_launches += 1
    return (out, lse) if return_lse else out


def flash_attention_f32_one_pass(q, k, v, *, causal: bool = False,
                                 segment_ids: Optional[SegmentIds] = None,
                                 scale: Optional[float] = None,
                                 return_lse: bool = False):
    """K1 f32 with one TF32 pass per product (big·big alone): the control
    that shows the tolerance K1 f32 is held to has power. Never on a
    serving or training path; not counted."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_f32(q, k, v, causal, segment_ids, scale,
                      return_lse=return_lse, passes=1)

BWD_KERNEL = "flash_bwd"
_BWD_DQ_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_BWD_DKV_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# K2/K3's Hopper regime: rows of every tile (K2's query rows and K/V tiles,
# K3's keys and query tiles), rows per consumer warp, the least head dim
K23_TILE = 64
K23_WARP_ROWS = 16
K23_MIN_HEAD_DIM = 32


def k23_regime(D: int) -> str:
    """K2's and K3's regime for head dim D (a multiple of 8 up to 256, or
    raise): ``"wgmma"``, the Hopper kernels (TMA rings, wgmma, one consumer
    warpgroup of 64 rows, two blocks per SM where their shared memory
    allows; above a padded 128, K3 with two consumer warpgroups, one for dV
    and one for dK; above 160 at :func:`padded_head_dim`'s 192 or 256), from
    32 on; ``"mma_sync"``, their first design (head dims up to 160),
    below."""
    _check_head_dim(D, K23_MAX_HEAD_DIM, "flash_bwd", BF16_GAP)
    return "wgmma" if D >= K23_MIN_HEAD_DIM else "mma_sync"


def _disjoint(a: torch.Tensor, b: torch.Tensor) -> bool:
    return int(a.max()) < int(b.min()) or int(a.min()) > int(b.max())


def k2_kv_tiles(q0: int, Sq: int, Sk: int, causal: bool,
                q_ids: Optional[torch.Tensor] = None,
                kv_ids: Optional[torch.Tensor] = None) -> list:
    """The 64-key K/V tiles (indices, in order) K2 visits for the query
    rows [q0, q0 + 64): up to the causal diagonal of the last row,
    less, with segment ids (one batch row's ``q_ids`` [Sq] and ``kv_ids``
    [Sk]), those whose kv-id range over the keys below Sk is disjoint from
    the q-id range of the rows below Sq; if none is left, the last. The
    mirror of the producer's walk in ``csrc/flash_bwd.cu``."""
    n = -(-Sk // K23_TILE)
    if causal:
        n = min(n, (min(q0 + K23_TILE, Sq) - 1) // K23_TILE + 1)
    if q_ids is None:
        return list(range(n))
    rows = q_ids[q0:min(q0 + K23_TILE, Sq)]
    kept = [j for j in range(n) if not _disjoint(
        rows, kv_ids[j * K23_TILE:min((j + 1) * K23_TILE, Sk)])]
    return kept or [n - 1]


def k3_q_tiles(k0: int, Sq: int, Sk: int, causal: bool,
               q_ids: Optional[torch.Tensor] = None,
               kv_ids: Optional[torch.Tensor] = None) -> list:
    """The 64-row query tiles (indices, in order) K3 visits for the keys
    [k0, k0 + 64), each once per query head of the group: from the
    first that reaches the keys (causal; at least the last tile) on, less,
    with segment ids, those whose q-id range is disjoint from the keys'
    kv-id range; if none is left, the last. The mirror of the producer's
    walk in ``csrc/flash_bwd.cu``."""
    nq = -(-Sq // K23_TILE)
    first = min(k0 // K23_TILE, nq - 1) if causal else 0
    if q_ids is None:
        return list(range(first, nq))
    keys = kv_ids[k0:min(k0 + K23_TILE, Sk)]
    kept = [i for i in range(first, nq) if not _disjoint(
        q_ids[i * K23_TILE:min((i + 1) * K23_TILE, Sq)], keys)]
    return kept or [nq - 1]


def k3_needs_mask(key0: int, q0: int, Sq: int, causal: bool,
                  kv_ids: Optional[torch.Tensor] = None,
                  q_ids: Optional[torch.Tensor] = None) -> bool:
    """Whether K3 runs the elementwise mask for one warp's keys
    [key0, key0 + 16) on the query tile [q0, q0 + 64): the tile holds rows
    past Sq, crosses the causal diagonal of the warp's keys, or (with
    segment ids: ``kv_ids`` of the warp's keys below Sk, ``q_ids`` of the
    tile's rows below Sq) holds any segment but the warp's single one. The
    mirror of the test in ``csrc/flash_bwd.cu``. (K2's rule is K1's,
    :func:`k1_needs_mask` with ``block_k`` 64.)"""
    if q0 + K23_TILE > Sq or (causal and key0 + K23_WARP_ROWS - 1 > q0):
        return True
    if kv_ids is None:
        return False
    if kv_ids.numel() == 0:
        return True
    lo = int(kv_ids.min())
    return not (lo == int(kv_ids.max()) == int(q_ids.min())
                == int(q_ids.max()))


# K2 f32 / K3 f32 (``csrc/flash_bwd_f32.cuh``). Their route by padded head
# dim: wgmma up to K23_F32_WGMMA_MAX_DP, mma.sync above. The mma.sync
# route's rows of a block (K2's query rows, K3's keys), rows of a streamed
# tile (K2's keys, K3's query rows), and above which padded head dim the
# streamed tile is K23_F32_WIDE_TILE rows instead (at 256 two stages of
# 32-row tiles do not fit), the row padding of every shared tile (floats)
# and K3's warps there (four for dV, four for dK). The wgmma route's rows a
# consumer warpgroup, and its tiles: 32 rows, 16 where 32 do not fit.
K23_F32_BLOCK = 64
K23_F32_TILE = 32
K23_F32_WIDE_TILE = 16
K23_F32_WIDE_TILE_ABOVE = 192
K23_F32_PAD = 4
K3_F32_WARPS = 8
K23_F32_WGMMA_MAX_DP = 128
K23_F32_GROUP_ROWS = 64


class K23F32Plan(NamedTuple):
    dp: int          # the head dim the kernels compute at
    route: str       # "wgmma" (padded head dim up to 128) or "mma_sync"
    k2_rows: int     # query rows a K2 f32 block
    k2_tile: int     # keys a streamed K/V tile
    k2_smem: int     # bytes of shared memory a K2 f32 block takes
    k3_rows: int     # keys a K3 f32 block
    k3_tile: int     # query rows a streamed Q/dO tile
    k3_warps: int    # warps a K3 f32 block
    k3_smem: int     # bytes a K3 f32 block takes


def _k2_wgmma_floats(dp: int, groups: int, tile: int) -> int:
    # Q and dO resident, split; K, V and the permuted Kᵀ of a tile, split;
    # the raw K and V tile; two stages of key ids
    return (4 * K23_F32_GROUP_ROWS * groups * dp + 6 * tile * dp
            + 2 * tile * (dp + K23_F32_PAD) + 2 * tile)


def _k3_wgmma_floats(dp: int, groups: int, tile: int) -> int:
    # K and V resident, split; Q, dO, Qᵀ and dOᵀ of a tile, split; the raw
    # Q and dO tile; two stages of LSEs, δs and query ids
    return (4 * K23_F32_GROUP_ROWS * groups * dp + 8 * tile * dp
            + 2 * tile * (dp + K23_F32_PAD) + 3 * 2 * tile)


def _wgmma_choice(floats, dp: int):
    """(groups, tile, bytes): two consumer warpgroups and 32-row tiles
    where they fit, else one warpgroup, else 16-row tiles (``K2W`` /
    ``K3W`` in ``csrc/flash_bwd_f32.cuh``)."""
    groups = 2 if 4 * floats(dp, 2, K23_F32_TILE) <= K1_MAX_SMEM else 1
    tile = (K23_F32_TILE if 4 * floats(dp, groups, K23_F32_TILE)
            <= K1_MAX_SMEM else K23_F32_WIDE_TILE)
    return groups, tile, 4 * floats(dp, groups, tile)


def k23_f32_plan(D: int) -> K23F32Plan:
    """K2 f32's and K3 f32's plan for head dim D (a multiple of 8 up to
    256, or raise), the mirror of ``csrc/flash_bwd_f32.cuh``.

    Up to a padded head dim of 128 the wgmma route (``K2W``, ``K3W``):
    blocks of one or two consumer warpgroups of 64 rows (two where their
    shared memory fits), K2 keeping Q and dO and K3 K and V resident as
    TF32 big and small parts, streaming tiles of ``k2_tile`` keys /
    ``k3_tile`` query rows (32, or 16 where 32 do not fit) through one raw
    cp.async stage that each tile's split pass turns into the layouts its
    products read. Above, the mma.sync route (``tile_rows``,
    ``k2_smem_floats``, ``k3_smem_floats``): K2 keeps Q and dO (64 rows
    each) and two stages of K and V (32 rows, 16 at a padded 256), K3 K and
    V and two stages of Q and dO, every row :func:`padded_head_dim` plus 4
    floats; a 16 × (tile + 4) patch a warp; K2 two stages of key ids, K3
    two of LSEs, δs and query ids; K3 eight warps. The wrappers hand
    ``k2_smem`` / ``k3_smem`` to the kernels, which refuse a plan that
    differs from theirs."""
    _check_head_dim(D, F32_MAX_HEAD_DIM, "flash_bwd (fp32)", F32_GAP)
    dp = padded_head_dim(D)
    if dp <= K23_F32_WGMMA_MAX_DP:
        g2, t2, s2 = _wgmma_choice(_k2_wgmma_floats, dp)
        g3, t3, s3 = _wgmma_choice(_k3_wgmma_floats, dp)
        plan = K23F32Plan(dp, "wgmma", K23_F32_GROUP_ROWS * g2, t2, s2,
                          K23_F32_GROUP_ROWS * g3, t3, 4 * g3, s3)
    else:
        tile = (K23_F32_WIDE_TILE if dp > K23_F32_WIDE_TILE_ABOVE
                else K23_F32_TILE)
        rows = (2 * K23_F32_BLOCK + 4 * tile) * (dp + K23_F32_PAD)
        patch = 16 * (tile + K23_F32_PAD)
        plan = K23F32Plan(
            dp, "mma_sync", K23_F32_BLOCK, tile,
            4 * (rows + 4 * patch + 2 * tile), K23_F32_BLOCK, tile,
            K3_F32_WARPS, 4 * (rows + K3_F32_WARPS * patch + 3 * 2 * tile))
    if max(plan.k2_smem, plan.k3_smem) > K1_MAX_SMEM:
        raise ValueError(f"flash_bwd (fp32): head dim {D} needs "
                         f"{max(plan.k2_smem, plan.k3_smem)} bytes of shared "
                         f"memory a block, over {K1_MAX_SMEM}")
    return plan


def k23_f32_tile_perm(tile: int) -> list:
    """The rows of a streamed tile in the order the wgmma route's
    transposed copies hold them (``split_cols`` in
    ``csrc/flash_bwd_f32.cuh``): within each group of 8, slot s < 4 holds
    row 2s and slot s >= 4 row 2(s − 4) + 1. With it an accumulator's
    columns 2t and 2t + 1 of a chunk are the next product's A fragment at
    k = t and t + 4."""
    return [8 * (s // 8) + (2 * (s % 8) if s % 8 < 4 else 2 * (s % 8 - 4) + 1)
            for s in range(tile)]


def k2_f32_kv_tiles(q0: int, Sq: int, Sk: int, causal: bool,
                    tile: int = K23_F32_TILE,
                    rows: int = K23_F32_BLOCK) -> list:
    """The ``tile``-key K/V tiles (indices, in order; the plan's
    ``k2_tile``) K2 f32 visits for the query rows [q0, q0 + rows) (the
    plan's ``k2_rows``): all of them, or with ``causal`` up to the one that
    holds the diagonal of the last row below Sq. The mirror of ``n_kv`` in
    ``csrc/flash_bwd_f32.cu``; every tile is masked there."""
    n = -(-Sk // tile)
    if causal:
        n = min(n, (min(q0 + rows, Sq) - 1) // tile + 1)
    return list(range(n))


def k3_f32_q_tiles(k0: int, Sq: int, causal: bool,
                   tile: int = K23_F32_TILE) -> list:
    """The ``tile``-row query tiles (indices, in order; the plan's
    ``k3_tile``) K3 f32 visits for the keys of a block from k0 on, each
    once per query head of the group: all of them, or with ``causal`` from
    the first whose last row reaches k0 (none when no query row does). The
    mirror of ``qt0`` in ``csrc/flash_bwd_dkv_f32.cu``."""
    nq = -(-Sq // tile)
    first = min(k0 // tile, nq) if causal else 0
    return list(range(first, nq))


def _check_bwd(q, k, v, do, lse, delta, segment_ids, name,
               dtype=torch.bfloat16):
    _check(q, k, v, segment_ids, name, dtype)
    _check_bshd(do, "do", name, dtype)
    if do.shape != q.shape or not do.is_cuda:
        raise ValueError(f"{name}: do must be a GPU tensor shaped like q")
    B, Sq, Hq, _ = q.shape
    for nm, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (B, Hq, Sq)
                or not t.is_contiguous() or not t.is_cuda):
            raise ValueError(f"{name}: {nm} must be a contiguous fp32 GPU "
                             f"tensor [B, Hq, Sq] = {(B, Hq, Sq)}")


def _bwd_launch(library, symbol, argtypes, regime, q, k, v, do, lse, delta,
                outs, causal, segment_ids, scale):
    """One launch into ``outs`` of K2 or K3 (``library`` ``flash_bwd``,
    ``regime`` (wgmma,)) or of K2 f32 or K3 f32 (``flash_bwd_f32``,
    ``flash_bwd_dkv_f32``, ``regime`` (passes, the plan's shared-memory
    bytes)); error 1 is
    arguments the kernel refused."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    dq = outs[0] if len(outs) == 1 else None
    dk, dv = (outs if len(outs) == 2 else (None, None))
    strides = []
    for t in (q, k, v, do, dq, dk, dv):
        strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    qseg, kseg = _segments(segment_ids, q.device)
    err = _fn(library, symbol, argtypes)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(qseg), _ptr(kseg),
        *[t.data_ptr() for t in outs],
        B, Sq, Sk, Hq, Hkv, D, (ctypes.c_longlong * 21)(*strides),
        float(scale), int(bool(causal)), *(int(x) for x in regime),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


BWD_F32_KERNEL = "flash_bwd_f32"          # K2 f32
BWD_DKV_F32_KERNEL = "flash_bwd_dkv_f32"  # K3 f32
_BWD_F32_TAIL = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                 ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_F32_DQ_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + _BWD_F32_TAIL
_BWD_F32_DKV_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                     + _BWD_F32_TAIL)


def _dq(q, k, v, do, lse, delta, causal, segment_ids, scale, passes=3):
    """K2 on CUDA tensors: bf16 operands to K2, fp32 to K2 f32 (with
    ``passes`` 1 its uncounted one-pass control)."""
    kw = dict(causal=causal, segment_ids=segment_ids, scale=scale)
    f32 = q.dtype == torch.float32
    if passes != 3 and not f32:
        raise TypeError("flash_bwd_dq: the one-pass control takes fp32 "
                        "operands")
    _check_bwd(q, k, v, do, lse, delta, segment_ids, "flash_bwd_dq",
               torch.float32 if f32 else torch.bfloat16)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.shape[0] and q.shape[1] and not k.shape[1]:
        dq.zero_()                  # no key: every row is fully masked
    elif q.shape[0] and q.shape[1] and f32:
        _bwd_launch(BWD_F32_KERNEL, "flash_bwd_dq_f32", _BWD_F32_DQ_ARGS,
                    (passes, k23_f32_plan(q.shape[3]).k2_smem), q, k, v, do,
                    lse, delta, (dq,), **kw)
        flash_bwd_dq.f32_launches += passes == 3
    elif q.shape[0] and q.shape[1]:
        wgmma = k23_regime(q.shape[3]) == "wgmma"
        _bwd_launch(BWD_KERNEL, "flash_bwd_dq_bf16", _BWD_DQ_ARGS, (wgmma,),
                    q, k, v, do, lse, delta, (dq,), **kw)
        flash_bwd_dq.launches += 1
        flash_bwd_dq.wgmma_launches += wgmma
    return dq


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                 segment_ids: Optional[SegmentIds] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """K2: dQ [B, Sq, Hq, D] from q, k, v, dO, the forward's LSE and
    δ = rowsum(dO∘O) (fp32 [B, Hq, Sq] each); bf16 operands to K2, fp32
    ones to K2 f32 (``.f32_launches``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, causal=causal,
                                      segment_ids=segment_ids, scale=scale)
    return _dq(q, k, v, do, lse, delta, causal, segment_ids, scale)


flash_bwd_dq.launches = 0
flash_bwd_dq.wgmma_launches = 0
flash_bwd_dq.f32_launches = 0      # K2 f32 (fp32 operands)


def _dkv(q, k, v, do, lse, delta, causal, segment_ids, scale, passes=3):
    """K3 on CUDA tensors: bf16 operands to K3, fp32 to K3 f32 (with
    ``passes`` 1 its uncounted one-pass control)."""
    kw = dict(causal=causal, segment_ids=segment_ids, scale=scale)
    f32 = q.dtype == torch.float32
    if passes != 3 and not f32:
        raise TypeError("flash_bwd_dkv: the one-pass control takes fp32 "
                        "operands")
    _check_bwd(q, k, v, do, lse, delta, segment_ids, "flash_bwd_dkv",
               torch.float32 if f32 else torch.bfloat16)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if k.shape[0] and k.shape[1] and not q.shape[1]:
        dk.zero_()                  # no query: no key is seen
        dv.zero_()
    elif k.shape[0] and k.shape[1] and f32:
        _bwd_launch(BWD_DKV_F32_KERNEL, "flash_bwd_dkv_f32",
                    _BWD_F32_DKV_ARGS,
                    (passes, k23_f32_plan(q.shape[3]).k3_smem), q, k, v, do,
                    lse, delta, (dk, dv), **kw)
        flash_bwd_dkv.f32_launches += passes == 3
    elif k.shape[0] and k.shape[1]:
        wgmma = k23_regime(q.shape[3]) == "wgmma"
        _bwd_launch(BWD_KERNEL, "flash_bwd_dkv_bf16", _BWD_DKV_ARGS,
                    (wgmma,), q, k, v, do, lse, delta, (dk, dv), **kw)
        flash_bwd_dkv.launches += 1
        flash_bwd_dkv.wgmma_launches += wgmma
    return dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                  segment_ids: Optional[SegmentIds] = None,
                  scale: Optional[float] = None):
    """K3: (dK, dV) [B, Sk, Hkv, D], each summed over the KV head's query
    heads, from the same inputs as :func:`flash_bwd_dq`; bf16 operands to
    K3, fp32 ones to K3 f32 (``.f32_launches``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta,
                                       causal=causal,
                                       segment_ids=segment_ids, scale=scale)
    return _dkv(q, k, v, do, lse, delta, causal, segment_ids, scale)


flash_bwd_dkv.launches = 0
flash_bwd_dkv.wgmma_launches = 0
flash_bwd_dkv.f32_launches = 0     # K3 f32 (fp32 operands)


def flash_bwd_dq_f32_one_pass(q, k, v, do, lse, delta, *,
                              causal: bool = False,
                              segment_ids: Optional[SegmentIds] = None,
                              scale: Optional[float] = None):
    """K2 f32 with one TF32 pass per product (big·big; on the wgmma route
    through the same sequence with the small parts zeroed): the control of
    the tolerance K2 f32 is held to. CUDA fp32 tensors only; never on a
    training path; not counted."""
    return _dq(q, k, v, do, lse, delta, causal, segment_ids,
               q.shape[-1] ** -0.5 if scale is None else scale, passes=1)


def flash_bwd_dkv_f32_one_pass(q, k, v, do, lse, delta, *,
                               causal: bool = False,
                               segment_ids: Optional[SegmentIds] = None,
                               scale: Optional[float] = None):
    """K3 f32 with one TF32 pass per product (see
    :func:`flash_bwd_dq_f32_one_pass`)."""
    return _dkv(q, k, v, do, lse, delta, causal, segment_ids,
                q.shape[-1] ** -0.5 if scale is None else scale, passes=1)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient (twin of ``_flash`` and its
    ``custom_vjp`` rules): K1 with the LSE forward, K2 and K3 backward on
    bf16 CUDA tensors, K1 f32 with the LSE, K2 f32 and K3 f32 on fp32 ones;
    the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, segment_ids, scale):
        o, lse = flash_attention(q, k, v, causal=causal,
                                 segment_ids=segment_ids, scale=scale,
                                 return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.segment_ids, ctx.scale = causal, segment_ids, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over a strided or expanded gradient
        do = do.to(q.dtype).contiguous()
        delta = attention_delta(o, do)
        kw = dict(causal=ctx.causal, segment_ids=ctx.segment_ids,
                  scale=ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, *, causal: bool = False,
                              segment_ids: Optional[SegmentIds] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """:class:`FlashAttention` with keyword arguments; ``scale`` defaults
    to ``D ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttention.apply(q, k, v, causal, segment_ids, float(scale))
