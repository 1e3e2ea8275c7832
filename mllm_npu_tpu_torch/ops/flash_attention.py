"""K1: flash-attention forward, a hand-written CUDA kernel for Hopper.

Replaces ``mllm_npu_tpu/ops/flash_attention.py:100 _fwd_kernel`` (launched
by ``_fwd`` :211, API ``flash_attention`` :697). It computes
``O = softmax(scale·QKᵀ + mask)·V`` with GQA (query head h reads KV head
``h·Hkv/Hq``), an optional causal mask (top-left aligned, as the
reference) and an optional segment-id mask (``q_seg == kv_seg``). A fully
masked row gives 0. Layout is the reference's public ``[B, S, H, D]``,
read through strides.

The kernel lives in ``csrc/flash_fwd.cu``; its design notes (bound on the
H100 and what the design does about it) are at the top of that file.
:func:`flash_attention` launches it for CUDA tensors and counts the launch
in ``flash_attention.launches``; for CPU tensors it computes the same
function with :func:`flash_attention_reference`, the plain version. There
is no fallback for CUDA tensors: a shape or type the kernel does not take
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

KERNEL = "flash_fwd"
MAX_HEAD_DIM = 128


class SegmentIds(NamedTuple):
    q: torch.Tensor   # int [B, Sq]
    kv: torch.Tensor  # int [B, Sk]


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              segment_ids: Optional[SegmentIds] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of K1, in fp32: same masks, same GQA mapping, and
    0 for a fully masked row. Returns q's dtype."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (torch.arange(Sq, device=q.device)[:, None]
                       >= torch.arange(Sk, device=q.device)[None, :])
    if segment_ids is not None:
        mask = mask & (segment_ids.q[:, :, None] == segment_ids.kv[:, None, :])
    mask = mask[:, None, None]                       # [B|1, 1, 1, Sq, Sk]
    logits = logits.masked_fill(~mask, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(l > 0, l, torch.ones_like(l))
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _check(q, k, v, segment_ids):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must all be on the GPU")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention kernel takes bf16, got "
                            f"{name}.dtype={t.dtype}")
        if t.ndim != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be [B, S, H, D] with unit "
                             f"last stride, got {tuple(t.shape)} "
                             f"strides {t.stride()}")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides must be multiples of 8 and "
                             "the base 16-byte aligned (16-byte tile loads)")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if Hq % k.shape[2]:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq} % "
                         f"{k.shape[2]}")
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the kernel takes multiples of 8 "
                         f"up to {MAX_HEAD_DIM}")
    if segment_ids is not None:
        if (segment_ids.q.shape != (B, Sq)
                or segment_ids.kv.shape != (B, k.shape[1])):
            raise ValueError("segment ids must be [B, Sq] and [B, Sk]")


_kernel_fn = None


def _library():
    """The kernel's C entry point, built, loaded and typed on first use."""
    global _kernel_fn
    if _kernel_fn is None:
        from mllm_npu_tpu_torch.utils.cuda_build import load
        fn = load(KERNEL).flash_fwd_bf16
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _kernel_fn = fn
    return _kernel_fn


def flash_attention(q, k, v, *, causal: bool = False,
                    segment_ids: Optional[SegmentIds] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA flash attention forward; q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D]
    → [B, Sq, Hq, D]. ``scale`` defaults to ``D ** -0.5``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         segment_ids=segment_ids,
                                         scale=scale)
    _check(q, k, v, segment_ids)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0:
        return out
    qseg = kseg = None
    if segment_ids is not None:
        qseg = segment_ids.q.to(device=q.device, dtype=torch.int32)
        kseg = segment_ids.kv.to(device=q.device, dtype=torch.int32)
        qseg, kseg = qseg.contiguous(), kseg.contiguous()
    err = _library()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        0 if qseg is None else qseg.data_ptr(),
        0 if kseg is None else kseg.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
