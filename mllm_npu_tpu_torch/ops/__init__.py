"""Compute ops of the port; ``multi_head_attention`` is the one attention
entry point the models use (twin of ``mllm_npu_tpu/ops/__init__.py:97``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mllm_npu_tpu_torch.ops.attention import (decode_attention,
                                              dot_product_attention)
from mllm_npu_tpu_torch.ops.flash_attention import (
    SegmentIds, flash_attention, flash_attention_trainable)
from mllm_npu_tpu_torch.ops.norms import layer_norm, rms_norm
from mllm_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin

__all__ = ["SegmentIds", "apply_rope", "decode_attention",
           "dot_product_attention", "flash_attention",
           "flash_attention_trainable", "head_dim_padded", "kernel_head_dim",
           "layer_norm", "multi_head_attention", "rms_norm", "rope_cos_sin"]


def kernel_head_dim(D: int) -> int:
    """The head dim the flash kernels are handed for D: D itself when it
    is a multiple of 8 (at least 8), else D rounded up to one."""
    return max(8, -(-D // 8) * 8)


def head_dim_padded(attend, q, k, v, *, scale: Optional[float] = None,
                    **kw) -> torch.Tensor:
    """``attend(q, k, v, scale=..., **kw)`` on q, k and v zero-padded along
    D to :func:`kernel_head_dim` (new contiguous tensors), the output
    sliced back to D. The zero columns add nothing to QKᵀ and give zero
    output columns; ``scale`` defaults to the true D's ``D ** -0.5``. The
    pad (``F.pad``) and the slice are differentiable, so gradients come
    back sliced. The twin of the reference's head-dim padding into its
    kernel (``flash_attention_padded``)."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    pad = kernel_head_dim(D) - D

    def padded(t):
        return F.pad(t, (0, pad)).contiguous()
    return attend(padded(q), padded(k), padded(v), scale=scale,
                  **kw)[..., :D]


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = False,
                         segment_ids: Optional[SegmentIds] = None,
                         attn_mask: Optional[torch.Tensor] = None,
                         q_offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """BSHD attention. Every call without a dense ``attn_mask`` and with
    ``q_offset == 0`` goes to the flash kernels, whatever the sequence
    lengths and head dim: K1 alone (``flash_attention``) when no gradient
    is wanted, and :class:`FlashAttention` (K1 with its LSE forward, K2 and
    K3 backward, ``flash_attention_trainable``) when q, k or v needs one;
    the rest go to :func:`dot_product_attention`. The reference's
    Sq ≥ 128, %128 and pad-waste conditions were TPU lane-tiling limits and
    are not carried over. On the card, a head dim the kernels do not take
    (D % 8 != 0 or D < 8) goes through :func:`head_dim_padded`, as the
    reference pads D into its kernel."""
    if attn_mask is None and q_offset == 0:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            attend = flash_attention_trainable
        else:
            attend = flash_attention
        D = q.shape[-1]
        if q.is_cuda and kernel_head_dim(D) != D:
            return head_dim_padded(attend, q, k, v, causal=causal,
                                   segment_ids=segment_ids, scale=scale)
        return attend(q, k, v, causal=causal, segment_ids=segment_ids,
                      scale=scale)
    return dot_product_attention(
        q, k, v, causal=causal, attn_mask=attn_mask,
        q_segment_ids=None if segment_ids is None else segment_ids.q,
        kv_segment_ids=None if segment_ids is None else segment_ids.kv,
        q_offset=q_offset, scale=scale)
