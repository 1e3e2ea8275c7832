"""Compute ops of the port; ``multi_head_attention`` is the one attention
entry point the models use (twin of ``mllm_npu_tpu/ops/__init__.py:97``)."""

from __future__ import annotations

from typing import Optional

import torch

from mllm_npu_tpu_torch.ops.attention import (decode_attention,
                                              dot_product_attention)
from mllm_npu_tpu_torch.ops.flash_attention import (
    SegmentIds, flash_attention, flash_attention_trainable)
from mllm_npu_tpu_torch.ops.norms import layer_norm, rms_norm
from mllm_npu_tpu_torch.ops.rope import apply_rope, rope_cos_sin

__all__ = ["SegmentIds", "apply_rope", "decode_attention",
           "dot_product_attention", "flash_attention",
           "flash_attention_trainable", "layer_norm",
           "multi_head_attention", "rms_norm", "rope_cos_sin"]


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
    are not carried over."""
    if attn_mask is None and q_offset == 0:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return flash_attention_trainable(q, k, v, causal=causal,
                                             segment_ids=segment_ids,
                                             scale=scale)
        return flash_attention(q, k, v, causal=causal,
                               segment_ids=segment_ids, scale=scale)
    return dot_product_attention(
        q, k, v, causal=causal, attn_mask=attn_mask,
        q_segment_ids=None if segment_ids is None else segment_ids.q,
        kv_segment_ids=None if segment_ids is None else segment_ids.kv,
        q_offset=q_offset, scale=scale)
