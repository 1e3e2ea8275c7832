"""Rotary position embeddings with linear / NTK-dynamic scaling (twin of
``mllm_npu_tpu/ops/rope.py``). All trig in fp32; half-rotation
convention."""

from __future__ import annotations

from typing import Optional

import torch


def rope_inv_freq(head_dim: int, theta: float = 10000.0,
                  device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, *,
                 theta: float = 10000.0,
                 scaling_type: Optional[str] = None,
                 scaling_factor: float = 1.0,
                 max_position_embeddings: int = 4096):
    """positions: int [..., S] → cos/sin fp32 [..., S, head_dim]."""
    pos = positions.float()
    if scaling_type == "linear":
        pos = pos / scaling_factor
    elif scaling_type == "dynamic":
        # NTK-dynamic: rescale theta once the sequence exceeds the
        # training window (decided by the length of ``positions``)
        seq_len = positions.shape[-1]
        if seq_len > max_position_embeddings:
            alpha = (scaling_factor * seq_len / max_position_embeddings
                     - (scaling_factor - 1))
            theta = theta * alpha ** (head_dim / max(head_dim - 2, 1))
    inv_freq = rope_inv_freq(head_dim, theta, device=positions.device)
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor):
    """q/k: [B, S, H, D]; cos/sin: [B, S, D] or [S, D]."""
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
