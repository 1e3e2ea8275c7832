"""Perceiver-style attention resampler projector (twin of
``mllm_npu_tpu/models/multimodal_projector/attention_resampler.py``).

grid² learnable queries plus a frozen 2-D sin-cos table (added to the
queries and, bicubic-resized, to the keys), an optional ``kv_proj``,
LayerNorm (eps 1e-5) on queries and keys/values, and one torch-style
cross-attention. Maps encoder tokens [B, L, kv_dim] → [B, grid², E].
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mllm_npu_tpu_torch.models.layers import LayerNorm, Linear
from mllm_npu_tpu_torch.models.vit_common import (TorchMHA,
                                                  get_2d_sincos_pos_embed,
                                                  interpolate_abs_pos)


class AttentionResampler(nn.Module):
    def __init__(self, grid_size: int, embed_dim: int, num_heads: int,
                 kv_dim: Optional[int] = None, ln_eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.grid_size, self.embed_dim = grid_size, embed_dim
        self.compute_dtype = dtype
        E = embed_dim
        self.query = nn.Parameter(torch.empty(self.num_queries, E))
        self.kv_proj = (Linear(kv_dim, E, bias=False, dtype=dtype)
                        if kv_dim is not None and kv_dim != E else None)
        self.ln_kv = LayerNorm(E, ln_eps, dtype)
        self.ln_q = LayerNorm(E, ln_eps, dtype)
        self.attn = TorchMHA(E, num_heads, dtype)
        self._pos_tables: dict = {}

    def pos_tables(self, L: int, device):
        """The sin-cos table for the queries and its resize to ``L`` keys,
        made once per (L, device): they are constants."""
        key = (L, torch.device(device))
        if key not in self._pos_tables:
            pos = torch.from_numpy(get_2d_sincos_pos_embed(
                self.embed_dim, self.grid_size)).to(
                    device=device, dtype=self.compute_dtype)
            self._pos_tables[key] = (pos, interpolate_abs_pos(pos, L))
        return self._pos_tables[key]

    @property
    def num_queries(self) -> int:
        return self.grid_size ** 2

    def forward(self, x):
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        x = self.ln_kv(x)
        q = self.ln_q(self.query.to(self.compute_dtype))
        B, L, _ = x.shape
        pos, kv_pos = self.pos_tables(L, x.device)
        qb = (q + pos)[None].expand(B, -1, -1)
        return self.attn(qb, x + kv_pos[None], x)
