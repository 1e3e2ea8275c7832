"""Shared ViT building blocks (twin of ``mllm_npu_tpu/models/vit_common.py``).

``TorchMHA`` keeps ``torch.nn.MultiheadAttention``'s parameter layout
(fused ``in_proj_weight``/``in_proj_bias`` and ``out_proj``), the layout of
the reference resampler's checkpoints. ``ViTBlock`` keeps HF SigLIP's
names (``layer_norm1``, ``self_attn.{q,k,v,out}_proj``, ``mlp.fc1/fc2``).
Both attend through ``ops.multi_head_attention`` (K1 on the GPU).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mllm_npu_tpu_torch import ops
from mllm_npu_tpu_torch.models.layers import LayerNorm, Linear


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """Frozen 2-D sin-cos position table [grid², D]."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)   # w first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


def interpolate_abs_pos(pos: torch.Tensor, tgt_len: int) -> torch.Tensor:
    """Bicubic-resize a square [L, C] position table to [tgt_len, C]
    (torch's bicubic, align_corners=False, in fp32 — the resize the
    reference's checkpoints were trained with)."""
    src = int(math.sqrt(pos.shape[0]))
    tgt = int(math.sqrt(tgt_len))
    if src == tgt:
        return pos
    grid = pos.float().reshape(src, src, -1).permute(2, 0, 1)[None]
    out = F.interpolate(grid, size=(tgt, tgt), mode="bicubic",
                        align_corners=False)
    return out[0].permute(1, 2, 0).reshape(tgt * tgt, -1).to(pos.dtype)


class TorchMHA(nn.Module):
    """``torch.nn.MultiheadAttention`` semantics and parameter layout
    (batch-first, bias on the in/out projections)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.compute_dtype = dtype

    def forward(self, q, k, v):
        E, H, cd = self.embed_dim, self.num_heads, self.compute_dtype
        w = self.in_proj_weight.to(cd)
        b = self.in_proj_bias.to(cd)
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        qh = F.linear(q.to(cd), w[:E], b[:E]).reshape(B, Lq, H, E // H)
        kh = F.linear(k.to(cd), w[E:2 * E], b[E:2 * E]).reshape(B, Lk, H,
                                                                E // H)
        vh = F.linear(v.to(cd), w[2 * E:], b[2 * E:]).reshape(B, Lk, H,
                                                              E // H)
        out = ops.multi_head_attention(qh, kh, vh, causal=False)
        return self.out_proj(out.reshape(B, Lq, E))


class ViTSelfAttention(nn.Module):
    """Self-attention with separate q/k/v/out projections (HF SigLIP)."""

    def __init__(self, width: int, heads: int, dtype):
        super().__init__()
        self.heads = heads
        self.q_proj = Linear(width, width, dtype=dtype)
        self.k_proj = Linear(width, width, dtype=dtype)
        self.v_proj = Linear(width, width, dtype=dtype)
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x):
        B, L, E = x.shape
        shape = (B, L, self.heads, E // self.heads)
        out = ops.multi_head_attention(
            self.q_proj(x).reshape(shape), self.k_proj(x).reshape(shape),
            self.v_proj(x).reshape(shape), causal=False)
        return self.out_proj(out.reshape(B, L, E))


class ViTMLP(nn.Module):
    def __init__(self, width: int, mlp_width: int, gelu_approx: bool, dtype):
        super().__init__()
        self.fc1 = Linear(width, mlp_width, dtype=dtype)
        self.fc2 = Linear(mlp_width, width, dtype=dtype)
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class ViTBlock(nn.Module):
    """Pre-LN transformer block: LN→MHA→res, LN→MLP(GELU)→res."""

    def __init__(self, width: int, heads: int, mlp_width: int,
                 ln_eps: float = 1e-6, gelu_approx: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.layer_norm1 = LayerNorm(width, ln_eps, dtype)
        self.self_attn = ViTSelfAttention(width, heads, dtype)
        self.layer_norm2 = LayerNorm(width, ln_eps, dtype)
        self.mlp = ViTMLP(width, mlp_width, gelu_approx, dtype)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class ViTEncoder(nn.Module):
    """A stack of ViTBlocks under ``layers`` (a loop replaces nn.scan)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_width: int,
                 ln_eps: float = 1e-6, gelu_approx: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            ViTBlock(width, heads, mlp_width, ln_eps, gelu_approx, dtype)
            for _ in range(layers))

    def forward(self, x):
        for block in self.layers:
            x = block(x)
        return x
