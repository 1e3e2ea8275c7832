"""Qwen-VL vision tower (twin of
``mllm_npu_tpu/models/multimodal_encoder/qwenvl_vit.py``), with and without
its attention-pool head, under the reference's torch parameter names
(``conv1``, ``positional_embedding``, ``ln_pre``,
``transformer.resblocks.{i}.{ln_1, attn.in_proj, attn.out_proj, ln_2,
mlp.c_fc, mlp.c_proj}``, ``attn_pool.*``, ``ln_post``, ``proj``,
``patch_pos_embed``).

ViT-G-448 (SEED-X): 448 px / patch 14 → 32×32 = 1024 tokens, width 1664,
48 layers, 16 heads (D = 104), MLP 8192, erf GELU, LayerNorm eps 1e-6, a
256-entry position table resized bicubically to the 1024-token grid. The
pool is a 256-query attention resampler (32 heads of D = 128 over the
tower's 1664-wide tokens), then the optional four-corner patch position,
``ln_post`` and a square projection. Self-attention and the pool attend
through ``ops.multi_head_attention`` (K1 on the GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mllm_npu_tpu_torch import ops
from mllm_npu_tpu_torch.models.layers import LayerNorm, Linear
from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
    import AttentionResampler
from mllm_npu_tpu_torch.models.vit_common import interpolate_abs_pos


@dataclasses.dataclass(frozen=True)
class QwenViTConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_ratio: float = 4.9231
    n_queries: int = 256
    output_dim: int = 4096
    patch_pos: bool = False
    ln_eps: float = 1e-6
    # entries of the learned position table (256 in the reference),
    # resized bicubically to the token grid
    pos_embed_size: int = 256

    @property
    def mlp_width(self) -> int:
        return int(self.width * self.mlp_ratio)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def vit_g(cls, **kw) -> "QwenViTConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "QwenViTConfig":
        kw.setdefault("image_size", 56)
        kw.setdefault("width", 64)
        kw.setdefault("layers", 1)
        kw.setdefault("heads", 4)
        kw.setdefault("mlp_ratio", 1.0)
        kw.setdefault("n_queries", 16)
        kw.setdefault("output_dim", 128)
        kw.setdefault("pos_embed_size", 16)
        return cls(**kw)


class VisualAttention(nn.Module):
    """Self-attention with one fused ``in_proj`` [3E, E] and ``out_proj``."""

    def __init__(self, width: int, heads: int, dtype):
        super().__init__()
        self.heads = heads
        self.in_proj = Linear(width, 3 * width, dtype=dtype)
        self.out_proj = Linear(width, width, dtype=dtype)

    def forward(self, x):
        B, L, E = x.shape
        q, k, v = self.in_proj(x).reshape(B, L, 3, self.heads,
                                          E // self.heads).unbind(2)
        out = ops.multi_head_attention(q, k, v, causal=False)
        return self.out_proj(out.reshape(B, L, E))


class QwenMLP(nn.Module):
    def __init__(self, width: int, mlp_width: int, dtype):
        super().__init__()
        self.c_fc = Linear(width, mlp_width, dtype=dtype)
        self.c_proj = Linear(mlp_width, width, dtype=dtype)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: LN → attention → residual, LN → MLP (erf GELU) →
    residual."""

    def __init__(self, cfg: QwenViTConfig, dtype):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width, cfg.ln_eps, dtype)
        self.attn = VisualAttention(cfg.width, cfg.heads, dtype)
        self.ln_2 = LayerNorm(cfg.width, cfg.ln_eps, dtype)
        self.mlp = QwenMLP(cfg.width, cfg.mlp_width, dtype)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class TransformerStack(nn.Module):
    def __init__(self, cfg: QwenViTConfig, dtype):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualAttentionBlock(cfg, dtype)
                                       for _ in range(cfg.layers))

    def forward(self, x):
        for block in self.resblocks:
            x = block(x)
        return x


class VisionTransformer(nn.Module):
    """The tower alone: images [B, H, W, 3] (NHWC, normalized) → tokens
    [B, L, width]: a patch conv without bias, the resized position table,
    ``ln_pre`` and the blocks."""

    def __init__(self, config: QwenViTConfig = QwenViTConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.compute_dtype = dtype
        W, P = config.width, config.patch_size
        self.conv1 = nn.Conv2d(3, W, P, stride=P, bias=False)
        self.positional_embedding = nn.Parameter(
            torch.empty(config.pos_embed_size, W))
        self.ln_pre = LayerNorm(W, config.ln_eps, dtype)
        self.transformer = TransformerStack(config, dtype)

    def tokens(self, images):
        cd = self.compute_dtype
        x = F.conv2d(images.to(cd).permute(0, 3, 1, 2),
                     self.conv1.weight.to(cd), stride=self.conv1.stride)
        x = x.flatten(2).transpose(1, 2)                 # row-major patches
        x = x + interpolate_abs_pos(self.positional_embedding.to(cd),
                                    x.shape[1])[None]
        return self.transformer(self.ln_pre(x))

    def forward(self, images):
        return self.tokens(images)


class VisionTransformerWithAttnPool(VisionTransformer):
    """The tower and its pooling head: images → [B, n_queries, output_dim].
    ``patch_positions`` [B, 2] (normalized tile centres) add the four-corner
    position table where the config has one."""

    def __init__(self, config: QwenViTConfig = QwenViTConfig(),
                 dtype=torch.float32):
        super().__init__(config, dtype)
        out = config.output_dim
        self.attn_pool = AttentionResampler(
            grid_size=int(config.n_queries ** 0.5), embed_dim=out,
            num_heads=max(out // 128, 1), kv_dim=config.width,
            ln_eps=config.ln_eps, dtype=dtype)
        if config.patch_pos:
            self.patch_pos_embed = nn.Parameter(torch.empty(4, out))
        self.ln_post = LayerNorm(out, config.ln_eps, dtype)
        self.proj = nn.Parameter(torch.empty(out, out))

    @property
    def output_dim(self) -> int:
        return self.config.output_dim

    def forward(self, images, patch_positions: Optional[torch.Tensor] = None):
        cd = self.compute_dtype
        x = self.attn_pool(self.tokens(images))
        if self.config.patch_pos and patch_positions is not None:
            rel = torch.cat([patch_positions, 1 - patch_positions], -1) / 2
            x = x + (rel.to(cd) @ self.patch_pos_embed.to(cd))[:, None, :]
        return self.ln_post(x) @ self.proj.to(cd)
