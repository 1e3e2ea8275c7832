"""SigLIP vision tower (twin of
``mllm_npu_tpu/models/multimodal_encoder/siglip_vit.py``), with HF
``SiglipVisionModel`` parameter names under ``vision_model.``.

so400m-patch14-384: 384 px / patch 14 → 27×27 = 729 tokens, width 1152,
27 layers, 16 heads (D=72), MLP 4304, gelu-tanh, learned positions,
final LayerNorm at eps 1e-6.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mllm_npu_tpu_torch.models.layers import LayerNorm
from mllm_npu_tpu_torch.models.vit_common import (ViTEncoder,
                                                  interpolate_abs_pos)


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    image_size: int = 384
    patch_size: int = 14
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def so400m_384(cls, **kw) -> "SigLIPConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "SigLIPConfig":
        kw.setdefault("image_size", 56)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("num_hidden_layers", 2)
        kw.setdefault("num_attention_heads", 4)
        return cls(**kw)


class SiglipEmbeddings(nn.Module):
    def __init__(self, cfg: SigLIPConfig, dtype):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size)
        self.position_embedding = nn.Embedding(cfg.num_patches,
                                               cfg.hidden_size)
        self.compute_dtype = dtype

    def forward(self, images):
        """images [B, H, W, 3] NHWC (the reference layout) → [B, L, C]."""
        cd = self.compute_dtype
        conv = self.patch_embedding
        x = F.conv2d(images.to(cd).permute(0, 3, 1, 2), conv.weight.to(cd),
                     conv.bias.to(cd), stride=conv.stride)
        x = x.flatten(2).transpose(1, 2)                # row-major patches
        pos = self.position_embedding.weight.to(cd)
        return x + interpolate_abs_pos(pos, x.shape[1])[None]


class SiglipVisionTransformer(nn.Module):
    def __init__(self, cfg: SigLIPConfig, dtype):
        super().__init__()
        self.embeddings = SiglipEmbeddings(cfg, dtype)
        self.encoder = ViTEncoder(cfg.hidden_size, cfg.num_hidden_layers,
                                  cfg.num_attention_heads,
                                  cfg.intermediate_size,
                                  ln_eps=cfg.layer_norm_eps,
                                  gelu_approx=True, dtype=dtype)
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        dtype)

    def forward(self, images):
        return self.post_layernorm(self.encoder(self.embeddings(images)))


class SigLIPVisionEncoder(nn.Module):
    """Images [B, H, W, 3] (NHWC, normalized) → tokens [B, L, width]."""

    def __init__(self, config: SigLIPConfig = SigLIPConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.config = config
        self.vision_model = SiglipVisionTransformer(config, dtype)

    def forward(self, images):
        return self.vision_model(images)
