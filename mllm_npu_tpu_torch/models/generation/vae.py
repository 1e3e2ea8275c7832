"""AutoencoderKL, the SD/SDXL latent VAE (twin of
``mllm_npu_tpu/models/generation/vae.py:22-202``).

The decoder turns the denoised latents into the image; the encoder (image
→ moments) serves the editing path. ``VAEAttention``, the mid blocks'
single-head attention over every position (C = 512 over 16384 positions
at 1024²), is a plain ``q @ kᵀ`` with an fp32 softmax in the reference,
outside any Pallas kernel, and so here: its fp32 logits are 1 GiB at
1024².

NCHW with diffusers' module tree and parameter names
(``tests/diffusers_manifest.py``); ``utils/weights.py vae_from_jax``
moves the reference's NHWC parameters across.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from mllm_npu_tpu_torch.models.generation.unet import (Conv2d, GroupNorm,
                                                       UNetBlock, Upsample)
from mllm_npu_tpu_torch.models.layers import Linear

EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025   # SDXL; SD2.1 uses 0.18215

    @property
    def spatial_scale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def sdxl(cls, **kw) -> "VAEConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        kw.setdefault("block_out_channels", (16, 32))
        kw.setdefault("layers_per_block", 1)
        kw.setdefault("norm_num_groups", 8)
        return cls(**kw)


class VAEResnet(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, EPS, dtype)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(groups, cout, EPS, dtype)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, dtype=dtype)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int = 32, dtype=torch.float32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, EPS, dtype)
        self.to_q = Linear(channels, channels, dtype=dtype)
        self.to_k = Linear(channels, channels, dtype=dtype)
        self.to_v = Linear(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype=dtype),
                                     nn.Identity()])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        w = torch.softmax((q @ k.transpose(1, 2) * (C ** -0.5)).float(),
                          dim=-1).to(q.dtype)
        h = self.to_out[0](w @ v)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class VAEDownsample(nn.Module):
    """The stride-2 convolution on the input padded by one row and column
    at the bottom and right (the reference's ((0, 1), (0, 1)))."""

    def __init__(self, channels: int, dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


def _mid(c: int, g: int, dtype) -> UNetBlock:
    return UNetBlock([VAEResnet(c, c, g, dtype), VAEResnet(c, c, g, dtype)],
                    [VAEAttention(c, g, dtype)])


def _run_mid(mid: UNetBlock, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype=torch.float32):
        super().__init__()
        cfg, g = config, config.norm_num_groups
        ch = cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1,
                              dtype=dtype)
        cur = ch[0]
        self.down_blocks = nn.ModuleList()
        for bi, c in enumerate(ch):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VAEResnet(cur, c, g, dtype))
                cur = c
            down = VAEDownsample(c, dtype) if bi < len(ch) - 1 else None
            self.down_blocks.append(UNetBlock(resnets, downsample=down))
        self.mid_block = _mid(ch[-1], g, dtype)
        self.conv_norm_out = GroupNorm(g, ch[-1], EPS, dtype)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels, 3,
                               padding=1, dtype=dtype)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, dtype=torch.float32):
        super().__init__()
        cfg, g = config, config.norm_num_groups
        ch = tuple(reversed(config.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, ch[0], 3, padding=1,
                              dtype=dtype)
        self.mid_block = _mid(ch[0], g, dtype)
        cur = ch[0]
        self.up_blocks = nn.ModuleList()
        for bi, c in enumerate(ch):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VAEResnet(cur, c, g, dtype))
                cur = c
            up = Upsample(c, dtype) if bi < len(ch) - 1 else None
            self.up_blocks.append(UNetBlock(resnets, upsample=up))
        self.conv_norm_out = GroupNorm(g, ch[-1], EPS, dtype)
        self.conv_out = Conv2d(ch[-1], cfg.in_channels, 3, padding=1,
                               dtype=dtype)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Images and latents NCHW; images in [-1, 1]."""

    def __init__(self, config: VAEConfig = VAEConfig(), dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        lat = config.latent_channels
        self.encoder = Encoder(config, dtype)
        self.decoder = Decoder(config, dtype)
        self.quant_conv = Conv2d(2 * lat, 2 * lat, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(lat, lat, 1, dtype=dtype)

    def encode_moments(self, x):
        """→ [B, 2·latent, h, w]: the mean, then the log-variance."""
        return self.quant_conv(self.encoder(x.to(self.dtype)))

    def encode(self, x):
        """The posterior's mean (the reference's ``encode`` without a
        key)."""
        return self.encode_moments(x).chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
