"""SDXL-class conditional UNet (twin of
``mllm_npu_tpu/models/generation/unet.py:34-520``).

The de-tokenizer's denoiser: added conditioning (the pooled embeds and
six micro-conditioning time ids, Fourier-embedded and merged into the
time embedding), cross-attention over ``encoder_hidden_states`` of width
2048 (the resampler's image tokens), and the IP-Adapter's decoupled image
cross-attention (``ip_num_image_tokens``, ``attention_processor.py``'s
``IPCrossAttention``, which every attention of the UNet is). Also the
SD-2.1 and SD-1.5 shapes (``UNetConfig.sd21``, ``sd15``), rank-r LoRA on
the attentions' ``lora_targets`` (``LoRALinear`` with α = r, as the
reference's ``LoRADense``: ``to_out`` then has no bias, as there), int8 /
int4 weights on the transformer blocks' projections (``quantization``,
``Int8Linear`` / ``Int4Linear`` with their biases: K4 / K5 on the GPU;
:func:`quantize_unet_params` converts a float state_dict) and ``remat``:
each resnet and transformer stage is recomputed in the backward pass
(``torch.utils.checkpoint``), where the reference rematerialises.

Every attention, self and cross, goes through ``ops.multi_head_attention``
without a mask: K1 (``csrc/flash_fwd.cu``) on the GPU, its plain fp32
version on the CPU. At 1024² that is D = 64 at S = 4096 (10 heads) and
S = 1024 (20 heads), and the cross-attention over the resampler's 64
tokens at the same query lengths: 140 launches a forward.

Layout: NCHW, the diffusers module tree and parameter names
(``tests/diffusers_manifest.py``), where the reference is NHWC with
flattened block names; ``utils/weights.py unet_from_jax`` moves the
reference's parameters across (HWIO → OIHW for the convolutions). Each
module computes in its ``dtype`` (parameters cast at use), normalisation
statistics in fp32. LoRA together with ``quantization`` raises: the
reference's ``quantize_unet_params`` quantizes the LoRA bases, which its
LoRA module then cannot read (ROADMAP, known issues of the reference).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mllm_npu_tpu_torch.models.generation.attention_processor import (
    IPCrossAttention, split_ip_context)
from mllm_npu_tpu_torch.models.language_models.llama import LoRALinear
from mllm_npu_tpu_torch.models.layers import LayerNorm, Linear
from mllm_npu_tpu_torch.ops.quant import (Int4Linear, Int8Linear,
                                          quantize_dense_params)

LN_EPS = 1e-6     # flax's LayerNorm default, the reference's
# the int4 UNet's group size along K (the reference's QuantDense default)
UNET_QUANT_GROUP = 256
# Linear layers outside the transformer blocks stay float under
# ``quantization`` (reference :515): the timestep MLPs and each resnet's
# time_emb_proj
UNET_QUANT_SKIP = ("time_embedding", "add_embedding", "time_emb_proj")


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple = (320, 640, 1280)
    down_block_types: tuple = ("DownBlock2D", "CrossAttnDownBlock2D",
                               "CrossAttnDownBlock2D")
    layers_per_block: int = 2
    transformer_layers_per_block: tuple = (1, 2, 10)
    num_attention_heads: tuple = (5, 10, 20)
    cross_attention_dim: int = 2048
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32
    # recompute each resnet and transformer stage in the backward pass
    remat: bool = True
    # LoRA (α = rank) on these attention projections
    lora_rank: int = 0
    lora_targets: tuple = ("to_q", "to_out")
    ip_num_image_tokens: int = 0
    ip_scale: float = 1.0
    # None | "int8" | "int4": the transformer blocks' projections
    quantization: Optional[str] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @classmethod
    def sdxl_base(cls, in_channels: int = 4, **kw) -> "UNetConfig":
        return cls(in_channels=in_channels, **kw)

    @classmethod
    def sd21(cls, **kw) -> "UNetConfig":
        kw.setdefault("block_out_channels", (320, 640, 1280, 1280))
        kw.setdefault("down_block_types",
                      ("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                       "CrossAttnDownBlock2D", "DownBlock2D"))
        kw.setdefault("transformer_layers_per_block", (1, 1, 1, 1))
        kw.setdefault("num_attention_heads", (5, 10, 20, 20))
        kw.setdefault("cross_attention_dim", 1024)
        kw.setdefault("projection_class_embeddings_input_dim", 0)
        kw.setdefault("sample_size", 96)
        return cls(**kw)

    @classmethod
    def sd15(cls, **kw) -> "UNetConfig":
        kw.setdefault("block_out_channels", (320, 640, 1280, 1280))
        kw.setdefault("down_block_types",
                      ("CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                       "CrossAttnDownBlock2D", "DownBlock2D"))
        kw.setdefault("transformer_layers_per_block", (1, 1, 1, 1))
        kw.setdefault("num_attention_heads", (8, 8, 8, 8))
        kw.setdefault("cross_attention_dim", 768)
        kw.setdefault("projection_class_embeddings_input_dim", 0)
        kw.setdefault("sample_size", 64)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "UNetConfig":
        kw.setdefault("sample_size", 8)
        kw.setdefault("block_out_channels", (32, 64))
        kw.setdefault("down_block_types",
                      ("DownBlock2D", "CrossAttnDownBlock2D"))
        kw.setdefault("layers_per_block", 1)
        kw.setdefault("transformer_layers_per_block", (1, 1))
        kw.setdefault("num_attention_heads", (2, 4))
        kw.setdefault("cross_attention_dim", 64)
        kw.setdefault("addition_time_embed_dim", 8)
        kw.setdefault("projection_class_embeddings_input_dim", 8 * 6 + 32)
        kw.setdefault("norm_num_groups", 8)
        kw.setdefault("remat", False)
        return cls(**kw)


def _quantized(cfg: UNetConfig) -> bool:
    if cfg.quantization in (None, "none"):
        return False
    if cfg.quantization not in ("int8", "int4"):
        raise ValueError(f"unknown quantization {cfg.quantization!r}")
    return True


def _check_config(cfg: UNetConfig) -> None:
    if _quantized(cfg) and cfg.lora_rank > 0:
        raise ValueError(
            "UNet LoRA over quantized projections: the reference's "
            "quantize_unet_params quantizes the LoRA bases, which its LoRA "
            "module cannot read (ROADMAP, known issues of the reference); "
            "merge the adapters first")


# the projections of an attention: where LoRA may go (the feed-forward's and
# proj_in/proj_out never take it, as in the reference)
ATTENTION_PROJECTIONS = {"to_q", "to_k", "to_v", "to_out", "to_k_ip",
                         "to_v_ip"}


def unet_dense(cfg: UNetConfig, dtype):
    """``dense(name, in, out, bias)`` for the transformer blocks: a
    ``LoRALinear`` (α = rank, no bias) for ``cfg.lora_targets`` when
    ``lora_rank > 0``, an ``Int8Linear`` / ``Int4Linear`` under
    ``quantization``, else a ``Linear`` (the reference's
    ``CrossAttention.dense`` and ``QuantDense``)."""
    quant = _quantized(cfg)
    lora = cfg.lora_rank > 0 and set(cfg.lora_targets) & ATTENTION_PROJECTIONS

    def dense(name, cin, cout, bias):
        if lora and name in lora:
            return LoRALinear(cin, cout, cfg.lora_rank, float(cfg.lora_rank),
                              dtype)
        if quant and cfg.quantization == "int8":
            return Int8Linear(cin, cout, dtype, bias=bias)
        if quant:
            return Int4Linear(cin, cout, UNET_QUANT_GROUP, dtype, bias=bias)
        return Linear(cin, cout, bias=bias, dtype=dtype)
    return dense


def quantize_unet_params(state: dict, bits: int = 8,
                         group_size: int = UNET_QUANT_GROUP) -> dict:
    """A float UNet state_dict → the one ``UNetConfig(quantization=
    'int8' | 'int4')`` holds (reference :518): every Linear weight of the
    transformer blocks → ``weight_q`` and its scales; convolutions, norms
    and the ``UNET_QUANT_SKIP`` layers as they are. A LoRA state raises
    (see :func:`_check_config`)."""
    if any(".lora_A." in k for k in state):
        raise ValueError("quantize_unet_params: the state holds LoRA "
                         "adapters (the reference would quantize their "
                         "bases; ROADMAP, known issues of the reference)")
    return quantize_dense_params(state, skip=UNET_QUANT_SKIP, bits=bits,
                                 group_size=group_size)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal embeddings [N, dim] fp32 (diffusers ``Timesteps``)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device)
                      / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class Conv2d(nn.Conv2d):
    """A convolution that computes in a set dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x):
        cd = self.compute_dtype
        return self._conv_forward(x.to(cd), self.weight.to(cd),
                                  self.bias.to(cd))


class GroupNorm(nn.GroupNorm):
    """Statistics in fp32, output in the compute dtype."""

    def __init__(self, groups: int, channels: int, eps: float,
                 dtype=torch.float32):
        super().__init__(groups, channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int, dtype=torch.float32):
        super().__init__()
        self.linear_1 = Linear(cin, dim, dtype=dtype)
        self.linear_2 = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int = 32,
                 temb: Optional[int] = None, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, eps, dtype)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        if temb:
            self.time_emb_proj = Linear(temb, cout, dtype=dtype)
        self.norm2 = GroupNorm(groups, cout, eps, dtype)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, dtype=dtype)
        if cin != cout:
            self.conv_shortcut = Conv2d(cin, cout, 1, dtype=dtype)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(IPCrossAttention):
    """Self-attention (no ``context``) or cross-attention; with
    ``ip_tokens`` the last ``ip_tokens`` of the context are image tokens,
    attended through ``to_k_ip``/``to_v_ip`` and added with ``ip_scale``
    (the reference's IP-Adapter path, :func:`split_ip_context`)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, ip_tokens: int = 0,
                 dense=None, dtype=torch.float32):
        super().__init__(query_dim, heads, dim_head, context_dim,
                         ip=ip_tokens > 0, dense=dense, dtype=dtype)
        self.ip_tokens = ip_tokens

    def forward(self, x, context=None, ip_scale=None):
        if context is None:
            return super().forward(x, x)
        if self.ip_tokens > 0:
            text, image = split_ip_context(context, self.ip_tokens)
            return super().forward(x, text, image,
                                   1.0 if ip_scale is None else ip_scale)
        return super().forward(x, context)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dense):
        super().__init__()
        self.proj = dense("proj", dim, inner * 2, True)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class GEGLUFeedForward(nn.Module):
    """``net.0`` the GEGLU projection, ``net.2`` the output (diffusers'
    names; ``net.1`` is its parameter-free dropout)."""

    def __init__(self, dim: int, dense, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dense),
                                  nn.Identity(),
                                  dense("out", dim * mult, dim, True)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 ip_tokens: int, dense, dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, LN_EPS, dtype)
        self.attn1 = CrossAttention(dim, heads, dim_head, dense=dense,
                                    dtype=dtype)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype)
        self.attn2 = CrossAttention(dim, heads, dim_head, context_dim,
                                    ip_tokens=ip_tokens, dense=dense,
                                    dtype=dtype)
        self.norm3 = LayerNorm(dim, LN_EPS, dtype)
        self.ff = GEGLUFeedForward(dim, dense)

    def forward(self, x, context, ip_scale=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, ip_scale)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm, a linear ``proj_in`` over the flattened positions
    (SDXL's ``use_linear_projection``), the blocks, ``proj_out`` and the
    residual."""

    def __init__(self, channels: int, heads: int, layers: int,
                 context_dim: int, groups: int, ip_tokens: int, dense,
                 dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm(groups, channels, 1e-6, dtype)
        self.proj_in = dense("proj_in", channels, channels, True)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, heads, channels // heads,
                                  context_dim, ip_tokens, dense, dtype)
            for _ in range(layers))
        self.proj_out = dense("proj_out", channels, channels, True)

    def forward(self, x, context, ip_scale=None):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context, ip_scale)
        h = self.proj_out(h)
        return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1,
                           dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNetBlock(nn.Module):
    """One down, mid or up stage (of the UNet, and of the VAE's coders):
    ``resnets``, ``attentions`` where it has them, and ``downsamplers`` /
    ``upsamplers``, diffusers' names."""

    def __init__(self, resnets, attentions=(), downsample=None,
                 upsample=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig = UNetConfig(),
                 dtype=torch.float32):
        super().__init__()
        _check_config(config)
        cfg = self.config = config
        self.dtype = dtype
        ch = cfg.block_out_channels
        n = len(ch)
        temb, g, ip = cfg.time_embed_dim, cfg.norm_num_groups, \
            cfg.ip_num_image_tokens
        ctx = cfg.cross_attention_dim
        dense = unet_dense(cfg, dtype)
        res = lambda cin, cout: ResnetBlock(cin, cout, g, temb, 1e-5, dtype)
        tr = lambda c, i: Transformer2D(
            c, cfg.num_attention_heads[i],
            cfg.transformer_layers_per_block[i], ctx, g, ip, dense, dtype)

        self.conv_in = Conv2d(cfg.in_channels, ch[0], 3, padding=1,
                              dtype=dtype)
        self.time_embedding = TimestepEmbedding(ch[0], temb, dtype)
        if cfg.projection_class_embeddings_input_dim:
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb, dtype)

        skips, cur = [ch[0]], ch[0]
        self.down_blocks = nn.ModuleList()
        for bi, btype in enumerate(cfg.down_block_types):
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(res(cur, ch[bi]))
                cur = ch[bi]
                if btype == "CrossAttnDownBlock2D":
                    attns.append(tr(cur, bi))
                skips.append(cur)
            down = None
            if bi < n - 1:
                down = Downsample(cur, dtype)
                skips.append(cur)
            self.down_blocks.append(UNetBlock(resnets, attns, downsample=down))

        self.mid_block = UNetBlock([res(cur, ch[-1]), res(ch[-1], ch[-1])],
                                   [tr(ch[-1], n - 1)])
        cur = ch[-1]

        self.up_blocks = nn.ModuleList()
        for bi, btype in enumerate(reversed(cfg.down_block_types)):
            out = ch[n - 1 - bi]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(res(cur + skips.pop(), out))
                cur = out
                if btype == "CrossAttnDownBlock2D":
                    attns.append(tr(out, n - 1 - bi))
            up = Upsample(out, dtype) if bi < n - 1 else None
            self.up_blocks.append(UNetBlock(resnets, attns, upsample=up))

        self.conv_norm_out = GroupNorm(g, ch[0], 1e-5, dtype)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, padding=1,
                               dtype=dtype)

    def forward(self, sample, timesteps, encoder_hidden_states,
                added_cond: Optional[dict] = None, ip_scale=None):
        """sample [B, Cin, H, W]; timesteps [B] or a scalar;
        encoder_hidden_states [B, L, context_dim]; ``added_cond``
        {'text_embeds': [B, pooled], 'time_ids': [B, 6]} (SDXL);
        ``ip_scale`` the IP-Adapter's mixing scale where the config has
        image tokens. → ε [B, Cout, H, W] in the compute dtype."""
        cfg, dt = self.config, self.dtype
        if cfg.ip_num_image_tokens > 0 and ip_scale is None:
            ip_scale = cfg.ip_scale
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        if added_cond is not None and cfg.projection_class_embeddings_input_dim:
            add_t = timestep_embedding(added_cond["time_ids"].reshape(-1),
                                       cfg.addition_time_embed_dim)
            add_emb = torch.cat([added_cond["text_embeds"].to(dt),
                                 add_t.reshape(B, -1).to(dt)], dim=-1)
            temb = temb + self.add_embedding(add_emb)
        context = encoder_hidden_states.to(dt)

        if cfg.remat and torch.is_grad_enabled():
            run = lambda stage, *a: checkpoint(stage, *a, use_reentrant=False)
        else:
            run = lambda stage, *a: stage(*a)

        h = self.conv_in(sample.to(dt))
        skips = [h]
        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for li, resnet in enumerate(block.resnets):
                h = run(resnet, h, temb)
                if attns is not None:
                    h = run(attns[li], h, context, ip_scale)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = run(mid.resnets[0], h, temb)
        h = run(mid.attentions[0], h, context, ip_scale)
        h = run(mid.resnets[1], h, temb)

        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for li, resnet in enumerate(block.resnets):
                h = run(resnet, torch.cat([h, skips.pop()], dim=1), temb)
                if attns is not None:
                    h = run(attns[li], h, context, ip_scale)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        return self.conv_out(F.silu(self.conv_norm_out(h)))
