"""Deep perceiver resamplers: LLM features → UNet conditioning (twin of
``mllm_npu_tpu/models/generation/resampler.py:22-220``).

``PerceiverAttention`` (keys and values over concat(x, latents), the
reference's ``dim_head ** -0.25`` applied to both q and k), ``FeedForward``,
the deep ``Resampler``, the SDXL variants that emit dual-width prompt
embeds (768 + 1280) and an attention-pooled ``pooled_prompt_embeds``
(``ResamplerXL``; ``ResamplerXLV2`` L2-normalises its input first),
``ResamplerXLIdentity`` and the CLIP-style ``AttentionPool2d``. The
attention is plain tensor code here as in the reference (no Pallas kernel
there), its softmax in fp32.

Parameter names are the reference's torch checkpoint's, the names
``torch_to_flax_perceiver`` reads: ``latents``, ``proj_in``, ``norm_out``,
``layers.{i}.0`` (the attention: ``norm1``, ``norm2``, ``to_q``, ``to_kv``,
``to_out``), ``layers.{i}.1`` (the feed-forward Sequential: ``0`` norm,
``1`` and ``3`` Linear), ``proj_out`` or ``unet_proj_1/2`` and
``unet_attnpool``. The reference's ``_PerceiverCore`` has no module of its
own here: its latents and layers sit on the resampler, as in the torch
checkpoint. LayerNorms take flax's epsilon, 1e-6.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mllm_npu_tpu_torch.models.layers import LayerNorm, Linear

LN_EPS = 1e-6


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 dtype=torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = LayerNorm(dim, LN_EPS, dtype)
        self.norm2 = LayerNorm(dim, LN_EPS, dtype)
        self.to_q = Linear(dim, inner, bias=False, dtype=dtype)
        self.to_kv = Linear(dim, inner * 2, bias=False, dtype=dtype)
        self.to_out = Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        B, L, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)

        def heads_first(t):
            return t.reshape(B, t.shape[1], self.heads,
                             self.dim_head).transpose(1, 2)

        q, k, v = map(heads_first, (q, k, v))
        scale = self.dim_head ** -0.25   # the reference's double scaling
        w = torch.einsum("bhqd,bhkd->bhqk", q * scale, k * scale)
        w = torch.softmax(w.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", w, v)
        return self.to_out(out.transpose(1, 2).reshape(B, L, -1))


class FeedForward(nn.Sequential):
    """LayerNorm → Linear → exact GELU → Linear, no biases (Sequential
    indices 0, 1, 2, 3: the reference checkpoint's names)."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32):
        inner = int(dim * mult)
        super().__init__(LayerNorm(dim, LN_EPS, dtype),
                         Linear(dim, inner, bias=False, dtype=dtype),
                         nn.GELU(),
                         Linear(inner, dim, bias=False, dtype=dtype))


class AttentionPool2d(nn.Module):
    """CLIP-style pool: the token mean prepended, a learned position
    table, one attention over the sequence; returns the mean token's
    output [B, output_dim] (every token's with ``return_all_tokens``)."""

    def __init__(self, seq_len: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.randn(seq_len + 1, embed_dim) / embed_dim ** 0.5)
        self.q_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Linear(embed_dim, embed_dim, dtype=dtype)
        self.c_proj = Linear(embed_dim, output_dim or embed_dim, dtype=dtype)

    def forward(self, x, return_all_tokens: bool = False):
        B, _, E = x.shape
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None].to(x.dtype)
        H = self.num_heads
        D = E // H
        q = self.q_proj(x).reshape(B, -1, H, D)
        k = self.k_proj(x).reshape(B, -1, H, D)
        v = self.v_proj(x).reshape(B, -1, H, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (D ** -0.5)
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, -1, E)
        out = self.c_proj(out)
        return out if return_all_tokens else out[:, 0]


class Resampler(nn.Module):
    """proj_in → ``depth`` × (PerceiverAttention, FeedForward) over
    ``num_queries`` learned latents → proj_out → norm_out."""

    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64,
                 heads: int = 16, num_queries: int = 8,
                 embedding_dim: int = 768, output_dim: int = 1024,
                 ff_mult: int = 4, dtype=torch.float32):
        super().__init__()
        self._core(dim, depth, dim_head, heads, num_queries, embedding_dim,
                   ff_mult, dtype)
        self.proj_out = Linear(dim, output_dim, dtype=dtype)
        self.norm_out = LayerNorm(output_dim, LN_EPS, dtype)

    def _core(self, dim, depth, dim_head, heads, num_queries, embedding_dim,
              ff_mult, dtype):
        self.latents = nn.Parameter(
            torch.randn(1, num_queries, dim) / dim ** 0.5)
        self.proj_in = Linear(embedding_dim, dim, dtype=dtype)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads, dtype),
                           FeedForward(dim, ff_mult, dtype)])
            for _ in range(depth))

    def _run_core(self, x):
        x = self.proj_in(x)
        latents = self.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        return latents

    def forward(self, x):
        return self.norm_out(self.proj_out(self._run_core(x)))


class ResamplerXL(Resampler):
    """→ (prompt_embeds [B, nq, out1 + out2], pooled [B, out2]);
    ``normalize`` L2-normalises the input first (ResamplerXLV2)."""

    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64,
                 heads: int = 16, num_queries: int = 8,
                 embedding_dim: int = 768, output1_dim: int = 768,
                 output2_dim: int = 1280, ff_mult: int = 4,
                 normalize: bool = False, dtype=torch.float32):
        nn.Module.__init__(self)
        self.normalize = normalize
        self._core(dim, depth, dim_head, heads, num_queries, embedding_dim,
                   ff_mult, dtype)
        self.norm_out = LayerNorm(dim, LN_EPS, dtype)
        self.unet_proj_1 = Linear(dim, output1_dim, dtype=dtype)
        self.unet_proj_2 = Linear(dim, output2_dim, dtype=dtype)
        self.unet_attnpool = AttentionPool2d(num_queries, dim, heads,
                                             output2_dim, dtype)

    def forward(self, x, pooled_text_embeds=None):
        if self.normalize:
            # in fp32 (the reference's dtype), then the compute dtype
            x = x.float()
            x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                     + 1e-12)
        hidden = self.norm_out(self._run_core(x))
        prompt_embeds = torch.cat([self.unet_proj_1(hidden),
                                   self.unet_proj_2(hidden)], dim=-1)
        return prompt_embeds, self.unet_attnpool(hidden)


class ResamplerXLV2(ResamplerXL):
    def __init__(self, normalize: bool = True, **kw):
        super().__init__(normalize=normalize, **kw)


class ResamplerXLIdentity(nn.Module):
    def forward(self, x, pooled_text_embeds=None):
        return x, pooled_text_embeds

