"""IP-Adapter-style decoupled cross-attention (twin of
``mllm_npu_tpu/models/generation/attention_processor.py``).

Attention over the text tokens and over the image tokens runs as two
attentions sharing the query, mixed with a scale:

    out = attn(q, text_kv) + scale · attn(q, image_kv)

:class:`IPCrossAttention` is that module, and the UNet's attention
(``unet.CrossAttention``) is the same module with the UNet's projections
(LoRA or quantized where its config says): self-attention, plain
cross-attention, and the IP-Adapter's decoupled branch are one code path.
Every attention goes through ``ops.multi_head_attention``: K1 on the GPU,
its plain fp32 version on the CPU (the reference's module here runs a plain
softmax; the two agree in fp32).

Names are diffusers': ``to_q``, ``to_k``, ``to_v``, ``to_out.0`` (the
reference's ``to_out``) and the IP-Adapter's ``to_k_ip`` / ``to_v_ip``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from mllm_npu_tpu_torch import ops
from mllm_npu_tpu_torch.models.layers import Linear


def split_ip_context(context: torch.Tensor, num_image_tokens: int):
    """A combined [text; image] context → (text, image) along the token
    axis (reference :66)."""
    return context[:, :-num_image_tokens], context[:, -num_image_tokens:]


def plain_dense(dtype) -> Callable[..., nn.Module]:
    """``dense(name, in, out, bias)`` → a Linear computing in ``dtype``."""
    return lambda name, cin, cout, bias: Linear(cin, cout, bias=bias,
                                                 dtype=dtype)


class IPCrossAttention(nn.Module):
    """Decoupled text/image cross-attention with a mixing scale (reference
    :38). ``ip`` builds the image projections; ``dense(name, in, out,
    bias)`` makes each projection (a plain Linear by default)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None, ip_scale: float = 1.0,
                 ip: bool = True, dense: Optional[Callable] = None,
                 dtype=torch.float32):
        super().__init__()
        dense = dense or plain_dense(dtype)
        inner = heads * dim_head
        kv = context_dim or query_dim
        self.heads, self.dim_head, self.ip_scale = heads, dim_head, ip_scale
        self.to_q = dense("to_q", query_dim, inner, False)
        self.to_k = dense("to_k", kv, inner, False)
        self.to_v = dense("to_v", kv, inner, False)
        self.to_out = nn.ModuleList([dense("to_out", inner, query_dim, True),
                                     nn.Identity()])
        if ip:
            self.to_k_ip = dense("to_k_ip", kv, inner, False)
            self.to_v_ip = dense("to_v_ip", kv, inner, False)

    def _attend(self, q, ctx, to_k, to_v):
        B = q.shape[0]
        k = to_k(ctx).reshape(B, -1, self.heads, self.dim_head)
        v = to_v(ctx).reshape(B, -1, self.heads, self.dim_head)
        return ops.multi_head_attention(q, k, v, scale=self.dim_head ** -0.5)

    def forward(self, x, text_context, image_context=None, ip_scale=None):
        B, L, _ = x.shape
        q = self.to_q(x).reshape(B, L, self.heads, self.dim_head)
        out = self._attend(q, text_context, self.to_k, self.to_v)
        if image_context is not None:
            scale = self.ip_scale if ip_scale is None else ip_scale
            out = out + scale * self._attend(q, image_context, self.to_k_ip,
                                             self.to_v_ip)
        return self.to_out[0](out.reshape(B, L, -1))
