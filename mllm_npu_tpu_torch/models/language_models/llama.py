"""Llama-family causal LM in PyTorch (twin of
``mllm_npu_tpu/models/language_models/llama.py``).

Parameter names follow HF Llama (``model.layers.{i}.self_attn.q_proj
.weight``, …) with peft-style adapters (``…q_proj.lora_A.weight`` [r, in],
``…q_proj.lora_B.weight`` [out, r]). A Python loop over layers replaces
``nn.scan``. The KV cache is updated in place (the reference threads an
immutable cache through ``dynamic_update_slice``): the prefill writes the
prompt's keys and values, and each decode step attends over the cache
read-only plus its own key/value as a virtual column, then writes that
column for all layers at once (:func:`write_decode_column`).

Served here: the prefill (causal, segment ids, K1 on the GPU) and the
single-token read-only-cache decode, with bf16, int8 (K4) or int4 (K5)
weights (``LlamaConfig.quantization``; every projection and the
``lm_head``, as the reference). The reference's multi-token verify and
eager branches, fused projections and LoRA over a quantized base are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mllm_npu_tpu_torch import ops
from mllm_npu_tpu_torch.models.layers import Linear
from mllm_npu_tpu_torch.ops.quant import Int4Linear, Int8Linear


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_type: Optional[str] = None   # None | "linear" | "dynamic"
    rope_scaling_factor: float = 1.0
    lora_rank: int = 0
    lora_alpha: float = 32.0
    lora_targets: tuple = ("q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj")
    # weight-only serving: "none" | "int8" | "int4" (every projection and
    # the lm_head; utils.weights.quantize_llama_ converts a float model)
    quantization: str = "none"
    # int4 group size along K (falls back to K where it does not divide)
    quant_group_size: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=128256, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   max_position_embeddings=8192, rope_theta=500000.0, **kw)

    @classmethod
    def llama2_13b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=32000, hidden_size=5120,
                   intermediate_size=13824, num_hidden_layers=40,
                   num_attention_heads=40, num_key_value_heads=40,
                   max_position_embeddings=4096, **kw)

    @classmethod
    def tiny(cls, vocab_size: int = 1024, **kw) -> "LlamaConfig":
        return cls(vocab_size=vocab_size, hidden_size=128,
                   intermediate_size=256, num_hidden_layers=2,
                   num_attention_heads=4, num_key_value_heads=2,
                   max_position_embeddings=2048, **kw)


class LoRALinear(nn.Module):
    """Bias-free Linear plus a low-rank adapter: ``W x + (B A x)·α/r``.
    Inference only (the reference's adapter dropout is a training path)."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.lora_A = Linear(in_features, rank, bias=False, dtype=dtype)
        self.lora_B = Linear(rank, out_features, bias=False, dtype=dtype)
        self.scale = alpha / rank
        self.compute_dtype = dtype

    def forward(self, x):
        x = x.to(self.compute_dtype)
        y = F.linear(x, self.weight.to(self.compute_dtype))
        return y + self.lora_B(self.lora_A(x)) * self.scale


def quantized_linear(cfg: LlamaConfig, in_f: int, out_f: int, dtype):
    """An empty Int8Linear / Int4Linear for ``cfg.quantization``."""
    if cfg.quantization == "int8":
        return Int8Linear(in_f, out_f, dtype)
    if cfg.quantization == "int4":
        return Int4Linear(in_f, out_f, cfg.quant_group_size, dtype)
    raise ValueError(f"unknown quantization {cfg.quantization!r}")


def _dense(cfg: LlamaConfig, name: str, in_f: int, out_f: int, dtype):
    lora = cfg.lora_rank > 0 and name in cfg.lora_targets
    if cfg.quantization != "none":
        if lora:
            raise NotImplementedError(
                "LoRA over a quantized base is not ported yet: merge the "
                "adapters before quantizing")
        return quantized_linear(cfg, in_f, out_f, dtype)
    if lora:
        return LoRALinear(in_f, out_f, cfg.lora_rank, cfg.lora_alpha, dtype)
    return Linear(in_f, out_f, bias=False, dtype=dtype)


def init_cache(config: LlamaConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Preallocated KV cache [L, B, max_len, Hkv, D]; ``pos`` is the filled
    length."""
    shape = (config.num_hidden_layers, batch_size, max_len,
             config.num_key_value_heads, config.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def write_decode_column(cache: torch.Tensor, col: torch.Tensor,
                        pos: int) -> None:
    """Write one decoded column for all layers at once, in place:
    cache [L, B, max_len, Hkv, D], col [L, B, 1, Hkv, D]."""
    cache[:, :, pos:pos + 1] = col.to(cache.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return ops.rms_norm(x, self.weight.to(x.dtype), self.eps)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        hs, inter = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _dense(cfg, "gate_proj", hs, inter, dtype)
        self.up_proj = _dense(cfg, "up_proj", hs, inter, dtype)
        self.down_proj = _dense(cfg, "down_proj", inter, hs, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        self.config = cfg
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        hs = cfg.hidden_size
        self.q_proj = _dense(cfg, "q_proj", hs, H * D, dtype)
        self.k_proj = _dense(cfg, "k_proj", hs, Hkv * D, dtype)
        self.v_proj = _dense(cfg, "v_proj", hs, Hkv * D, dtype)
        self.o_proj = _dense(cfg, "o_proj", H * D, hs, dtype)

    def forward(self, x, *, positions, layer_cache=None, cache_pos=None,
                segment_ids=None, attn_mask=None, prefill=False):
        """Returns (output, (k, v) of this step for a decode step or None)."""
        cfg = self.config
        B, S, _ = x.shape
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        q = self.q_proj(x).reshape(B, S, H, D)
        k = self.k_proj(x).reshape(B, S, Hkv, D)
        v = self.v_proj(x).reshape(B, S, Hkv, D)
        cos, sin = ops.rope_cos_sin(
            positions, D, theta=cfg.rope_theta,
            scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position_embeddings=cfg.max_position_embeddings)
        q, k = ops.apply_rope(q, k, cos, sin)

        new_col = None
        if layer_cache is not None and not prefill:
            if S != 1:
                raise NotImplementedError(
                    "multi-token cached steps are not ported yet")
            ck, cv = layer_cache                       # [B, max_len, Hkv, D]
            kv_len = ck.shape[1]
            am = (torch.arange(kv_len, device=x.device)
                  < cache_pos)[None, None, None, :]    # [1, 1, 1, Skv]
            if attn_mask is not None:
                am = am & attn_mask
            out = ops.decode_attention(q, ck, cv, am, k_cur=k, v_cur=v)
            new_col = (k, v)
        else:
            if layer_cache is not None:
                ck, cv = layer_cache
                ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
                cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
            out = ops.multi_head_attention(
                q, k, v, causal=True, segment_ids=segment_ids,
                attn_mask=attn_mask)
        return self.o_proj(out.reshape(B, S, H * D)), new_col


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, dtype)

    def forward(self, x, **kw):
        attn_out, new_col = self.self_attn(self.input_layernorm(x), **kw)
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x)), new_col


class LlamaModel(nn.Module):
    """Decoder stack; returns final hidden states (post-norm)."""

    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        self.config = cfg
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def embed(self, input_ids):
        # table cast first, then gather (the reference's numerics)
        return F.embedding(input_ids, self.embed_tokens.weight.to(self.dtype))

    def forward(self, input_ids=None, *, inputs_embeds=None, positions=None,
                cache=None, segment_ids=None, attn_mask=None, prefill=False):
        if (input_ids is None) == (inputs_embeds is None):
            raise ValueError("pass exactly one of input_ids, inputs_embeds")
        h = inputs_embeds if inputs_embeds is not None else \
            self.embed(input_ids)
        h = h.to(self.dtype)
        B, S = h.shape[:2]
        cache_pos = None if cache is None else cache["pos"]
        if positions is None:
            positions = (torch.arange(S, device=h.device)[None]
                         + (cache_pos or 0)).expand(B, S)
        cols = []
        for i, layer in enumerate(self.layers):
            lc = None if cache is None else (cache["k"][i], cache["v"][i])
            h, col = layer(h, positions=positions, layer_cache=lc,
                           cache_pos=cache_pos, segment_ids=segment_ids,
                           attn_mask=attn_mask, prefill=prefill)
            if col is not None:
                cols.append(col)
        h = self.norm(h)
        if cache is not None:
            if cols:
                write_decode_column(cache["k"],
                                    torch.stack([c[0] for c in cols]),
                                    cache_pos)
                write_decode_column(cache["v"],
                                    torch.stack([c[1] for c in cols]),
                                    cache_pos)
            cache["pos"] = cache_pos + S
        return h, cache


class LlamaForCausalLM(nn.Module):
    """``forward`` returns (last hidden states, cache); :meth:`logits` maps
    hidden states to vocabulary logits, so a caller computes them only
    where it reads them."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.bfloat16):
        super().__init__()
        self.config = cfg
        self.model = LlamaModel(cfg, dtype)
        if cfg.quantization != "none":
            self.lm_head = quantized_linear(cfg, cfg.hidden_size,
                                            cfg.vocab_size, dtype)
        else:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size,
                                  bias=False, dtype=dtype)

    def embed(self, input_ids):
        return self.model.embed(input_ids)

    def logits(self, h):
        return self.lm_head(h)

    def forward(self, input_ids=None, **kw):
        return self.model(input_ids, **kw)
