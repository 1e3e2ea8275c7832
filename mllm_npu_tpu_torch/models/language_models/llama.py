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

Served here: the prefill (causal, segment ids, K1 on the GPU); the
single-token read-only-cache decode, with one scalar filled length or one
per row (``cache["pos"]`` a [B] tensor: continuous batching, each row
writing its column at its own position); the multi-token verify window
(per-row positions and S > 1: the batched engine's speculative tick,
which attends over the read-only cache plus the window, causal within it,
and hands the window's columns back as ``k_col``/``v_col`` for the engine
to write); and the multi-token cached step (a scalar filled length and
S > 1: the chunked prefill and the single-request speculative verify,
which write the chunk first and attend causally from ``q_offset = pos``,
eagerly, as the reference does). The KV cache may be bf16, fp32 or fp8
(e4m3; :func:`to_cache` saturates at ±448). Weights in bf16, int8 (K4) or
int4 (K5) (``LlamaConfig.quantization``; every projection and the
``lm_head``, as the reference), with q/k/v and gate/up fused into one
product each when ``fused_projections`` is set
(``utils.weights.fuse_llama_projections_``). Trained here: LoRA with
adapter dropout, per-segment positions (:func:`packed_positions`), the
dense and chunked causal-LM losses, per-layer remat (``remat_policy``
``nothing``, ``dots``, ``dots_no_batch``, ``dots_lite`` or
``hoist_attn``: :func:`remat_layer`), and LoRA over a frozen int8 / int4 base
(QLoRA: ``LoRALinear(base=...)``, the product's gradient through
``ops.quant.QuantMatmul``); attention then runs K1 with its LSE forward
and K2/K3 backward. The reference's tensor-parallel fused layout
(``fused_shards > 1``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from mllm_npu_tpu_torch import ops
from mllm_npu_tpu_torch.constant import IGNORE_INDEX
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
    # adapter-input dropout, active in training once a dropout seed is set
    # (set_lora_dropout_seed; the reference's 'dropout' rng)
    lora_dropout: float = 0.0
    lora_targets: tuple = ("q_proj", "k_proj", "v_proj", "o_proj",
                           "gate_proj", "up_proj", "down_proj")
    # weight-only storage: "none" | "int8" | "int4" (every projection and
    # the lm_head; with LoRA, the adapters' frozen bases: QLoRA training;
    # utils.weights.quantize_llama_ converts a float model)
    quantization: str = "none"
    # int4 group size along K (falls back to K where it does not divide)
    quant_group_size: int = 256
    # per-layer activation checkpointing in training: 'nothing' saves only
    # each layer's input, 'dots' also every matmul output
    remat: bool = False
    remat_policy: str = "nothing"
    # serving: q/k/v as one qkv_proj and gate/up as one gate_up_proj
    # (utils.weights.fuse_llama_projections_); fused_shards > 1, the
    # tensor-parallel interleaved layout, is not ported yet
    fused_projections: bool = False
    fused_shards: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    # the presets: ``kw`` adds fields or overrides theirs (a YAML may set
    # ``num_hidden_layers`` to cut a model's depth)
    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=128256, hidden_size=4096,
                             intermediate_size=14336, num_hidden_layers=32,
                             num_attention_heads=32, num_key_value_heads=8,
                             max_position_embeddings=8192,
                             rope_theta=500000.0), **kw})

    @classmethod
    def llama2_13b(cls, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=32000, hidden_size=5120,
                             intermediate_size=13824, num_hidden_layers=40,
                             num_attention_heads=40, num_key_value_heads=40,
                             max_position_embeddings=4096), **kw})

    @classmethod
    def tiny(cls, vocab_size: int = 1024, **kw) -> "LlamaConfig":
        return cls(**{**dict(vocab_size=vocab_size, hidden_size=128,
                             intermediate_size=256, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2,
                             max_position_embeddings=2048), **kw})


class LoRALinear(nn.Module):
    """Bias-free Linear plus a low-rank adapter: ``W x + (B A x')·α/r``,
    where ``x'`` is ``x`` under dropout at rate ``dropout`` while the
    module is training and a dropout seed is set, and ``x`` otherwise
    (peft ``lora_dropout``; the reference's ``LoRADense``). The mask is a
    function of (seed, ``dropout_key``) alone, so a layer re-run by
    activation checkpointing draws the same mask. W is ``weight``, or with
    ``base`` (an ``Int8Linear`` / ``Int4Linear``: QLoRA, the reference's
    ``LoRADense(quantization=...)``) the frozen quantized ``base``, whose
    product passes a gradient to x alone."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float, dtype: torch.dtype, dropout: float = 0.0,
                 base: Optional[nn.Module] = None):
        super().__init__()
        if base is None:
            self.weight = nn.Parameter(torch.empty(out_features,
                                                   in_features))
        self.base = base
        self.lora_A = Linear(in_features, rank, bias=False, dtype=dtype)
        self.lora_B = Linear(rank, out_features, bias=False, dtype=dtype)
        self.scale = alpha / rank
        self.compute_dtype = dtype
        self.dropout = dropout
        self.dropout_key = 0        # set per layer and projection
        self.dropout_seed = None    # set per step (set_lora_dropout_seed)

    def _dropout(self, x):
        if not (self.training and self.dropout > 0
                and self.dropout_seed is not None):
            return x
        g = torch.Generator(device=x.device)
        g.manual_seed(_mix(self.dropout_seed, self.dropout_key))
        keep = 1.0 - self.dropout
        mask = torch.rand(x.shape, generator=g, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))

    def forward(self, x):
        x = x.to(self.compute_dtype)
        y = (F.linear(x, self.weight.to(self.compute_dtype))
             if self.base is None else self.base(x))
        return y + self.lora_B(self.lora_A(self._dropout(x))) * self.scale


def _mix(seed: int, key: int) -> int:
    """A 63-bit generator seed from (seed, key) (splitmix64's finalizer)."""
    z = (seed * 0x9E3779B97F4A7C15 + key + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def set_lora_dropout_seed(module: nn.Module, seed: Optional[int]) -> None:
    """Seed (or, with None, switch off) every LoRA adapter's dropout under
    ``module``; the trainer sets one seed per step (the twin of the
    reference's ``fold_in(PRNGKey(17), step)``)."""
    for m in module.modules():
        if isinstance(m, LoRALinear):
            m.dropout_seed = seed


def quantized_linear(cfg: LlamaConfig, in_f: int, out_f: int, dtype):
    """An empty Int8Linear / Int4Linear for ``cfg.quantization``."""
    if cfg.quantization == "int8":
        return Int8Linear(in_f, out_f, dtype)
    if cfg.quantization == "int4":
        return Int4Linear(in_f, out_f, cfg.quant_group_size, dtype)
    raise ValueError(f"unknown quantization {cfg.quantization!r}")


def _dense(cfg: LlamaConfig, name: str, in_f: int, out_f: int, dtype):
    lora = cfg.lora_rank > 0 and name in cfg.lora_targets
    quantized = cfg.quantization != "none"
    if lora:
        return LoRALinear(in_f, out_f, cfg.lora_rank, cfg.lora_alpha, dtype,
                          dropout=cfg.lora_dropout,
                          base=(quantized_linear(cfg, in_f, out_f, dtype)
                                if quantized else None))
    if quantized:
        return quantized_linear(cfg, in_f, out_f, dtype)
    return Linear(in_f, out_f, bias=False, dtype=dtype)


def packed_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-segment position ids: positions restart at 0 wherever the
    segment id changes. [B, S] int → [B, S] long (twin of ``:222``)."""
    B, S = segment_ids.shape
    idx = torch.arange(S, device=segment_ids.device).expand(B, S)
    is_start = torch.ones_like(segment_ids, dtype=torch.bool)
    is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    start = torch.where(is_start, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start, dim=1).values


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Shifted next-token CE in fp32, the mean over targets that are not
    ``ignore_index`` (twin of ``:935``)."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    mask = targets != ignore_index
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll.sum() / mask.sum().clamp(min=1)


def _ce_piece(hc, tc, w, ignore_index):
    logits = (hc.to(w.dtype) @ w.t()).float()
    lse = torch.logsumexp(logits, dim=-1)
    mask = tc != ignore_index
    safe = torch.where(mask, tc, torch.zeros_like(tc)).long()
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - picked, torch.zeros_like(lse))
    return nll.sum(), mask.sum()


def chunked_causal_lm_loss(h: torch.Tensor, weight: torch.Tensor,
                           labels: torch.Tensor, *, chunk: int = 256,
                           compute_dtype=torch.bfloat16,
                           ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Fused-linear CE (twin of ``:951``): the head product and softmax-CE
    per sequence chunk of ``chunk`` positions, each under activation
    checkpointing, so the [B, S, V] logits never exist at once and the
    backward recomputes each chunk's. ``weight`` is the head's [V, D]; the
    product runs in ``compute_dtype``, the log-sum-exp in fp32. Equal to
    :func:`causal_lm_loss` up to summation order."""
    hp, tg = h[:, :-1], labels[:, 1:]
    w = weight.to(compute_dtype)
    total = h.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.long, device=h.device)
    for i in range(0, hp.shape[1], chunk):
        s, c = checkpoint(_ce_piece, hp[:, i:i + chunk], tg[:, i:i + chunk],
                          w, ignore_index, use_reentrant=False)
        total = total + s
        count = count + c
    return total / count.clamp(min=1)


@torch.library.custom_op("mllm_torch::remat_save", mutates_args=())
def remat_save(x: torch.Tensor) -> torch.Tensor:
    """A named identity (a copy) marking a tensor that ``dots_lite`` keeps:
    the twin of ``checkpoint_name``, since a selective-checkpoint policy
    sees ops, not names."""
    return x.clone()


@remat_save.register_fake
def _(x):
    return torch.empty_like(x)


remat_save.register_autograd(lambda ctx, grad: grad)

_MM_OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
_BATCHED_MM_OPS = {torch.ops.aten.bmm.default,
                   torch.ops.aten.baddbmm.default}
# what each selective policy keeps (the twins of jax.checkpoint_policies'
# checkpoint_dots, checkpoint_dots_with_no_batch_dims and
# save_only_these_names("remat_qkv", "remat_attn_o")): every product; the
# products without a batch dim (the projections, whose 3-D inputs reach
# mm / addmm; not the eager attention's bmm); the post-RoPE q/k/v and the
# o_proj output (remat_save)
_SAVED_OPS = {"dots": _MM_OPS | _BATCHED_MM_OPS, "dots_no_batch": _MM_OPS,
              "dots_lite": {torch.ops.mllm_torch.remat_save.default}}
REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "dots_lite",
                  "hoist_attn")


def _saving(ops_to_save, ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of ``ops_to_save``,
    recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in ops_to_save
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(layer: nn.Module, policy: str, h, **kw):
    """``layer(h, **kw)`` under activation checkpointing (twin of the
    ``nn.remat`` in ``:599-626``): ``nothing`` keeps only the layer's
    input, ``dots`` / ``dots_no_batch`` / ``dots_lite`` also the outputs
    ``_SAVED_OPS`` names, ``hoist_attn`` checkpoints around the attention
    kernel (``LlamaDecoderLayer.forward_hoist_attn``). Non-reentrant, so
    LoRA dropout's seeded masks and the flash kernels' saved tensors are
    rebuilt by the replay: the flash forward (K1) runs twice per layer
    per step, but once under ``hoist_attn``."""
    if policy == "hoist_attn":
        return layer.forward_hoist_attn(
            h, positions=kw["positions"], segment_ids=kw.get("segment_ids"),
            attn_mask=kw.get("attn_mask"))
    if policy == "nothing":
        return checkpoint(layer, h, use_reentrant=False, **kw)
    if policy not in _SAVED_OPS:
        raise ValueError(f"remat_policy {policy!r}: the reference has "
                         f"{REMAT_POLICIES}")
    return checkpoint(layer, h, use_reentrant=False,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          functools.partial(_saving, _SAVED_OPS[policy])),
                      **kw)


FP8_MAX = 448.0


def byte_view(x: torch.Tensor) -> torch.Tensor:
    """A 1-byte float tensor as the uint8 view of its storage (the same
    bytes; scatters and fills take it on every device), else itself."""
    if x.is_floating_point() and x.element_size() == 1:
        return x.view(torch.uint8)
    return x


def to_cache(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Keys or values in the cache's dtype. Into fp8 (e4m3) they are first
    clamped to ±448, so the cast rounds as the reference's for every
    |x| < 464 and saturates above on the CPU and the GPU alike (the
    reference's cast gives NaN there: ROADMAP, known issues)."""
    if dtype == torch.float8_e4m3fn:
        x = x.clamp(-FP8_MAX, FP8_MAX)
    return x.to(dtype)


def init_cache(config: LlamaConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Preallocated KV cache [L, B, max_len, Hkv, D] in ``dtype`` (bf16,
    fp32 or fp8); ``pos`` is the filled length."""
    shape = (config.num_hidden_layers, batch_size, max_len,
             config.num_key_value_heads, config.head_dim)
    zeros = lambda: torch.zeros(shape, dtype=dtype, device=device)
    if torch.empty((), dtype=dtype).element_size() == 1:
        zeros = lambda: torch.zeros(shape, dtype=torch.uint8,
                                    device=device).view(dtype)
    return {"k": zeros(), "v": zeros(), "pos": 0}


def write_decode_column(cache: torch.Tensor, col: torch.Tensor,
                        pos) -> None:
    """Write W decoded columns for all layers at once, in place:
    cache [L, B, max_len, Hkv, D], col [L, B, W, Hkv, D]; ``pos`` an int,
    or a [B] tensor of per-row positions (one scatter over device
    indices: no host read, so a CUDA graph can hold it). Per-row indices
    past the cache's end are clamped to its last column, where only an
    idle row writes (the reference's update clamps likewise)."""
    W = col.shape[2]
    col = byte_view(to_cache(col, cache.dtype))
    cache = byte_view(cache)
    if isinstance(pos, torch.Tensor):
        rows = torch.arange(cache.shape[1], device=cache.device)[:, None]
        idx = pos[:, None]
        if W > 1:
            idx = (idx + torch.arange(W, device=cache.device)
                   ).clamp(max=cache.shape[2] - 1)
        cache[:, rows, idx] = col
    else:
        cache[:, :, pos:pos + W] = col


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        return ops.rms_norm(x, self.weight.to(x.dtype), self.eps)


def _check_fused(cfg: LlamaConfig) -> None:
    if cfg.fused_shards > 1:
        raise NotImplementedError(
            "fused_shards > 1 (the tensor-parallel interleaved layout) is "
            "not ported yet (ROADMAP queue 1 item 12)")
    if cfg.lora_rank > 0:
        raise ValueError("fused projections need the LoRA adapters merged "
                         "first (merge_lora_)")


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        hs, inter = cfg.hidden_size, cfg.intermediate_size
        self.fused = cfg.fused_projections
        if self.fused:
            _check_fused(cfg)
            self.gate_up_proj = _dense(cfg, "gate_up_proj", hs, 2 * inter,
                                       dtype)
        else:
            self.gate_proj = _dense(cfg, "gate_proj", hs, inter, dtype)
            self.up_proj = _dense(cfg, "up_proj", hs, inter, dtype)
        self.down_proj = _dense(cfg, "down_proj", inter, hs, dtype)

    def forward(self, x):
        if self.fused:
            gate, up = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(gate) * up)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype):
        super().__init__()
        self.config = cfg
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        hs = cfg.hidden_size
        if cfg.fused_projections:
            _check_fused(cfg)
            self.qkv_proj = _dense(cfg, "qkv_proj", hs, (H + 2 * Hkv) * D,
                                   dtype)
        else:
            self.q_proj = _dense(cfg, "q_proj", hs, H * D, dtype)
            self.k_proj = _dense(cfg, "k_proj", hs, Hkv * D, dtype)
            self.v_proj = _dense(cfg, "v_proj", hs, Hkv * D, dtype)
        self.o_proj = _dense(cfg, "o_proj", H * D, hs, dtype)

    def project_qkv(self, x, positions):
        """Input-norm'd hidden states → post-RoPE q, k, v ([B, S, H(kv),
        D]). Split out so ``hoist_attn`` can checkpoint the projections
        with the attention kernel outside the checkpointed region; under
        ``dots_lite`` they are the tensors that remat keeps."""
        cfg = self.config
        B, S, _ = x.shape
        H, Hkv, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
        if cfg.fused_projections:
            q, k, v = self.qkv_proj(x).split([H * D, Hkv * D, Hkv * D],
                                             dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(B, S, H, D)
        k = k.reshape(B, S, Hkv, D)
        v = v.reshape(B, S, Hkv, D)
        cos, sin = ops.rope_cos_sin(
            positions, D, theta=cfg.rope_theta,
            scaling_type=cfg.rope_scaling_type,
            scaling_factor=cfg.rope_scaling_factor,
            max_position_embeddings=cfg.max_position_embeddings)
        q, k = ops.apply_rope(q, k, cos, sin)
        if cfg.remat and cfg.remat_policy == "dots_lite" \
                and torch.is_grad_enabled():
            q, k, v = remat_save(q), remat_save(k), remat_save(v)
        return q, k, v

    def project_out(self, out):
        """[B, S, H, D] attention output → o_proj'd hidden states."""
        B, S = out.shape[:2]
        return self.o_proj(out.reshape(B, S, -1))

    def forward(self, x, *, positions, layer_cache=None, cache_pos=None,
                segment_ids=None, attn_mask=None, prefill=False):
        """Returns (output, (k, v) of this step for a decode step or a
        verify window, else None)."""
        B, S, _ = x.shape
        q, k, v = self.project_qkv(x, positions)

        new_col = None
        per_row = isinstance(cache_pos, torch.Tensor)
        if layer_cache is not None and not prefill and (S == 1 or per_row):
            # one token, or a verify window of S tokens a row: the cache is
            # read-only here, the step's keys and values virtual columns
            # (causal within the window), written by the caller
            ck, cv = layer_cache                       # [B, max_len, Hkv, D]
            kv_idx = torch.arange(ck.shape[1], device=x.device)
            if per_row:
                # each row sees its strictly older keys
                am = (kv_idx[None] < cache_pos[:, None])[:, None, None]
            else:
                am = (kv_idx < cache_pos)[None, None, None, :]
            if attn_mask is not None:
                am = am & attn_mask
            out = ops.decode_attention(q, ck, cv, am, k_cur=k, v_cur=v)
            new_col = (k, v)
        else:
            if layer_cache is not None:
                # the chunk (a prefill's whole prompt) goes into the cache
                ck, cv = layer_cache
                ck[:, cache_pos:cache_pos + S] = to_cache(k, ck.dtype)
                cv[:, cache_pos:cache_pos + S] = to_cache(v, cv.dtype)
            if layer_cache is not None and not prefill:
                # multi-token cached step (chunked prefill, single-request
                # verify): the filled keys and this chunk's, read back in
                # the compute dtype, causal from q_offset = cache_pos;
                # eager (dot_product_attention), as the reference runs it
                am = (torch.arange(ck.shape[1], device=x.device)
                      < cache_pos + S)[None, None, None, :]
                if attn_mask is not None:
                    am = am & attn_mask
                out = ops.multi_head_attention(
                    q, ck.to(k.dtype), cv.to(v.dtype), causal=True,
                    attn_mask=am, q_offset=cache_pos)
            else:
                # no cache, or a prefill into an empty one: the prompt alone
                out = ops.multi_head_attention(
                    q, k, v, causal=True, segment_ids=segment_ids,
                    attn_mask=attn_mask)
        return self.project_out(out), new_col


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
        cfg = self.self_attn.config
        if cfg.remat and cfg.remat_policy == "dots_lite" \
                and torch.is_grad_enabled():
            # o_proj's output kept: the replay of the MLP branch needs
            # x + attn_out, not the product itself
            attn_out = remat_save(attn_out)
        x = x + attn_out
        return x + self.mlp(self.post_attention_layernorm(x)), new_col

    def _pre_attention(self, x, positions):
        return self.self_attn.project_qkv(self.input_layernorm(x), positions)

    def _post_attention(self, x, out):
        x = x + self.self_attn.project_out(out)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward_hoist_attn(self, x, *, positions, segment_ids=None,
                           attn_mask=None):
        """``remat_policy="hoist_attn"`` (the reference's
        ``_call_hoist_attn``): the projections and, apart, the output
        projection with the MLP are checkpointed (saving nothing inside),
        and the attention kernel runs between them outside any
        checkpointed region, so its saved tensors are kept and K1 runs
        once per layer and step, not twice. Costs q, k, v and the
        attention output kept per layer."""
        q, k, v = checkpoint(self._pre_attention, x, positions,
                             use_reentrant=False)
        out = ops.multi_head_attention(q, k, v, causal=True,
                                       segment_ids=segment_ids,
                                       attn_mask=attn_mask)
        return checkpoint(self._post_attention, x, out,
                          use_reentrant=False), None


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
        for i, layer in enumerate(self.layers):
            adapters = [m for m in layer.modules()
                        if isinstance(m, LoRALinear)]
            for j, m in enumerate(adapters):
                m.dropout_key = i * 64 + j

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
            offset = 0 if cache_pos is None else cache_pos
            if isinstance(offset, torch.Tensor):
                offset = offset[:, None]
            positions = (torch.arange(S, device=h.device)[None]
                         + offset).expand(B, S)
        cols = []
        remat = (self.config.remat and cache is None
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            lc = None if cache is None else (cache["k"][i], cache["v"][i])
            kw = dict(positions=positions, layer_cache=lc,
                      cache_pos=cache_pos, segment_ids=segment_ids,
                      attn_mask=attn_mask, prefill=prefill)
            if remat:
                h, col = remat_layer(layer, self.config.remat_policy, h,
                                     **kw)
            else:
                h, col = layer(h, **kw)
            if col is not None:
                cols.append(col)
        h = self.norm(h)
        if cache is not None:
            if cols and S > 1:
                # a verify window: the cache stays read-only and the
                # window's [L, B, S, Hkv, D] columns go back to the caller,
                # who writes them and advances each row by what it accepts
                cache["k_col"] = torch.stack([c[0] for c in cols])
                cache["v_col"] = torch.stack([c[1] for c in cols])
                return h, cache
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

    def loss_from_hidden(self, h, labels, *, chunk: int,
                         ignore_index: int = IGNORE_INDEX):
        """Causal-LM loss from the final hidden states without the full
        [B, S, V] logits (:func:`chunked_causal_lm_loss`; twin of
        ``:812``); a quantized head takes the dense loss, as the
        reference's."""
        if self.config.quantization != "none":
            return causal_lm_loss(self.logits(h), labels, ignore_index)
        return chunked_causal_lm_loss(
            h, self.lm_head.weight, labels, chunk=chunk,
            compute_dtype=self.lm_head.compute_dtype,
            ignore_index=ignore_index)

    def forward(self, input_ids=None, **kw):
        return self.model(input_ids, **kw)
