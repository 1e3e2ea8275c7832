"""JAX parameter tree → the port's state_dict.

:func:`from_jax_params` takes the reference assembly's ``params["params"]``
as nested dicts of numpy arrays and returns the port's weights, whose
names are the torch names the reference's converters read
(``mllm_npu_tpu/utils/weights.py``: HF Llama with peft adapters, HF
SigLIP, the reference's Qwen ViT and resampler), so
``torch_to_flax_assembly`` inverts it, for the comprehension assembly and
for SEED (its output projector too). It undoes:

- the scan-stacked leading layer axis (Llama and SigLIP layers);
- Dense ``[in, out]`` → Linear ``[out, in]``, LoRA ``lora_a [in, r]`` →
  ``lora_A.weight [r, in]`` and ``lora_b [r, out]`` → ``lora_B.weight``;
- HWIO → OIHW for the patch conv;
- split q/k/v/out projections → ``nn.MultiheadAttention``'s fused
  ``in_proj_weight``/``in_proj_bias`` for the resamplers, and the Qwen
  ViT's fused ``attn.in_proj`` Linear;
- quantized Llama leaves (``quantize_llama_params``): ``kernel_q`` [K, N]
  (int8) or [K/2, N] (packed int4) → ``weight_q`` [N, K] or [N, K/2], its
  transpose; ``scale`` [N] and ``scale_g`` [K/G, N] as they are; a QLoRA
  projection's quantized ``base`` → ``….base.weight_q`` / ``scale``
  beside its adapters.

The de-tokenizer's parts go across by name rules instead
(:func:`unet_from_jax`, :func:`vae_from_jax`, :func:`perceiver_from_jax`,
also reached from :func:`from_jax_params`): every leaf keeps its module
path with the reference's flattened block names turned into diffusers'
(``down_1_attn_0/blocks_0`` → ``down_blocks.1.attentions.0.
transformer_blocks.0``) or the perceiver checkpoint's (``core/attn_0`` →
``layers.0.0``), a 4-D ``kernel`` HWIO → OIHW, a 2-D one transposed, a
norm's ``scale`` → ``weight``; the inverses are the reference's
``torch_to_flax_unet``, ``torch_to_flax_vae`` and
``torch_to_flax_perceiver``.

The reference's own checkpoint files go across by the twins of its
``torch_to_flax_*`` converters (:func:`llama_state`, :func:`siglip_state`,
:func:`qwen_vit_state`, :func:`vae_state`, :func:`assembly_state`): the
port keeps the torch names those read, so most of the mapping is a
prefix or a rename (the resamplers and the UNet keep theirs as they
are), and what is left is the
reference's rules: the vocabulary resized by the mean rule, ``lm_head``
from ``embed_tokens`` when a checkpoint has none, fresh LoRA adapters
drawn as the reference draws them (:func:`lora_init`), and the peft
wrapper's names (:func:`normalize_peft_keys`). A value a rule makes is a
:class:`Lazy`: its shape is known at once, its tensor only made when a
load needs it.

It also holds the port's serving transforms, :func:`merge_lora_`,
:func:`fuse_llama_projections_` and :func:`quantize_llama_` (twins of
``merge_lora_params``, ``fuse_llama_projections`` with one shard and
``quantize_llama_params``). Unlike the reference's pure tree functions,
they change the model in place and free each replaced weight as they go,
so a full-width model is never held twice.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from mllm_npu_tpu_torch.models.language_models.llama import (LlamaConfig,
                                                             LoRALinear)
from mllm_npu_tpu_torch.models.layers import Linear
from mllm_npu_tpu_torch.ops.quant import Int4Linear, Int8Linear

log = logging.getLogger(__name__)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _dense_T(x) -> torch.Tensor:
    return _t(np.asarray(x).T)


def linear_from_jax(node: dict, key: str, i=None
                     ) -> Dict[str, torch.Tensor]:
    """A bias-free Dense, Int8Dense or Int4Dense node (layer ``i`` of a
    scan-stacked one) → the port's Linear / Int8Linear / Int4Linear."""
    def pick(x):
        x = np.asarray(x)
        return x if i is None else x[i]
    if "kernel_q" not in node:
        return {f"{key}.weight": _dense_T(pick(node["kernel"]))}
    sd = {f"{key}.weight_q": torch.from_numpy(
        np.ascontiguousarray(pick(node["kernel_q"]).T))}
    for name in ("scale", "scale_g"):
        if name in node:
            sd[f"{key}.{name}"] = _t(pick(node[name]))
    return sd


def llama_from_jax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``LlamaForCausalLM`` params (scan-stacked layers, float or
    quantized, with separate or fused projections) → state_dict."""
    sd = {}
    m = tree["model"]
    sd[f"{prefix}model.embed_tokens.weight"] = _t(
        m["embed_tokens"]["embedding"])
    sd[f"{prefix}model.norm.weight"] = _t(m["norm"]["weight"])
    sd.update(linear_from_jax(tree["lm_head"], f"{prefix}lm_head"))
    layers = m["layers"]
    L = np.asarray(layers["input_layernorm"]["weight"]).shape[0]
    for i in range(L):
        lp = f"{prefix}model.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{lp}{norm}.weight"] = _t(layers[norm]["weight"][i])
        for group in ("self_attn", "mlp"):
            for name in sorted(layers[group]):
                node = layers[group][name]
                key = f"{lp}{group}.{name}"
                if "base" in node:
                    # a LoRA projection: float base, or quantized (QLoRA)
                    if "kernel" in node["base"]:
                        sd[f"{key}.weight"] = _dense_T(
                            node["base"]["kernel"][i])
                    else:
                        sd.update(linear_from_jax(node["base"],
                                                  f"{key}.base", i))
                    sd[f"{key}.lora_A.weight"] = _dense_T(node["lora_a"][i])
                    sd[f"{key}.lora_B.weight"] = _dense_T(node["lora_b"][i])
                else:
                    sd.update(linear_from_jax(node, key, i))
    return sd


def siglip_from_jax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``SigLIPVisionEncoder`` params → state_dict (HF names)."""
    pre = f"{prefix}vision_model."
    sd = {
        f"{pre}embeddings.patch_embedding.weight": _t(np.asarray(
            tree["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1)),
        f"{pre}embeddings.patch_embedding.bias": _t(
            tree["patch_embedding"]["bias"]),
        f"{pre}embeddings.position_embedding.weight": _t(
            tree["position_embedding"]),
        f"{pre}post_layernorm.weight": _t(tree["post_layernorm"]["scale"]),
        f"{pre}post_layernorm.bias": _t(tree["post_layernorm"]["bias"]),
    }
    blocks = tree["encoder"]["blocks"]
    L = np.asarray(blocks["ln_1"]["scale"]).shape[0]
    names = {("attn", "q_proj"): "self_attn.q_proj",
             ("attn", "k_proj"): "self_attn.k_proj",
             ("attn", "v_proj"): "self_attn.v_proj",
             ("attn", "out_proj"): "self_attn.out_proj",
             ("mlp_fc",): "mlp.fc1", ("mlp_proj",): "mlp.fc2"}
    for i in range(L):
        lp = f"{pre}encoder.layers.{i}."
        for path, name in names.items():
            node = blocks
            for k in path:
                node = node[k]
            sd[f"{lp}{name}.weight"] = _dense_T(node["kernel"][i])
            sd[f"{lp}{name}.bias"] = _t(node["bias"][i])
        for ln, name in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2")):
            sd[f"{lp}{name}.weight"] = _t(blocks[ln]["scale"][i])
            sd[f"{lp}{name}.bias"] = _t(blocks[ln]["bias"][i])
    return sd


def resampler_from_jax(tree: dict, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """``AttentionResampler`` params → state_dict (reference names)."""
    attn = tree["attn"]
    sd = {
        f"{prefix}query": _t(tree["query"]),
        f"{prefix}ln_q.weight": _t(tree["ln_q"]["scale"]),
        f"{prefix}ln_q.bias": _t(tree["ln_q"]["bias"]),
        f"{prefix}ln_kv.weight": _t(tree["ln_kv"]["scale"]),
        f"{prefix}ln_kv.bias": _t(tree["ln_kv"]["bias"]),
        f"{prefix}attn.in_proj_weight": torch.cat(
            [_dense_T(attn[n]["kernel"]) for n in ("q_proj", "k_proj",
                                                   "v_proj")]),
        f"{prefix}attn.in_proj_bias": torch.cat(
            [_t(attn[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")]),
        f"{prefix}attn.out_proj.weight": _dense_T(attn["out_proj"]["kernel"]),
        f"{prefix}attn.out_proj.bias": _t(attn["out_proj"]["bias"]),
    }
    if "kv_proj" in tree:
        sd[f"{prefix}kv_proj.weight"] = _dense_T(tree["kv_proj"]["kernel"])
    return sd


def qwen_vit_from_jax(tree: dict, prefix: str = ""
                      ) -> Dict[str, torch.Tensor]:
    """``VisionTransformerWithAttnPool`` params (or the tower alone,
    ``VisionTransformer``) → state_dict (the reference's Qwen names)."""
    bb = tree.get("backbone", tree)
    sd = {
        f"{prefix}conv1.weight": _t(np.asarray(
            bb["conv1"]["kernel"]).transpose(3, 2, 0, 1)),
        f"{prefix}positional_embedding": _t(bb["positional_embedding"]),
        f"{prefix}ln_pre.weight": _t(bb["ln_pre"]["scale"]),
        f"{prefix}ln_pre.bias": _t(bb["ln_pre"]["bias"]),
    }
    blocks = bb["transformer"]["blocks"]
    attn = blocks["attn"]
    L = np.asarray(blocks["ln_1"]["scale"]).shape[0]
    for i in range(L):
        rb = f"{prefix}transformer.resblocks.{i}."
        sd[rb + "attn.in_proj.weight"] = torch.cat(
            [_dense_T(attn[n]["kernel"][i]) for n in ("q_proj", "k_proj",
                                                      "v_proj")])
        sd[rb + "attn.in_proj.bias"] = torch.cat(
            [_t(attn[n]["bias"][i]) for n in ("q_proj", "k_proj", "v_proj")])
        sd[rb + "attn.out_proj.weight"] = _dense_T(
            attn["out_proj"]["kernel"][i])
        sd[rb + "attn.out_proj.bias"] = _t(attn["out_proj"]["bias"][i])
        for name, node in (("mlp.c_fc", blocks["mlp_fc"]),
                           ("mlp.c_proj", blocks["mlp_proj"])):
            sd[rb + name + ".weight"] = _dense_T(node["kernel"][i])
            sd[rb + name + ".bias"] = _t(node["bias"][i])
        for ln in ("ln_1", "ln_2"):
            sd[rb + ln + ".weight"] = _t(blocks[ln]["scale"][i])
            sd[rb + ln + ".bias"] = _t(blocks[ln]["bias"][i])
    if "attn_pool" in tree:
        sd.update(resampler_from_jax(tree["attn_pool"], f"{prefix}attn_pool."))
        sd[f"{prefix}ln_post.weight"] = _t(tree["ln_post"]["scale"])
        sd[f"{prefix}ln_post.bias"] = _t(tree["ln_post"]["bias"])
        sd[f"{prefix}proj"] = _t(tree["proj"])
        if "patch_pos_embed" in tree:
            sd[f"{prefix}patch_pos_embed"] = _t(tree["patch_pos_embed"])
    return sd


def _named_leaves(node: dict, path=()):
    """(path, leaf, the dict that holds it) for every leaf of ``node``."""
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, path + (k,))
        else:
            yield path + (k,), v, node


def _renamed(tree: dict, rules) -> Dict[str, torch.Tensor]:
    """Every leaf of ``tree`` under its dotted path rewritten by ``rules``
    (regex, replacement), applied in order: kernels to torch's layout,
    norm scales to ``weight``; a ``LoRADense``'s ``base/kernel``,
    ``lora_a`` and ``lora_b`` to ``LoRALinear``'s ``weight``,
    ``lora_A.weight`` and ``lora_B.weight`` (transposed); a quantized
    Dense's int8 ``kernel_q`` to ``weight_q`` (transposed, int8) beside its
    ``scale`` / ``scale_g`` (fp32, as they are)."""
    sd = {}
    for path, x, node in _named_leaves(tree):
        x = np.asarray(x)
        *mods, leaf = path
        quantized = "kernel_q" in node
        if leaf == "kernel":
            if mods and mods[-1] == "base":
                mods = mods[:-1]
            leaf, x = "weight", (x.transpose(3, 2, 0, 1) if x.ndim == 4
                                 else x.T)
        elif leaf in ("lora_a", "lora_b"):
            leaf, x = f"lora_{leaf[-1].upper()}.weight", x.T
        elif leaf == "kernel_q":
            leaf, x = "weight_q", x.T
        elif leaf == "scale" and not quantized:
            leaf = "weight"
        key = ".".join(mods + [leaf])
        for pat, rep in rules:
            key = re.sub(pat, rep, key)
        sd[key] = (torch.from_numpy(np.ascontiguousarray(x))
                   if x.dtype == np.int8 else _t(x))
    return sd


_BLOCK_RULES = (
    (r"^(\w+\.)?down_(\d+)_res_(\d+)\.", r"\1down_blocks.\2.resnets.\3."),
    (r"^(\w+\.)?up_(\d+)_res_(\d+)\.", r"\1up_blocks.\2.resnets.\3."),
    (r"^down_(\d+)_attn_(\d+)\.", r"down_blocks.\1.attentions.\2."),
    (r"^up_(\d+)_attn_(\d+)\.", r"up_blocks.\1.attentions.\2."),
    # the UNet's resamplers hold a ``conv``; the VAE's are the conv itself
    (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0."),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0."),
    (r"^(\w+)\.down_(\d+)_downsample\.", r"\1.down_blocks.\2.downsamplers.0.conv."),
    (r"^(\w+)\.up_(\d+)_upsample\.", r"\1.up_blocks.\2.upsamplers.0.conv."),
    (r"^(\w+\.)?mid_res_(\d+)\.", r"\1mid_block.resnets.\2."),
    (r"^(\w+\.)?mid_attn\.", r"\1mid_block.attentions.0."),
    (r"\.blocks_(\d+)\.", r".transformer_blocks.\1."),
    (r"(^|\.)to_out\.", r"\1to_out.0."),
    (r"\.ff\.proj\.", ".ff.net.0.proj."),
    (r"\.ff\.out\.", ".ff.net.2."),
)


def unet_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """Reference ``UNet2DConditionModel`` params → the port's state_dict
    (diffusers names; the IP-Adapter's ``to_k_ip``/``to_v_ip``, the LoRA
    adapters and the int8 / int4 projections of ``quantize_unet_params``
    too); also an ``IPCrossAttention``'s alone."""
    return _renamed(tree, _BLOCK_RULES)


def vae_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """Reference ``AutoencoderKL`` params → state_dict (diffusers names,
    the modern ``to_q``/``to_out.0`` attention layout)."""
    return _renamed(tree, _BLOCK_RULES)


_PERCEIVER_RULES = (
    (r"^core\.latents$", "latents"),
    (r"^core\.attn_(\d+)\.", r"layers.\1.0."),
    (r"^core\.ff_(\d+)\.norm\.", r"layers.\1.1.0."),
    (r"^core\.ff_(\d+)\.fc1\.", r"layers.\1.1.1."),
    (r"^core\.ff_(\d+)\.fc2\.", r"layers.\1.1.3."),
)


def perceiver_from_jax(tree: dict, prefix: str = ""
                       ) -> Dict[str, torch.Tensor]:
    """Reference ``Resampler`` / ``ResamplerXL(V2)`` params → state_dict
    (the reference's torch checkpoint names)."""
    return {prefix + k: v for k, v in _renamed(tree, _PERCEIVER_RULES).items()}


def from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """Reference ``GeneralizedMultimodalModel`` or ``SEED`` params (SigLIP
    or Qwen-ViT tower), or one of the de-tokenizer's parts (the UNet, the
    VAE, a perceiver resampler), → the port's state_dict (fp32 CPU
    tensors; ``load_state_dict`` casts and moves)."""
    if "language_model" not in tree:
        if "core" in tree:
            return perceiver_from_jax(tree)
        if "encoder" in tree and "decoder" in tree:
            return vae_from_jax(tree)
        if "conv_in" in tree and "time_embedding" in tree:
            return unet_from_jax(tree)
        raise ValueError(f"unknown parameter tree: {sorted(tree)[:8]}")
    sd = {}
    sd.update(llama_from_jax(tree["language_model"], "language_model."))
    vision = tree["vision_encoder"]
    tower = qwen_vit_from_jax if "backbone" in vision else siglip_from_jax
    sd.update(tower(vision, "vision_encoder."))
    sd.update(resampler_from_jax(tree["projector"], "projector."))
    if "output_projector" in tree:
        sd.update(resampler_from_jax(tree["output_projector"],
                                     "output_projector."))
    if "patch_pos_embed" in tree:
        sd["patch_pos_embed"] = _t(tree["patch_pos_embed"])
    return sd


# -- the reference's checkpoint files → the port's state_dict ------------

class Lazy:
    """A tensor a loading rule makes (a resized embedding, a fresh LoRA
    adapter): its ``shape`` now, the tensor when called."""

    def __init__(self, shape, make: Callable[[], torch.Tensor]):
        self.shape = torch.Size(shape)
        self.make = make

    def __call__(self) -> torch.Tensor:
        return self.make()


def resize_embedding(emb: torch.Tensor, new_vocab: int,
                     mean_mult: float = 1.0) -> torch.Tensor:
    """``emb`` cut or padded to ``new_vocab`` rows in fp32, each new row
    ``mean_mult`` × the mean of the old rows (twin of the reference's
    ``resize_embedding``, ``weights.py:41-54``: 1.0 for the input
    embeddings, 3.0 for ``lm_head``; ``peft_models.py:56-99``)."""
    if new_vocab <= emb.shape[0]:
        return emb[:new_vocab].float()
    emb = emb.float()
    mean = emb.mean(dim=0, keepdim=True) * mean_mult
    return torch.cat([emb, mean.expand(new_vocab - emb.shape[0], -1)])


def _resized(emb: torch.Tensor, vocab: int, mult: float):
    if emb.shape[0] == vocab:
        return emb
    return Lazy((vocab, emb.shape[1]),
                lambda: resize_embedding(emb, vocab, mult))


def _lora_dims(cfg: LlamaConfig) -> Dict[str, tuple]:
    """(in, out) of each LoRA target of a Llama layer."""
    hs, inter = cfg.hidden_size, cfg.intermediate_size
    q = cfg.num_attention_heads * cfg.head_dim
    kv = cfg.num_key_value_heads * cfg.head_dim
    dims = {"self_attn.q_proj": (hs, q), "self_attn.k_proj": (hs, kv),
            "self_attn.v_proj": (hs, kv), "self_attn.o_proj": (q, hs),
            "mlp.gate_proj": (hs, inter), "mlp.up_proj": (hs, inter),
            "mlp.down_proj": (inter, hs)}
    return {k: v for k, v in dims.items()
            if k.split(".")[1] in cfg.lora_targets}


def _he_uniform(rs: np.random.RandomState, shape, fan_in: int) -> np.ndarray:
    return rs.uniform(-1, 1, shape).astype(np.float32) * (3.0 / fan_in) ** 0.5


def lora_init(cfg: LlamaConfig, rule: str) -> Dict[str, Lazy]:
    """Fresh adapters for every LoRA target of ``cfg``, B zero and A drawn
    with numpy as the reference draws it: ``rule="base"`` for a base
    loaded from its own checkpoint (``_relayout_lora``, ``factory.py:
    198-228``: one ``RandomState(0)`` per projection over the scan-stacked
    [layers, in, r] kernel), ``rule="assembly"`` for an assembly
    checkpoint without adapters (``torch_to_flax_llama``, ``weights.py:
    119-125``: ``RandomState(1234 + i)`` for layer i). A is stored
    transposed, [r, in]."""
    L, r = cfg.num_hidden_layers, cfg.lora_rank
    out = {}
    for mod, (i_dim, o_dim) in _lora_dims(cfg).items():
        if rule == "base":
            stack = {}

            def a(i, i_dim=i_dim, stack=stack):
                if "a" not in stack:
                    stack["a"] = _he_uniform(np.random.RandomState(0),
                                             (L, i_dim, r), i_dim)
                return torch.from_numpy(np.ascontiguousarray(stack["a"][i].T))
        elif rule == "assembly":
            def a(i, i_dim=i_dim):
                return torch.from_numpy(np.ascontiguousarray(_he_uniform(
                    np.random.RandomState(1234 + i), (i_dim, r), i_dim).T))
        else:
            raise ValueError(f"unknown LoRA rule {rule!r}")
        for i in range(L):
            key = f"model.layers.{i}.{mod}"
            out[f"{key}.lora_A.weight"] = Lazy((r, i_dim),
                                               lambda a=a, i=i: a(i))
            out[f"{key}.lora_B.weight"] = Lazy(
                (o_dim, r), lambda o=o_dim: torch.zeros(o, r))
    return out


_LLAMA_IGNORED = re.compile(r"(^|\.)rotary_emb\.inv_freq$")


def llama_state(sd: Dict[str, Any], cfg: LlamaConfig, *,
                lora: Optional[str] = "base", partial: bool = False
                ) -> Dict[str, Any]:
    """An HF Llama state dict (``model.`` prefix or none; peft names
    normalised first) → the port's ``LlamaForCausalLM`` state at
    ``cfg.vocab_size`` (twin of ``torch_to_flax_llama``, ``weights.py:
    57-167``): ``lm_head`` falls back to ``embed_tokens`` when absent, the
    vocabulary is resized by the mean rule (1.0 embeddings, 3.0
    ``lm_head``), and with LoRA in ``cfg`` the adapters are the
    checkpoint's ``lora_A`` / ``lora_B`` where it has them, else fresh by
    :func:`lora_init`'s ``lora`` rule. ``partial`` (an assembly's language
    model merged over the base): no fallback where the part holds no
    embeddings, and no fresh adapters where it holds some."""
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        if _LLAMA_IGNORED.search(k):
            continue
        if k.startswith("lm_head.") or not k.startswith(prefix):
            out[k] = v
        else:
            out["model." + k[len(prefix):]] = v
    emb_key, head_key = "model.embed_tokens.weight", "lm_head.weight"
    if emb_key in out and head_key not in out:
        out[head_key] = out[emb_key]
    if emb_key in out:
        out[emb_key] = _resized(out[emb_key], cfg.vocab_size, 1.0)
    if head_key in out:
        out[head_key] = _resized(out[head_key], cfg.vocab_size, 3.0)
    if cfg.lora_rank > 0 and lora is not None:
        has = any(k.endswith(".lora_A.weight") for k in out)
        if not (partial and has):
            for k, v in lora_init(cfg, lora).items():
                out.setdefault(k, v)
    return out


def _find_prefix(sd: Dict[str, Any], head: str, leaf: str, what: str) -> str:
    """The prefix under which ``sd`` holds a tower: ``head`` when a key
    starts with it, else whatever precedes the first key ending in
    ``leaf`` (the reference's search, ``weights.py:176-182, 272-276``)."""
    if any(k.startswith(head) for k in sd):
        return head
    cands = [k for k in sd if k.endswith(leaf)]
    if not cands:
        raise KeyError(f"no {what} keys in the checkpoint: {list(sd)[:5]}")
    return cands[0][:-len(leaf)]


# the parts of an HF SigLIP checkpoint the reference does not read
_SIGLIP_IGNORED = re.compile(r"^(head\.|embeddings\.position_ids$)")


def siglip_state(sd: Dict[str, Any], cfg=None) -> Dict[str, Any]:
    """An HF ``SiglipVisionModel`` state (``vision_model.``, or the nested
    prefix the reference searches for) → the port's
    ``SigLIPVisionEncoder`` state (twin of ``torch_to_flax_siglip``). The
    pooling head and the position-id buffer are left out, as the
    reference leaves them; keys outside the prefix are not the tower's."""
    pre = _find_prefix(sd, "vision_model.", "embeddings.patch_embedding."
                       "weight", "SigLIP")
    out = {}
    for k, v in sd.items():
        if not k.startswith(pre):
            continue
        rest = k[len(pre):]
        if not _SIGLIP_IGNORED.match(rest):
            out["vision_model." + rest] = v
    return out


_QWEN_IN_PROJ = re.compile(
    r"^(transformer\.resblocks\.\d+\.attn\.)in_proj_(weight|bias)$")


def qwen_vit_state(sd: Dict[str, Any], cfg=None) -> Dict[str, Any]:
    """A ``qwen_vit_G.pt``-style state (the tower at the root, or under the
    prefix the reference searches for) → the port's
    ``VisionTransformerWithAttnPool`` state (twin of
    ``torch_to_flax_qwen_vit``): a block's attention may be the fused
    ``attn.in_proj`` Linear (the reference's) or ``nn.MultiheadAttention``'s
    ``in_proj_weight`` / ``in_proj_bias``, both kept fused.
    ``patch_pos_embed`` only where ``cfg`` has patch positions."""
    pre = "" if any(k.startswith("conv1") for k in sd) else _find_prefix(
        sd, "conv1", "conv1.weight", "Qwen-ViT")
    out = {}
    for k, v in sd.items():
        if not k.startswith(pre):
            continue
        rest = _QWEN_IN_PROJ.sub(r"\1in_proj.\2", k[len(pre):])
        if rest == "patch_pos_embed" and not getattr(cfg, "patch_pos", True):
            continue
        out[rest] = v
    return out


_VAE_OLD_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                 "proj_attn": "to_out.0"}
_VAE_ATTN = re.compile(r"^(\w+\.mid_block\.attentions\.0\.)"
                       r"(query|key|value|proj_attn)\.(weight|bias)$")


def vae_state(sd: Dict[str, Any], cfg=None) -> Dict[str, Any]:
    """A diffusers ``AutoencoderKL`` state → the port's (twin of
    ``torch_to_flax_vae``): the pre-0.15 attention names
    (``query``/``key``/``value``/``proj_attn``) become the modern ones."""
    return {_VAE_ATTN.sub(lambda m: m.group(1) + _VAE_OLD_ATTN[m.group(2)]
                          + "." + m.group(3), k): v for k, v in sd.items()}


def normalize_peft_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A peft-wrapped language model's state → HF-Llama names (twin of the
    reference's ``normalize_peft_keys``, ``weights.py:668-695``): the
    ``base_model.model.`` wrapper and ``.base_layer.`` go, the trained
    ``.modules_to_save.default.`` copy wins over the dropped
    ``.original_module.``, ``.lora_{A,B}.default.`` → ``.lora_{A,B}.``."""
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        if ".original_module." in k:
            continue
        k = k.replace("base_model.model.", "")
        k = k.replace(".base_layer.", ".")
        k = k.replace(".modules_to_save.default.", ".")
        k = k.replace(".lora_A.default.", ".lora_A.")
        k = k.replace(".lora_B.default.", ".lora_B.")
        out[k] = v
    return out


def split_assembly_state(sd: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """An assembly state → {component: its state, prefix stripped}, with
    ``patch_pos_embed`` under ``__root__`` (twin of the reference's
    ``split_assembly_state``)."""
    out: Dict[str, Dict[str, Any]] = {}
    for k, v in sd.items():
        if k == "patch_pos_embed":
            out.setdefault("__root__", {})[k] = v
            continue
        head, _, rest = k.partition(".")
        out.setdefault(head, {})[rest] = v
    return out


def split_adapter_state(sd: Dict[str, Any]) -> tuple:
    """A de-tokenizer checkpoint → (resampler state, UNet state) (twin of
    the reference's ``split_adapter_state``)."""
    res = {k[len("resampler."):]: v for k, v in sd.items()
           if k.startswith("resampler.")}
    unet = {k[len("unet."):]: v for k, v in sd.items()
            if k.startswith("unet.")}
    return res, unet


ASSEMBLY_PARTS = ("language_model", "vision_encoder", "projector",
                  "output_projector")


def assembly_state(sd: Dict[str, Any], lm_config: LlamaConfig,
                   vision_convert: Callable, vision_config=None
                   ) -> Dict[str, Any]:
    """A reference assembly checkpoint (SEED-X's ``pytorch_model.bin``:
    ``language_model.*`` through peft, ``vision_encoder.*``,
    ``projector.*``, ``output_projector.*``, ``patch_pos_embed``) → the
    port's assembly state (twin of ``torch_to_flax_assembly``, ``weights.
    py:713-737``). The language model goes through :func:`llama_state`
    at the config's vocab, with fresh adapters by the assembly rule where
    it holds none; the tower through ``vision_convert``
    (:func:`siglip_state` or :func:`qwen_vit_state`). An unknown component
    raises."""
    out: Dict[str, Any] = {}
    for head, part in split_assembly_state(sd).items():
        if head == "__root__":
            out.update(part)
            continue
        if head == "language_model":
            conv = llama_state(normalize_peft_keys(part), lm_config,
                               lora="assembly", partial=True)
        elif head == "vision_encoder":
            conv = vision_convert(part, vision_config)
        elif head in ASSEMBLY_PARTS:
            conv = part
        else:
            raise KeyError(f"assembly checkpoint: unknown component "
                           f"{head!r} ({next(iter(part))!r}, …)")
        out.update({f"{head}.{k}": v for k, v in conv.items()})
    return out


def merge_partial_state(state: Dict[str, Any], partial: Dict[str, Any],
                        shapes: Dict[str, torch.Size], what: str) -> int:
    """Merge ``partial`` into ``state`` key by key, strictly (twin of
    ``merge_partial_unet_state``, ``weights.py:575-610``): a key the module
    (``shapes``: its parameters' shapes) does not hold raises ``KeyError``,
    a shape that does not match raises ``ValueError``. Returns the count
    merged."""
    for k, v in partial.items():
        if k not in shapes:
            raise KeyError(f"{what}: checkpoint key {k!r} is not a "
                           "parameter of the model")
        if tuple(v.shape) != tuple(shapes[k]):
            raise ValueError(f"{what}: shape mismatch merging {k!r}: "
                             f"checkpoint {tuple(v.shape)} vs model "
                             f"{tuple(shapes[k])}")
        state[k] = v
    return len(partial)


def remove_mismatched_weights(shapes: Dict[str, torch.Size],
                              state: Dict[str, Any]) -> list:
    """Drop the entries of ``state`` whose shapes differ from the model's
    (``shapes``), logging each; returns the dropped keys (twin of
    ``utils/misc.py:47``; ``init_assembly_params``' skip,
    ``factory.py:387-403``)."""
    dropped = []
    for k in list(state):
        if k in shapes and tuple(shapes[k]) != tuple(state[k].shape):
            log.warning("skipping mismatched weight %s: checkpoint %s, "
                        "model %s", k, tuple(state[k].shape),
                        tuple(shapes[k]))
            dropped.append(k)
            del state[k]
    return dropped


def reload_qwen_vit(pretrained_path, out_path) -> Dict[str, torch.Tensor]:
    """The visual tower of a whole Qwen-VL checkpoint
    (``transformer.visual.*`` or ``visual.*``) saved alone to ``out_path``
    (twin of ``utils/misc.py:31``)."""
    from mllm_npu_tpu_torch.utils.checkpoint_files import load_torch_file
    ckpt = load_torch_file(pretrained_path)
    for pre in ("transformer.visual.", "visual."):
        visual = {k[len(pre):]: v for k, v in ckpt.items()
                  if k.startswith(pre)}
        if visual:
            break
    torch.save(visual, out_path)
    log.info("extracted %d visual tensors -> %s", len(visual), out_path)
    return visual


def set_llama_config(lm: nn.Module, **changes) -> None:
    """Replace the config held by ``lm`` and each of its submodules."""
    cfg = dataclasses.replace(lm.config, **changes)
    for mod in lm.modules():
        if isinstance(getattr(mod, "config", None), LlamaConfig):
            mod.config = cfg


def _swap(root: nn.Module, name: str, new: nn.Module) -> None:
    parent, _, child = name.rpartition(".")
    setattr(root.get_submodule(parent), child, new)


@torch.no_grad()
def merge_lora_(lm: nn.Module) -> None:
    """In place: fold every LoRA adapter of the Llama ``lm`` into its base,
    W + (α/r)·B·A computed in fp32 and cast back to W's dtype (peft
    ``merge_and_unload``; twin of ``merge_lora_params``). Each
    ``LoRALinear`` becomes a plain ``Linear`` and ``lora_rank`` becomes 0."""
    names = [n for n, m in lm.named_modules() if isinstance(m, LoRALinear)]
    for name in names:
        mod = lm.get_submodule(name)
        if mod.base is not None:
            raise ValueError(f"{name}: an adapter over a quantized base "
                             "cannot be merged (merge, then quantize)")
        w = mod.weight
        delta = (mod.lora_B.weight.float() @ mod.lora_A.weight.float()
                 ) * mod.scale
        with torch.device("meta"):
            merged = Linear(w.shape[1], w.shape[0], bias=False,
                            dtype=mod.compute_dtype)
        merged.weight = nn.Parameter((w.float() + delta).to(w.dtype),
                                     requires_grad=w.requires_grad)
        _swap(lm, name, merged)
        del mod, w, delta   # the old weight goes before the next is merged
    set_llama_config(lm, lora_rank=0)


_FUSED = (("self_attn", "qkv_proj", ("q_proj", "k_proj", "v_proj")),
          ("mlp", "gate_up_proj", ("gate_proj", "up_proj")))


def _fuse(parts):
    """One module whose output is the concatenation of ``parts``' (bias-free
    Linear, Int8Linear or Int4Linear of one input width): their weights
    (or int8 values and per-channel scales, or packed int4 values and
    group scales) joined along the output axis. Quantization is per output
    channel, so fusing quantized parts gives the same buffers as
    quantizing the fused float weight."""
    first = parts[0]
    n_out = sum(_out(p) for p in parts)
    if isinstance(first, Int8Linear):
        with torch.device("meta"):
            new = Int8Linear(first.weight_q.shape[1], n_out,
                             first.compute_dtype)
        new.weight_q = torch.cat([p.weight_q for p in parts])
        new.scale = torch.cat([p.scale for p in parts])
    elif isinstance(first, Int4Linear):
        K = 2 * first.weight_q.shape[1]
        G = K // first.scale_g.shape[0]
        with torch.device("meta"):
            new = Int4Linear(K, n_out, G, first.compute_dtype)
        new.weight_q = torch.cat([p.weight_q for p in parts])
        new.scale_g = torch.cat([p.scale_g for p in parts], dim=1)
    else:
        w = first.weight
        with torch.device("meta"):
            new = Linear(w.shape[1], n_out, bias=False,
                         dtype=first.compute_dtype)
        new.weight = nn.Parameter(torch.cat([p.weight for p in parts]),
                                  requires_grad=w.requires_grad)
    return new


def _out(m: nn.Module) -> int:
    return (m.weight_q if hasattr(m, "weight_q") else m.weight).shape[0]


@torch.no_grad()
def fuse_llama_projections_(lm: nn.Module) -> None:
    """In place: join each layer's q/k/v projections into ``qkv_proj``
    ([(H + 2·Hkv)·D, hidden]) and gate/up into ``gate_up_proj`` ([2·I,
    hidden]), in the reference's order (``fuse_llama_projections`` with
    one shard: q | k | v, gate | up), and set ``fused_projections``.
    Serving order: after :func:`merge_lora_` (a LoRA model raises) and
    before :func:`quantize_llama_`; fusing a quantized model gives the same
    buffers. The parts are freed as each fused module is made."""
    if any(isinstance(m, LoRALinear) for m in lm.modules()):
        raise ValueError("merge the LoRA adapters (merge_lora_) before "
                         "fusing projections")
    if lm.config.fused_projections:
        return
    for layer in lm.model.layers:
        for group, fused, names in _FUSED:
            mod = getattr(layer, group)
            setattr(mod, fused, _fuse([getattr(mod, n) for n in names]))
            for n in names:
                delattr(mod, n)
            if group == "mlp":
                mod.fused = True
    set_llama_config(lm, fused_projections=True)


def _quantized(w: torch.Tensor, bits: int, group_size: int, dtype):
    if bits == 8:
        return Int8Linear.from_weight(w, dtype)
    return Int4Linear.from_weight(w, group_size, dtype)


@torch.no_grad()
def quantize_llama_(lm: nn.Module, bits: int = 8, group_size: int = 256,
                    keep_lora: bool = False) -> None:
    """In place: swap every bias-free ``Linear`` of the Llama ``lm`` (the
    seven projections of each layer and the ``lm_head``; paths with
    ``embed`` are skipped, as the reference) for an ``Int8Linear`` or
    ``Int4Linear`` quantized from its current values on its device (twin of
    ``quantize_llama_params``). Each float weight is freed once its
    replacement exists. Serving merges LoRA adapters first
    (:func:`merge_lora_`); a model with adapters raises unless
    ``keep_lora``, the QLoRA layout: each adapter's base is quantized into
    its ``base`` and the adapters stay float (the reference's trainer with
    ``--quantize_base``)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    adapters = [n for n, m in lm.named_modules() if isinstance(m, LoRALinear)]
    if adapters and not keep_lora:
        raise ValueError("merge the LoRA adapters (merge_lora_) before "
                         "quantizing")
    for name in adapters:
        mod = lm.get_submodule(name)
        mod.base = _quantized(mod.weight, bits, group_size, mod.compute_dtype)
        del mod.weight
    inside = tuple(f"{n}." for n in adapters)
    names = [n for n, m in lm.named_modules()
             if isinstance(m, Linear) and m.bias is None and "embed" not in n
             and not n.startswith(inside)]
    for name in names:
        mod = lm.get_submodule(name)
        _swap(lm, name, _quantized(mod.weight, bits, group_size,
                                   mod.compute_dtype))
        del mod   # the float weight goes before the next is quantized
    set_llama_config(lm, quantization=f"int{bits}",
                      quant_group_size=group_size)
