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
  transpose; ``scale`` [N] and ``scale_g`` [K/G, N] as they are.

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

It also holds the port's serving transforms, :func:`merge_lora_`,
:func:`fuse_llama_projections_` and :func:`quantize_llama_` (twins of
``merge_lora_params``, ``fuse_llama_projections`` with one shard and
``quantize_llama_params``). Unlike the reference's pure tree functions,
they change the model in place and free each replaced weight as they go,
so a full-width model is never held twice.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

import numpy as np
import torch
from torch import nn

from mllm_npu_tpu_torch.models.language_models.llama import (LlamaConfig,
                                                             LoRALinear)
from mllm_npu_tpu_torch.models.layers import Linear
from mllm_npu_tpu_torch.ops.quant import Int4Linear, Int8Linear


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
                    sd[f"{key}.weight"] = _dense_T(node["base"]["kernel"][i])
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
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _renamed(tree: dict, rules) -> Dict[str, torch.Tensor]:
    """Every leaf of ``tree`` under its dotted path rewritten by ``rules``
    (regex, replacement), applied in order: kernels to torch's layout,
    norm scales to ``weight``."""
    sd = {}
    for path, x in _named_leaves(tree):
        x = np.asarray(x)
        *mods, leaf = path
        if leaf == "kernel":
            leaf, x = "weight", (x.transpose(3, 2, 0, 1) if x.ndim == 4
                                 else x.T)
        elif leaf == "scale":
            leaf = "weight"
        key = ".".join(mods + [leaf])
        for pat, rep in rules:
            key = re.sub(pat, rep, key)
        sd[key] = _t(x)
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
    (r"\.to_out\.", ".to_out.0."),
    (r"\.ff\.proj\.", ".ff.net.0.proj."),
    (r"\.ff\.out\.", ".ff.net.2."),
)


def unet_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """Reference ``UNet2DConditionModel`` params → the port's state_dict
    (diffusers names; the IP-Adapter's ``to_k_ip``/``to_v_ip`` too)."""
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


@torch.no_grad()
def quantize_llama_(lm: nn.Module, bits: int = 8,
                    group_size: int = 256) -> None:
    """In place: swap every bias-free ``Linear`` of the Llama ``lm`` (the
    seven projections of each layer and the ``lm_head``; paths with
    ``embed`` are skipped, as the reference) for an ``Int8Linear`` or
    ``Int4Linear`` quantized from its current values on its device (twin of
    ``quantize_llama_params``). Each float weight is freed once its
    replacement exists. Merge LoRA adapters first (:func:`merge_lora_`)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if any(isinstance(m, LoRALinear) for m in lm.modules()):
        raise ValueError("merge the LoRA adapters (merge_lora_) before "
                         "quantizing")
    names = [n for n, m in lm.named_modules()
             if isinstance(m, Linear) and m.bias is None and "embed" not in n]
    for name in names:
        mod = lm.get_submodule(name)
        if bits == 8:
            new = Int8Linear.from_weight(mod.weight, mod.compute_dtype)
        else:
            new = Int4Linear.from_weight(mod.weight, group_size,
                                         mod.compute_dtype)
        _swap(lm, name, new)
        del mod   # the float weight goes before the next is quantized
    set_llama_config(lm, quantization=f"int{bits}",
                      quant_group_size=group_size)
