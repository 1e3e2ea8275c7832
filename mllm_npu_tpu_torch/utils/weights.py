"""JAX parameter tree → the port's state_dict.

:func:`from_jax_params` takes the reference assembly's ``params["params"]``
as nested dicts of numpy arrays and returns the port's weights, whose
names are the torch names the reference's converters read
(``mllm_npu_tpu/utils/weights.py``: HF Llama with peft adapters, HF
SigLIP, the reference resampler), so ``torch_to_flax_assembly`` inverts
it. It undoes:

- the scan-stacked leading layer axis (Llama and SigLIP layers);
- Dense ``[in, out]`` → Linear ``[out, in]``, LoRA ``lora_a [in, r]`` →
  ``lora_A.weight [r, in]`` and ``lora_b [r, out]`` → ``lora_B.weight``;
- HWIO → OIHW for the patch conv;
- split q/k/v/out projections → ``nn.MultiheadAttention``'s fused
  ``in_proj_weight``/``in_proj_bias`` for the resampler.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _dense_T(x) -> torch.Tensor:
    return _t(np.asarray(x).T)


def llama_from_jax(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``LlamaForCausalLM`` params (scan-stacked layers) → state_dict."""
    sd = {}
    m = tree["model"]
    sd[f"{prefix}model.embed_tokens.weight"] = _t(
        m["embed_tokens"]["embedding"])
    sd[f"{prefix}model.norm.weight"] = _t(m["norm"]["weight"])
    sd[f"{prefix}lm_head.weight"] = _dense_T(tree["lm_head"]["kernel"])
    layers = m["layers"]
    L = np.asarray(layers["input_layernorm"]["weight"]).shape[0]
    for i in range(L):
        lp = f"{prefix}model.layers.{i}."
        for norm in ("input_layernorm", "post_attention_layernorm"):
            sd[f"{lp}{norm}.weight"] = _t(layers[norm]["weight"][i])
        for group, names in (("self_attn", ("q_proj", "k_proj", "v_proj",
                                            "o_proj")),
                             ("mlp", ("gate_proj", "up_proj", "down_proj"))):
            for name in names:
                node = layers[group][name]
                key = f"{lp}{group}.{name}"
                if "base" in node:
                    sd[f"{key}.weight"] = _dense_T(node["base"]["kernel"][i])
                    sd[f"{key}.lora_A.weight"] = _dense_T(node["lora_a"][i])
                    sd[f"{key}.lora_B.weight"] = _dense_T(node["lora_b"][i])
                else:
                    sd[f"{key}.weight"] = _dense_T(node["kernel"][i])
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


def from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """Reference ``GeneralizedMultimodalModel`` params → the port's
    state_dict (fp32 CPU tensors; ``load_state_dict`` casts and moves)."""
    sd = {}
    sd.update(llama_from_jax(tree["language_model"], "language_model."))
    sd.update(siglip_from_jax(tree["vision_encoder"], "vision_encoder."))
    sd.update(resampler_from_jax(tree["projector"], "projector."))
    if "patch_pos_embed" in tree:
        sd["patch_pos_embed"] = _t(tree["patch_pos_embed"])
    return sd
