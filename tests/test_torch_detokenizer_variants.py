"""The de-tokenizer's UNet variants in the port against the JAX package on
the CPU, in fp32 at tiny widths, inputs drawn from numpy seeds: the biased
int8 / int4 linear (``QuantDense``), the 8-channel edit UNet, UNet LoRA,
the int8 and int4 UNet (``quantize_unet_params`` on both sides), the SD-2.1
and SD-1.5 layouts (four levels, the last without attention, no added
conditioning) with the IP-Adapter's image tokens, ``IPCrossAttention`` and
``split_ip_context``; every tree carried into the port by ``unet_from_jax``
and back to the reference's tree unchanged; the trainable sets of every
adapter, name for name; and three defects of the reference, each shown
beside the port's behaviour.

Tolerances: ε within 1e-4 absolute (outputs of order 1; the same fp32
products summed in other orders, and for the quantized UNet the scales
applied after the product here, to the weight there); quantized storage
bit for bit.
"""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation import attention_processor as jap
from mllm_npu_tpu.models.generation import resampler as jr
from mllm_npu_tpu.models.generation.adapter_modules import (
    SDXLText2ImageAndEditAdapter as JLoRAAdapter,
    adapter_trainable_patterns as j_adapter_patterns,
    ip_adapter_trainable_patterns as j_ip_patterns)
from mllm_npu_tpu.models.generation.unet import (
    UNet2DConditionModel as JUNet, UNetConfig as JUNetConfig,
    quantize_unet_params as j_quantize_unet)
from mllm_npu_tpu.ops import quant as jq
from mllm_npu_tpu.train.train_state import trainable_mask
from mllm_npu_tpu.utils.weights import _unet_torch_key_to_flax
from mllm_npu_tpu_torch.models.generation import attention_processor as tap
from mllm_npu_tpu_torch.models.generation import resampler as tr
from mllm_npu_tpu_torch.models.generation.adapter_modules import (
    SDXLText2ImageAndEditAdapter, adapter_trainable_patterns,
    ip_adapter_trainable_patterns)
from mllm_npu_tpu_torch.models.generation.unet import (
    UNET_QUANT_SKIP, UNet2DConditionModel, UNetConfig, quantize_unet_params)
from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.train.train_state import apply_frozen_patterns
from mllm_npu_tpu_torch.utils.weights import (perceiver_from_jax,
                                              unet_from_jax)
from test_torch_detokenizer import (DEBUG_RESAMPLER, UNET_ATOL,
                                    _unet_inputs, assert_same_tree,
                                    seeded_tree, unet_eps)

LIN_ATOL = 1e-4


def sd_small(kind: str, **kw) -> dict:
    """Keywords of ``UNetConfig.sd21`` / ``sd15`` at narrow widths: four
    levels (Cross, Cross, Cross, Down), SD-2.1's one head width everywhere
    (as its 64) and SD-1.5's head width doubling per level (as its 40, 80,
    160)."""
    heads = {"sd21": (2, 4, 8, 8), "sd15": (4, 4, 4, 4)}[kind]
    base = dict(block_out_channels=(32, 64, 128, 128), layers_per_block=1,
                num_attention_heads=heads, cross_attention_dim=48,
                norm_num_groups=8, sample_size=16, remat=False)
    base.update(kw)
    return base


def config_pair(kind: str, **kw):
    """(reference config, port config) of one layout."""
    if kind in ("sd21", "sd15"):
        kw = sd_small(kind, **kw)
        return (getattr(JUNetConfig, kind)(**kw),
                getattr(UNetConfig, kind)(**kw))
    return JUNetConfig.tiny(**kw), UNetConfig.tiny(**kw)


def jax_tree_of(sd: dict) -> dict:
    """The port's UNet state_dict → the reference's tree: the inverse of
    ``unet_from_jax``, through the reference's own key map for the float
    leaves (``_unet_torch_key_to_flax``) and the LoRA and quantized leaves'
    names."""
    lora = {k[:-len(".lora_A.weight")] for k in sd
            if k.endswith(".lora_A.weight")}
    flat = {}
    for key, t in sd.items():
        x = t.numpy()
        mod, leaf = key.rsplit(".", 1)
        if leaf in ("weight_q", "scale", "scale_g"):
            path, _ = _unet_torch_key_to_flax(mod + ".weight")
            path = path[:-1] + ("kernel_q" if leaf == "weight_q" else leaf,)
            x = x.T if leaf == "weight_q" else x
        elif mod.endswith((".lora_A", ".lora_B")):
            base, ab = mod.rsplit(".", 1)
            path, _ = _unet_torch_key_to_flax(base + ".weight")
            path, x = path[:-1] + ("lora_" + ab[-1].lower(),), x.T
        else:
            path, tf = _unet_torch_key_to_flax(key)
            x = tf(x)
            if mod in lora:
                path = path[:-1] + ("base", "kernel")
        flat[path] = x
    return flax.traverse_util.unflatten_dict(flat)


def _sd(module):
    return {k: v.detach() for k, v in module.state_dict().items()}


# -- QuantDense: the biased int8 / int4 linear -------------------------------

@pytest.mark.parametrize("bits,K", [(8, 640), (4, 640), (4, 512)])
def test_biased_quant_linear_matches_quant_dense(bits, K):
    """K = 640 takes one int4 group of 640 (256 does not divide it, the
    SDXL UNet's level-1 projections); 512 two of 256."""
    rs = np.random.RandomState(11)
    N = 96
    x = rs.randn(3, 5, K).astype(np.float32)
    dense = {"kernel": (0.05 * rs.randn(K, N)).astype(np.float32),
             "bias": rs.randn(N).astype(np.float32)}
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_dense_params(
        {"d": dense}, skip=(), bits=bits)["d"])
    mod = jq.QuantDense(N, quantization=f"int{bits}", use_bias=True,
                        dtype=jnp.float32)
    ref = np.asarray(mod.apply({"params": qtree}, jnp.asarray(x)))
    # the port's storage from the reference's tree, and quantized here
    sd = unet_from_jax({"d": qtree})
    w = torch.from_numpy(dense["kernel"].T.copy())
    b = torch.from_numpy(dense["bias"])
    if bits == 8:
        tm = tq.Int8Linear.from_weight(w, torch.float32, bias=b)
    else:
        tm = tq.Int4Linear.from_weight(w, 256, torch.float32, bias=b)
    assert {f"d.{k}" for k in _sd(tm)} == set(sd)
    for k, v in _sd(tm).items():
        assert torch.equal(v, sd[f"d.{k}"]), k
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=LIN_ATOL, rtol=0)
    # the state_dict transform equals the reference's tree transform
    port_q = tq.quantize_dense_params({"d.weight": w, "d.bias": b}, skip=(),
                                      bits=bits)
    assert port_q.keys() == sd.keys()
    for k in sd:
        assert torch.equal(port_q[k], sd[k]), k


# -- the UNet's variants --------------------------------------------------------

VARIANTS = {
    "edit_8ch": ("tiny", dict(in_channels=8), None),
    "lora": ("tiny", dict(lora_rank=4), None),
    "lora_qkvo": ("tiny", dict(lora_rank=2, lora_targets=(
        "to_q", "to_k", "to_v", "to_out")), None),
    "int8": ("tiny", dict(quantization="int8"), 8),
    "int4": ("tiny", dict(quantization="int4"), 4),
    "sd21": ("sd21", {}, None),
    "sd15_ip": ("sd15", dict(ip_num_image_tokens=4, ip_scale=0.7), None),
    "sd21_edit_lora": ("sd21", dict(in_channels=8, lora_rank=4), None),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unet_variant_matches_reference_and_carries_back(variant):
    kind, kw, bits = VARIANTS[variant]
    jcfg, tcfg = config_pair(kind, **kw)
    ref, got, tree, tm = unet_eps(jcfg, tcfg, quant_bits=bits)
    assert got.shape == ref.shape
    assert got.shape[-1] == 4
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=UNET_ATOL, rtol=0)
    assert_same_tree(jax_tree_of(_sd(tm)), tree)
    if bits:
        kinds = {type(m).__name__ for m in tm.modules()}
        assert f"Int{bits}Linear" in kinds and "LoRALinear" not in kinds


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_unet_params_matches_reference(bits):
    jcfg, tcfg = JUNetConfig.tiny(), UNetConfig.tiny()
    x = _unet_inputs(jcfg)
    args = (jnp.asarray(x["sample"]), jnp.asarray(x["t"]),
            jnp.asarray(x["ctx"]),
            {"text_embeds": jnp.asarray(x["text_embeds"]),
             "time_ids": jnp.asarray(x["time_ids"])})
    tree = seeded_tree(JUNet(jcfg), *args, seed=3)
    want = unet_from_jax(jax.tree_util.tree_map(
        np.asarray, j_quantize_unet(tree, bits=bits)))
    got = quantize_unet_params(unet_from_jax(tree), bits=bits)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the skipped layers stay float, every block projection is quantized
    assert all(not any(s in k for s in UNET_QUANT_SKIP)
               for k in got if k.endswith(".weight_q"))
    assert not any(k.endswith(".weight") and v.ndim == 2
                   and not any(s in k for s in UNET_QUANT_SKIP)
                   for k, v in got.items())
    tm = UNet2DConditionModel(dataclasses.replace(
        tcfg, quantization=f"int{bits}"))
    tm.load_state_dict(got, strict=True)


def test_ip_cross_attention_and_split_match_reference():
    rs = np.random.RandomState(12)
    x = rs.randn(2, 9, 32).astype(np.float32)
    ctx = rs.randn(2, 7 + 3, 24).astype(np.float32)
    text, image = jap.split_ip_context(jnp.asarray(ctx), 3)
    t_text, t_image = tap.split_ip_context(torch.from_numpy(ctx), 3)
    np.testing.assert_array_equal(t_text.numpy(), np.asarray(text))
    np.testing.assert_array_equal(t_image.numpy(), np.asarray(image))
    jm = jap.IPCrossAttention(32, 4, 8, 24, ip_scale=0.5)
    tree = seeded_tree(jm, jnp.asarray(x), text, image, seed=13)
    tm = tap.IPCrossAttention(32, 4, 8, 24, ip_scale=0.5)
    tm.load_state_dict(unet_from_jax(tree), strict=True)
    for img in (image, None):
        ref = np.asarray(jm.apply({"params": tree}, jnp.asarray(x), text,
                                  img))
        with torch.no_grad():
            got = tm(torch.from_numpy(x), t_text,
                     None if img is None else t_image).numpy()
        np.testing.assert_allclose(got, ref, atol=LIN_ATOL, rtol=0)


# -- the trainable sets, name for name --------------------------------------

def _port_names(jax_tree: dict, convert) -> dict:
    """{reference leaf path: the port's name}: each leaf of ``jax_tree``
    replaced by its index and carried through ``convert``."""
    leaves = jax.tree_util.tree_leaves_with_path(jax_tree)
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jax_tree),
        [np.full(np.shape(v), i, np.float32) for i, (_, v) in
         enumerate(leaves)])
    by_id = {int(t.flatten()[0]): k for k, t in convert(ids).items()}
    assert len(by_id) == len(leaves)
    return {jax.tree_util.keystr(p): by_id[i]
            for i, (p, _) in enumerate(leaves)}


def _trees(jcfg, resampler):
    """The UNet's and the resampler's parameter trees, zeros of their
    shapes and dtypes (the sets below need only the names)."""
    x = _unet_inputs(jcfg)
    added = None
    if jcfg.projection_class_embeddings_input_dim:
        added = {"text_embeds": jnp.asarray(x["text_embeds"]),
                 "time_ids": jnp.asarray(x["time_ids"])}
    zeros = lambda tree: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), tree["params"])
    utree = zeros(jax.eval_shape(
        JUNet(jcfg).init, jax.random.PRNGKey(0), jnp.asarray(x["sample"]),
        jnp.asarray(x["t"]), jnp.asarray(x["ctx"]), added))
    rtree = zeros(jax.eval_shape(resampler.init, jax.random.PRNGKey(1),
                                 jnp.ones((1, 4, 128))))
    return utree, rtree


SETS = {
    # name: (layout, keywords, resampler, reference patterns, port patterns)
    "adapter": ("tiny", {}, "xl", j_adapter_patterns(),
                adapter_trainable_patterns()),
    "adapter_full_ft": ("tiny", {}, "xl", j_adapter_patterns(True),
                        adapter_trainable_patterns(True)),
    "lora_with_down_block": (
        "tiny", dict(in_channels=8, lora_rank=4), "xl",
        JLoRAAdapter.trainable_patterns(True),
        SDXLText2ImageAndEditAdapter.trainable_patterns(True)),
    "lora_only": ("tiny", dict(in_channels=8, lora_rank=4), "xl",
                  JLoRAAdapter.trainable_patterns(False),
                  SDXLText2ImageAndEditAdapter.trainable_patterns(False)),
    "ip_adapter": ("sd15", dict(ip_num_image_tokens=4), "plain",
                   j_ip_patterns(), ip_adapter_trainable_patterns()),
}


def _resamplers(kind, width):
    if kind == "xl":
        kw = dict(DEBUG_RESAMPLER, normalize=True)
        return jr.ResamplerXL(**kw), tr.ResamplerXL(**kw)
    kw = dict(dim=32, depth=1, dim_head=8, heads=4, num_queries=4,
              embedding_dim=128, output_dim=width)
    return jr.Resampler(**kw), tr.Resampler(**kw)


@pytest.mark.parametrize("which", sorted(SETS))
def test_trainable_sets_match_reference_name_for_name(which):
    """The reference's regexes over its tree (``{"unet": ..., "resampler":
    ...}``, ``trainable_mask``) against the port's over ``parts``' names,
    through ``unet_from_jax`` / ``perceiver_from_jax``'s name maps."""
    kind, kw, res_kind, jpats, tpats = SETS[which]
    jcfg, tcfg = config_pair(kind, **kw)
    jres, tres = _resamplers(res_kind, tcfg.cross_attention_dim)
    utree, rtree = _trees(jcfg, jres)
    trees = {"unet": utree, "resampler": rtree}
    names = {**{f"['unet']{p}": f"unet.{n}"
                for p, n in _port_names(utree, unet_from_jax).items()},
             **{f"['resampler']{p}": f"resampler.{n}"
                for p, n in _port_names(rtree, perceiver_from_jax).items()}}
    mask = trainable_mask(trees, jpats)
    want = {names[jax.tree_util.keystr(p)] for p, t in
            jax.tree_util.tree_leaves_with_path(mask) if t}
    parts = torch.nn.ModuleDict({"unet": UNet2DConditionModel(tcfg),
                                 "resampler": tres})
    apply_frozen_patterns(parts, tpats)
    got = {n for n, p in parts.named_parameters() if p.requires_grad}
    assert set(names.values()) == {n for n, _ in parts.named_parameters()}
    assert got == want
    assert any(n.startswith("resampler.") for n in got)
    if which != "adapter_full_ft":
        assert any(n.startswith("unet.") for n in got)
        assert not all(n in got for n, _ in parts.named_parameters())


# -- the reference's defects ------------------------------------------------

def test_reference_train_down_block_rule_misses_its_params_level():
    """``SDXLText2ImageAndEditAdapter.trainable_patterns(True)`` exempts
    ``unet/down_0_…`` right after ``unet/``; the tree its ``loss_fn`` takes
    holds ``{"unet": {"params": ...}}``, so no down block ever trains there.
    The port trains ``down_blocks.0`` as the rule means."""
    jcfg, tcfg = config_pair("tiny", in_channels=8, lora_rank=4)
    jres, tres = _resamplers("xl", 64)
    utree, rtree = _trees(jcfg, jres)
    pats = JLoRAAdapter.trainable_patterns(True)

    def down0(trees):
        mask = trainable_mask(trees, pats)
        return [jax.tree_util.keystr(p) for p, t in
                jax.tree_util.tree_leaves_with_path(mask)
                if t and "down_0_" in jax.tree_util.keystr(p)]
    assert down0({"unet": utree, "resampler": rtree})
    assert not down0({"unet": {"params": utree},
                      "resampler": {"params": rtree}})
    parts = torch.nn.ModuleDict({"unet": UNet2DConditionModel(tcfg),
                                 "resampler": tres})
    apply_frozen_patterns(parts,
                          SDXLText2ImageAndEditAdapter.trainable_patterns())
    assert any(n.startswith("unet.down_blocks.0.resnets.0.")
               for n, p in parts.named_parameters() if p.requires_grad)


def test_lora_to_out_has_no_bias_as_in_the_reference():
    """The reference's LoRA ``to_out`` (a ``LoRADense``) drops its bias,
    so a diffusers LoRA checkpoint's ``to_out.0.bias`` has nowhere to go;
    the port matches it module for module, and a state that holds the bias
    does not load."""
    jcfg, tcfg = config_pair("tiny", lora_rank=4)
    utree, _ = _trees(jcfg, _resamplers("xl", 64)[0])
    node = utree["down_1_attn_0"]["blocks_0"]["attn1"]
    assert set(node["to_out"]) == {"base", "lora_a", "lora_b"}
    assert "bias" in _trees(JUNetConfig.tiny(), _resamplers("xl", 64)[0])[
        0]["down_1_attn_0"]["blocks_0"]["attn1"]["to_out"]
    tm = UNet2DConditionModel(tcfg)
    sd = _sd(tm)
    key = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_out.0"
    assert f"{key}.lora_A.weight" in sd and f"{key}.bias" not in sd
    assert f"{key}.bias" in _sd(UNet2DConditionModel(UNetConfig.tiny()))
    sd[f"{key}.bias"] = torch.zeros(64)
    with pytest.raises(RuntimeError, match=r"to_out\.0\.bias"):
        tm.load_state_dict(sd, strict=True)


def test_quantize_with_lora_breaks_the_reference_and_raises_here():
    """The reference's ``quantize_unet_params`` quantizes the LoRA bases
    (``base/kernel`` → ``base/kernel_q``), which its ``LoRADense`` cannot
    read; the port refuses LoRA with quantization, naming the issue."""
    jcfg = JUNetConfig.tiny(lora_rank=4, quantization="int8")
    x = _unet_inputs(jcfg)
    args = (jnp.asarray(x["sample"]), jnp.asarray(x["t"]),
            jnp.asarray(x["ctx"]),
            {"text_embeds": jnp.asarray(x["text_embeds"]),
             "time_ids": jnp.asarray(x["time_ids"])})
    float_tree = seeded_tree(JUNet(dataclasses.replace(
        jcfg, quantization=None)), *args)
    q = j_quantize_unet(float_tree)
    base = q["down_1_attn_0"]["blocks_0"]["attn1"]["to_q"]["base"]
    assert set(base) == {"kernel_q", "scale"}
    with pytest.raises(Exception, match="kernel"):
        jax.jit(JUNet(jcfg).apply)({"params": q}, *args)
    with pytest.raises(ValueError, match="known issues"):
        UNet2DConditionModel(UNetConfig.tiny(lora_rank=4,
                                             quantization="int8"))
    lora_sd = _sd(UNet2DConditionModel(UNetConfig.tiny(lora_rank=4)))
    with pytest.raises(ValueError, match="LoRA"):
        quantize_unet_params(lora_sd)
