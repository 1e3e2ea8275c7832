"""The port's checkpoint loading per component, against the reference's
converters on the same files: HF Llama (a ``.bin`` directory, safetensors
shards written by the ``safetensors`` package, a single file; with the
vocabulary resized; with and without trained adapters), HF SigLIP, a
``qwen_vit_G.pt``-style tower, the diffusers UNet and VAE, and the
de-tokenizer checkpoint with a partial UNet. The port builds each through
its builders outside ``DEBUG_FLAG`` with the full-width configs pointed at
the tiny ones (``checkpoint_sources.patch_tiny``); the reference converts
the same files with ``torch_to_flax_*``. Forwards agree within 1e-5 in
fp32 (relative to the output's scale for the UNet and the VAE, whose
seeded weights are large)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch as st
import torch

from mllm_npu_tpu.models.generation import resampler as jr
from mllm_npu_tpu.models.generation.unet import (
    UNet2DConditionModel as JUNet, UNetConfig as JUNetConfig)
from mllm_npu_tpu.models.generation.vae import (AutoencoderKL as JVAE,
                                                VAEConfig as JVAEConfig)
from mllm_npu_tpu.models import factory as jfactory
from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JConfig, LlamaForCausalLM as JLlama)
from mllm_npu_tpu.models.multimodal_encoder.qwenvl_vit import (
    QwenViTConfig as JQwenCfg, VisionTransformerWithAttnPool as JQwen)
from mllm_npu_tpu.models.multimodal_encoder.siglip_vit import (
    SigLIPConfig as JSigCfg, SigLIPVisionEncoder as JSig)
from mllm_npu_tpu.utils import weights as JW
from mllm_npu_tpu_torch.models import factory
from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
    QwenViTConfig, VisionTransformerWithAttnPool)
from mllm_npu_tpu_torch.utils import weights as W
from mllm_npu_tpu_torch.utils.weights import perceiver_from_jax

import checkpoint_sources as src
from test_unet_vae_conversion import synth_unet_sd, synth_vae_sd

ATOL = 1e-5
RTOL_SCALED = 1e-5      # |port - reference| / max |reference|


@pytest.fixture
def full_width(monkeypatch):
    """Outside DEBUG_FLAG, the full-width configs tiny on both sides."""
    monkeypatch.delenv("DEBUG_FLAG", raising=False)
    src.patch_tiny(monkeypatch.setattr)


def _save(sd, path, fmt):
    """``sd`` in one of the reference's layouts; → the path to configure."""
    path.mkdir(parents=True, exist_ok=True)
    if fmt == "bin":
        torch.save(sd, path / "pytorch_model.bin")
        return path
    if fmt == "file":
        st.save_file(sd, path / "model.safetensors")
        return path / "model.safetensors"
    names = sorted(sd)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:]), 1):
        st.save_file({n: sd[n].contiguous() for n in part},
                     path / f"model-0000{i}-of-00002.safetensors")
    return path


def _peft_spec(path, vocab=src.VOCAB):
    base = factory.build_llama3(pretrained_model_name_or_path=str(path),
                                dtype=torch.float32)
    return factory.get_peft_model_with_resize_embedding(
        model=base, peft_config=dict(src.LORA), vocab_size=vocab)


def _jconfig(vocab=src.VOCAB):
    return JConfig.tiny(vocab_size=vocab, lora_rank=src.LORA["r"],
                        lora_alpha=float(src.LORA["lora_alpha"]),
                        attention_impl="eager")


def _port_logits(model, ids):
    with torch.no_grad():
        h, _ = model(torch.from_numpy(ids).long())
        return model.logits(h).numpy()


@pytest.mark.parametrize("adapters", [False, True])
@pytest.mark.parametrize("fmt", ["bin", "shards", "file"])
def test_llama_loads_hf_files(full_width, tmp_path, fmt, adapters):
    sd = src.hf_llama_state()
    if adapters:
        sd.update(src.trained_adapters(sd))
    path = _save(sd, tmp_path / "llama", fmt)
    spec = _peft_spec(path)
    assert spec.config.vocab_size == src.VOCAB
    tm = factory.build_component(spec, device="cpu",
                                 param_dtype=torch.float32)
    assert tm.checkpoint_report["seeded"] == 0
    jcfg = _jconfig()
    tree = JW.torch_to_flax_llama(sd, jcfg, vocab_size=src.VOCAB)
    ids = np.random.RandomState(0).randint(0, src.VOCAB, (2, 11))
    ref, _, _ = JLlama(jcfg, dtype=jnp.float32).apply({"params": tree},
                                                      jnp.asarray(ids))
    np.testing.assert_allclose(_port_logits(tm, ids), np.asarray(ref),
                               atol=ATOL, rtol=0)
    b = tm.model.layers[1].self_attn.q_proj.lora_B.weight
    if adapters:
        torch.testing.assert_close(
            b, sd["model.layers.1.self_attn.q_proj.lora_B.weight"], rtol=0,
            atol=0)
    else:
        assert not b.any()


def test_vocab_resize_is_the_mean_rule(full_width, tmp_path):
    sd = src.hf_llama_state()
    sd.pop("lm_head.weight")        # the fallback: lm_head from embed_tokens
    tm = factory.build_component(_peft_spec(_save(sd, tmp_path / "l", "bin")),
                                 device="cpu", param_dtype=torch.float32)
    emb = sd["model.embed_tokens.weight"].numpy()
    for got, mult in ((tm.model.embed_tokens.weight, 1.0),
                      (tm.lm_head.weight, 3.0)):
        want = JW.resize_embedding(emb, src.VOCAB, mult)
        assert got.shape == want.shape == (src.VOCAB, 128)
        np.testing.assert_array_equal(got[:src.BASE_VOCAB].detach().numpy(),
                                      emb)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("rule", ["base", "assembly"])
def test_fresh_adapters_are_the_references_draws(full_width, tmp_path, rule):
    """A loaded base starts with LoRA B = 0 and A drawn as the reference
    draws it: ``_relayout_lora``'s ``RandomState(0)`` for a base checkpoint
    (the reference's factory on the same file), ``RandomState(1234 + i)``
    for an assembly without adapters (``torch_to_flax_llama``)."""
    sd = src.hf_llama_state()
    path = _save(sd, tmp_path / "l", "bin")
    jcfg = _jconfig()
    if rule == "base":
        tm = factory.build_component(_peft_spec(path), device="cpu",
                                     param_dtype=torch.float32)
        jbase = jfactory.build_llama3(pretrained_model_name_or_path=str(path))
        layers = jfactory.get_peft_model_with_resize_embedding(
            model=jbase, peft_config=dict(src.LORA),
            vocab_size=src.VOCAB).params["model"]["layers"]
        state = {k: p for k, p in tm.state_dict().items()}
    else:
        layers = JW.torch_to_flax_llama(sd, jcfg)["model"]["layers"]
        spec = _peft_spec(path)
        state = {k: (v() if isinstance(v, W.Lazy) else v) for k, v in
                 W.llama_state(sd, spec.config, lora="assembly").items()}
    n = 0
    for group in ("self_attn", "mlp"):
        for name, node in layers[group].items():
            for i in range(2):
                key = f"model.layers.{i}.{group}.{name}"
                np.testing.assert_array_equal(
                    state[f"{key}.lora_A.weight"].numpy(),
                    np.asarray(node["lora_a"][i]).T, err_msg=key)
                assert not state[f"{key}.lora_B.weight"].any()
                n += 1
    assert n == 14


@pytest.mark.parametrize("prefix", ["vision_model.", "tower.vision_model."])
def test_siglip_loads_hf_files(full_width, tmp_path, prefix):
    sd = {prefix + k[len("vision_model."):]: v
          for k, v in src.hf_siglip_state().items()}
    assert any(".head." in k for k in sd)      # not read, as the reference
    path = _save(sd, tmp_path / "siglip", "shards")
    tm = factory.build_component(
        factory.build_siglip(pretrained_model_name_or_path=str(path),
                             dtype=torch.float32),
        device="cpu", param_dtype=torch.float32)
    cfg = JSigCfg.tiny()
    tree = JW.torch_to_flax_siglip(sd, cfg)
    x = np.random.RandomState(1).randn(2, 56, 56, 3).astype(np.float32)
    ref = JSig(cfg).apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)


def _qwen_spec(path):
    cfg = QwenViTConfig.tiny()
    return factory.ModelSpec(
        cfg, torch.float32,
        lambda: VisionTransformerWithAttnPool(cfg, dtype=torch.float32),
        str(path), W.qwen_vit_state)


def _qwen_reference(sd, x):
    cfg = JQwenCfg.tiny()
    tree = JW.torch_to_flax_qwen_vit(sd, cfg)
    return np.asarray(JQwen(cfg).apply({"params": tree}, jnp.asarray(x)))


@pytest.mark.parametrize("blocks", ["in_proj", "mha"])
def test_qwen_vit_loads_reference_file(tmp_path, blocks):
    sd = src.qwen_vit_state(mha_blocks=blocks == "mha")
    torch.save(sd, tmp_path / "qwen_vit_G.pt")
    tm = factory.build_component(_qwen_spec(tmp_path / "qwen_vit_G.pt"),
                                 device="cpu", param_dtype=torch.float32)
    x = np.random.RandomState(2).randn(2, 56, 56, 3).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _qwen_reference(sd, x), atol=ATOL,
                               rtol=0)


def test_reload_qwen_vit_cuts_the_tower_out(tmp_path):
    """A whole Qwen-VL checkpoint's ``transformer.visual.*`` saved alone
    (twin of ``utils/misc.py reload_qwen_vit``) loads as the tower; the
    reference's function cuts the same tensors."""
    from mllm_npu_tpu.utils.misc import reload_qwen_vit as j_reload
    tower = src.qwen_vit_state()
    whole = {f"transformer.visual.{k}": v for k, v in tower.items()}
    whole["transformer.wte.weight"] = torch.zeros(3, 4)
    torch.save(whole, tmp_path / "qwen_vl.bin")
    got = W.reload_qwen_vit(tmp_path / "qwen_vl.bin", tmp_path / "vit.pt")
    want = j_reload(str(tmp_path / "qwen_vl.bin"), str(tmp_path / "j.pt"))
    assert got.keys() == want.keys() == tower.keys()
    tm = factory.build_component(_qwen_spec(tmp_path / "vit.pt"),
                                 device="cpu", param_dtype=torch.float32)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(
            v, tower[k if ".resblocks." not in k else k], rtol=0, atol=0)


def _small(sd, scale=0.2, seed=0):
    torch.manual_seed(seed)
    return {k: (scale * v).contiguous() for k, v in sd.items()}


def _unet_inputs(cfg, seed=7):
    rs = np.random.RandomState(seed)
    S = cfg.sample_size
    pooled = cfg.projection_class_embeddings_input_dim \
        - 6 * cfg.addition_time_embed_dim
    return (rs.randn(2, S, S, cfg.in_channels).astype(np.float32),
            np.array([10.0, 731.0], np.float32),
            rs.randn(2, 5, cfg.cross_attention_dim).astype(np.float32),
            rs.randn(2, pooled).astype(np.float32),
            np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1)))


def _unet_pair(unet, jtree):
    cfg = JUNetConfig.tiny()
    x, t, ctx, pooled, tids = _unet_inputs(cfg)
    ref = np.asarray(JUNet(cfg).apply(
        {"params": jtree}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        {"text_embeds": jnp.asarray(pooled), "time_ids": jnp.asarray(tids)}))
    with torch.no_grad():
        got = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), torch.from_numpy(ctx),
                   {"text_embeds": torch.from_numpy(pooled),
                    "time_ids": torch.from_numpy(tids)})
    return got.permute(0, 2, 3, 1).numpy(), ref


def _close_scaled(got, ref):
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0.1
    np.testing.assert_allclose(got / scale, ref / scale, atol=RTOL_SCALED,
                               rtol=0)


def _adapter(**paths):
    return factory.build_sdxl_adapter(
        resampler=dict(_target_="mllm_npu_tpu_torch.models.generation."
                                 "resampler.ResamplerXLV2", dim=32, depth=1,
                       dim_head=8, heads=4, num_queries=4, embedding_dim=128,
                       output1_dim=32, output2_dim=32),
        device="cpu", param_dtype=torch.float32, **paths)


def test_unet_loads_diffusers_directory(full_width, tmp_path):
    cfg = JUNetConfig.tiny()
    sd = _small(synth_unet_sd(cfg))
    path = tmp_path / "unet"
    path.mkdir()
    st.save_file(sd, path / "diffusion_pytorch_model.safetensors")
    ad = _adapter(unet_checkpoint=str(path))
    assert ad.unet.checkpoint_report["seeded"] == 0
    got, ref = _unet_pair(ad.unet, JW.torch_to_flax_unet(sd, cfg))
    _close_scaled(got, ref)


@pytest.mark.parametrize("legacy", [False, True])
def test_vae_loads_diffusers_directory(full_width, tmp_path, legacy):
    cfg = JVAEConfig.tiny()
    sd = _small(synth_vae_sd(cfg))
    if legacy:      # diffusers < 0.15 names the mid-block attention so
        old = {"to_q": "query", "to_k": "key", "to_v": "value",
               "to_out.0": "proj_attn"}
        for new, was in old.items():
            for k in [k for k in sd if f"attentions.0.{new}." in k]:
                sd[k.replace(f".{new}.", f".{was}.")] = sd.pop(k)
    path = tmp_path / "vae"
    path.mkdir()
    st.save_file(sd, path / "diffusion_pytorch_model.safetensors")
    ad = _adapter(vae_checkpoint=str(path))
    z = np.random.RandomState(3).randn(2, 8, 8, 4).astype(np.float32)
    jm = JVAE(cfg)
    ref = np.asarray(jm.apply({"params": JW.torch_to_flax_vae(sd, cfg)},
                              jnp.asarray(z), method=jm.decode))
    with torch.no_grad():
        got = ad.vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    _close_scaled(got.permute(0, 2, 3, 1).numpy(), ref)


def _resampler_sd():
    """A ResamplerXL checkpoint as the reference's torch module names it
    (the reference model's seeded weights, renamed by the port's
    ``perceiver_from_jax`` and read back by the reference's
    ``torch_to_flax_perceiver``)."""
    res = jr.ResamplerXL(dim=32, depth=1, dim_head=8, heads=4, num_queries=4,
                         embedding_dim=128, output1_dim=32, output2_dim=32,
                         normalize=True)
    tree = res.init(jax.random.PRNGKey(1), jnp.ones((1, 4, 128)))["params"]
    rs = np.random.RandomState(4)
    tree = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rs.randn(*np.shape(x))
                   ).astype(np.float32), tree)
    return res, {k: v.contiguous() for k, v in
                 perceiver_from_jax(tree).items()}


def test_detokenizer_with_a_partial_unet(full_width, tmp_path):
    """The de-tokenizer checkpoint: the resampler, and the UNet's tuned
    ``to_k`` / ``to_v`` subset merged key by key over the UNet directory
    (the reference's ``merge_partial_unet_state``)."""
    cfg = JUNetConfig.tiny()
    base = _small(synth_unet_sd(cfg))
    tuned = {k: v + 0.05 for k, v in _small(synth_unet_sd(cfg), seed=1).items()
             if ".to_k." in k or ".to_v." in k}
    assert tuned
    (tmp_path / "unet").mkdir()
    st.save_file(base, tmp_path / "unet" / "diffusion_pytorch_model."
                 "safetensors")
    res, res_sd = _resampler_sd()
    ckpt = {f"resampler.{k}": v for k, v in res_sd.items()}
    ckpt.update({f"unet.{k}": v for k, v in tuned.items()})
    torch.save(ckpt, tmp_path / "pytorch_model.bin")
    ad = _adapter(unet_checkpoint=str(tmp_path / "unet"),
                  adapter_checkpoint=str(tmp_path / "pytorch_model.bin"))
    jparams = JW.merge_partial_unet_state(
        {"params": JW.torch_to_flax_unet(base, cfg)}, tuned)
    got, ref = _unet_pair(ad.unet, jparams["params"])
    _close_scaled(got, ref)
    for k, v in tuned.items():
        torch.testing.assert_close(ad.unet.state_dict()[k], v, rtol=0, atol=0)
    x = np.random.RandomState(5).randn(2, 6, 128).astype(np.float32)
    rtree = JW.torch_to_flax_perceiver(res_sd)
    ref = res.apply({"params": rtree}, jnp.asarray(x))
    with torch.no_grad():
        got = ad.resampler(torch.from_numpy(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("debug", [False, True])
def test_partial_unet_refuses_unknown_keys_and_shapes(full_width, tmp_path,
                                                      monkeypatch, debug):
    """An unknown key and a shape that differs raise when the tuned subset
    merges, through the builder outside DEBUG_FLAG and through the merge
    itself with DEBUG_FLAG set or unset (under DEBUG_FLAG the builder reads
    no checkpoint: every path resolves to None)."""
    if debug:
        monkeypatch.setenv("DEBUG_FLAG", "True")
    shapes = {"down_blocks.1.attentions.0.transformer_blocks.0.attn2.to_k."
              "weight": torch.Size([64, 64])}
    for bad, err in (({"not.a.key": torch.zeros(3)}, KeyError),
                     ({next(iter(shapes)): torch.zeros(7, 9)}, ValueError)):
        with pytest.raises(err):
            W.merge_partial_state({}, bad, shapes, "test")
        torch.save({f"unet.{k}": v for k, v in bad.items()},
                   tmp_path / "bad.bin")
        if debug:
            ad = _adapter(adapter_checkpoint=str(tmp_path / "bad.bin"))
            assert ad.unet.checkpoint_report["loaded"] == {}
        else:
            with pytest.raises(err):
                _adapter(adapter_checkpoint=str(tmp_path / "bad.bin"))
