"""The de-tokenizers' training and their other pipelines in the port against
the JAX package on the CPU, in fp32 at tiny widths, inputs drawn from
numpy seeds, every JAX parameter drawn from a seed at its shape
(``seeded_tree``): ``SDXLAdapter.loss_fn`` and its trainable gradients against
``jax.grad`` (over the plain UNet and over the LoRA edit UNet), one AdamW
step over the trainable set against the reference's masked optax chain,
``IPAdapterSD``'s seeding, loss and gradients, ``ip_scale = 0``, and the
generate paths with JAX's first noise handed in as ``latents``: SEED-X-Edit
(``_denoise3_fn`` with a VAE-encoded input image), ``IPAdapterSDPipe`` and
the SD-2.1 adapter (with the plain ``Resampler`` it names, which the
reference cannot run).

Tolerances: losses within 1e-5, each gradient within 1e-4 of its largest
reference entry (or of a thousandth of the largest gradient, for those
that are 0 but for rounding), parameters after a step within 1e-6 (AdamW's first step
moves each by about lr = 1e-4), u8 images within 1 (the fp32 latents agree
to about 1e-5, so only a value that close to a rounding boundary moves).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation import adapter_modules as ja
from mllm_npu_tpu.models.generation import resampler as jr
from mllm_npu_tpu.models.generation import schedulers as js
from mllm_npu_tpu.models.generation.unet import UNet2DConditionModel as JUNet
from mllm_npu_tpu.models.generation.vae import (AutoencoderKL as JVAE,
                                                VAEConfig as JVAEConfig)
from mllm_npu_tpu.models.multimodal_encoder import qwenvl_vit as jq
from mllm_npu_tpu.train import train_state as jts
from mllm_npu_tpu_torch.models.generation import adapter_modules as ta
from mllm_npu_tpu_torch.models.generation import resampler as tr
from mllm_npu_tpu_torch.models.generation.schedulers import (
    EulerDiscreteScheduler)
from mllm_npu_tpu_torch.models.generation.unet import UNet2DConditionModel
from mllm_npu_tpu_torch.models.generation.vae import AutoencoderKL, VAEConfig
from mllm_npu_tpu_torch.models.multimodal_encoder import qwenvl_vit as tq
from mllm_npu_tpu_torch.train import train_state as tts
from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                              perceiver_from_jax,
                                              qwen_vit_from_jax,
                                              unet_from_jax)
from test_torch_detokenizer import DEBUG_RESAMPLER, seeded_tree
from test_torch_detokenizer_variants import config_pair

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
# a gradient that is 0 but for rounding (the attention pool's key bias
# moves no softmax) is held to the largest gradient's scale instead
GRAD_FLOOR = 1e-3
U8_MAX_DIFF = 1
STEPS = 3
SEED = 5


def _unet_pair(kind, seed=1, **kw):
    """(reference module, its seeded tree, the port's module loaded)."""
    jcfg, tcfg = config_pair(kind, **kw)
    S, B = jcfg.sample_size, 2
    added = None
    pooled = (jcfg.projection_class_embeddings_input_dim
              - 6 * jcfg.addition_time_embed_dim)
    if pooled > 0:
        added = {"text_embeds": jnp.ones((B, pooled)),
                 "time_ids": jnp.ones((B, 6))}
    jm = JUNet(jcfg)
    tree = seeded_tree(
        jm, jnp.ones((B, S, S, jcfg.in_channels)), jnp.ones((B,)),
        jnp.ones((B, 4 + jcfg.ip_num_image_tokens, jcfg.cross_attention_dim)),
        added, seed=seed)
    tm = UNet2DConditionModel(tcfg)
    tm.load_state_dict(unet_from_jax(tree), strict=True)
    return jm, tree, tm.eval()


def _resampler_pair(kind, out_dim=None, seed=2):
    if kind == "plain":
        kw = dict(dim=32, depth=1, dim_head=8, heads=4, num_queries=4,
                  embedding_dim=128, output_dim=out_dim)
        jm, tm = jr.Resampler(**kw), tr.Resampler(**kw)
    else:
        kw = dict(DEBUG_RESAMPLER, normalize=True)
        jm, tm = jr.ResamplerXL(**kw), tr.ResamplerXL(**kw)
    tree = seeded_tree(jm, jnp.ones((1, 4, 128)), seed=seed)
    tm.load_state_dict(perceiver_from_jax(tree), strict=True)
    return jm, tree, tm.eval()


def _vae_pair(seed=3):
    jm = JVAE(JVAEConfig.tiny())
    tree = seeded_tree(jm, jnp.ones((1, 16, 16, 3)), seed=seed)
    tm = AutoencoderKL(VAEConfig.tiny())
    tm.load_state_dict(from_jax_params(tree), strict=True)
    return jm, tree, tm.eval()


def _vision_pair(seed=4):
    jm = jq.VisionTransformerWithAttnPool(jq.QwenViTConfig.tiny())
    tree = seeded_tree(jm, jnp.ones((1, 56, 56, 3)), seed=seed)
    tm = tq.VisionTransformerWithAttnPool(tq.QwenViTConfig.tiny())
    tm.load_state_dict(qwen_vit_from_jax(tree), strict=True)
    return jm, tree, tm.eval()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _grads_close(parts, jgrads):
    """Every trainable parameter's ``.grad`` against the reference's
    gradient carried to the port's names; → the names compared."""
    want = {**{f"unet.{k}": v
               for k, v in unet_from_jax(jgrads["unet"]["params"]).items()},
            **{f"resampler.{k}": v for k, v in perceiver_from_jax(
                jgrads["resampler"]["params"]).items()}}
    top = max(float(want[n].abs().max()) for n, p in parts.named_parameters()
              if p.requires_grad)
    names = []
    for name, p in parts.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        ref = want[name]
        scale = max(float(ref.abs().max()), GRAD_FLOOR * top)
        assert float((p.grad - ref).abs().max()) <= GRAD_RTOL * scale, \
            (name, float((p.grad - ref).abs().max()), scale)
        names.append(name)
    return names


def _value_and_grad(adapter, params, batch):
    """The reference's loss and its gradient, compiled once."""
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: adapter.loss_fn(p, batch)[0]))(params)
    return float(loss), grads


@functools.lru_cache(maxsize=None)
def _sdxl_reference(variant):
    """The reference's SDXLAdapter over the tiny UNet (``variant`` "sdxl")
    or the LoRA edit UNet ("lora_edit"), with one batch, its loss and its
    gradient: → (UNet pair, resampler pair, params, batch, loss, grads);
    the port's modules are built anew by each caller."""
    kw = {} if variant == "sdxl" else dict(in_channels=8, lora_rank=4)
    ju, utree, _ = _unet_pair("tiny", **kw)
    jres, rtree, _ = _resampler_pair("xl")
    jad = ja.SDXLAdapter(unet_module=ju, unet_params={"params": utree},
                         resampler_module=jres,
                         resampler_params={"params": rtree})
    batch = _sdxl_batch(ju.config)
    params = {"unet": {"params": utree}, "resampler": {"params": rtree}}
    loss, grads = _value_and_grad(
        jad, params, jax.tree_util.tree_map(jnp.asarray, batch))
    return (ju, utree), (jres, rtree), params, batch, loss, grads


def _port_pair(ju, utree, jres, rtree):
    """The port's UNet and resampler loaded from the reference's trees."""
    tu = UNet2DConditionModel(config_pair("tiny", **{
        k: getattr(ju.config, k) for k in ("in_channels", "lora_rank")})[1])
    tu.load_state_dict(unet_from_jax(utree), strict=True)
    tres = tr.ResamplerXL(**dict(DEBUG_RESAMPLER, normalize=True))
    tres.load_state_dict(perceiver_from_jax(rtree), strict=True)
    return tu.eval(), tres.eval()


def _sdxl_batch(jcfg, B=2, seed=6):
    rs = np.random.RandomState(seed)
    S = jcfg.sample_size
    return {
        "noisy_latents": rs.randn(B, S, S, jcfg.in_channels).astype(
            np.float32),
        "timesteps": np.array([17.0, 803.0], np.float32)[:B],
        "image_embeds": rs.randn(B, 6, 128).astype(np.float32),
        "noise": rs.randn(B, S, S, 4).astype(np.float32),
        "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32),
                            (B, 1)),
    }


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("noisy_latents", "noise"):
        out[k] = _nchw(batch[k])
    return out


# -- training -------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["sdxl", "lora_edit"])
def test_sdxl_adapter_loss_and_trainable_grads_match_reference(variant):
    (ju, utree), (jres, rtree), _, batch, ref_loss, jgrads = \
        _sdxl_reference(variant)
    tu, tres = _port_pair(ju, utree, jres, rtree)
    cls = ta.SDXLAdapter if variant == "sdxl" \
        else ta.SDXLText2ImageAndEditAdapter
    ad = cls.from_pretrained(tu, tres)
    pats = ta.adapter_trainable_patterns() if variant == "sdxl" \
        else cls.trainable_patterns(True)
    tts.apply_frozen_patterns(ad.parts, pats)
    loss, aux = ad.loss_fn(_torch_batch(batch))
    loss.backward()
    assert aux["noise_pred"].shape == (2, 4, 8, 8)
    assert abs(loss.item() - ref_loss) <= LOSS_ATOL, (loss.item(), ref_loss)
    names = _grads_close(ad.parts, jgrads)
    assert any(n.startswith("resampler.") for n in names)
    want = ".attn2.to_k." if variant == "sdxl" else ".lora_B."
    assert any(want in n for n in names)


def test_adamw_step_over_the_trainable_set_matches_reference():
    """One step of the port's AdamW over ``adapter_trainable_patterns``'
    set against the reference's ``build_optimizer`` (the masked
    clip → adamw chain, ``set_to_zero`` elsewhere) on the same gradients
    of the reference's loss."""
    (ju, utree), (jres, rtree), params, _, _, jgrads = \
        _sdxl_reference("sdxl")
    tu, tres = _port_pair(ju, utree, jres, rtree)
    opt = dict(lr=1e-4, warmup_steps=0, total_steps=10, max_grad_norm=0.5)
    tx, _ = jts.build_optimizer(jts.OptimizerConfig(
        frozen_patterns=ja.adapter_trainable_patterns(), **opt), params)
    import optax
    updates, _ = tx.update(jgrads, tx.init(params), params)
    new = optax.apply_updates(params, updates)

    ad = ta.SDXLAdapter(unet=tu, resampler=tres)
    tts.apply_frozen_patterns(ad.parts, ta.adapter_trainable_patterns())
    want_grads = {**{f"unet.{k}": v for k, v in unet_from_jax(
        jgrads["unet"]["params"]).items()}, **{
        f"resampler.{k}": v for k, v in perceiver_from_jax(
            jgrads["resampler"]["params"]).items()}}
    trainable = tts.trainable_parameters(ad.parts)
    for name, p in trainable:
        p.grad = want_grads[name].clone()
    before = {n: p.detach().clone() for n, p in ad.parts.named_parameters()}
    tts.AdamW(trainable, tts.OptimizerConfig(**opt)).step()
    after = {**{f"unet.{k}": v for k, v in unet_from_jax(
        new["unet"]["params"]).items()}, **{
        f"resampler.{k}": v for k, v in perceiver_from_jax(
            new["resampler"]["params"]).items()}}
    moved = set()
    for name, p in ad.parts.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
        if not torch.equal(p.detach(), before[name]):
            moved.add(name)
    assert moved == {n for n, _ in trainable}


def test_ip_adapter_seeding_loss_and_grads_match_reference():
    ju, utree, tu = _unet_pair("sd15", ip_num_image_tokens=4)
    width = ju.config.cross_attention_dim
    jres, rtree, tres = _resampler_pair("plain", width)
    jad = ja.IPAdapterSD.from_pretrained(ju, {"params": utree}, jres,
                                         {"params": rtree})
    ad = ta.IPAdapterSD.from_pretrained(tu, tres)
    seeded = unet_from_jax(jad.unet_params["params"])
    n_ip = 0
    for k, v in ad.unet.state_dict().items():
        assert torch.equal(v, seeded[k]), k
        n_ip += "_ip." in k
    # to_k_ip and to_v_ip in each cross-attention
    assert n_ip == 2 * sum(hasattr(m, "to_k_ip") for m in ad.unet.modules())
    assert n_ip > 0
    rs = np.random.RandomState(7)
    S = ju.config.sample_size
    batch = {"noisy_latents": rs.randn(2, S, S, 4).astype(np.float32),
             "timesteps": np.array([3.0, 640.0], np.float32),
             "image_embeds": rs.randn(2, 6, 128).astype(np.float32),
             "text_embeds": rs.randn(2, 7, width).astype(np.float32),
             "noise": rs.randn(2, S, S, 4).astype(np.float32)}
    params = {"unet": jad.unet_params, "resampler": {"params": rtree}}
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    ref_loss, jgrads = _value_and_grad(jad, params, jbatch)
    tts.apply_frozen_patterns(ad.parts, ta.ip_adapter_trainable_patterns())
    loss, _ = ad.loss_fn(_torch_batch(batch))
    loss.backward()
    assert abs(loss.item() - ref_loss) <= LOSS_ATOL
    names = _grads_close(ad.parts, jgrads)
    assert sum("_ip." in n for n in names) == n_ip
    assert all(n.startswith("resampler.") or "_ip." in n for n in names)


def test_ip_scale_zero_ignores_the_image_tokens():
    ju, utree, tu = _unet_pair("sd15", ip_num_image_tokens=4)
    rs = np.random.RandomState(8)
    S, C = ju.config.sample_size, ju.config.cross_attention_dim
    x = rs.randn(2, S, S, 4).astype(np.float32)
    ctx = rs.randn(2, 7 + 4, C).astype(np.float32)
    ctx2 = ctx.copy()
    ctx2[:, -4:] = rs.randn(2, 4, C)
    t = np.array([10.0, 500.0], np.float32)

    def port(c, s):
        with torch.no_grad():
            return tu(_nchw(x), torch.from_numpy(t), torch.from_numpy(c),
                      ip_scale=s)
    assert torch.equal(port(ctx, 0.0), port(ctx2, 0.0))
    assert (port(ctx, 1.0) - port(ctx2, 1.0)).abs().max() > 1e-3
    apply = jax.jit(ju.apply)
    for s in (0.0, 0.6):
        ref = apply({"params": utree}, jnp.asarray(x), jnp.asarray(t),
                    jnp.asarray(ctx), ip_scale=jnp.float32(s))
        np.testing.assert_allclose(port(ctx, s).permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), atol=1e-4, rtol=0)


# -- the generate paths -------------------------------------------------------

def _u8_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g).astype(int), np.asarray(r).astype(int)
        assert g.shape == r.shape
        assert np.abs(g - r).max() <= U8_MAX_DIFF, np.abs(g - r).max()
        assert r.std() > 1.0


def _jax_noise(B, size, f=2):
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(SEED), (B, size // f, size // f, 4), jnp.float32))


def test_edit_generate_matches_reference():
    """SEED-X-Edit's path: the input image VAE-encoded to its posterior
    mean, three-way guidance, the UNet at batch 3."""
    ju, utree, tu = _unet_pair("tiny", in_channels=8)
    jres, rtree, tres = _resampler_pair("xl")
    jv, vtree, tv = _vae_pair()
    jvis, vis_tree, tvis = _vision_pair()
    size = 16
    rs = np.random.RandomState(9)
    feats = rs.randn(1, 4, 128).astype(np.float32)
    image = rs.uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    kw = dict(seed=SEED, height=size, width=size, guidance_scale=7.5,
              image_guidance_scale=1.5, num_inference_steps=STEPS,
              input_image_size=56)
    jad = ja.SDXLAdapterWithLatentImage(
        unet_module=ju, unet_params={"params": utree}, resampler_module=jres,
        resampler_params={"params": rtree}, vit_down=True)
    jad.init_pipe(jv, {"params": vtree}, js.EulerDiscreteScheduler(),
                  visual_encoder=(jvis, {"params": vis_tree}))
    ref = jad.generate(image_embeds=jnp.asarray(feats),
                       latent_image=jnp.asarray(image), **kw)
    ad = ta.SDXLAdapterWithLatentImage(unet=tu, resampler=tres,
                                       vit_down=True)
    ad.init_pipe(tv, EulerDiscreteScheduler(), visual_encoder=tvis)
    got = ad.generate(image_embeds=torch.from_numpy(feats),
                      latent_image=_nchw(image),
                      latents=_nchw(_jax_noise(1, size)), **kw)
    _u8_close(got, ref)
    t = ad.last_timings
    assert t["steps"] == STEPS and t["encode_s"] > 0
    # the encoded image is the VAE's mean, unscaled
    mean = np.asarray(jv.apply({"params": vtree}, jnp.asarray(image),
                               method=jv.encode))
    with torch.no_grad():
        got_mean = ad.encode_image(_nchw(image))
    np.testing.assert_allclose(got_mean.permute(0, 2, 3, 1).numpy(), mean,
                               atol=1e-4, rtol=0)


def test_ip_pipe_generate_matches_reference():
    ju, utree, tu = _unet_pair("sd15", ip_num_image_tokens=4)
    jres, rtree, tres = _resampler_pair("plain", ju.config.cross_attention_dim)
    jv, vtree, tv = _vae_pair()
    jvis, vis_tree, tvis = _vision_pair()
    size = ju.config.sample_size * 2
    image = np.random.RandomState(10).uniform(
        -1, 1, (1, 56, 56, 3)).astype(np.float32)
    kw = dict(scale=0.5, seed=SEED, guidance_scale=6.0,
              num_inference_steps=STEPS, height=size, width=size)
    jad = ja.IPAdapterSD.from_pretrained(ju, {"params": utree}, jres,
                                         {"params": rtree})
    jpipe = ja.IPAdapterSDPipe(ip_adapter=jad, vae_module=jv,
                               vae_params={"params": vtree},
                               visual_encoder=(jvis, {"params": vis_tree}),
                               text_context_len=7)
    ref = jpipe.generate(image_tensor=jnp.asarray(image), **kw)
    pipe = ta.IPAdapterSDPipe(ip_adapter=ta.IPAdapterSD.from_pretrained(
        tu, tres), vae=tv, visual_encoder=tvis, text_context_len=7)
    got = pipe.generate(image_tensor=torch.from_numpy(image),
                        latents=_nchw(_jax_noise(1, size)), **kw)
    _u8_close(got, ref)
    assert pipe.ip_scale == 0.5


def test_sd21_adapter_generate_with_a_plain_resampler():
    """With the plain ``Resampler`` the class names, the reference's
    ``get_image_embeds`` unpacks the [2B, Q, D] tensor along its batch
    axis: its prompt embeds become [Q/2, D], so its generate makes Q/2
    images for one input, each cross-attending one resampler token. The
    port takes the tensor as the prompt embeds with no pooled ones (the
    SD-2.1 UNet takes none), and matches the reference's denoise loop
    given those. (The XL resampler's path is the edit generate's above.)"""
    ju, utree, tu = _unet_pair("sd21", in_channels=8)
    width = ju.config.cross_attention_dim
    jv, vtree, tv = _vae_pair()
    jvis, vis_tree, tvis = _vision_pair()
    size = ju.config.sample_size * 2
    feats = np.random.RandomState(11).randn(1, 4, 128).astype(np.float32)
    kw = dict(seed=SEED, height=size, width=size, guidance_scale=7.5,
              image_guidance_scale=1.5, num_inference_steps=STEPS,
              input_image_size=56)
    noise = _nchw(_jax_noise(1, size))

    jres, rtree, tres = _resampler_pair("plain", width)
    jad = ja.SD21Text2ImageAndEditAdapter(
        unet_module=ju, unet_params={"params": utree},
        resampler_module=jres, resampler_params={"params": rtree},
        vit_down=True)
    jad.init_pipe(jv, {"params": vtree}, js.EulerDiscreteScheduler(),
                  visual_encoder=(jvis, {"params": vis_tree}))
    ad = ta.SD21Text2ImageAndEditAdapter(unet=tu, resampler=tres,
                                         vit_down=True)
    ad.init_pipe(tv, EulerDiscreteScheduler(), visual_encoder=tvis)
    pe = jad.get_image_embeds(image_embeds=jnp.asarray(feats),
                              image_size=56)[0]
    Q = ad.resampler.latents.shape[1]
    assert pe.shape == (Q // 2, width)   # the batch axis was unpacked
    got = ad.generate(image_embeds=torch.from_numpy(feats), latents=noise,
                      **kw)
    # the reference's loop on the prompt embeds its intent gives
    out = jad.resampler_module.apply(jad.resampler_params, jnp.concatenate(
        [jnp.asarray(feats), jad._negative_embeds(1, 56)]))
    pe, pe_neg = jnp.split(out, 2)
    zeros = jnp.zeros((3, 1), jnp.float32)
    run = jad._denoise3_fn(STEPS, size, size)
    ref = run(jad.unet_params, jad.vae_params,
              jnp.asarray(_jax_noise(1, size))
              * jad.scheduler.init_noise_sigma,
              jnp.concatenate([pe_neg, pe_neg, pe]), zeros,
              jnp.tile(jnp.asarray(ja.compute_time_ids((size, size), (0, 0),
                                                      size)), (3, 1)),
              jnp.zeros((3, size // 2, size // 2, 4)),
              jnp.float32(7.5), jnp.float32(1.5))
    _u8_close(got, [np.asarray(a) for a in ja._postprocess_u8(ref)])
