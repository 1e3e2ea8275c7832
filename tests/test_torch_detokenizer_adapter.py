"""``SDXLAdapter.generate`` in the port against the JAX package's, end to
end on the CPU in fp32 at tiny widths: the same features, the same
weights (the tiny UNet, VAE and DEBUG resampler, and the tiny Qwen-ViT
pool as the vision encoder of the zero-image negative, given to the JAX
adapter through its own ``init_pipe``), the same first noise (JAX's draw
handed to the port as ``latents``), Euler with guidance 7.5. The u8
images may differ by at most 1: the fp32 latents agree to about 1e-5, so
only a value within that of a rounding boundary moves. Also the factory:
``build_sdxl_adapter`` under ``DEBUG_FLAG`` and its refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation import resampler as jr
from mllm_npu_tpu.models.generation import schedulers as js
from mllm_npu_tpu.models.generation.adapter_modules import (
    SDXLAdapter as JAdapter)
from mllm_npu_tpu.models.generation.unet import (
    UNet2DConditionModel as JUNet, UNetConfig as JUNetConfig)
from mllm_npu_tpu.models.generation.vae import (AutoencoderKL as JVAE,
                                                VAEConfig as JVAEConfig)
from mllm_npu_tpu.models.multimodal_encoder import qwenvl_vit as jq
from mllm_npu_tpu_torch.models import factory
from mllm_npu_tpu_torch.models.generation import resampler as tr
from mllm_npu_tpu_torch.models.generation.adapter_modules import (
    SDXLAdapter, compute_time_ids)
from mllm_npu_tpu_torch.models.generation.schedulers import (
    EulerDiscreteScheduler)
from mllm_npu_tpu_torch.models.generation.unet import (UNet2DConditionModel,
                                                       UNetConfig)
from mllm_npu_tpu_torch.models.generation.vae import AutoencoderKL, VAEConfig
from mllm_npu_tpu_torch.models.multimodal_encoder import qwenvl_vit as tq
from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                              qwen_vit_from_jax)
from test_torch_detokenizer import DEBUG_RESAMPLER, perturbed

U8_MAX_DIFF = 1
STEPS = 4
SEED = 3


def _jax_parts():
    ucfg, vcfg = JUNetConfig.tiny(), JVAEConfig.tiny()
    S = ucfg.sample_size
    unet = JUNet(ucfg)
    utree = perturbed(unet.init(
        jax.random.PRNGKey(0), jnp.ones((1, S, S, 4)), jnp.ones((1,)),
        jnp.ones((1, 4, ucfg.cross_attention_dim)),
        {"text_embeds": jnp.ones((1, 32)), "time_ids": jnp.ones((1, 6))}), 1)
    res = jr.ResamplerXL(**DEBUG_RESAMPLER, normalize=True)
    rtree = perturbed(res.init(jax.random.PRNGKey(1), jnp.ones((1, 4, 128))),
                      2)
    vae = JVAE(vcfg)
    vtree = perturbed(vae.init(jax.random.PRNGKey(2),
                               jnp.ones((1, 2 * S, 2 * S, 3))), 3)
    vis = jq.VisionTransformerWithAttnPool(jq.QwenViTConfig.tiny())
    vis_tree = perturbed(vis.init(jax.random.PRNGKey(4),
                                  jnp.ones((1, 56, 56, 3))), 5)
    return (unet, utree), (res, rtree), (vae, vtree), (vis, vis_tree)


def test_generate_matches_reference():
    (unet, utree), (res, rtree), (vae, vtree), (vis, vis_tree) = _jax_parts()
    ja = JAdapter(unet_module=unet, unet_params={"params": utree},
                  resampler_module=res, resampler_params={"params": rtree},
                  vit_down=True)
    ja.init_pipe(vae, {"params": vtree}, js.EulerDiscreteScheduler(),
                 visual_encoder=(vis, {"params": vis_tree}))
    feats = np.random.RandomState(6).randn(1, 4, 128).astype(np.float32)
    size = UNetConfig.tiny().sample_size * VAEConfig.tiny(
    ).spatial_scale_factor
    kw = dict(seed=SEED, height=size, width=size, guidance_scale=7.5,
              num_inference_steps=STEPS, input_image_size=56)
    ref = [np.asarray(im) for im in ja.generate(
        image_embeds=jnp.asarray(feats), **kw)]

    t_unet = UNet2DConditionModel(UNetConfig.tiny())
    t_unet.load_state_dict(from_jax_params(utree), strict=True)
    t_res = tr.ResamplerXLV2(**DEBUG_RESAMPLER)
    t_res.load_state_dict(from_jax_params(rtree), strict=True)
    t_vae = AutoencoderKL(VAEConfig.tiny())
    t_vae.load_state_dict(from_jax_params(vtree), strict=True)
    t_vis = tq.VisionTransformerWithAttnPool(tq.QwenViTConfig.tiny())
    t_vis.load_state_dict(qwen_vit_from_jax(vis_tree), strict=True)
    adapter = SDXLAdapter(unet=t_unet.eval(), resampler=t_res.eval(),
                          vit_down=True)
    adapter.init_pipe(t_vae.eval(), EulerDiscreteScheduler(),
                      visual_encoder=t_vis.eval())
    # JAX's first noise, NHWC → NCHW
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                       (1, size // 2, size // 2, 4),
                                       jnp.float32)).transpose(0, 3, 1, 2)
    got = [np.asarray(im) for im in adapter.generate(
        image_embeds=torch.from_numpy(feats),
        latents=torch.from_numpy(np.ascontiguousarray(lat)), **kw)]
    assert len(got) == len(ref) == 1
    assert got[0].shape == ref[0].shape == (size, size, 3)
    assert got[0].dtype == np.uint8
    diff = np.abs(got[0].astype(int) - ref[0].astype(int))
    assert diff.max() <= U8_MAX_DIFF, diff.max()
    assert ref[0].std() > 1.0        # not a flat image
    # the negative was computed once, at the requested size, and is kept
    assert set(adapter._negatives) == {56}
    t = adapter.last_timings
    assert t["steps"] == STEPS and t["total_s"] >= t["denoise_s"] > 0


def test_time_ids_and_seeded_latents():
    np.testing.assert_array_equal(compute_time_ids((1024, 768), (0, 0),
                                                   1024),
                                  [[1024, 768, 0, 0, 1024, 1024]])
    g = torch.Generator().manual_seed(5)
    a = torch.randn((1, 4, 8, 8), generator=g)
    g.manual_seed(5)
    assert torch.equal(a, torch.randn((1, 4, 8, 8), generator=g))


def test_build_sdxl_adapter_debug_and_refusals(monkeypatch, tmp_path):
    monkeypatch.setenv("DEBUG_FLAG", "True")
    vis = factory.materialize(
        lambda: tq.VisionTransformerWithAttnPool(tq.QwenViTConfig.tiny()),
        device="cpu", param_dtype=torch.float32)
    ad = factory.build_sdxl_adapter(
        resampler={"_target_": "mllm_npu_tpu_torch.models.generation."
                                "resampler.ResamplerXLV2",
                   "embedding_dim": 4096},
        vit_down=True, visual_encoder=vis, device="cpu",
        param_dtype=torch.float32)
    assert isinstance(ad.resampler, tr.ResamplerXLV2)
    assert ad.resampler.proj_in.in_features == 128   # the tiny encoder's
    assert ad.unet.config == UNetConfig.tiny()
    assert ad.vae.config == VAEConfig.tiny()
    gn = ad.unet.conv_norm_out
    assert torch.equal(gn.weight, torch.ones_like(gn.weight))
    imgs = ad.generate(image_embeds=torch.randn(1, 4, 128), seed=0,
                       height=16, width=16, num_inference_steps=2,
                       input_image_size=56)
    assert imgs[0].size == (16, 16)
    with pytest.raises(NotImplementedError, match="14b"):
        factory.build_sdxl_adapter(with_latent_image=True, device="cpu")
    monkeypatch.delenv("DEBUG_FLAG")
    ckpt = tmp_path / "unet"
    ckpt.mkdir()
    with pytest.raises(NotImplementedError, match="exists"):
        factory.build_sdxl_adapter(unet_checkpoint=str(ckpt), device="cpu")
