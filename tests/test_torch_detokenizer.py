"""The SDXL de-tokenizer's modules in the port against the JAX package on
the CPU, in fp32 at tiny widths (``UNetConfig.tiny()``, ``VAEConfig.tiny()``,
the reference factory's DEBUG resampler), inputs drawn from numpy seeds:
the three schedulers, the resamplers, the UNet (with and without the
IP-Adapter's image tokens), the VAE's decode and encoder moments, and the
weight carrier both ways (``from_jax_params`` in, the reference's
``torch_to_flax_*`` back to the same tree). The port's full-size SDXL UNet
and VAE, built on the ``meta`` device, hold exactly the keys and shapes of
diffusers' checkpoints (``tests/diffusers_manifest.py``).

Every JAX parameter is moved off its initial value by seeded noise first,
so that zero biases and unit norm scales cannot hide a wrong mapping.

Tolerances: both sides sum the same fp32 products in other orders
(PyTorch's and XLA's CPU kernels; the GroupNorm variance by another
formula), about 1e-6 relative: the schedules agree exactly, the model
inputs and the steps' latents within 1e-5 relative (the multistep
solver carries an ulp of log / expm1 through its loop), the
resamplers within 1e-5 absolute, the UNet's ε and the VAE within 1e-4
absolute (outputs of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mllm_npu_tpu.models.generation import resampler as jr
from mllm_npu_tpu.models.generation import schedulers as js
from mllm_npu_tpu.models.generation.unet import (
    UNet2DConditionModel as JUNet, UNetConfig as JUNetConfig)
from mllm_npu_tpu.models.generation.vae import (AutoencoderKL as JVAE,
                                                VAEConfig as JVAEConfig)
from mllm_npu_tpu.utils.weights import (torch_to_flax_perceiver,
                                        torch_to_flax_unet,
                                        torch_to_flax_vae)
from mllm_npu_tpu_torch.models.generation import resampler as tr
from mllm_npu_tpu_torch.models.generation import schedulers as ts
from mllm_npu_tpu_torch.models.generation.unet import (UNet2DConditionModel,
                                                       UNetConfig)
from mllm_npu_tpu_torch.models.generation.vae import AutoencoderKL, VAEConfig
from mllm_npu_tpu_torch.utils.weights import from_jax_params
from diffusers_manifest import (unet_state_dict_manifest,
                                vae_state_dict_manifest)

SCHED_TOL = 1e-6
# a step's log / expm1 differ by an ulp between the libraries, and the
# solver's state carries it through the loop
STEP_RTOL = 1e-5
RES_ATOL = 1e-5
UNET_ATOL = 1e-4
VAE_ATOL = 1e-4
# the reference factory's DEBUG resampler (factory.py:439)
DEBUG_RESAMPLER = dict(dim=32, depth=1, dim_head=8, heads=4, num_queries=4,
                       embedding_dim=128, output1_dim=32, output2_dim=32)


def perturbed(params, seed=0, scale=0.05):
    """The ``params`` tree as numpy, every leaf plus seeded noise."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rs.randn(*np.shape(x))
                   ).astype(np.float32), params["params"])


def assert_same_tree(a, b):
    fa = dict(jax.tree_util.tree_leaves_with_path(a))
    fb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert fa.keys() == fb.keys()
    for path, leaf in fa.items():
        np.testing.assert_array_equal(np.asarray(fb[path]), np.asarray(leaf),
                                      err_msg=str(path))


def _np_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _load(module, tree):
    module.load_state_dict(from_jax_params(tree), strict=True)
    return module.eval()


# -- schedulers ---------------------------------------------------------------

@pytest.mark.parametrize("cls,kw,steps", [
    ("EulerDiscreteScheduler", {}, 50),
    ("EulerDiscreteScheduler", dict(timestep_spacing="linspace",
                                    beta_schedule="linear"), 7),
    ("DPMSolverPP2MScheduler", {}, 20),
])
def test_scheduler_schedule_and_steps_match_reference(cls, kw, steps):
    jsch, tsch = getattr(js, cls)(**kw), getattr(ts, cls)(**kw)
    assert tsch.init_noise_sigma == jsch.init_noise_sigma
    jt, jsig = (np.asarray(a) for a in jsch.make_schedule(steps))
    tt, tsig = tsch.make_schedule(steps)
    assert tt.dtype == tsig.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_equal(tsig.numpy(), jsig)
    rs = np.random.RandomState(1)
    lat = rs.randn(2, 4, 4, 4).astype(np.float32)
    jstate = jsch.init_state(jnp.asarray(lat))
    tstate = tsch.init_state(torch.from_numpy(lat))
    jlat, tlat = jnp.asarray(lat), torch.from_numpy(lat)
    for i in range(steps):
        eps = rs.randn(*lat.shape).astype(np.float32)
        scaled_j = jsch.scale_model_input(jlat, jsig[i])
        scaled_t = tsch.scale_model_input(tlat, tsig[i])
        np.testing.assert_allclose(scaled_t.numpy(), np.asarray(scaled_j),
                                   rtol=STEP_RTOL, atol=STEP_RTOL)
        jlat, jstate = jsch.step(jnp.asarray(eps), jlat, i, jnp.asarray(jt),
                                 jnp.asarray(jsig), jstate)
        tlat, tstate = tsch.step(torch.from_numpy(eps), tlat, i, tt, tsig,
                                 tstate)
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat),
                                   rtol=STEP_RTOL, atol=STEP_RTOL,
                                   err_msg=f"step {i}")


def test_ddpm_add_noise_matches_reference():
    rs = np.random.RandomState(2)
    x0, noise = (rs.randn(3, 4, 8, 8).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999])
    ref = js.DDPMScheduler().add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                       jnp.asarray(t))
    got = ts.DDPMScheduler().add_noise(torch.from_numpy(x0),
                                       torch.from_numpy(noise),
                                       torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=SCHED_TOL,
                               atol=SCHED_TOL)


# -- resamplers ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["xl", "xl_v2", "plain"])
def test_resampler_matches_reference_and_carries_back(kind):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 128).astype(np.float32)
    if kind == "plain":
        kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=4,
                  embedding_dim=128, output_dim=48)
        jm, tm = jr.Resampler(**kw), tr.Resampler(**kw)
    else:
        kw = dict(DEBUG_RESAMPLER, normalize=kind == "xl_v2")
        jm, tm = jr.ResamplerXL(**kw), tr.ResamplerXL(**kw)
    tree = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    ref = jm.apply({"params": tree}, jnp.asarray(x))
    _load(tm, tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    if kind == "plain":
        ref, got = (ref,), (got,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=RES_ATOL,
                                   rtol=0)
    assert_same_tree(torch_to_flax_perceiver(_np_sd(tm)), tree)


def test_resampler_v2_class_and_identity():
    assert tr.ResamplerXLV2(**DEBUG_RESAMPLER).normalize
    x, p = torch.ones(1, 2, 3), torch.zeros(1, 3)
    assert tr.ResamplerXLIdentity()(x, p) == (x, p)


def test_attention_pool_all_tokens_matches_reference():
    rs = np.random.RandomState(5)
    x = rs.randn(2, 4, 32).astype(np.float32)
    jm = jr.AttentionPool2d(4, 32, 4, 16)
    tree = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    ref = jm.apply({"params": tree}, jnp.asarray(x), return_all_tokens=True)
    tm = tr.AttentionPool2d(4, 32, 4, 16)
    tm.load_state_dict({
        "positional_embedding": torch.from_numpy(tree["positional_embedding"]),
        **{f"{n}.weight": torch.from_numpy(np.ascontiguousarray(
            tree[n]["kernel"].T)) for n in ("q_proj", "k_proj", "v_proj",
                                            "c_proj")},
        **{f"{n}.bias": torch.from_numpy(tree[n]["bias"])
           for n in ("q_proj", "k_proj", "v_proj", "c_proj")}})
    with torch.no_grad():
        got = tm(torch.from_numpy(x), return_all_tokens=True)
    assert got.shape == (2, 5, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=RES_ATOL,
                               rtol=0)


# -- UNet ---------------------------------------------------------------------

def _unet_inputs(cfg, B=2, L=5, seed=7):
    rs = np.random.RandomState(seed)
    S = cfg.sample_size
    pooled = cfg.projection_class_embeddings_input_dim \
        - 6 * cfg.addition_time_embed_dim
    return dict(sample=rs.randn(B, S, S, cfg.in_channels).astype(np.float32),
                t=np.array([10.0, 731.0], np.float32)[:B],
                ctx=rs.randn(B, L + cfg.ip_num_image_tokens,
                             cfg.cross_attention_dim).astype(np.float32),
                text_embeds=rs.randn(B, pooled).astype(np.float32),
                time_ids=np.tile(np.array([[1024, 1024, 0, 0, 1024, 1024]],
                                          np.float32), (B, 1)))


@pytest.mark.parametrize("ip_tokens", [0, 2])
def test_unet_matches_reference_and_carries_back(ip_tokens):
    jcfg = JUNetConfig.tiny(ip_num_image_tokens=ip_tokens, ip_scale=0.6)
    tcfg = UNetConfig.tiny(ip_num_image_tokens=ip_tokens, ip_scale=0.6)
    x = _unet_inputs(jcfg)
    added = {"text_embeds": jnp.asarray(x["text_embeds"]),
             "time_ids": jnp.asarray(x["time_ids"])}
    jm = JUNet(jcfg)
    args = (jnp.asarray(x["sample"]), jnp.asarray(x["t"]),
            jnp.asarray(x["ctx"]), added)
    tree = perturbed(jm.init(jax.random.PRNGKey(0), *args), 8)
    ref = np.asarray(jm.apply({"params": tree}, *args))
    tm = _load(UNet2DConditionModel(tcfg), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x["sample"]).permute(0, 3, 1, 2),
                 torch.from_numpy(x["t"]), torch.from_numpy(x["ctx"]),
                 {"text_embeds": torch.from_numpy(x["text_embeds"]),
                  "time_ids": torch.from_numpy(x["time_ids"])})
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=UNET_ATOL, rtol=0)
    if not ip_tokens:   # the reference's converter has no IP keys
        assert_same_tree(torch_to_flax_unet(_np_sd(tm), jcfg), tree)


def test_unet_scalar_timestep_and_unported_options():
    cfg = UNetConfig.tiny()
    tm = UNet2DConditionModel(cfg).eval()
    x = _unet_inputs(cfg)
    args = (torch.from_numpy(x["sample"]).permute(0, 3, 1, 2),)
    added = {"text_embeds": torch.from_numpy(x["text_embeds"]),
             "time_ids": torch.from_numpy(x["time_ids"])}
    with torch.no_grad():
        a = tm(*args, torch.tensor(500.0), torch.from_numpy(x["ctx"]), added)
        b = tm(*args, torch.full((2,), 500.0), torch.from_numpy(x["ctx"]),
               added)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for kw, item in ((dict(lora_rank=4), "14b"),
                     (dict(quantization="int8"), "14b")):
        with pytest.raises(NotImplementedError, match=item):
            UNet2DConditionModel(UNetConfig.tiny(**kw))


# -- VAE ----------------------------------------------------------------------

def test_vae_decode_and_moments_match_reference():
    rs = np.random.RandomState(9)
    cfg_j, cfg_t = JVAEConfig.tiny(), VAEConfig.tiny()
    img = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = rs.randn(2, 8, 8, 4).astype(np.float32)
    jm = JVAE(cfg_j)
    tree = perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(img)), 10)
    p = {"params": tree}
    ref_dec = np.asarray(jm.apply(p, jnp.asarray(z), method=jm.decode))
    ref_mom = np.asarray(jm.apply(p, jnp.asarray(img),
                                  method=jm.encode_moments))
    tm = _load(AutoencoderKL(cfg_t), tree)
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    with torch.no_grad():
        dec = tm.decode(nchw(z)).permute(0, 2, 3, 1).numpy()
        mom = tm.encode_moments(nchw(img)).permute(0, 2, 3, 1).numpy()
        mean = tm.encode(nchw(img)).permute(0, 2, 3, 1).numpy()
    assert dec.shape == (2, 16, 16, 3) and mom.shape == (2, 8, 8, 8)
    np.testing.assert_allclose(dec, ref_dec, atol=VAE_ATOL, rtol=0)
    np.testing.assert_allclose(mom, ref_mom, atol=VAE_ATOL, rtol=0)
    np.testing.assert_array_equal(mean, mom[..., :4])
    assert_same_tree(torch_to_flax_vae(_np_sd(tm), cfg_j), tree)


# -- full-size key manifests ----------------------------------------------------

def _meta_shapes(make):
    with torch.device("meta"):
        m = make()
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


def test_sdxl_unet_state_dict_is_diffusers():
    got = _meta_shapes(lambda: UNet2DConditionModel(UNetConfig.sdxl_base()))
    want = unet_state_dict_manifest(UNetConfig.sdxl_base())
    assert set(got) == set(want)
    assert got == want
    n = sum(int(np.prod(s)) for s in got.values())
    assert 2.56e9 < n < 2.57e9     # SDXL-base's 2.567 B parameters


def test_sdxl_vae_state_dict_is_diffusers():
    got = _meta_shapes(lambda: AutoencoderKL(VAEConfig.sdxl()))
    assert got == vae_state_dict_manifest(VAEConfig.sdxl())
