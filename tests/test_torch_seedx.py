"""SEED-X's modules in the port against the JAX package on the CPU, in
fp32 at tiny widths, inputs drawn from numpy seeds: the Qwen-ViT tower
(alone, with its attention pool, with the patch positions and a resized
position table), the Qwen processor, ``gather_masked_tokens``, SEED's
losses (cosine and MSE, ``vit_down``), ``extract_img_windows``,
``generate_with_projection`` (plain and speculative) and the weight
carrier (reference names; the round trip through the reference's
converter).

Tolerances: the towers and the projected features sum the same fp32
products in other orders (PyTorch's and XLA's CPU kernels), so they agree
to about 1e-6 relative; 1e-4 absolute bounds them, and 1e-5 the losses,
which are means. Token ids, texts and masks are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mllm_npu_tpu.data.processor import init_processor as j_init_processor
from mllm_npu_tpu.models.generation import sampler as jsampler
from mllm_npu_tpu.models.generation.generate import MLLMGenerator as JGen
from mllm_npu_tpu.models.language_models.llama import (
    LlamaConfig as JLlamaConfig, LlamaForCausalLM as JLlama)
from mllm_npu_tpu.models.mllm import SEED as JSEED
from mllm_npu_tpu.models.mllm import gather_masked_tokens as j_gather
from mllm_npu_tpu.models.multimodal_encoder import qwenvl_vit as jq
from mllm_npu_tpu.models.multimodal_projector.attention_resampler import (
    AttentionResampler as JResampler)
from mllm_npu_tpu.utils.fake_tokenizer import FakeTokenizer as JTok
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch as j_batch)
from mllm_npu_tpu.utils.weights import torch_to_flax_assembly
from mllm_npu_tpu_torch.constant import BOI_TOKEN
from mllm_npu_tpu_torch.data.processor import init_processor
from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
from mllm_npu_tpu_torch.models.generation.sampler import (
    SamplingConfig, extract_img_windows, ladder_from_tokenizer)
from mllm_npu_tpu_torch.models.mllm import gather_masked_tokens
from mllm_npu_tpu_torch.models.multimodal_encoder import qwenvl_vit as tq
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import (TinySpec, build_tiny_mllm,
                                              synthetic_batch)
from mllm_npu_tpu_torch.utils.weights import (from_jax_params,
                                              qwen_vit_from_jax)
from seedx_manifest import qwen_vit_sd

TOWER_ATOL = 1e-4
LOSS_ATOL = 1e-5
FEAT_ATOL = 1e-4
NQ = 4


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params["params"])


@pytest.mark.parametrize("kind,cfg_kw", [
    ("pool", {}),
    ("pool", dict(patch_pos=True, pos_embed_size=4)),   # 2×2 → 4×4 table
    ("tower", {}),
    ("tower", dict(image_size=84, pos_embed_size=16)),  # 4×4 → 6×6 table
])
def test_qwen_vit_matches_reference(kind, cfg_kw):
    rs = np.random.RandomState(0)
    jcfg, tcfg = jq.QwenViTConfig.tiny(**cfg_kw), tq.QwenViTConfig.tiny(
        **cfg_kw)
    size = jcfg.image_size
    x = rs.randn(2, size, size, 3).astype(np.float32)
    pp = rs.rand(2, 2).astype(np.float32)
    jcls, tcls = ((jq.VisionTransformerWithAttnPool,
                   tq.VisionTransformerWithAttnPool) if kind == "pool" else
                  (jq.VisionTransformer, tq.VisionTransformer))
    jm = jcls(jcfg)
    args = (jnp.asarray(x), jnp.asarray(pp)) if kind == "pool" else (
        jnp.asarray(x),)
    params = jm.init(jax.random.PRNGKey(0), *args)
    ref = np.asarray(jm.apply(params, *args))
    tm = tcls(tcfg)
    tm.load_state_dict(qwen_vit_from_jax(_tree(params)), strict=True)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
    assert got.shape == ref.shape
    want = (2, jcfg.n_queries, jcfg.output_dim) if kind == "pool" else (
        2, (size // 14) ** 2, jcfg.width)
    assert got.shape == want
    np.testing.assert_allclose(got, ref, atol=TOWER_ATOL, rtol=0)


def test_qwen_processor_matches_reference():
    """The Qwen JSON (no rescale, CLIP mean/std, bilinear to 448) on one
    PIL image, against the JAX processor."""
    rs = np.random.RandomState(3)
    img = Image.fromarray((rs.rand(300, 500, 3) * 255).astype(np.uint8))
    path = "mllm_npu_tpu_torch/configs/processor_configs/qwen_448_transform.json"
    tp = init_processor("qwen_vit", path)
    jp = j_init_processor("qwen_vit", path.replace("mllm_npu_tpu_torch",
                                                   "mllm_npu_tpu"))
    assert (tp.height, tp.width, tp.do_rescale, tp.resample) == (448, 448,
                                                                 False, 2)
    got, ref = tp(img), np.asarray(jp(img))
    assert got.shape == (448, 448, 3)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("capacity", [3, 8, 20])
def test_gather_masked_tokens_matches_reference(capacity):
    rs = np.random.RandomState(capacity)
    h = rs.randn(3, 9, 5).astype(np.float32)
    mask = rs.rand(3, 9) < 0.3
    ref = np.asarray(j_gather(jnp.asarray(h), jnp.asarray(mask), capacity))
    got = gather_masked_tokens(torch.from_numpy(h), torch.from_numpy(mask),
                               capacity).numpy()
    assert got.shape == (capacity, 5)
    np.testing.assert_array_equal(got, ref)


def _j_seed_qwen(spec, mse):
    """The reference's tiny SEED with the Qwen tower (its ``build_tiny_mllm
    (seed=True)`` takes SigLIP): the port's ``build_tiny_mllm(seed_x=True,
    tower="qwen")`` twin."""
    lm_cfg = JLlamaConfig.tiny(vocab_size=spec.vocab)
    vis_cfg = jq.QwenViTConfig.tiny(image_size=spec.image_size)
    H, W = lm_cfg.hidden_size, vis_cfg.output_dim
    grid = int(spec.nq ** 0.5)
    return JSEED(
        language_model=JLlama(lm_cfg, dtype=spec.dtype),
        vision_encoder=jq.VisionTransformerWithAttnPool(vis_cfg),
        projector=JResampler(grid_size=grid, embed_dim=H, num_heads=4,
                             kv_dim=W, dtype=spec.dtype),
        output_projector=JResampler(grid_size=grid, embed_dim=W, num_heads=4,
                                    kv_dim=H, dtype=spec.dtype),
        freeze_vision_encoder=True, lm_loss_scale=1.0, add_patch_pos=True,
        patch_pos_dim=H, rec_loss_scale=1.0, vit_down=True, mse=mse,
        num_img_out_tokens=spec.nq), lm_cfg


def seed_pair(tower, mse=False):
    """The reference's tiny SEED and the port's with its weights: → (JAX
    module, its params, LlamaConfig, port model)."""
    spec = JSpec(batch=2, seq=64, max_images=2, image_size=56, nq=NQ)
    if tower == "qwen":
        jm, jl = _j_seed_qwen(spec, mse)
    else:
        jm, jl, _ = j_build(spec, seed=True)
        jm = jm.clone(mse=mse)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              **j_batch(spec, cmp_images=1, gen_images=1))
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", seed_x=True,
                               tower=tower)
    tm.mse = mse
    tm.load_state_dict(from_jax_params(_tree(params)), strict=True)
    return jm, params, jl, tm


@pytest.fixture(scope="module")
def qwen_seed():
    return seed_pair("qwen")


@pytest.mark.parametrize("tower", ["qwen", "siglip"])
@pytest.mark.parametrize("mse", [False, True], ids=["cosine", "mse"])
def test_seed_losses_match_reference(tower, mse):
    """lm_loss, rec_loss and their sum on a batch with a comprehension and
    a generation image (the output projector over the hidden states at
    ids_gen_mask, against the tower's tokens pooled 4× by vit_down)."""
    jm, params, _, tm = seed_pair(tower, mse)
    batch = synthetic_batch(TinySpec(), batch=2, seq=64, max_images=2,
                            cmp_images=1, gen_images=1, rng=7)
    ref = jax.jit(jm.apply)(params,
                            **{k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    tb["labels"] = tb["labels"].long()
    with torch.no_grad():
        got = tm(**tb)
    assert float(got["rec_loss"]) > 0
    for key in ("lm_loss", "rec_loss", "total_loss"):
        np.testing.assert_allclose(float(got[key]), float(ref[key]),
                                   atol=LOSS_ATOL, rtol=0, err_msg=key)


def test_seed_without_generation_targets_has_zero_rec_loss(qwen_seed):
    *_, tm = qwen_seed
    batch = synthetic_batch(TinySpec(), cmp_images=1, gen_images=0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["input_ids"] = tb["input_ids"].long()
    tb["labels"] = tb["labels"].long()
    with torch.no_grad():
        out = tm(**tb)
    assert float(out["rec_loss"]) == 0.0
    assert float(out["total_loss"]) == pytest.approx(float(out["lm_loss"]))


@pytest.mark.parametrize("eois", [[], [6], [5, 14], [0, 7, 9, 13, 15]])
def test_extract_img_windows_matches_reference(eois):
    """No image, one, two, and more than max_imgs (one at index 0, whose
    window is clamped into the row); <img> tokens leave the text mask."""
    rs = np.random.RandomState(len(eois))
    T, D, n, eoi, boi = 16, 3, 4, 11, 10
    tokens = rs.randint(20, 99, T)
    tokens[eois] = eoi
    tokens[[i - n - 1 for i in eois if i - n - 1 >= 0]] = boi
    h = rs.randn(T, D).astype(np.float32)
    ref = jsampler.extract_img_windows(jnp.asarray(tokens), jnp.asarray(h),
                                       eoi, n, 3, boi_token_id=boi)
    got = extract_img_windows(torch.from_numpy(tokens), torch.from_numpy(h),
                              eoi, n, 3, boi_token_id=boi)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("k", [0, 4])
def test_generate_with_projection_matches_reference(qwen_seed, k):
    """A caption ending in <img>: the forced ladder (4 image tokens and
    </img>), then free text; greedy ids and text identical to the JAX
    generator's, the projected window within FEAT_ATOL, plain and with
    prompt-lookup speculation (k = 4: the ladder's hidden states are the
    verify forward's rows). Both store the weights in bf16 and the cache in
    fp32."""
    jm, params, jl, tm = qwen_seed
    tok, T = FakeTokenizer(), 12
    ids = [tok.bos_token_id] + tok.encode(f"a red cat on a mat {BOI_TOKEN}")
    gen = MLLMGenerator(tm, sampling=SamplingConfig(max_new_tokens=T),
                        ladder=ladder_from_tokenizer(tok, NQ),
                        cache_dtype=torch.float32, speculative_k=k,
                        cast_params_bf16=True)
    jgen = JGen(jm, jl, params,
                sampling=jsampler.SamplingConfig(max_new_tokens=T),
                ladder=jsampler.ladder_from_tokenizer(JTok(), NQ),
                cache_dtype=jnp.float32, cast_params_bf16=True,
                speculative_k=k)
    got = gen.generate_with_projection(torch.tensor([ids]), tokenizer=tok,
                                       num_img_gen_tokens=NQ)
    ref = jgen.generate_with_projection(jnp.asarray([ids], jnp.int32),
                                        tokenizer=JTok(),
                                        num_img_gen_tokens=NQ)
    assert gen.last_timings["speculative_k"] == k
    gids = got["generate_ids"][0].tolist()
    assert gids == np.asarray(ref["generate_ids"])[0].tolist()
    assert gids[:NQ + 1] == list(gen.ladder.ids[1:])    # the forced ladder
    assert got["text"] == ref["text"]
    assert got["has_img_output"] and got["num_gen_imgs"] == 1 == \
        ref["num_gen_imgs"]
    feat = got["img_gen_feat"].numpy()
    assert feat.shape == (1, NQ, tm.output_projector.embed_dim)
    np.testing.assert_allclose(feat, np.asarray(ref["img_gen_feat"]),
                               atol=FEAT_ATOL, rtol=0)


def test_weight_carrier_round_trip_and_names(qwen_seed):
    """from_jax_params → the port's SEED state_dict → the reference's
    torch_to_flax_assembly gives the JAX tree back exactly; the tower's
    names are the reference checkpoint's (tests/seedx_manifest.py), less
    the resampler's frozen sin-cos buffer, which the port computes."""
    jm, params, jl, tm = qwen_seed
    tree = _tree(params)
    sd = from_jax_params(tree)
    back = torch_to_flax_assembly(sd, lm_config=jl,
                                  vision_config=jm.vision_encoder.config,
                                  vision_kind="qwen",
                                  has_output_projector=True)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf), err_msg=str(path))
    names = {k for k in sd if k.startswith("vision_encoder.")}
    manifest = set(qwen_vit_sd(jm.vision_encoder.config, "vision_encoder.",
                               np.random.RandomState(0)))
    assert manifest - names == {"vision_encoder.attn_pool.pos_embed"}
    assert names <= manifest
    assert {k for k in sd if k.startswith("output_projector.")} == {
        k for k in tm.state_dict() if k.startswith("output_projector.")}
