"""The slices as a whole on the CPU: the tiny port engine against the JAX
``InferenceEngine`` with the same weights, image and question, in bf16 and
with int8 and int4 weights (greedy ids and text must be identical), the
tiny SEED with the Qwen tower the same way, and its
``text_to_image_features`` (ids and text identical, the features within
the bf16 cache's rounding), the SEED-X YAML under ``DEBUG_FLAG``, the
weight round trip through the reference's converter, the port's import
hygiene, and the device rule of its entry points."""

import ast
import base64
import io
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.serve.engine import InferenceEngine as JEngine
from mllm_npu_tpu.utils.fake_tokenizer import FakeTokenizer as JTok
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch)
from mllm_npu_tpu.utils.weights import torch_to_flax_assembly
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.serve.engine import InferenceEngine
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import from_jax_params
from test_torch_seedx import seed_pair

REPO = Path(__file__).resolve().parents[1]
COMMON = dict(resolution_grids=("1x1", "1x2", "2x1", "2x2"),
              base_resolution=448, num_img_in_tokens=4,
              num_img_out_tokens=4, max_new_tokens=10)


def _png_b64(w, h, seed=0):
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def reference_tree():
    spec = JSpec(batch=1, seq=64, image_size=56, nq=4)
    jm, jl, _ = j_build(spec, llama_kw=dict(lora_rank=8))
    params = jm.init(jax.random.PRNGKey(0),
                     **synthetic_batch(spec, cmp_images=1))
    rs = np.random.RandomState(1)

    def fix(path, x):   # non-zero adapters, so the LoRA path is exercised
        x = np.asarray(x)
        if path[-1].key == "lora_b":
            return rs.normal(0, 0.05, x.shape).astype(np.float32)
        return x
    tree = jax.tree_util.tree_map_with_path(fix, params["params"])
    return jm, jl, tree


@pytest.fixture(scope="module")
def engines(reference_tree):
    """Both engines with the reference's serving defaults: parameters
    cast to bf16, a bf16 KV cache."""
    jm, jl, tree = reference_tree
    je = JEngine(model=jm, lm_config=jl, params={"params": tree},
                 tokenizer=JTok(), image_transform=JProc(height=56, width=56),
                 **COMMON)
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu",
                               llama_kw=dict(lora_rank=8))
    tm.load_state_dict(from_jax_params(tree), strict=True)
    te = InferenceEngine(model=tm, tokenizer=FakeTokenizer(),
                         image_transform=ImageProcessor(height=56, width=56),
                         device="cpu", **COMMON)
    return je, te


def _reference_ids(je, q, b64):
    """Greedy ids of the JAX engine, as its ``comprehension`` makes them."""
    import jax.numpy as jnp
    ids, patches, pos, cmp = je._prepare_comprehension(q, b64)
    if patches is None:
        out = je.generator.generate(jnp.asarray(ids[None]))
    else:
        n = patches.shape[0]
        out = je.generator.generate(
            jnp.asarray(ids[None]), images=jnp.asarray(patches),
            embeds_cmp_mask=jnp.ones((n,), bool),
            ids_cmp_mask=jnp.asarray(cmp[None]),
            patch_positions=jnp.asarray(pos))
    return np.asarray(out["generate_ids"][0])


@pytest.mark.parametrize("image", ["896x896", "384x1152", "none"])
def test_comprehension_identical_to_reference(engines, image):
    je, te = engines
    b64 = "" if image == "none" else _png_b64(*map(int, image.split("x")))
    q = "what is shown in this picture?"
    ids, patches, _, _ = te._prepare_comprehension(q, b64)
    np.testing.assert_array_equal(ids, je._prepare_comprehension(q, b64)[0])
    if image == "896x896":
        assert patches.shape[0] == 5          # 2×2 grid + thumbnail
    got = te.comprehension_ids(q, b64)
    assert got.shape == (COMMON["max_new_tokens"],)
    np.testing.assert_array_equal(got, _reference_ids(je, q, b64))
    assert te.comprehension(q, b64) == je.comprehension(q, b64)


@pytest.fixture(scope="module", params=[8, 4], ids=["int8", "int4"])
def quantized_engines(reference_tree, request):
    """Both engines serving the same LoRA tree with ``quantize_int8`` or
    ``quantize_int4``: each merges the adapters in fp32, casts to bf16 and
    quantizes the Llama's projections and lm_head."""
    jm, jl, tree = reference_tree
    flag = {f"quantize_int{request.param}": True}
    je = JEngine(model=jm, lm_config=jl, params={"params": tree},
                 tokenizer=JTok(), image_transform=JProc(height=56, width=56),
                 **COMMON, **flag)
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu",
                               llama_kw=dict(lora_rank=8))
    tm.load_state_dict(from_jax_params(tree), strict=True)
    te = InferenceEngine(model=tm, tokenizer=FakeTokenizer(),
                         image_transform=ImageProcessor(height=56, width=56),
                         device="cpu", **COMMON, **flag)
    lm = te.generator.model.language_model
    assert lm.config.quantization == f"int{request.param}"
    assert lm.config.lora_rank == 0
    return je, te


@pytest.mark.parametrize("image", ["896x896", "none"])
def test_quantized_comprehension_identical_to_reference(quantized_engines,
                                                        image):
    je, te = quantized_engines
    b64 = "" if image == "none" else _png_b64(896, 896)
    q = "what is shown in this picture?"
    got = te.comprehension_ids(q, b64)
    assert got.shape == (COMMON["max_new_tokens"],)
    np.testing.assert_array_equal(got, _reference_ids(je, q, b64))
    assert te.comprehension(q, b64) == je.comprehension(q, b64)


def test_both_quantizations_raise():
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    with pytest.raises(ValueError, match="one of"):
        InferenceEngine(model=tm, tokenizer=FakeTokenizer(),
                        image_transform=ImageProcessor(56, 56), device="cpu",
                        quantize_int8=True, quantize_int4=True, **COMMON)


@pytest.fixture(scope="module")
def seed_engines():
    """The reference's tiny SEED with the Qwen tower and the port's with
    its weights, each in its engine with the serving defaults."""
    jm, params, jl, tm = seed_pair("qwen")
    je = JEngine(model=jm, lm_config=jl, params=params, tokenizer=JTok(),
                 image_transform=JProc(height=56, width=56), **COMMON)
    te = InferenceEngine(model=tm, tokenizer=FakeTokenizer(),
                         image_transform=ImageProcessor(height=56, width=56),
                         device="cpu", **COMMON)
    return je, te


@pytest.mark.parametrize("image", ["896x896", "none"])
def test_seed_comprehension_identical_to_reference(seed_engines, image):
    je, te = seed_engines
    b64 = "" if image == "none" else _png_b64(896, 896)
    q = "what is shown in this picture?"
    np.testing.assert_array_equal(te.comprehension_ids(q, b64),
                                  _reference_ids(je, q, b64))
    assert te.comprehension(q, b64) == je.comprehension(q, b64)


# the engines store the weights and the KV cache in bf16: a key that
# rounds to the other neighbour on one side moves the features by a few
# bf16 ulps of the attention's output
SEED_FEAT_ATOL = 2e-3


def test_text_to_image_features_identical_to_reference(seed_engines):
    """A caption through both engines: the forced ladder, the same ids and
    text, and the output projector's features for the one image."""
    je, te = seed_engines
    ref = je.text_to_image_features("a red cat on a mat")
    got = te.text_to_image_features("a red cat on a mat")
    assert got["generate_ids"][0].tolist() == np.asarray(
        ref["generate_ids"])[0].tolist()
    assert got["text"] == ref["text"]
    assert got["has_img_output"] and got["num_gen_imgs"] == 1 == \
        ref["num_gen_imgs"]
    assert tuple(got["img_gen_feat"].shape) == (1, 4, 128)
    np.testing.assert_allclose(got["img_gen_feat"].float().numpy(),
                               np.asarray(ref["img_gen_feat"], np.float32),
                               atol=SEED_FEAT_ATOL, rtol=0)
    # a budget below the ladder leaves no image
    short = te.text_to_image_features("a red cat on a mat", max_new_tokens=3)
    assert not short["has_img_output"] and short["img_gen_feat"] is None
    # an engine built without the de-tokenizer cannot make the image
    with pytest.raises(RuntimeError, match="de-tokenizer"):
        te.generation("a red cat on a mat")


def test_generate_right_padded_batch_identical_to_reference(engines):
    """Two prompts of different lengths, right-padded into one batch: the
    prompt mask becomes segment ids and positions in both generators."""
    je, te = engines
    import jax.numpy as jnp
    tok = te.tokenizer
    rows = [[tok.bos_token_id] + tok.encode(f"Question: {q}\nAnswer:")
            for q in ("what is the colour of the sky today?", "hi")]
    Sp = max(map(len, rows))
    ids = np.zeros((2, Sp), np.int32)
    mask = np.zeros((2, Sp), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)], mask[i, :len(r)] = r, 1
    assert mask[1].sum() < Sp
    ref = je.generator.generate(jnp.asarray(ids),
                                prompt_mask=jnp.asarray(mask))
    got = te.generator.generate(torch.from_numpy(ids).long(),
                                prompt_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got["generate_ids"].numpy(),
                                  np.asarray(ref["generate_ids"]))


def test_weight_round_trip(reference_tree):
    """from_jax_params → port state_dict → the reference's
    torch_to_flax_assembly reproduces the JAX tree exactly."""
    jm, jl, tree = reference_tree
    sd = from_jax_params(tree)
    back = torch_to_flax_assembly(sd, lm_config=jl,
                                  vision_config=jm.vision_encoder.config,
                                  vision_kind="siglip")
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mllm_npu_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'mllm_npu_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mllm_npu_tpu' or m.startswith('mllm_npu_tpu.')]\n"
        "assert len(names) > 20, names\n"
        "for m in ('train.train', 'train.train_state', 'train.checkpoint',"
        " 'train.scheduler', 'train.trackers', 'data.streams',"
        " 'data.datapipes', 'data.dataloader', 'data.data_utils',"
        " 'data.tasks.image_caption', 'serve.batched_engine',"
        " 'serve.prefix_cache', 'serve.worker', 'serve.serve_utils',"
        " 'models.multimodal_encoder.qwenvl_vit', 'models.mllm',"
        " 'models.generation.generate', 'models.generation.schedulers',"
        " 'models.generation.resampler', 'models.generation.unet',"
        " 'models.generation.vae', 'models.generation.discrete_models',"
        " 'models.generation.adapter_modules', 'demo_txt2img'):\n"
        "    assert 'mllm_npu_tpu_torch.' + m in names, m\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert mods, "chip_smoke.py imports nothing?"
    for m in mods:
        root = m.split(".")[0]
        assert root not in ("jax", "jaxlib", "flax", "mllm_npu_tpu"), m
    assert "mllm_npu_tpu_torch" in {m.split(".")[0] for m in mods}


def test_entry_points_raise_without_gpu(monkeypatch):
    """No device named and no GPU: the entry points raise instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_tiny_mllm(TinySpec())
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model=tm, tokenizer=FakeTokenizer(),
                        image_transform=ImageProcessor(56, 56), **COMMON)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine()
    from mllm_npu_tpu_torch.serve.worker import load_engine_from_config
    for batched in (False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_engine_from_config("models/mllm_llama3_8b_siglip_vit.yaml",
                                    batched=batched)


def test_yaml_builds_and_serves_tiny_on_cpu(monkeypatch):
    """The port's YAML resolves through its own instantiate; under
    DEBUG_FLAG every component is tiny, and the demo entry serves a
    request on the CPU when asked to."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    eng = build_engine(device="cpu", max_new_tokens=3)
    model = eng.generator.model
    assert model.language_model.config.lora_rank == 32
    assert model.language_model.config.vocab_size == 128587
    assert model.projector.num_queries == 4
    assert next(model.parameters()).device.type == "cpu"
    text = eng.comprehension("hi", _png_b64(500, 300))
    assert isinstance(text, str)


def test_existing_checkpoint_path_is_not_replaced(tmp_path):
    from mllm_npu_tpu_torch.models.factory import build_siglip
    with pytest.raises(NotImplementedError):
        build_siglip(pretrained_model_name_or_path=str(tmp_path))


def test_seedx_builders_refuse_an_existing_checkpoint(tmp_path):
    """The SEED-X builders: a tower, a Llama or an assembly checkpoint
    path that exists raises (loading them is queue 1 item 16)."""
    from mllm_npu_tpu_torch.models import factory
    for build in (factory.build_qwen_vit, factory.build_llama2):
        with pytest.raises(NotImplementedError):
            build(pretrained_model_name_or_path=str(tmp_path))
    with pytest.raises(NotImplementedError):
        factory.build_seed(pretrained_model_path=str(tmp_path))


def test_seedx_yaml_builds_and_serves_tiny_on_cpu(monkeypatch):
    """The port's SEED-X YAML through the worker's loader under
    DEBUG_FLAG: the SEED assembly with the tiny Qwen tower and its pool,
    r32 LoRA and the 32330 vocab, the Qwen processor at 448, the offline
    tokenizer; it answers a question on an image and turns a caption into
    image features."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    from mllm_npu_tpu_torch.models.mllm import SEED
    from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
        VisionTransformerWithAttnPool)
    from mllm_npu_tpu_torch.serve.worker import load_engine_from_config
    eng = load_engine_from_config("models/seedx_llama2_13b_qwenvl_vitg.yaml",
                                  max_new_tokens=8, device="cpu")
    model = eng.generator.model
    assert isinstance(model, SEED) and model.vit_down and model.mse
    assert isinstance(model.vision_encoder, VisionTransformerWithAttnPool)
    lm_cfg = model.language_model.config
    assert (lm_cfg.lora_rank, lm_cfg.vocab_size) == (32, 32330)
    assert model.num_img_out_tokens == model.projector.num_queries == 4
    assert isinstance(eng.tokenizer, FakeTokenizer)
    assert eng.tokenizer.vocab_size == 32330
    proc = eng.image_transform
    assert (proc.height, proc.do_rescale, proc.resample) == (448, False, 2)
    assert isinstance(eng.comprehension("hi", _png_b64(500, 300)), str)
    out = eng.text_to_image_features("a cat")
    assert out["has_img_output"]
    assert tuple(out["img_gen_feat"].shape) == (1, 4, 128)
