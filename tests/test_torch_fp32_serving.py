"""fp32 serving on the CPU against the JAX package, with the same seeded
weights: K1's plain fp32 version against the JAX flash kernel in interpret
mode on fp32 operands, K4/K5's plain versions on fp32 x against JAX's
products on fp32 x, the tiny engines with ``cast_params_bf16=False``
(single and batched, float, int8 and int4) against the JAX engine with the
same flag (greedy ids identical), ``MLLMGenerator``'s defaults against the
JAX generator's, and the worker's ``--no-cast-bf16`` and its fp32
de-tokenizer. (The card's side, K1 f32 and K4/K5 f32 against their plain
versions and the fp32 backward's refusal, is in
``tests/test_torch_cuda.py``.)"""

import base64
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mllm_npu_tpu.data.processor import ImageProcessor as JProc
from mllm_npu_tpu.models.generation.generate import MLLMGenerator as JGen
from mllm_npu_tpu.ops import flash_attention_padded as j_flash_padded
from mllm_npu_tpu.ops.flash_attention import SegmentIds as JSeg
from mllm_npu_tpu.ops.quant import (int4_matmul as j_int4,
                                    int8_matmul as j_int8,
                                    quantize_int4 as j_q4,
                                    quantize_int8 as j_q8)
from mllm_npu_tpu.serve.engine import InferenceEngine as JEngine
from mllm_npu_tpu.utils.fake_tokenizer import FakeTokenizer as JTok
from mllm_npu_tpu.utils.testing import (TinySpec as JSpec,
                                        build_tiny_mllm as j_build,
                                        synthetic_batch)
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.ops.flash_attention import (SegmentIds,
                                                    flash_attention)
from mllm_npu_tpu_torch.serve import worker as worker_mod
from mllm_npu_tpu_torch.serve.engine import (BatchedInferenceEngine,
                                             InferenceEngine)
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm
from mllm_npu_tpu_torch.utils.weights import from_jax_params

# the plain versions and the JAX kernels compute in fp32 on the same fp32
# operands, summing in other orders
ATOL = 1e-5
COMMON = dict(resolution_grids=("1x1", "1x2", "2x1", "2x2"),
              base_resolution=448, num_img_in_tokens=4,
              num_img_out_tokens=4, max_new_tokens=8)
BATCH = dict(num_slots=2, max_len=96, max_prompt=48, block_steps=3,
             batch_prompt_bucket=16)
QUESTION, IMAGE = "what is shown in this picture?", (300, 500)


def _png_b64(w, h, seed=0):
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,seg", [
    (2, 150, 150, 4, 2, 72, True, 120),       # GQA, causal, a padded row
    (1, 96, 200, 4, 4, 160, False, None),
    (2, 130, 130, 4, 1, 72, False, 100),      # GQA 4/1, segments
    (1, 64, 64, 2, 2, 160, True, 40),
])
def test_k1_plain_fp32_matches_jax_kernel(B, Sq, Sk, Hq, Hkv, D, causal,
                                          seg):
    rs = np.random.RandomState(D + Sq)
    q = rs.randn(B, Sq, Hq, D).astype(np.float32)
    k = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    v = rs.randn(B, Sk, Hkv, D).astype(np.float32)
    sids = jsids = None
    if seg is not None:
        qs = np.ones((B, Sq), np.int32)
        ks = np.ones((B, Sk), np.int32)
        qs[-1, seg:] = 0
        ks[-1, seg:] = 0
        sids = SegmentIds(q=torch.from_numpy(qs), kv=torch.from_numpy(ks))
        jsids = JSeg(q=jnp.asarray(qs), kv=jnp.asarray(ks))
    ref = j_flash_padded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, segment_ids=jsids, interpret=True)
    assert ref.dtype == jnp.float32
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          segment_ids=sids)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_plain_fp32_x_matches_jax(bits):
    rs = np.random.RandomState(bits)
    w = (rs.randn(256, 384) * 0.05).astype(np.float32)      # JAX [K, N]
    x = rs.randn(3, 5, 256).astype(np.float32)
    if bits == 8:
        jq = j_q8(jnp.asarray(w))
        ref = j_int8(jnp.asarray(x), jq, interpret=True)
        qt = tq.quantize_int8(torch.from_numpy(w.T.copy()))
        out = tq.int8_matmul(torch.from_numpy(x), *qt)
    else:
        jq = j_q4(jnp.asarray(w), group_size=128)
        ref = j_int4(jnp.asarray(x), jq, interpret=True)
        qt = tq.quantize_int4(torch.from_numpy(w.T.copy()), 128)
        out = tq.int4_matmul(torch.from_numpy(x), *qt)
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(qt.values.numpy(),
                                  np.asarray(jq.values).T)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.fixture(scope="module")
def tree():
    """The JAX tiny assembly (fp32 compute) with r8 LoRA adapters made
    non-zero, so the merge is exercised."""
    spec = JSpec(batch=1, seq=64, image_size=56, nq=4)
    jm, jl, _ = j_build(spec, llama_kw=dict(lora_rank=8))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              **synthetic_batch(spec, cmp_images=1))
    rs = np.random.RandomState(1)

    def fix(path, x):
        x = np.asarray(x)
        if path[-1].key == "lora_b":
            return rs.normal(0, 0.05, x.shape).astype(np.float32)
        return x
    return jm, jl, jax.tree_util.tree_map_with_path(fix, params["params"])


def _port_model(tree):
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu",
                               llama_kw=dict(lora_rank=8))
    tm.load_state_dict(from_jax_params(tree[2]), strict=True)
    return tm


def _reference_ids(je, q, b64):
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


@pytest.fixture(scope="module", params=[None, 8, 4],
                ids=["float", "int8", "int4"])
def reference_engine(tree, request):
    """The JAX engine with ``cast_params_bf16=False`` (float, int8 or int4),
    and its greedy ids for an image question (one compile each)."""
    jm, jl, params = tree
    flag = {} if request.param is None else {
        f"quantize_int{request.param}": True}
    je = JEngine(model=jm, lm_config=jl, params={"params": params},
                 tokenizer=JTok(), image_transform=JProc(height=56, width=56),
                 cast_params_bf16=False, **COMMON, **flag)
    return flag, _reference_ids(je, QUESTION, _png_b64(*IMAGE))


@pytest.mark.parametrize("batched", [False, True],
                         ids=["single", "batched"])
def test_fp32_engine_matches_reference(tree, reference_engine, batched):
    """The port's engines with ``cast_params_bf16=False`` keep every
    parameter fp32 (int8 / int4 quantized from the fp32 merged weights) and
    give the JAX engine's greedy ids."""
    flag, want = reference_engine
    kw = dict(model=_port_model(tree), tokenizer=FakeTokenizer(),
              image_transform=ImageProcessor(height=56, width=56),
              device="cpu", cast_params_bf16=False, **COMMON, **flag)
    te = BatchedInferenceEngine(**BATCH, **kw) if batched else \
        InferenceEngine(**kw)
    try:
        model = te.generator.model
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        if flag:
            lm = model.language_model
            assert lm.config.quantization == next(iter(flag))[-4:]
            assert lm.lm_head.compute_dtype == torch.float32
        got = te.comprehension_ids(QUESTION, _png_b64(*IMAGE))
        np.testing.assert_array_equal(got, want)
    finally:
        if batched:
            te.close()


def test_engine_defaults_are_the_references():
    """``MLLMGenerator`` keeps fp32 parameters unless asked, the engines
    cast them to bf16 unless asked, as the reference's."""
    import inspect
    gen = inspect.signature(MLLMGenerator).parameters["cast_params_bf16"]
    eng = inspect.signature(InferenceEngine).parameters["cast_params_bf16"]
    assert (gen.default, eng.default) == (
        inspect.signature(JGen).parameters["cast_params_bf16"].default,
        inspect.signature(JEngine).parameters["cast_params_bf16"].default)
    assert (gen.default, eng.default) == (False, True)


def test_generator_defaults_match_reference_generator(tree):
    """``MLLMGenerator()`` at its defaults (no cast: fp32 weights, bf16
    cache) gives the JAX ``MLLMGenerator()``'s greedy ids at its defaults,
    and leaves the model's parameters fp32."""
    from mllm_npu_tpu.models.generation.sampler import \
        SamplingConfig as JSampling
    from mllm_npu_tpu_torch.models.generation.sampler import SamplingConfig
    jm, jl, params = tree
    tm = _port_model(tree)
    gen = MLLMGenerator(tm, sampling=SamplingConfig(max_new_tokens=10))
    jgen = JGen(jm, jl, {"params": params},
                sampling=JSampling(max_new_tokens=10))
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    prompt = [3, 17, 42, 9, 100, 7]
    got = gen.generate(torch.tensor([prompt]))["generate_ids"]
    ref = jgen.generate(jnp.asarray([prompt], jnp.int32))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref["generate_ids"]))


def test_no_cast_bf16_parses_and_serves_through_the_worker(monkeypatch):
    """``--no-cast-bf16`` is taken: the worker builds the tiny assembly in
    fp32 (parameters and compute), serves it without the cast, batched and
    int8, and answers a POST over HTTP."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    args = worker_mod.parse_worker_args(
        ["--model-config", "models/mllm_llama3_8b_siglip_vit.yaml",
         "--batched", "--device", "cpu", "--no-cast-bf16",
         "--quantize-int8"])
    assert args.cast_bf16 is False and "cast_bf16" not in \
        worker_mod.UNPORTED_FLAGS
    eng = worker_mod.load_engine_from_config(
        args.model_config, max_new_tokens=3, batched=True, num_slots=2,
        max_len=256, quantize_int8=args.quantize_int8, device="cpu",
        cast_bf16=args.cast_bf16)
    worker = worker_mod.ModelWorker("http://unused", "http://worker", "id0",
                                    "tiny", eng, no_register=True)
    server = worker_mod.make_server(worker, "127.0.0.1", 0)
    import threading
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        model = eng.generator.model
        assert {p.dtype for p in model.parameters()} == {torch.float32}
        lm = model.language_model
        assert lm.model.dtype == torch.float32
        assert lm.config.quantization == "int8"
        assert {m.compute_dtype for m in model.modules()
                if hasattr(m, "compute_dtype")} == {torch.float32}
        url = "http://127.0.0.1:%d/worker_generate" % server.server_address[1]
        req = urllib.request.Request(url, data=json.dumps(
            {"input_text": "hi", "image": _png_b64(300, 200)}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            msgs = [json.loads(c) for c in r.read().split(b"\0") if c]
        assert [m["error_code"] for m in msgs] == [0]
        assert msgs[0]["text"] == InferenceEngine.comprehension(
            eng, "hi", _png_b64(300, 200))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        eng.close()


def test_worker_detokenizer_is_fp32(monkeypatch):
    """The worker builds its de-tokenizer in fp32 whatever ``--cast-bf16``
    says, as the reference's worker (its factory's default); the factory's
    own default stays bf16."""
    from mllm_npu_tpu_torch.configs import load_config
    from mllm_npu_tpu_torch.models.factory import build_sdxl_adapter
    monkeypatch.setenv("DEBUG_FLAG", "True")
    gen_cfg = "mllm_npu_tpu_torch/configs/generation/sd_xl_resampler.yaml"
    eng = worker_mod.load_engine_from_config(
        "mllm_npu_tpu_torch/configs/models/seedx_llama2_13b_qwenvl_vitg.yaml",
        max_new_tokens=4, generation_config=gen_cfg, device="cpu")
    ad = eng.adapter
    for part in (ad.unet, ad.vae, ad.resampler):
        assert {p.dtype for p in part.parameters()} == {torch.float32}
    # the Llama itself stays in the serving default's bf16
    assert {p.dtype for p in eng.generator.model.language_model
            .parameters()} == {torch.bfloat16}
    default = build_sdxl_adapter(**load_config(gen_cfg), device="cpu")
    assert {p.dtype for p in default.unet.parameters()} == {torch.bfloat16}
