"""The port's HTTP worker on loopback (port 0, the CPU, the tiny stack in
the serving setting: bf16 weights, bf16 cache): its routes and error
codes, streamed against non-streamed text, concurrent requests against
the single-request engine's serial texts, the worker-config JSON and the
unported flags, registration with the JAX package's controller and a
request proxied by it, and the serve helpers."""

import asyncio
import base64
import io
import json
import logging
import sys
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from mllm_npu_tpu.serve import controller as controller_mod
from mllm_npu_tpu_torch.data.processor import ImageProcessor
from mllm_npu_tpu_torch.serve import serve_utils, worker as worker_mod
from mllm_npu_tpu_torch.serve.engine import (BatchedInferenceEngine,
                                             InferenceEngine)
from mllm_npu_tpu_torch.serve.worker import ModelWorker, make_server
from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
from mllm_npu_tpu_torch.utils.testing import TinySpec, build_tiny_mllm

COMMON = dict(resolution_grids=("1x1", "1x2", "2x1", "2x2"),
              base_resolution=448, num_img_in_tokens=4, num_img_out_tokens=4,
              max_new_tokens=10)
BATCH = dict(num_slots=3, max_len=96, max_prompt=48, block_steps=3,
             batch_prompt_bucket=16, prefix_cache=2)


def _png_b64(w, h, seed=0):
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _engine(**kw):
    tm, _, _ = build_tiny_mllm(TinySpec(), device="cpu", seed=5,
                               llama_kw=dict(lora_rank=8))
    return BatchedInferenceEngine(
        model=tm, tokenizer=FakeTokenizer(),
        image_transform=ImageProcessor(height=56, width=56), device="cpu",
        **COMMON, **BATCH, **kw)


class _Served:
    """A worker on 127.0.0.1 and a free port, served from a thread."""

    def __init__(self, engine, **kw):
        self.worker = ModelWorker("http://unused", "http://worker", "id0",
                                  "tiny", engine, **kw)
        self.server = make_server(self.worker, "127.0.0.1", 0)
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _post(url, body, timeout=60):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _chunks(raw):
    return [json.loads(c) for c in raw.split(b"\0") if c]


@pytest.fixture(scope="module")
def served():
    eng = _engine()
    s = _Served(eng, no_register=True, limit_model_concurrency=4)
    yield s
    s.close()
    eng.close()


REQUESTS = [("what is shown?", _png_b64(896, 896, 0)),
            ("describe it", _png_b64(384, 1152, 1)),
            ("what is the capital of france?", ""),
            ("hi", ""),
            ("which colour dominates?", _png_b64(500, 300, 2)),
            ("count the objects", "")]


def test_generate_and_status_routes(served):
    q, b64 = REQUESTS[0]
    msgs = _chunks(_post(served.url + "/worker_generate",
                         {"input_text": q, "image": b64, "image_gen": False}))
    assert len(msgs) == 1 and msgs[0]["error_code"] == 0
    assert msgs[0]["text"] == InferenceEngine.comprehension(
        served.worker.engine, q, b64)
    status = json.loads(_post(served.url + "/worker_get_status", {}))
    assert status["model_names"] == ["tiny"] and status["speed"] == 1
    assert status["queue_length"] == 0
    assert status["engine"]["slots_busy"] == 0
    assert status["engine"]["pending"] == 0
    assert set(status["engine"]["prefix_cache"]) == {
        "entries", "hits", "misses", "tokens_saved"}
    with pytest.raises(urllib.error.HTTPError):
        _post(served.url + "/nowhere", {})


@pytest.mark.parametrize("body,code", [
    ({"input_text": "hi", "image": "@@not base64@@"}, 1),
    ({"input_text": "word " * 60, "image": ""}, 1),     # over max_prompt
    ({"input_text": "a cat", "image_gen": True}, 3),
    ({"image": ""}, 3),                                 # no input_text
])
def test_error_codes(served, body, code):
    msgs = _chunks(_post(served.url + "/worker_generate", body))
    assert [m["error_code"] for m in msgs] == [code]
    assert msgs[0]["text"] == serve_utils.server_error_msg
    # the worker keeps serving
    ok = _chunks(_post(served.url + "/worker_generate",
                       {"input_text": "hi", "image": ""}))
    assert ok[0]["error_code"] == 0


def test_streamed_snapshots_end_in_the_text(served):
    for q, b64 in REQUESTS[:3]:
        body = {"input_text": q, "image": b64}
        plain = _chunks(_post(served.url + "/worker_generate", body))
        streamed = _chunks(_post(served.url + "/worker_generate",
                                 dict(body, stream=True)))
        assert len(streamed) >= 2           # a snapshot a decode block
        assert all(m["error_code"] == 0 for m in streamed)
        assert streamed[-1]["text"] == plain[0]["text"]


def test_concurrent_requests_give_the_serial_texts(served):
    """Six requests at once (more than the three slots) through HTTP give
    the texts of the single-request engine on the same model, one at a
    time, and the request's ids are those of the single-request
    engine."""
    eng = served.worker.engine
    serial = [InferenceEngine.comprehension(eng, q, b) for q, b in REQUESTS]
    for q, b in REQUESTS[:2]:
        np.testing.assert_array_equal(
            eng.request(q, b).tokens,
            InferenceEngine.comprehension_ids(eng, q, b))

    def one(i):
        q, b = REQUESTS[i]
        return _chunks(_post(served.url + "/worker_generate",
                             {"input_text": q, "image": b}))
    with ThreadPoolExecutor(len(REQUESTS)) as ex:
        got = list(ex.map(one, range(len(REQUESTS))))
    assert [m[0]["error_code"] for m in got] == [0] * len(REQUESTS)
    assert [m[0]["text"] for m in got] == serial
    assert eng.batch_engine.stats()["slots_busy"] == 0


def test_generate_ids_and_max_new_tokens(served):
    """The evaluator's raw-ids path shares prefixes through the cache; a
    request asks for fewer tokens than the engine's default, or more than
    its row can hold and is cut to ``capacity_for``."""
    eng = served.worker.engine
    tok = eng.tokenizer
    ids = [tok.bos_token_id] + tok.encode("alpha beta gamma delta epsilon "
                                          "zeta eta theta iota kappa lambda "
                                          "mu nu xi omicron pi rho sigma")
    before = eng.batch_engine.stats()["prefix_cache"]["hits"]
    a = eng.generate_ids(ids + [200], 4)
    b = eng.generate_ids(ids + [300], 4)
    assert len(a) == len(b) == 4
    assert eng.batch_engine.stats()["prefix_cache"]["hits"] == before + 1
    cap = eng.batch_engine.capacity_for(len(ids) + 1)
    assert len(eng.generate_ids(ids + [200], cap + 50)) == cap
    q, b64 = REQUESTS[2]
    short = eng.request(q, b64, max_new_tokens=3).tokens
    assert short == eng.request(q, b64).tokens[:3]
    assert InferenceEngine.comprehension(eng, q, b64, max_new_tokens=3) == \
        eng.comprehension(q, b64, max_new_tokens=3)


def test_engine_failure_fails_every_request():
    eng = _engine()
    calls = []

    def broken():
        calls.append(1)
        raise RuntimeError("device lost")
    eng.batch_engine._dispatch_block = broken
    s = _Served(eng, no_register=True)
    try:
        with ThreadPoolExecutor(2) as ex:
            got = list(ex.map(lambda q: _chunks(_post(
                s.url + "/worker_generate",
                {"input_text": q, "image": ""})), ["one", "two"]))
        assert calls
        assert [m[0]["error_code"] for m in got] == [3, 3]
        later = _chunks(_post(s.url + "/worker_generate",
                              {"input_text": "three", "image": ""}))
        assert later[0]["error_code"] == 3
        with pytest.raises(RuntimeError, match="failed"):
            eng.comprehension("four", "")
    finally:
        s.close()
        eng.close()


def _start_reference_controller():
    """The JAX package's controller app on a free port, its event loop in
    a thread; → (url, stop)."""
    loop = asyncio.new_event_loop()
    from aiohttp import web
    runner = web.AppRunner(controller_mod.create_app(
        controller_mod.Controller("shortest_queue")))
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = runner.addresses[0][1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def stop():
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        assert not thread.is_alive()
        loop.close()
    return f"http://127.0.0.1:{port}", stop


def test_registers_with_the_reference_controller_and_is_proxied(
        served, monkeypatch):
    # the heart-beat thread this worker starts stays asleep past the test
    monkeypatch.setattr(worker_mod, "WORKER_HEART_BEAT_INTERVAL", 10 ** 6)
    url, stop = _start_reference_controller()
    try:
        w = ModelWorker(url, served.url, "id1", "tiny-port",
                        served.worker.engine, no_register=False)
        assert w.send_heart_beat() is True
        models = json.loads(_post(url + "/list_models", {}))
        assert models["models"] == ["tiny-port"]
        addr = json.loads(_post(url + "/get_worker_address",
                                {"model": "tiny-port"}))
        assert addr["address"] == served.url
        q, b64 = REQUESTS[4]     # under aiohttp's 1 MiB body limit
        body = {"model": "tiny-port", "input_text": q, "image": b64}
        via = _chunks(_post(url + "/worker_generate", body))
        direct = _chunks(_post(served.url + "/worker_generate", body))
        assert via == direct and via[0]["error_code"] == 0
        streamed = _chunks(_post(url + "/worker_generate",
                                 dict(body, stream=True)))
        assert streamed[-1] == direct[0]
    finally:
        stop()


def test_worker_config_json_and_unknown_keys(tmp_path):
    cfg = tmp_path / "w.json"
    cfg.write_text(json.dumps({"model_config": "m.yaml", "batched": True,
                               "num_slots": 4, "prefix_cache": 8,
                               "quantize_int8": True, "unroll_layers": True}))
    args = worker_mod.parse_worker_args(["--worker-config", str(cfg),
                                         "--num-slots", "6",
                                         "--no-quantize-int8"])
    assert args.model_config == "m.yaml" and args.batched
    assert args.num_slots == 6 and args.prefix_cache == 8
    assert not args.quantize_int8 and args.unroll_layers
    assert args.device == "cuda" and args.seed == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"model_config": "m.yaml", "slots": 4}))
    with pytest.raises(SystemExit, match="unknown worker-config keys"):
        worker_mod.parse_worker_args(["--worker-config", str(bad)])
    with pytest.raises(SystemExit):
        worker_mod.parse_worker_args([])


@pytest.mark.parametrize("flags,item", [
    (["--tensor-parallel", "2"], "item 12"),
    (["--params-checkpoint", "ckpt"], "item 16"),
    (["--no-cast-bf16"], "item 10c"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        worker_mod.parse_worker_args(["--model-config", "m.yaml"] + flags)


def test_generation_config_flag_is_taken():
    """The de-tokenizer's flag is ported: it parses, and the worker's main
    hands it to ``load_engine_from_config``."""
    args = worker_mod.parse_worker_args(["--model-config", "m.yaml",
                                         "--generation-config", "gen.yaml"])
    assert args.generation_config == "gen.yaml"
    assert "generation_config" not in worker_mod.UNPORTED_FLAGS


def test_unported_key_in_worker_config_raises(tmp_path):
    """A worker config's key that is not ported raises as its flag does."""
    cfg = tmp_path / "w.json"
    cfg.write_text(json.dumps({"model_config": "m.yaml",
                               "tensor_parallel": 2}))
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        worker_mod.parse_worker_args(["--worker-config", str(cfg)])


@pytest.mark.parametrize("flags", [
    ["--speculative-k", "4"],
    ["--speculative-k", "3", "--speculative-ngram", "2"],
    ["--fuse-projections"],
    ["--kv-cache-dtype", "fp8"],
    ["--kv-cache-dtype", "f32"],
])
def test_ported_flags_build_an_engine_on_cpu(monkeypatch, flags):
    """The serving flags of queue 1 item 10b parse and build the tiny
    batched engine on the CPU with what they ask for, and it answers."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    args = worker_mod.parse_worker_args(
        ["--model-config", "models/mllm_llama3_8b_siglip_vit.yaml",
         "--batched", "--device", "cpu"] + flags)
    eng = worker_mod.load_engine_from_config(
        args.model_config, max_new_tokens=3, batched=True, num_slots=2,
        max_len=256, fuse_projections=args.fuse_projections,
        speculative_k=args.speculative_k,
        speculative_ngram=args.speculative_ngram,
        kv_cache_dtype=args.kv_cache_dtype, device="cpu")
    try:
        be = eng.batch_engine
        assert be.speculative_k == args.speculative_k
        assert be.speculative_ngram == args.speculative_ngram
        assert eng.generator.speculative_k == args.speculative_k
        assert be.state["k"].dtype == worker_mod.KV_CACHE_DTYPES[
            args.kv_cache_dtype] == eng.generator.cache_dtype
        lm_cfg = eng.generator.model.language_model.config
        assert lm_cfg.fused_projections == args.fuse_projections
        assert len(eng.comprehension_ids("hi", "")) == 3
    finally:
        eng.close()


def test_worker_config_speculation_and_cache_dtype(tmp_path):
    """The reference's shipped worker config sets speculative_k 63; a
    worker config's speculative_k and kv_cache_dtype are honoured, and the
    command line still wins."""
    cfg = tmp_path / "w.json"
    cfg.write_text(json.dumps({"model_config": "m.yaml",
                               "speculative_k": 63,
                               "kv_cache_dtype": "fp8"}))
    args = worker_mod.parse_worker_args(["--worker-config", str(cfg)])
    assert args.speculative_k == 63 and args.kv_cache_dtype == "fp8"
    args = worker_mod.parse_worker_args(["--worker-config", str(cfg),
                                         "--speculative-k", "4"])
    assert args.speculative_k == 4
    assert worker_mod.parse_worker_args(
        ["--model-config", "m.yaml"]).speculative_k == 0


def test_load_engine_from_config_serves_tiny_on_cpu(monkeypatch):
    """The worker's YAML path: under DEBUG_FLAG the stack is tiny and the
    missing tokenizer is the offline one; batched, on the CPU."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    eng = worker_mod.load_engine_from_config(
        "models/mllm_llama3_8b_siglip_vit.yaml", max_new_tokens=3,
        batched=True, num_slots=2, max_len=256, device="cpu")
    try:
        assert isinstance(eng, BatchedInferenceEngine)
        assert eng.batch_engine.max_prompt == 128
        assert isinstance(eng.tokenizer, FakeTokenizer)
        text = eng.comprehension("hi", _png_b64(500, 300))
        assert isinstance(text, str)
        assert eng.batch_engine.replays == 0      # eager on the CPU
    finally:
        eng.close()


def test_seedx_worker_config_serves_tiny_on_cpu(monkeypatch):
    """The port's copy of the reference's shipped worker config: its own
    SEED-X YAML and generation config, the reference's values (8 slots, a
    2048-token cache, speculative_k 63). Under DEBUG_FLAG it builds the
    tiny SEED stack and the tiny de-tokenizer on the CPU, whose worker
    answers an image, a text and an image_gen request (code 0, a JPEG of
    the tiny UNet's native size)."""
    monkeypatch.setenv("DEBUG_FLAG", "True")
    path = "mllm_npu_tpu_torch/configs/workers/seedx_worker.json"
    raw = json.load(open(path))
    assert raw["generation_config"].endswith("sd_xl_resampler.yaml")
    assert not any("mllm_npu_tpu/" in str(v) for v in raw.values())
    args = worker_mod.parse_worker_args(["--worker-config", path,
                                         "--device", "cpu"])
    assert args.model_name == "seed-x" and args.batched
    assert (args.num_slots, args.max_cache_len, args.speculative_k) == (
        8, 2048, 63)
    assert args.model_config.endswith("seedx_llama2_13b_qwenvl_vitg.yaml")
    eng = worker_mod.load_engine_from_config(
        args.model_config, max_new_tokens=6, batched=args.batched,
        num_slots=args.num_slots, max_len=args.max_cache_len,
        speculative_k=args.speculative_k,
        generation_config=args.generation_config, device=args.device)
    served = _Served(eng, no_register=True, limit_model_concurrency=4)
    try:
        assert eng.batch_engine.speculative_k == 63
        assert eng.adapter.visual_encoder is eng.generator.model.vision_encoder
        for q, b64 in (("what is shown?", _png_b64(500, 300)), ("hi", "")):
            msgs = _chunks(_post(served.url + "/worker_generate",
                                 {"input_text": q, "image": b64}))
            assert [m["error_code"] for m in msgs] == [0]
            assert msgs[0]["text"] == InferenceEngine.comprehension(
                eng, q, b64)
        msgs = _chunks(_post(served.url + "/worker_generate",
                             {"input_text": "a cat", "image_gen": True}))
        assert [m["error_code"] for m in msgs] == [0]
        jpeg = base64.b64decode(msgs[0]["image"])
        assert jpeg[:3] == b"\xff\xd8\xff"
        assert Image.open(io.BytesIO(jpeg)).size == (16, 16)
        t = eng.last_timings
        assert t["steps"] == 50 and t["request_s"] >= t["denoise_s"] > 0
    finally:
        served.close()
        eng.close()


def test_serve_utils_logger_and_semaphore(tmp_path, monkeypatch):
    monkeypatch.setattr(serve_utils, "handler", None)
    log = serve_utils.build_logger("t_port_logger", "t.log",
                                   log_dir=str(tmp_path), redirect_std=False)
    log.info("hello-from-port-test")
    serve_utils.handler.flush()
    assert "hello-from-port-test" in (tmp_path / "t.log").read_text()
    logging.getLogger().removeHandler(serve_utils.handler)
    for sem in (asyncio.Semaphore(3), threading.Semaphore(3)):
        s = serve_utils.pretty_print_semaphore(sem)
        assert "value=3" in s and "locked=False" in s
    held = threading.Semaphore(1)
    held.acquire()
    assert "locked=True" in serve_utils.pretty_print_semaphore(held)
    assert serve_utils.pretty_print_semaphore(None) == "None"


def test_build_logger_captures_stdout_stderr(tmp_path, monkeypatch):
    monkeypatch.setattr(serve_utils, "handler", None)
    monkeypatch.setenv("MLLM_LOG_REDIRECT", "1")
    old_out, old_err = sys.stdout, sys.stderr
    try:
        serve_utils.build_logger("t_port_logger2", "cap.log",
                                 log_dir=str(tmp_path))
        assert isinstance(sys.stdout, serve_utils.StreamToLogger)
        print("printed-line-for-capture")
        sys.stderr.write("stderr-line-for-capture\n")
        sys.stdout.flush()
        sys.stderr.flush()
    finally:
        sys.stdout, sys.stderr = old_out, old_err
    serve_utils.handler.flush()
    logging.getLogger().removeHandler(serve_utils.handler)
    text = (tmp_path / "cap.log").read_text()
    assert "printed-line-for-capture" in text
    assert "stderr-line-for-capture" in text
    shim = serve_utils.StreamToLogger(logging.getLogger("x"), logging.INFO)
    assert not shim.isatty() and shim.encoding == "utf-8"
