"""Model worker (twin of ``mllm_npu_tpu/serve/worker.py``): builds the
engine from a model YAML, registers with the controller and heart-beats,
and serves ``/worker_generate`` (``b"\\0"``-delimited JSON chunks; with
``"stream": true`` one cumulative text snapshot a decode block) and
``/worker_get_status``. The wire format is the reference's, so its
controller and gradio app talk to this worker unchanged.

The HTTP layer is the standard library's (``http.server``'s
``ThreadingHTTPServer``, ``urllib.request`` to the controller): one thread
per connection, a ``threading.Semaphore`` bounding the generations in
flight (``--limit-model-concurrency``). Handler threads only prepare
inputs on the host and submit; with ``--batched`` one drain thread makes
every device call.

    DEBUG_FLAG=True python -m mllm_npu_tpu_torch.serve.worker \\
        --model-config mllm_npu_tpu_torch/configs/models/mllm_llama3_8b_siglip_vit.yaml \\
        --batched --device cpu --no-register --port 40000
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from mllm_npu_tpu_torch.serve.serve_utils import build_logger, server_error_msg

logger = logging.getLogger("model_worker")

WORKER_HEART_BEAT_INTERVAL = 15


def _post_json(url: str, data: dict, timeout: float = 5.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(data).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read() or b"{}")


class ModelWorker:
    def __init__(self, controller_addr: str, worker_addr: str,
                 worker_id: str, model_name: str, engine,
                 no_register: bool = False,
                 limit_model_concurrency: int = 5):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.model_name = model_name
        self.engine = engine
        self.limit_model_concurrency = limit_model_concurrency
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self._lock = threading.Lock()
        self.in_flight = 0
        self.global_counter = 0
        if not no_register:
            self.register_to_controller()
            self.heart_beat_thread = threading.Thread(
                target=self.heart_beat_worker, daemon=True)
            self.heart_beat_thread.start()

    # -- controller protocol -------------------------------------------------

    def register_to_controller(self) -> None:
        logger.info("register to controller")
        _post_json(self.controller_addr + "/register_worker",
                   {"worker_name": self.worker_addr,
                    "check_heart_beat": True,
                    "worker_status": self.get_status()})

    def send_heart_beat(self) -> bool:
        """One heart-beat; True if the controller still knows this worker."""
        return _post_json(self.controller_addr + "/receive_heart_beat",
                          {"worker_name": self.worker_addr,
                           "queue_length": self.get_queue_length()})["exist"]

    def heart_beat_worker(self) -> None:
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            while True:
                try:
                    exist = self.send_heart_beat()
                    break
                except (OSError, ValueError, KeyError) as e:  # retry
                    # OSError: URLError and timeouts; the others: a reply
                    # that is not the controller's
                    logger.error("heartbeat error: %s", e)
                time.sleep(5)
            if not exist:
                self.register_to_controller()

    def get_queue_length(self) -> int:
        return self.in_flight

    def get_status(self) -> dict:
        status = {"model_names": [self.model_name], "speed": 1,
                  "queue_length": self.get_queue_length()}
        # the batched engine's slots, queue and prefix-cache counters
        batch_eng = getattr(self.engine, "batch_engine", None)
        if batch_eng is not None:
            status["engine"] = batch_eng.stats()
        return status

    # -- generation ----------------------------------------------------------

    def generate_gate(self, params: dict):
        """Generator of ``b"\\0"``-delimited JSON chunks with the
        reference's error codes: 0 ok, 1 a ``ValueError`` (a bad image or
        prompt), 3 anything else (an ``image_gen`` request to a worker
        built without ``--generation-config`` among them). An ``image_gen``
        reply carries the b64 JPEG in ``image``."""
        try:
            if params.get("image_gen"):
                image_b64 = self.engine.generation(params["input_text"])
                yield json.dumps({"text": "generate successed.",
                                  "image": image_b64,
                                  "error_code": 0}).encode() + b"\0"
                return
            if params.get("stream") and hasattr(self.engine,
                                                "comprehension_stream"):
                for text in self.engine.comprehension_stream(
                        params["input_text"], params.get("image")):
                    yield json.dumps({"text": text,
                                      "error_code": 0}).encode() + b"\0"
                return
            text = self.engine.comprehension(params["input_text"],
                                             params.get("image"))
            yield json.dumps({"text": text, "error_code": 0}).encode() + b"\0"
        except ValueError:
            logger.exception("ValueError in generate")
            yield json.dumps({"text": server_error_msg,
                              "error_code": 1}).encode() + b"\0"
        except Exception:  # noqa: BLE001 — reported to the client as code 3
            logger.exception("error in generate")
            yield json.dumps({"text": server_error_msg,
                              "error_code": 3}).encode() + b"\0"


class _Handler(BaseHTTPRequestHandler):
    """HTTP/1.0: a streamed body ends when the connection closes."""
    worker: ModelWorker

    def log_message(self, fmt, *args):
        logger.info("%s - " + fmt, self.address_string(), *args)

    def _json_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        return json.loads(self.rfile.read(n) or b"{}")

    def do_POST(self):
        if self.path == "/worker_get_status":
            self._json_body()
            body = json.dumps(self.worker.get_status()).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/worker_generate":
            self._generate(self._json_body())
        else:
            self.send_error(404)

    def _generate(self, params: dict) -> None:
        w = self.worker
        with w._lock:
            w.global_counter += 1
        w.semaphore.acquire()
        with w._lock:
            w.in_flight += 1
        # everything after the acquisition is under the finally: a client
        # that goes away mid-stream must not leak a semaphore slot
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            for chunk in w.generate_gate(params):
                self.wfile.write(chunk)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            logger.warning("client went away mid-response")
        finally:
            with w._lock:
                w.in_flight -= 1
            w.semaphore.release()


def make_server(worker: ModelWorker, host: str = "0.0.0.0",
                port: int = 40000) -> ThreadingHTTPServer:
    """The worker's HTTP server (not started; ``port=0`` picks a free one:
    ``server.server_address``). Run it with ``serve_forever``."""
    handler = type("WorkerHandler", (_Handler,), {"worker": worker})
    server = ThreadingHTTPServer((host, port), handler)
    server.daemon_threads = True
    return server


def _load_tokenizer(tok_cfg: dict, vocab_size: int):
    """The config's tokenizer; under DEBUG_FLAG a missing tokenizer path
    gives the offline ``FakeTokenizer``, so the stack runs without
    checkpoints (as the reference's worker)."""
    import os
    from pathlib import Path

    from mllm_npu_tpu_torch.configs import instantiate
    path = tok_cfg.get("pretrained_model_name_or_path", "")
    if (os.environ.get("DEBUG_FLAG", "False") == "True"
            and not Path(str(path)).exists()):
        from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
        return FakeTokenizer(vocab_size=vocab_size)
    return instantiate(tok_cfg)


KV_CACHE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
                   "fp8": torch.float8_e4m3fn}


def load_engine_from_config(model_config_path: str,
                            max_new_tokens: int = 512,
                            batched: bool = False, num_slots: int = 8,
                            max_len: int = 2048, prefill_chunk=None,
                            prefix_cache=None, prompt_bucket: int = 128,
                            quantize_int8: bool = False,
                            quantize_int4: bool = False,
                            fuse_projections: bool = False,
                            speculative_k: int = 0,
                            speculative_ngram: int = 3,
                            kv_cache_dtype: str = "bf16",
                            generation_config=None, *, device=None,
                            seed: int = 0, fake_tokenizer: bool = False):
    """The worker's engine from a model YAML (the comprehension assembly or
    SEED), weights drawn from ``seed`` (checkpoint loading is not ported
    yet), on ``device`` (``cuda`` unless named; raises without a GPU);
    ``fake_tokenizer`` takes the offline ``FakeTokenizer`` at the model's
    vocab instead of the config's tokenizer. ``batched`` gives a
    :class:`BatchedInferenceEngine` with ``max_prompt = max_len // 2``, as
    the reference's worker. ``kv_cache_dtype`` is ``bf16``, ``fp8`` (e4m3:
    half the cache's memory and its read traffic) or ``f32``.
    ``generation_config`` (a YAML, ``configs/generation/sd_xl_resampler.
    yaml``) builds the SDXL de-tokenizer (``factory.build_sdxl_adapter``,
    weights from ``seed``) over the SEED model's vision encoder, for
    ``image_gen`` requests."""
    from mllm_npu_tpu_torch.configs import instantiate, load_config
    from mllm_npu_tpu_torch.serve.engine import (BatchedInferenceEngine,
                                                 InferenceEngine)
    from mllm_npu_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = load_config(model_config_path)["mllm"]
    llm = instantiate(cfg["language_model"])
    model = instantiate(cfg["mllm_model"], language_model=llm, device=device,
                        seed=seed)
    if fake_tokenizer:
        from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
        tokenizer = FakeTokenizer(vocab_size=llm.config.vocab_size)
    else:
        tokenizer = _load_tokenizer(cfg["tokenizer"], llm.config.vocab_size)
    nq = model.projector.num_queries
    adapter = None
    if generation_config:
        from mllm_npu_tpu_torch.models.factory import build_sdxl_adapter
        adapter = build_sdxl_adapter(**load_config(generation_config),
                                     visual_encoder=model.vision_encoder,
                                     device=device, seed=seed)
    common = dict(model=model, tokenizer=tokenizer, adapter=adapter,
                  image_transform=instantiate(cfg["processor"]),
                  num_img_in_tokens=nq, num_img_out_tokens=nq,
                  max_new_tokens=max_new_tokens, device=device,
                  quantize_int8=quantize_int8, quantize_int4=quantize_int4,
                  fuse_projections=fuse_projections,
                  speculative_k=speculative_k,
                  speculative_ngram=speculative_ngram,
                  cache_dtype=KV_CACHE_DTYPES[kv_cache_dtype])
    if batched:
        return BatchedInferenceEngine(
            num_slots=num_slots, max_len=max_len, max_prompt=max_len // 2,
            batch_prompt_bucket=prompt_bucket, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, **common)
    return InferenceEngine(**common)


# flags of the reference's worker this port does not serve yet: each
# raises, naming its ROADMAP item, when set to anything but its default
UNPORTED_FLAGS = {
    "tensor_parallel": (1, "tensor-parallel serving, queue 1 item 12"),
    "params_checkpoint": (None, "loading orbax checkpoints, queue 1 item "
                                "16"),
    "cast_bf16": (True, "serving fp32 weights (--no-cast-bf16: fp32 "
                        "serving needs K1 for fp32 operands), queue 1 "
                        "item 10c"),
}


def parse_worker_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker-config", type=str, default=None,
                        help="JSON wiring the serving stack from one file; "
                             "keys are the flags with underscores, unknown "
                             "keys are refused; flags on the command line "
                             "win")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=40000)
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:40000")
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:10075")
    parser.add_argument("--model-name", type=str, default="seed-x")
    parser.add_argument("--model-config", type=str, default=None)
    parser.add_argument("--generation-config", type=str, default=None,
                        help="the de-tokenizer's YAML (image_gen requests)")
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--batched", action=argparse.BooleanOptionalAction,
                        default=False,
                        help="continuous-batching comprehension: concurrent "
                             "requests share one KV cache, the decode block "
                             "a CUDA graph on the GPU")
    parser.add_argument("--num-slots", type=int, default=8)
    parser.add_argument("--max-cache-len", type=int, default=2048)
    parser.add_argument("--tensor-parallel", type=int, default=1,
                        help="not ported yet (raises above 1)")
    parser.add_argument("--prompt-bucket", type=int, default=128,
                        help="prompt lengths round up to this before the "
                             "prefill; also the prefix-cache alignment "
                             "(shared prefixes shorter than this never hit)")
    parser.add_argument("--prefix-cache", type=int, default=None,
                        help="cache up to N prompt-prefix KV entries on the "
                             "device; a request sharing a cached prefix "
                             "prefills only its suffix")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="chunked prefill: admit prompts N tokens a "
                             "tick so long prompts do not stall decoding "
                             "slots")
    parser.add_argument("--quantize-int8",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="int8 weight-only Llama (K4 on the GPU)")
    parser.add_argument("--quantize-int4",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="int4 group-scale weight-only Llama (K5 on the "
                             "GPU)")
    parser.add_argument("--cast-bf16", action=argparse.BooleanOptionalAction,
                        default=True, dest="cast_bf16",
                        help="fp32 weights are cast to bf16 (--no-cast-bf16 "
                             "is not ported yet and raises)")
    parser.add_argument("--fuse-projections",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="serve q/k/v and gate/up as one product each "
                             "(LoRA merged first)")
    parser.add_argument("--unroll-layers",
                        action=argparse.BooleanOptionalAction, default=False,
                        help="accepted and without effect: the port's "
                             "layers are already a Python loop")
    parser.add_argument("--speculative-k", type=int, default=0,
                        help="prompt-lookup speculative decode: verify k "
                             "proposed tokens a forward (greedy requests; "
                             "0 turns it off)")
    parser.add_argument("--speculative-ngram", type=int, default=3,
                        help="n-gram length the proposals are matched on")
    parser.add_argument("--kv-cache-dtype", type=str, default="bf16",
                        choices=list(KV_CACHE_DTYPES),
                        help="KV cache storage dtype (fp8: e4m3, half the "
                             "cache memory of bf16)")
    parser.add_argument("--params-checkpoint", type=str, default=None,
                        help="not ported yet (raises)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the drawn weights")

    # two stages: a --worker-config JSON gives every flag a default, and
    # the flags given on the command line still win
    pre, _ = parser.parse_known_args(argv)
    if pre.worker_config:
        with open(pre.worker_config) as f:
            wc = json.load(f)
        unknown = set(wc) - {a.dest for a in parser._actions}
        if unknown:
            raise SystemExit(f"unknown worker-config keys: {sorted(unknown)}")
        parser.set_defaults(**wc)
    args = parser.parse_args(argv)
    if not args.model_config:
        parser.error("--model-config (or a worker config providing "
                     "model_config) is required")
    for name, (default, what) in UNPORTED_FLAGS.items():
        if getattr(args, name) != default:
            raise NotImplementedError(
                f"--{name.replace('_', '-')} {getattr(args, name)!r}: "
                f"{what} is not ported yet (ROADMAP)")
    return args


def main(argv=None):
    args = parse_worker_args(argv)
    build_logger("model_worker", f"model_worker_{uuid.uuid4().hex[:6]}.log")
    engine = load_engine_from_config(
        args.model_config, batched=args.batched, num_slots=args.num_slots,
        max_len=args.max_cache_len, prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache, prompt_bucket=args.prompt_bucket,
        quantize_int8=args.quantize_int8, quantize_int4=args.quantize_int4,
        fuse_projections=args.fuse_projections,
        speculative_k=args.speculative_k,
        speculative_ngram=args.speculative_ngram,
        kv_cache_dtype=args.kv_cache_dtype,
        generation_config=args.generation_config, device=args.device,
        seed=args.seed)
    if args.batched:
        args.limit_model_concurrency = max(args.limit_model_concurrency,
                                           args.num_slots)
    worker = ModelWorker(args.controller_address, args.worker_address,
                         uuid.uuid4().hex[:6], args.model_name, engine,
                         no_register=args.no_register,
                         limit_model_concurrency=args.limit_model_concurrency)
    server = make_server(worker, args.host, args.port)
    logger.info("serving on %s:%d", *server.server_address[:2])
    server.serve_forever()


if __name__ == "__main__":
    main()
