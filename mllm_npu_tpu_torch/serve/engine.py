"""Inference engines, the model side of the serve worker (twins of
``InferenceEngine`` and ``BatchedInferenceEngine`` in
``mllm_npu_tpu/serve/engine.py``). Comprehension: b64 image → anyres
tiling → ``<patch>…</patch><img>…</img>Question: …\\nAnswer:`` prompt →
greedy decode → special-token-stripped text; a null or empty image means
a text-only question. For a SEED model, ``text_to_image_features``: a
caption ending in ``<img>`` → the forced image-token ladder → the output
projector's features. ``InferenceEngine`` serves one request per call;
``BatchedInferenceEngine`` sends concurrent comprehension requests through
the continuous-batching engine and the rest through its single-request
generator. Both take the reference's serving options: the KV cache's
dtype, fused projections and prompt-lookup speculation. ``generation``
(caption → image): the features through the SDXL de-tokenizer
(``adapter``, ``models/generation/adapter_modules.SDXLAdapter``) at its
native size, 50 Euler steps, guidance 7.5, as a b64 JPEG; it runs on the
calling thread through the single-request generator, as the reference's.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import logging
import queue
import re
import threading
import time
from typing import Optional

import numpy as np
import torch
from PIL import Image

from mllm_npu_tpu_torch.constant import (BOI_TOKEN, BOP_TOKEN, EOI_TOKEN,
                                         EOP_TOKEN, NUM_IMG_TOKENS,
                                         image_tokens_str)
from mllm_npu_tpu_torch.data.utils import (
    grid_pinpoints_from_resolution_grids, process_anyres_image)
from mllm_npu_tpu_torch.models.generation.generate import (CACHE_DTYPE,
                                                           MLLMGenerator)
from mllm_npu_tpu_torch.models.generation.sampler import (
    SamplingConfig, ladder_from_tokenizer)
from mllm_npu_tpu_torch.serve.batched_engine import ContinuousBatchingEngine
from mllm_npu_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_RESOLUTION_GRIDS = ("1x1", "1x2", "1x3", "2x1", "3x1", "1x4",
                            "4x1", "2x2")


class InferenceEngine:
    """``model`` is a ``GeneralizedMultimodalModel``; it is moved to
    ``device`` (``cuda`` unless the caller names another).
    ``quantize_int8`` / ``quantize_int4`` serve its Llama with int8 / int4
    weights and ``fuse_projections`` with fused q/k/v and gate/up products
    (``MLLMGenerator``, converted in place on ``device``); ``cache_dtype``
    is the KV cache's; ``speculative_k`` > 0 decodes a request by
    prompt-lookup speculation. ``adapter`` is the de-tokenizer that
    :meth:`generation` needs (None: it raises)."""

    def __init__(self, *, model, tokenizer, image_transform, adapter=None,
                 resolution_grids=DEFAULT_RESOLUTION_GRIDS,
                 base_resolution: int = 448,
                 num_img_in_tokens: int = NUM_IMG_TOKENS,
                 num_img_out_tokens: int = NUM_IMG_TOKENS,
                 max_new_tokens: int = 512, device=None,
                 quantize_int8: bool = False, quantize_int4: bool = False,
                 fuse_projections: bool = False,
                 cache_dtype: torch.dtype = CACHE_DTYPE,
                 speculative_k: int = 0, speculative_ngram: int = 3):
        self.device = resolve_device(device)
        self.adapter = adapter
        self.last_timings: dict = {}
        self.tokenizer = tokenizer
        self.image_transform = image_transform
        self.base_resolution = base_resolution
        self.grid_pinpoints = grid_pinpoints_from_resolution_grids(
            list(resolution_grids), base_resolution)
        self.num_img_in_tokens = num_img_in_tokens
        self.num_img_out_tokens = num_img_out_tokens
        self.boi = tokenizer.encode(BOI_TOKEN, add_special_tokens=False)[0]
        self.eoi = tokenizer.encode(EOI_TOKEN, add_special_tokens=False)[0]
        self.bop = tokenizer.encode(BOP_TOKEN, add_special_tokens=False)[0]
        self.eop = tokenizer.encode(EOP_TOKEN, add_special_tokens=False)[0]
        eos = getattr(tokenizer, "eos_token_id", -1)
        self.generator = MLLMGenerator(
            model.to(self.device),
            sampling=SamplingConfig(
                max_new_tokens=max_new_tokens,
                eos_token_id=eos if eos is not None else -1,
                pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0),
            ladder=ladder_from_tokenizer(tokenizer, num_img_out_tokens),
            quantize_int8=quantize_int8, quantize_int4=quantize_int4,
            fuse_projections=fuse_projections, cache_dtype=cache_dtype,
            speculative_k=speculative_k, speculative_ngram=speculative_ngram)

    def _prepare_comprehension(self, input_text: str, image_b64: str):
        """b64 image + question → (prompt ids, anyres tiles NHWC, tile
        positions, ids_cmp_mask); the last three are None without image."""
        if not image_b64:
            prompt = f"Question: {input_text}\nAnswer:"
            ids = [self.tokenizer.bos_token_id] + self.tokenizer.encode(
                prompt, add_special_tokens=False)
            return np.asarray(ids, np.int32), None, None, None
        image = Image.open(io.BytesIO(
            base64.b64decode(image_b64))).convert("RGB")
        patches, patch_pos = process_anyres_image(
            image, self.image_transform, self.grid_pinpoints,
            self.base_resolution)
        n = patches.shape[0]
        image_tokens = "".join(
            image_tokens_str(self.num_img_in_tokens, BOP_TOKEN, EOP_TOKEN)
            for _ in range(n - 1))
        image_tokens += image_tokens_str(self.num_img_in_tokens)
        prompt = image_tokens + f"Question: {input_text}\nAnswer:"
        ids = np.asarray([self.tokenizer.bos_token_id] + self.tokenizer.encode(
            prompt, add_special_tokens=False), np.int32)
        ids_cmp_mask = np.zeros_like(ids, bool)
        boi_idx = np.where((ids == self.boi) | (ids == self.bop))[0]
        eoi_idx = np.where((ids == self.eoi) | (ids == self.eop))[0]
        for b, e in zip(boi_idx, eoi_idx):
            ids_cmp_mask[b + 1:e] = True
        return ids, patches, patch_pos, ids_cmp_mask

    def _decode_text(self, gen_ids: np.ndarray) -> str:
        pad = self.generator.sampling.pad_token_id
        eos = self.generator.sampling.eos_token_id
        keep = gen_ids != pad
        if eos >= 0:
            hits = np.where(gen_ids == eos)[0]
            if len(hits):
                keep[hits[0]:] = False
        return self.tokenizer.decode(gen_ids[keep], skip_special_tokens=False)

    def _strip_text(self, gen_ids: np.ndarray) -> str:
        text = self._decode_text(gen_ids)
        text = re.sub(r"<[^>]*>", "", text)
        text = re.sub(r"\[(.*)\]", "", text)
        return text.split("\n")[0]

    def comprehension_ids(self, input_text: str, image_b64: str,
                          max_new_tokens: Optional[int] = None
                          ) -> np.ndarray:
        """Greedy ids [max_new_tokens] for one request (the engine's
        ``max_new_tokens`` unless one is given)."""
        ids, patches, patch_pos, ids_cmp_mask = \
            self._prepare_comprehension(input_text, image_b64)
        dev = self.device
        sampling = None
        if max_new_tokens is not None:
            sampling = dataclasses.replace(self.generator.sampling,
                                           max_new_tokens=max_new_tokens)
        input_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)[None]
        kw = dict(sampling=sampling,
                  num_img_gen_tokens=self.num_img_out_tokens)
        if patches is None:
            out = self.generator.generate(input_ids, **kw)
        else:
            n = patches.shape[0]
            out = self.generator.generate(
                input_ids,
                images=torch.as_tensor(patches, device=dev),
                embeds_cmp_mask=torch.ones((n,), dtype=torch.bool, device=dev),
                ids_cmp_mask=torch.as_tensor(ids_cmp_mask, device=dev)[None],
                patch_positions=torch.as_tensor(patch_pos, device=dev), **kw)
        return out["generate_ids"][0].cpu().numpy()

    def comprehension(self, input_text: str, image_b64: str,
                      max_new_tokens: Optional[int] = None) -> str:
        return self._strip_text(self.comprehension_ids(
            input_text, image_b64, max_new_tokens))

    def text_to_image_features(self, caption: str,
                               max_new_tokens: Optional[int] = None) -> dict:
        """``caption`` + ``<img>`` through a SEED model's generator
        (``MLLMGenerator.generate_with_projection``): the forced ladder's
        hidden states through the output projector. Returns its dict
        (``text``, ``has_img_output``, ``num_gen_imgs``, ``img_gen_feat``
        [n, num_img_out_tokens, D]). ``max_new_tokens`` (the engine's
        unless given) bounds the decode, the ladder included."""
        ids = [self.tokenizer.bos_token_id] + self.tokenizer.encode(
            f"{caption}{BOI_TOKEN}", add_special_tokens=False)
        sampling = None
        if max_new_tokens is not None:
            sampling = dataclasses.replace(self.generator.sampling,
                                           max_new_tokens=max_new_tokens)
        return self.generator.generate_with_projection(
            torch.as_tensor(ids, dtype=torch.long, device=self.device)[None],
            tokenizer=self.tokenizer, sampling=sampling,
            num_img_gen_tokens=self.num_img_out_tokens)

    def generation(self, input_text: str, num_inference_steps: int = 50
                   ) -> str:
        """Caption → b64 JPEG: the features of
        :meth:`text_to_image_features` through the SDXL de-tokenizer at its
        native size (the UNet's sample size times the VAE's scale: 1024 for
        SDXL-base), guidance 7.5, the zero-image negative at
        ``base_resolution``.
        ``last_timings`` records the features' and the adapter's times."""
        if self.adapter is None:
            raise RuntimeError("no de-tokenizer adapter loaded (the worker's "
                               "--generation-config)")
        t0 = time.perf_counter()
        # the forced ladder and </img> (one more for the margin): the first
        # window's hidden states, all the adapter reads, do not depend on
        # the tokens after it, so the decode stops there
        out = self.text_to_image_features(
            input_text, max_new_tokens=self.num_img_out_tokens + 2)
        if not out.get("has_img_output"):
            raise RuntimeError("model produced no image tokens")
        features_s = time.perf_counter() - t0
        size = (self.adapter.unet.config.sample_size
                * self.adapter.vae.config.spatial_scale_factor)
        images = self.adapter.generate(
            image_embeds=out["img_gen_feat"], height=size, width=size,
            num_inference_steps=num_inference_steps,
            input_image_size=self.base_resolution)
        buf = io.BytesIO()
        images[0].save(buf, format="JPEG")
        self.last_timings = {"features_s": features_s,
                             **self.adapter.last_timings,
                             "request_s": time.perf_counter() - t0}
        return base64.b64encode(buf.getvalue()).decode("utf-8")


class BatchedInferenceEngine(InferenceEngine):
    """``InferenceEngine`` whose comprehension runs through the
    :class:`ContinuousBatchingEngine`: concurrent requests share one static
    KV cache and decode together, the decode block (or the speculative
    verify tick) captured as a CUDA graph on the GPU. The other keywords
    are ``InferenceEngine``'s; its ``generator`` (weights cast, fused,
    quantized) holds the model both engines serve, and its cache dtype and
    speculation settings are the batched engine's too.

    Threads: callers (the worker's handler threads) prepare inputs on the
    host and submit; one drain thread, started last, makes every device
    call after construction (the capture happens before it starts); a
    ``threading.Condition`` hands requests over and wakes callers when
    theirs is done. An engine failure fails every request in flight and
    every later one."""

    def __init__(self, *, num_slots: int = 8, max_len: int = 2048,
                 max_prompt: int = 1024, block_steps: int = 16,
                 batch_prompt_bucket: int = 128,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[int] = None, **kw):
        super().__init__(**kw)
        gen = self.generator
        self.batch_engine = ContinuousBatchingEngine(
            gen.model, num_slots=num_slots, max_len=max_len,
            block_steps=block_steps, prompt_bucket=batch_prompt_bucket,
            max_prompt=max_prompt, eos_token_id=gen.sampling.eos_token_id,
            pad_token_id=gen.sampling.pad_token_id,
            cache_dtype=gen.cache_dtype, prefill_chunk=prefill_chunk,
            prefix_cache=prefix_cache, ladder=gen.ladder,
            speculative_k=gen.speculative_k,
            speculative_ngram=gen.speculative_ngram)
        self._cv = threading.Condition()
        self._inflight: dict = {}   # uid -> [request, event, queue, #sent]
        self._engine_error: Optional[BaseException] = None
        self._closed = False
        self._drain = threading.Thread(target=self._drain_loop, daemon=True,
                                       name="batched-engine-drain")
        self._drain.start()

    def close(self) -> None:
        """Stop the drain thread once nothing is in flight; after this the
        caller's thread may drive ``batch_engine`` itself."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._drain.join()

    def _submit(self, ids, patches, patch_pos, ids_cmp_mask,
                max_new_tokens: Optional[int], q=None):
        eng = self.batch_engine
        want = max_new_tokens or self.generator.sampling.max_new_tokens
        mnt = min(want, eng.capacity_for(len(ids)))
        if mnt < 1:
            raise ValueError(
                f"prompt of {len(ids)} tokens exceeds the batched engine's "
                f"capacity (max_prompt={eng.max_prompt}, "
                f"max_len={eng.max_len})")
        if mnt < want:
            log.warning(
                "truncating max_new_tokens %d -> %d: prompt of %d tokens "
                "leaves only that much cache-row capacity (raise the "
                "worker's --max-cache-len for longer answers)", want, mnt,
                len(ids))
        ev = threading.Event()
        with self._cv:
            if self._engine_error is not None:
                raise RuntimeError("batched engine failed") \
                    from self._engine_error
            if self._closed:
                raise RuntimeError("batched engine is closed")
            if patches is None:
                # text-only: eligible for the prompt-prefix cache
                req = eng.submit(ids, max_new_tokens=mnt)
            else:
                req = eng.submit(
                    ids, images=patches,
                    embeds_cmp_mask=np.ones((patches.shape[0],), bool),
                    ids_cmp_mask=ids_cmp_mask, patch_positions=patch_pos,
                    max_new_tokens=mnt)
            self._inflight[req.uid] = [req, ev, q, 0]
            self._cv.notify()
        return req, ev

    def _wait(self, req, ev) -> None:
        ev.wait()
        with self._cv:
            if self._engine_error is not None:
                raise RuntimeError("batched engine failed") \
                    from self._engine_error
        if req.error is not None:
            # a failure of this request alone (isolated at admission):
            # the worker's error code 1
            raise ValueError(f"request failed: {req.error}")

    def request(self, input_text: str, image_b64: str,
                max_new_tokens: Optional[int] = None):
        """Serve one comprehension request and return the finished
        ``Request`` (its greedy ids in ``tokens``, its host times)."""
        req, ev = self._submit(
            *self._prepare_comprehension(input_text, image_b64),
            max_new_tokens)
        self._wait(req, ev)
        return req

    def comprehension_ids(self, input_text: str, image_b64: str,
                          max_new_tokens: Optional[int] = None
                          ) -> np.ndarray:
        return np.asarray(self.request(input_text, image_b64,
                                       max_new_tokens).tokens, np.int32)

    def generate_ids(self, ids, max_new_tokens: int) -> np.ndarray:
        """Greedy ids for raw prompt ids through the batched engine (the
        evaluator's path; text-only, so prefix-cacheable)."""
        req, ev = self._submit(np.asarray(ids, np.int32), None, None, None,
                               max_new_tokens)
        self._wait(req, ev)
        return np.asarray(req.tokens, np.int32)

    def comprehension_stream(self, input_text: str, image_b64: str,
                             max_new_tokens: Optional[int] = None):
        """Cumulative text snapshots, one per decode block as the drain
        thread hands out tokens, then a final one equal to
        :meth:`comprehension`'s text."""
        q: "queue.Queue" = queue.Queue()
        req, ev = self._submit(
            *self._prepare_comprehension(input_text, image_b64),
            max_new_tokens, q)
        while True:
            toks = q.get()
            if toks is None:
                break
            yield self._strip_text(np.asarray(toks, np.int32))
        self._wait(req, ev)
        yield self._strip_text(np.asarray(req.tokens, np.int32))

    def _drain_loop(self) -> None:
        eng = self.batch_engine
        while True:
            with self._cv:
                while not self._inflight and not self._closed:
                    self._cv.wait()
                if not self._inflight:
                    return
            try:
                eng.step()
            except BaseException as e:  # noqa: BLE001 — fail every request
                log.exception("batched engine drain loop failed")
                with self._cv:
                    self._engine_error = e
                    for req, ev, q, _ in self._inflight.values():
                        req.done = True
                        if q is not None:
                            q.put(None)
                        ev.set()
                    self._inflight.clear()
                if not isinstance(e, Exception):
                    raise
                return
            with self._cv:
                done = []
                for uid, entry in self._inflight.items():
                    req, ev, q, sent = entry
                    if q is not None and len(req.tokens) > sent \
                            and not req.done:
                        q.put(list(req.tokens))
                        entry[3] = len(req.tokens)
                    if req.done:
                        if q is not None:
                            q.put(None)
                        ev.set()
                        done.append(uid)
                for uid in done:
                    self._inflight.pop(uid)
