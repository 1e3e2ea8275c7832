"""End-to-end generation for the multimodal assemblies (twin of
``MLLMGenerator.generate`` and ``generate_with_projection``,
``mllm_npu_tpu/models/generation/generate.py:50-346``).

One call: embed the prompt and scatter the image tokens; a causal prefill
over the right-padded prompt with segment ids from ``prompt_mask`` (K1 on
the GPU) that fills the KV cache; the first token from the last real
position's logits; then a read-only-cache decode with the image ladder,
greedy or sampled (``SamplingConfig.do_sample``), or, for one greedy row
with ``speculative_k``, prompt-lookup speculation (k proposals verified
in one multi-token forward). Each emitted token's hidden state is kept;
with a ladder the image windows are cut from them, and for SEED
(:meth:`MLLMGenerator.generate_with_projection`) the output projector maps
each window to the image-generation features. The one-token decode step
(the Llama forward, the ladder, the choice of the token) is one function
over static device state (:class:`DecodeStep`); on the GPU it is captured
as a CUDA graph once per static shape and replayed per token, the twin of
the reference's one jitted ``lax.while_loop`` per bucket, and the cache
length is rounded up to a multiple of ``CACHE_BUCKET`` there, so prompts
of nearby lengths share a graph. The prefill, the speculative verify and
everything on the CPU run eagerly.
The Llama's weights may be served in int8 or int4 (``quantize_int8`` /
``quantize_int4``, K4 / K5 on the GPU), with fused q/k/v and gate/up
products (``fuse_projections``); the KV cache in bf16, fp32 or fp8
(``cache_dtype``). The reference's ``unroll_layers`` needs no port, as the
port's layers are already a Python loop.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

import torch

from mllm_npu_tpu_torch.models.generation.sampler import (
    ImageTokenLadder, SamplingConfig, _sample, apply_image_ladder,
    extract_img_windows, pick, row_seeds, sample_rows,
    speculative_decode_loop)
from mllm_npu_tpu_torch.models.language_models.llama import init_cache
from mllm_npu_tpu_torch.ops import SegmentIds
from mllm_npu_tpu_torch.utils.weights import (fuse_llama_projections_,
                                              merge_lora_, quantize_llama_)

CACHE_DTYPE = torch.bfloat16
# on the GPU the cache length rounds up to a multiple of this, so one
# captured decode step serves every prompt length in the bucket
CACHE_BUCKET = 128
# the captured decode steps a generator keeps (their static caches,
# outputs and graph pools) may hold this share of the card's memory; the
# least recently used are dropped first
DECODE_GRAPH_MEMORY_SHARE = 1 / 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class DecodeStep:
    """The one-token decode step of :meth:`MLLMGenerator.generate` over
    static device state (the twin of the reference's ``decode_loop``),
    run eagerly, or on the GPU captured once as a CUDA graph and replayed
    per token (the reference's one jitted ``lax.while_loop`` per bucket).

    Holds the KV cache [L, B, max_len, Hkv, D] (the prefill writes into
    it) and the step's state as device tensors: the current token, the
    cache's filled length ``pos`` and the rope position per row, the
    output index ``t``, the decode mask, the rows' seeds, ``done``, the pad
    and EOS ids, with sampling each row's temperature and top-p, and the
    outputs ``tokens`` [B, max_len] and ``hiddens`` [B, max_len, D]. A step
    runs the Llama over the current token (the cache read-only, its column
    written in place at ``pos``), the ladder, greedy or sampled choice
    (``sample_rows`` at output index ``t``), pads finished rows, writes
    column ``t`` of both outputs and advances ``pos``, the rope positions
    and ``t``. A graph bakes in only the static shape (batch, cache length,
    greedy or sampled, cache dtype): every other value of a call is copied
    into the buffers by :meth:`run`."""

    def __init__(self, lm, *, batch: int, max_len: int, do_sample: bool,
                 ladder, cache_dtype, hidden_dim: int, hidden_dtype,
                 device):
        self.lm = lm
        self.do_sample = do_sample
        self.ladder = ladder
        B = batch
        self.cache = init_cache(lm.config, B, max_len, dtype=cache_dtype,
                                device=device)
        z = lambda *shape, dt=torch.long: torch.zeros(shape, dtype=dt,
                                                      device=device)
        self.tok, self.pos, self.rope_pos, self.seeds = z(B), z(B), z(B), z(B)
        self.t, self.pad, self.eos = z(1), z(), z()
        self.done = z(B, dt=torch.bool)
        self.am = z(B, 1, 1, max_len, dt=torch.bool)
        self.tokens = z(B, max_len)
        self.hiddens = z(B, max_len, hidden_dim, dt=hidden_dtype)
        if do_sample:
            self.temp = z(B, dt=torch.float32)
            self.top_p = z(B, dt=torch.float32)
            self.sample = torch.ones((B,), dtype=torch.bool, device=device)
        # device bytes held: the static buffers, and the graph's pool once
        # captured
        self.nbytes = sum(x.numel() * x.element_size() for x in (
            self.cache["k"], self.cache["v"], self.tokens, self.hiddens,
            self.am))
        self._graph = None

    def _step(self) -> None:
        lm = self.lm
        cache = {"k": self.cache["k"], "v": self.cache["v"],
                 "pos": self.pos}
        h, _ = lm(self.tok[:, None], positions=self.rope_pos[:, None],
                  cache=cache, attn_mask=self.am)
        hid = h[:, -1]
        logits = lm.logits(hid).float()
        if self.ladder is not None:
            logits = apply_image_ladder(logits, self.tok, self.ladder)
        if self.do_sample:
            nxt = sample_rows(logits, self.seeds,
                              self.t.expand(self.tok.shape[0]), self.temp,
                              self.top_p, self.sample)
        else:
            nxt = _sample(logits)
        nxt = torch.where(self.done, self.pad, nxt)
        self.tokens.index_copy_(1, self.t, nxt[:, None])
        self.hiddens.index_copy_(1, self.t, hid[:, None])
        self.done.logical_or_(nxt == self.eos)
        self.tok.copy_(nxt)
        for x in (self.pos, self.rope_pos, self.t):
            x.add_(1)

    def capture(self) -> None:
        """Run the step once on a side stream (a real step of the call,
        which also warms its kernels up), then capture it; the captured
        graph has not run yet. Raises if the capture fails; there is no
        eager fallback."""
        dev = self.tok.device
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        reserved = torch.cuda.memory_reserved(dev)
        # thread_local: the batched worker's drain thread may be running
        # its own (uncaptured) work on the card meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._step()
        torch.cuda.synchronize(dev)
        self.nbytes += max(torch.cuda.memory_reserved(dev) - reserved, 0)
        self._graph = graph

    def run(self, cfg: SamplingConfig, first_token, first_hidden, rope_pos,
            prompt_len: int, decode_am, seeds, *, graphed: bool):
        """The decode under ``cfg`` after a prefill of ``prompt_len``
        columns into :attr:`cache`. Returns (tokens [B, T], hiddens [B, T,
        D], stats), T = ``cfg.max_new_tokens``: the
        first token and its hidden state (``first_hidden`` [B, D], the
        prompt's last position) from the prefill, then one of each per step
        until every row has emitted EOS; a row pads with ``pad_token_id``
        after its EOS, and steps after all rows are done are not run (their
        columns stay 0, as in the reference). Column t of the hiddens is
        the hidden state token t was chosen from. ``graphed``: the first
        step of the first call captures the graph (:meth:`capture`), every
        later step is a replay; each step reads ``done`` on the host once,
        as the eager loop. ``stats``: the steps run, of them the replays,
        whether this call captured, and the capture's wall time (its first
        step included)."""
        T = cfg.max_new_tokens
        self.tokens.zero_()
        self.hiddens.zero_()
        self.tokens[:, 0] = first_token
        self.hiddens[:, 0] = first_hidden
        self.tok.copy_(first_token)
        self.pad.fill_(cfg.pad_token_id)
        self.eos.fill_(cfg.eos_token_id)
        self.done.copy_(first_token == cfg.eos_token_id)
        self.pos.fill_(prompt_len)
        self.rope_pos.copy_(rope_pos)
        self.t.fill_(1)
        self.am.copy_(decode_am)
        self.seeds.copy_(seeds)
        if self.do_sample:
            self.temp.fill_(cfg.temperature)
            self.top_p.fill_(cfg.top_p)
        t, replays, capture_s = 1, 0, None
        while t < T and not bool(self.done.all()):
            if not graphed:
                self._step()
            elif self._graph is None:
                t0 = time.perf_counter()
                self.capture()
                capture_s = time.perf_counter() - t0
            else:
                self._graph.replay()
                replays += 1
            t += 1
        stats = {"decode_steps": t - 1, "graph_replays": replays,
                 "graph_captured": capture_s is not None,
                 "capture_s": capture_s or 0.0}
        return (self.tokens[:, :T].clone(), self.hiddens[:, :T].clone(),
                stats)


class MLLMGenerator:
    """Generation for one ``GeneralizedMultimodalModel`` or ``SEED``.

    With ``cast_params_bf16`` every fp32 parameter is stored in bf16 (the
    modules still compute in their own dtype), as the reference's serving
    engines do; the generator's own default keeps the parameters as they
    are, as the reference's ``MLLMGenerator`` does (``generate.py:62``), so
    a model built in fp32 is served in fp32 (K1 f32, and K4 f32 / K5 f32
    when quantized, on the GPU). The KV cache is ``cache_dtype`` (bf16 by
    default). ``quantize_int8`` / ``quantize_int4`` serve the Llama's
    projections and ``lm_head`` in int8 / int4. The model is changed in
    place, in the reference's order (``generate.py:71-113``): LoRA adapters
    are merged in their dtype (fp32 where loaded so) when ``merge_lora``,
    ``fuse_projections`` or a quantization asks for it, then q/k/v and
    gate/up are fused, then (with ``cast_params_bf16``) the fp32 parameters
    are cast to bf16, then the Llama is quantized from those values. The
    scales are fp32 buffers, which the cast does not reach.
    ``speculative_k`` > 0 decodes a single greedy row by prompt-lookup
    speculation (``speculative_ngram``-grams), the cache given k of
    headroom; sampled calls and batches decode one token a
    step (:class:`DecodeStep`). On the GPU that step is a replayed CUDA
    graph unless ``cuda_graph`` is False: one per (batch, cache bucket,
    greedy or sampled, cache dtype), kept while the kept graphs hold at
    most ``DECODE_GRAPH_MEMORY_SHARE`` of the card (least recently used
    dropped first), all dropped when the Llama's weights are swapped in
    place. ``last_timings`` holds the wall times of the last call, each
    ending in a device synchronisation: the embedding (vision tower,
    projector and scatter), the prefill with the first token, their sum
    (time to first token) and the decode loop; and the decode's steps, of
    them the replays, and whether the call captured a graph and how long
    that took (its first decode step, which then runs twice: once for real
    on a side stream, once recorded; inside the decode's time, after the
    first token).
    """

    def __init__(self, model, *, sampling: SamplingConfig = SamplingConfig(),
                 ladder: Optional[ImageTokenLadder] = None,
                 quantize_int8: bool = False, quantize_int4: bool = False,
                 merge_lora: bool = False, fuse_projections: bool = False,
                 cache_dtype: torch.dtype = CACHE_DTYPE,
                 cast_params_bf16: bool = False,
                 speculative_k: int = 0, speculative_ngram: int = 3,
                 cuda_graph: bool = True):
        if quantize_int8 and quantize_int4:
            raise ValueError("pick one of quantize_int8 / quantize_int4")
        if speculative_k < 0:
            raise ValueError(f"speculative_k must be >= 0, got "
                             f"{speculative_k}")
        lm = model.language_model
        if lm.config.lora_rank > 0 and (merge_lora or fuse_projections
                                        or quantize_int8 or quantize_int4):
            merge_lora_(lm)
        if fuse_projections:
            fuse_llama_projections_(lm)
        if cast_params_bf16:
            for p in model.parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(torch.bfloat16)
        if quantize_int8 or quantize_int4:
            quantize_llama_(lm, bits=4 if quantize_int4 else 8,
                            group_size=lm.config.quant_group_size)
        self.model = model
        self.lm_config = model.language_model.config
        self.sampling = sampling
        self.ladder = ladder
        self.cache_dtype = cache_dtype
        self.speculative_k = speculative_k
        self.speculative_ngram = speculative_ngram
        self.cuda_graph = cuda_graph
        self._graphs: dict = {}
        self._graph_weights = None
        self._graph_lock = threading.Lock()
        self.last_timings: dict = {}

    def _decode_graph(self, key, **kw) -> DecodeStep:
        """The captured step for ``key``, built on first use after
        dropping the least recently used ones while the kept ones and its
        cache would exceed ``DECODE_GRAPH_MEMORY_SHARE`` of the card. A
        graph reads the Llama's weights at the addresses it was captured
        with, so when the weights are no longer those tensors (the serving
        transforms of ``utils/weights.py`` swap them in place) every graph
        is dropped."""
        lm = self.model.language_model
        weights = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                        for t in itertools.chain(lm.parameters(),
                                                 lm.buffers()))
        if weights != self._graph_weights:
            self._graphs.clear()
            self._graph_weights = weights
        dg = self._graphs.pop(key, None)
        if dg is None:
            B, max_len = key[:2]
            c = self.lm_config
            size = lambda dt: torch.empty((), dtype=dt).element_size()
            # its cache, and its hidden states in the Llama's compute dtype
            # (fp32 when served in fp32)
            need = B * max_len * (
                2 * c.num_hidden_layers * c.num_key_value_heads * c.head_dim
                * size(self.cache_dtype)
                + c.hidden_size * size(kw["hidden_dtype"]))
            budget = (DECODE_GRAPH_MEMORY_SHARE * torch.cuda
                      .get_device_properties(kw["device"]).total_memory)
            while self._graphs and need + sum(
                    g.nbytes for g in self._graphs.values()) > budget:
                self._graphs.pop(next(iter(self._graphs)))
            dg = DecodeStep(lm, **kw)
        self._graphs[key] = dg
        return dg

    def drop_graphs(self) -> None:
        """Free every captured decode step (its cache and graph pool)."""
        with self._graph_lock:
            self._graphs.clear()

    @torch.inference_mode()
    def generate(self, input_ids, **kw) -> dict:
        """input_ids [B, Sp] (right-padded when ``prompt_mask`` is given);
        returns {"generate_ids": [B, T], "hidden_states": [B, T, D]} (T =
        ``max_new_tokens``; column t the hidden state token t was chosen
        from) and, with a ladder, the image windows of each row
        (``sampler.extract_img_windows`` over its first ``max_gen_imgs``
        ``</img>``, ``num_img_gen_tokens`` hidden states each, at most T):
        "img_windows" [B, max_gen_imgs, n, D], "img_valid" [B,
        max_gen_imgs] and "text_mask" [B, T]. ``sampling`` overrides the
        generator's config for this call; a sampled row b draws from
        (``seed``, b) (``sampler.row_seeds``). The keywords are
        ``_generate``'s. Calls that decode through a captured graph run
        one at a time: they share its static buffers (a serve worker calls
        from several threads)."""
        if input_ids.is_cuda and self.cuda_graph:
            with self._graph_lock:
                return self._generate(input_ids, **kw)
        return self._generate(input_ids, **kw)

    def _generate(self, input_ids, *, prompt_mask=None, images=None,
                  embeds_cmp_mask=None, ids_cmp_mask=None,
                  patch_positions=None,
                  sampling: Optional[SamplingConfig] = None,
                  seed: int = 0, num_img_gen_tokens: int = 64,
                  max_gen_imgs: int = 4) -> dict:
        model = self.model
        cfg = self.sampling if sampling is None else sampling
        lm = model.language_model
        if input_ids.ndim == 1:
            input_ids = input_ids[None]
        B, Sp = input_ids.shape
        dev = input_ids.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        inputs_embeds, _ = model.embed_and_scatter(
            input_ids, images, embeds_cmp_mask, ids_cmp_mask,
            patch_positions)
        sync()
        t_embed = time.perf_counter()
        spec_k = 0 if cfg.do_sample or B != 1 else self.speculative_k
        max_len = Sp + cfg.max_new_tokens + spec_k
        if dev.type == "cuda":
            # graphed or eager, the same static shape
            max_len = _round_up(max_len, CACHE_BUCKET)
        graphed = dev.type == "cuda" and self.cuda_graph
        dstep = None
        if not spec_k:
            kw = dict(batch=B, max_len=max_len, do_sample=cfg.do_sample,
                      ladder=self.ladder, cache_dtype=self.cache_dtype,
                      hidden_dim=self.lm_config.hidden_size,
                      hidden_dtype=lm.model.dtype, device=dev)
            dstep = (self._decode_graph(
                (B, max_len, cfg.do_sample, self.cache_dtype), **kw)
                if graphed else DecodeStep(lm, **kw))
            cache = {"k": dstep.cache["k"], "v": dstep.cache["v"], "pos": 0}
        else:
            cache = init_cache(self.lm_config, B, max_len,
                               dtype=self.cache_dtype, device=dev)
        pm = (torch.ones((B, Sp), dtype=torch.int32, device=dev)
              if prompt_mask is None else prompt_mask.to(torch.int32))
        row_len = pm.sum(dim=-1)                                   # [B]
        positions = (torch.cumsum(pm, dim=-1) - 1).clamp(min=0)
        hidden, cache = lm(inputs_embeds=inputs_embeds, positions=positions,
                           cache=cache, segment_ids=SegmentIds(q=pm, kv=pm),
                           prefill=True)
        idx_last = (row_len - 1).long()
        rows = torch.arange(B, device=dev)
        first_hidden = hidden[rows, idx_last]
        last_logits = lm.logits(first_hidden).float()
        if self.ladder is not None:
            last_logits = apply_image_ladder(
                last_logits, input_ids[rows, idx_last], self.ladder)
        seeds = row_seeds(seed, B, dev)
        first_token = pick(last_logits, cfg, seeds, 0)

        # keys valid over the whole cache: the real prompt tokens and
        # everything decoded after position Sp
        base_valid = torch.cat(
            [pm.bool(), torch.ones((B, max_len - Sp), dtype=torch.bool,
                                   device=dev)], dim=1)
        decode_am = base_valid[:, None, None, :]
        sync()
        t1 = time.perf_counter()

        def step_multi(toks, cache):
            # k + 1 positions from the row's next one; the cache's keys
            # past the accepted ones are masked by the filled length
            pos_t = (row_len[:, None] + (cache["pos"] - Sp)
                     + torch.arange(toks.shape[1], device=dev))
            h, cache = lm(toks, positions=pos_t, cache=cache,
                          attn_mask=decode_am)
            return lm.logits(h).float(), h, cache

        if dstep is not None:
            tokens, hiddens, stats = dstep.run(
                cfg, first_token, first_hidden, row_len, Sp, decode_am,
                seeds, graphed=graphed)
        else:
            tokens, hiddens, _, steps = speculative_decode_loop(
                step_multi, cache, first_token, first_hidden, cfg, input_ids,
                ladder=self.ladder, k=spec_k, ngram=self.speculative_ngram,
                prompt_len=int(row_len[0]))
            stats = {"decode_steps": steps, "graph_replays": 0,
                     "graph_captured": False, "capture_s": 0.0}
        sync()
        t2 = time.perf_counter()
        # decode_steps: the model calls of the decode (verify forwards
        # when speculating); decode_s includes capture_s
        self.last_timings = {"embed_s": t_embed - t0,
                             "prefill_s": t1 - t_embed, "ttft_s": t1 - t0,
                             "decode_s": t2 - t1, **stats,
                             "speculative_k": spec_k}
        out = {"generate_ids": tokens, "hidden_states": hiddens}
        if self.ladder is not None:
            # a window can never exceed the decode budget
            n = min(num_img_gen_tokens, cfg.max_new_tokens)
            cut = [extract_img_windows(tokens[b], hiddens[b], self.ladder.eoi,
                                       n, max_gen_imgs, self.ladder.boi)
                   for b in range(B)]
            out["img_windows"], out["img_valid"], out["text_mask"] = (
                torch.stack(x) for x in zip(*cut))
        return out

    @torch.inference_mode()
    def generate_with_projection(self, input_ids, tokenizer=None,
                                 **kw) -> dict:
        """The SEED path: :meth:`generate` (``kw`` are its keywords), then
        every valid image window through the model's output projector, in
        one call. Returns the reference's dict: "generate_ids" and, with a
        ladder, "has_img_output", "num_gen_imgs" and "img_gen_feat" ([n,
        num_img_gen_tokens, D_out] in row-major (row, image) order, or
        None), and with ``tokenizer`` the first row's "text": its ids
        outside the image windows, cut at EOS and without padding."""
        out = self.generate(input_ids, **kw)
        result = {"generate_ids": out["generate_ids"]}
        if "img_windows" in out:
            valid = out["img_valid"]
            n = int(valid.sum())
            result["has_img_output"] = n > 0
            result["num_gen_imgs"] = n
            result["img_gen_feat"] = (
                self.model.output_projector(out["img_windows"][valid])
                if n else None)
        if tokenizer is not None:
            ids = out["generate_ids"][0]
            keep = ids != self.sampling.pad_token_id
            if "text_mask" in out:
                keep &= out["text_mask"][0]
            eos = (ids == self.sampling.eos_token_id).nonzero()
            if self.sampling.eos_token_id >= 0 and len(eos):
                keep[int(eos[0, 0]):] = False
            result["text"] = tokenizer.decode(
                ids[keep].cpu().numpy(), skip_special_tokens=False)
        return result
