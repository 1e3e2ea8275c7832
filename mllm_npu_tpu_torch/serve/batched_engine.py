"""Continuous-batching decode engine (twin of ``ContinuousBatchingEngine``
in ``mllm_npu_tpu/serve/batched_engine.py``).

- A fixed pool of ``num_slots`` decode slots shares one static KV cache
  ``[L, B, max_len, Hkv, D]`` and per-slot state tensors (the reference's
  ``state``: ``key_valid``, ``write_pos``, ``rope_pos``, ``cur_tok``,
  ``active``, ``n_gen``, ``max_gen``), allocated once and only ever
  written in place.
- Prefill runs per request over its prompt padded to a bucket (K1 on the
  GPU), monolithic or in chunks of ``prefill_chunk`` tokens (one chunk a
  tick, through the Llama's multi-token cached step), optionally seeded
  from a prompt-prefix cache; :meth:`_insert` copies its keys and values
  into a free slot.
- A decode block advances every slot ``block_steps`` tokens. Each step
  attends over the row's valid keys (per-row ``cache["pos"]``), writes its
  column at the row's ``write_pos`` in place and marks it valid only for
  rows that were active, so an idle row's garbage never becomes a key.
  Doneness is ``torch.where`` on the device: nothing in the block reads a
  device value on the host. On a CUDA device the block is captured once
  as a ``torch.cuda.CUDAGraph`` (the reference's ``jit`` of the block) and
  each tick is one ``replay()``; ``cuda_graph=False`` runs it eagerly, as
  it always runs on the CPU. A capture that fails raises.
- With ``speculative_k`` = k > 0 a tick is one speculative verify
  instead of a block (:meth:`_spec_tick`, the reference's
  ``_get_spec_decode``): every row proposes k tokens by prompt lookup
  over its own token history (the forced ladder's chain inside the
  ladder), one (k + 1)-wide forward verifies them over the read-only
  cache, and each row keeps its matching prefix and the token after it
  (cut at EOS and its budget), writes the window's columns and marks only
  the kept span valid. A tick emits 1 to k + 1 tokens a row; it too is
  one CUDA graph replay.
- With ``enable_sampling`` each request carries ``do_sample``,
  ``temperature``, ``top_p`` and ``seed`` into per-slot state; sampled and
  greedy rows decode together (``sampler.sample_rows``; a draw depends on
  the request's seed and the token's index only). Under speculation a
  sampled row accepts proposals only at forced ladder positions and
  samples the token after them.
- The static cache may be bf16, fp32 or fp8 (``cache_dtype``).
- :meth:`step` pipelines: tick N + 1 is dispatched before tick N's
  tokens are read from a pinned host buffer that a non-blocking copy
  filled behind an event; the emitted mask says which of them count.

Greedy ids equal the reference engine's and ``MLLMGenerator``'s (the
tests hold them on the CPU), with and without speculation.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from mllm_npu_tpu_torch.models.generation.sampler import (
    _sample, apply_image_ladder, ladder_propose, lookup_proposals,
    sample_rows)
from mllm_npu_tpu_torch.models.language_models.llama import (
    byte_view, init_cache, write_decode_column)
from mllm_npu_tpu_torch.ops import SegmentIds
from mllm_npu_tpu_torch.serve.prefix_cache import PrefixCache

log = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class Request:
    """One request. Images and masks may be numpy arrays: the engine moves
    them to its device at admission, on the thread that drives it."""
    uid: int
    input_ids: np.ndarray                 # [Sp] int32
    images: Optional[object] = None       # [N, H, W, 3]
    embeds_cmp_mask: Optional[object] = None
    ids_cmp_mask: Optional[np.ndarray] = None
    patch_positions: Optional[object] = None
    max_new_tokens: int = 128
    # per-request sampling (the engine needs enable_sampling=True)
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    seed: int = 0
    # filled by the engine (times on the host's perf_counter clock)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ContinuousBatchingEngine:
    """Slot-based continuous batching over a ``GeneralizedMultimodalModel``
    (its Llama and, for image requests, its vision tower and projector),
    on the device the model's parameters live on. Greedy unless
    ``enable_sampling``; speculative with ``speculative_k`` > 0."""

    def __init__(self, model, *, num_slots: int = 8, max_len: int = 1024,
                 block_steps: int = 8, prompt_bucket: int = 128,
                 max_prompt: Optional[int] = None, eos_token_id: int = -1,
                 pad_token_id: int = 0, cache_dtype=torch.bfloat16,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[int] = None, ladder=None,
                 enable_sampling: bool = False, speculative_k: int = 0,
                 speculative_ngram: int = 3, cuda_graph: bool = True):
        self.model = model
        self.lm = model.language_model
        self.cfg = self.lm.config
        self.device = next(model.parameters()).device
        self.ladder = ladder
        self.B = num_slots
        self.max_len = max_len
        self.block_steps = block_steps
        self.prompt_bucket = prompt_bucket
        # cap on a row's bucketed prompt, kept a multiple of the bucket so
        # the chunked prefill tiles every admission bucket
        self.max_prompt = (max_len if max_prompt is None
                           else min(max_prompt, max_len))
        if self.max_prompt >= prompt_bucket:
            self.max_prompt = (self.max_prompt // prompt_bucket
                               ) * prompt_bucket
        self.eos = eos_token_id
        self.pad = pad_token_id
        self.cache_dtype = cache_dtype
        if prefill_chunk is not None and (prefill_chunk % prompt_bucket
                                          and prompt_bucket % prefill_chunk):
            raise ValueError("prefill_chunk must divide (or be a multiple "
                             "of) prompt_bucket so chunks tile the bucketed "
                             "prompt")
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = (PrefixCache(prefix_cache,
                                         granularity=prompt_bucket)
                             if prefix_cache else None)
        if speculative_k < 0:
            raise ValueError(f"speculative_k must be >= 0, got "
                             f"{speculative_k}")
        self.enable_sampling = enable_sampling
        self.speculative_k = speculative_k
        self.speculative_ngram = speculative_ngram
        # tokens a tick may emit per row
        self.per_tick = speculative_k + 1 if speculative_k else block_steps

        dev, B = self.device, num_slots
        with torch.inference_mode():
            cache = init_cache(self.cfg, B, max_len, dtype=cache_dtype,
                               device=dev)
            self.state = {
                "k": cache["k"], "v": cache["v"],
                "key_valid": torch.zeros((B, max_len), dtype=torch.bool,
                                         device=dev),
                "write_pos": torch.full((B,), max_len - 1, dtype=torch.long,
                                        device=dev),
                "rope_pos": torch.zeros((B,), dtype=torch.long, device=dev),
                "cur_tok": torch.full((B,), pad_token_id, dtype=torch.long,
                                      device=dev),
                "active": torch.zeros((B,), dtype=torch.bool, device=dev),
                "n_gen": torch.zeros((B,), dtype=torch.long, device=dev),
                "max_gen": torch.zeros((B,), dtype=torch.long, device=dev),
            }
            if enable_sampling:
                self.state.update({
                    "seed": torch.zeros((B,), dtype=torch.long, device=dev),
                    "temp": torch.ones((B,), device=dev),
                    "top_p": torch.ones((B,), device=dev),
                    "do_sample": torch.zeros((B,), dtype=torch.bool,
                                             device=dev)})
            if speculative_k:
                # each row's token history for the proposals: the prompt's
                # real tokens, then every token emitted; one more column
                # takes the appends of positions not emitted
                self.state["hist"] = torch.full(
                    (B, max_len + speculative_k + 2), pad_token_id,
                    dtype=torch.long, device=dev)
                self.state["hist_len"] = torch.zeros((B,), dtype=torch.long,
                                                     device=dev)
            # a tick's outputs: each position's token and whether it was
            # emitted (the row was active at the step's entry; under
            # speculation, within the row's kept span)
            W = self.per_tick
            self._toks = torch.full((B, W), pad_token_id, dtype=torch.long,
                                    device=dev)
            self._emitted = torch.zeros((B, W), dtype=torch.bool, device=dev)
            self._rows = torch.arange(B, device=dev)
            self._iota_w = torch.arange(W, device=dev)
            self._iota_len = torch.arange(max_len, device=dev)
        # two pinned host copies of the outputs, used in turn: tick N's
        # stays readable while tick N + 1's copy is in flight
        pin = dev.type == "cuda"
        self._host = [(torch.empty((B, self.per_tick), dtype=torch.long,
                                   pin_memory=pin),
                       torch.empty((B, self.per_tick), dtype=torch.bool,
                                   pin_memory=pin)) for _ in range(2)]
        self._flip = 0
        self._slot_req: List[Optional[Request]] = [None] * B
        self._pending: deque[Request] = deque()
        self._uid = 0
        # the block in flight: (its host buffers, its event, the slots)
        self._result = None
        self._prefilling: Optional[dict] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        # one tick: a decode block, or a speculative verify
        self._tick = self._spec_tick if speculative_k else self._decode_block
        self.replays = 0        # graph replays
        self.eager_blocks = 0   # ticks run eagerly, the capture's warm-up too
        # handed-out ticks: (row, tick) pairs that emitted, and their tokens
        self.row_ticks = 0
        self.tokens_emitted = 0
        self.capture_s: Optional[float] = None
        if cuda_graph and dev.type == "cuda":
            self._capture()

    # ------------------------------------------------------------------
    # device pieces
    # ------------------------------------------------------------------

    def _first_token(self, h_last: torch.Tensor, req: Request
                     ) -> torch.Tensor:
        """The first token from the last real position's hidden state
        h_last [1, H], with the ladder applied, greedy or drawn as the
        request asks (its output index 0): a 0-d device tensor."""
        logits = self.lm.logits(h_last).float()
        one = lambda x, dt: torch.full((1,), x, dtype=dt, device=self.device)
        if self.ladder is not None:
            logits = apply_image_ladder(
                logits, one(int(req.input_ids[-1]), torch.long), self.ladder)
        if req.do_sample:
            return sample_rows(logits, one(req.seed, torch.long),
                               one(0, torch.long),
                               one(req.temperature, torch.float32),
                               one(req.top_p, torch.float32),
                               one(True, torch.bool))[0]
        return _sample(logits)[0]

    def _embeds(self, req: Request, bucket: int):
        """The request's prompt padded to ``bucket``, embedded with its
        images scattered in (moved to the device here, on the engine's
        thread) → (embeddings [1, bucket, H], prompt mask [1, bucket])."""
        Sp = len(req.input_ids)
        dev = self.device
        ids = np.full((1, bucket), self.pad, np.int64)
        ids[0, :Sp] = req.input_ids
        pm = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
        pm[0, :Sp] = 1
        icm = None
        if req.ids_cmp_mask is not None:
            icm = torch.zeros((1, bucket), dtype=torch.bool, device=dev)
            icm[0, :Sp] = torch.as_tensor(req.ids_cmp_mask, device=dev)
        as_dev = (lambda x: None if x is None
                  else torch.as_tensor(x, device=dev))
        embeds, _ = self.model.embed_and_scatter(
            torch.as_tensor(ids, device=dev), as_dev(req.images),
            as_dev(req.embeds_cmp_mask), icm, as_dev(req.patch_positions))
        return embeds, pm

    def _prefill(self, req: Request, bucket: int):
        """Monolithic prefill over the bucketed prompt (segment ids from
        the prompt mask, K1 on the GPU) → (first token, k, v) with k/v
        [L, 1, bucket, Hkv, D]."""
        embeds, pm = self._embeds(req, bucket)
        cache = init_cache(self.cfg, 1, bucket, dtype=self.cache_dtype,
                           device=self.device)
        positions = (torch.cumsum(pm, dim=-1) - 1).clamp(min=0)
        h, cache = self.lm(inputs_embeds=embeds, positions=positions,
                           cache=cache, segment_ids=SegmentIds(q=pm, kv=pm),
                           prefill=True)
        Sp = len(req.input_ids)
        first = self._first_token(h[:, Sp - 1], req)
        return first, cache["k"], cache["v"]

    def _insert(self, slot: int, k: torch.Tensor, v: torch.Tensor,
                req: Request, first_tok: torch.Tensor) -> None:
        """A prefilled request into ``slot``: its keys and values copied
        into the static cache at offset 0, its real prompt positions marked
        valid, its counters, sampling settings and token history set; every
        state tensor written in place."""
        st = self.state
        Sp, max_new = len(req.input_ids), req.max_new_tokens
        bucket = k.shape[2]
        byte_view(st["k"])[:, slot, :bucket].copy_(byte_view(k)[:, 0])
        byte_view(st["v"])[:, slot, :bucket].copy_(byte_view(v)[:, 0])
        st["key_valid"][slot].zero_()
        st["key_valid"][slot, :Sp] = True
        st["write_pos"][slot] = bucket
        st["rope_pos"][slot] = Sp
        st["cur_tok"][slot] = first_tok
        if max_new > 1:
            st["active"][slot] = first_tok != self.eos
        else:
            st["active"][slot] = False
        st["n_gen"][slot] = 1
        st["max_gen"][slot] = max_new
        if self.enable_sampling:
            st["seed"][slot] = req.seed
            st["temp"][slot] = req.temperature
            st["top_p"][slot] = req.top_p
            st["do_sample"][slot] = req.do_sample
        if self.speculative_k:
            hist = st["hist"][slot]
            hist.fill_(self.pad)
            hist[:Sp] = torch.as_tensor(req.input_ids, device=self.device)
            hist[Sp] = first_tok
            st["hist_len"][slot] = Sp + 1

    def _decode_block(self) -> None:
        """``block_steps`` steps of every slot, in place over the static
        state; each step's token and emission land in the output buffers.
        No host read of a device value, so it can be captured."""
        st, lm = self.state, self.lm
        key_valid = st["key_valid"]
        am = key_valid[:, None, None, :]          # a view: widens in place
        for i in range(self.block_steps):
            act = st["active"].clone()
            cache = {"k": st["k"], "v": st["v"], "pos": st["write_pos"]}
            h, _ = lm(st["cur_tok"][:, None],
                      positions=st["rope_pos"][:, None], cache=cache,
                      attn_mask=am)
            last = lm.logits(h[:, -1]).float()
            if self.ladder is not None:
                last = apply_image_ladder(last, st["cur_tok"], self.ladder)
            if self.enable_sampling:
                # the token drawn is the row's output index n_gen
                nxt = sample_rows(last, st["seed"], st["n_gen"], st["temp"],
                                  st["top_p"], st["do_sample"])
            else:
                nxt = _sample(last)
            nxt = torch.where(act, nxt, self.pad)
            # the column just written is a key only for rows that were
            # active; an idle row's garbage is never marked valid
            wp = st["write_pos"]
            key_valid[self._rows, wp] = key_valid[self._rows, wp] | act
            step = act.long()
            wp.add_(step)
            st["rope_pos"].add_(step)
            st["n_gen"].add_(step)
            done_now = (nxt == self.eos) | (st["n_gen"] >= st["max_gen"])
            new_active = act & ~done_now
            st["cur_tok"].copy_(torch.where(new_active, nxt, self.pad))
            st["active"].copy_(new_active)
            self._toks[:, i] = nxt
            self._emitted[:, i] = act

    def _verify(self, toks: torch.Tensor, positions: torch.Tensor,
                write_pos: torch.Tensor):
        """The verify forward of a speculative tick: toks [B, W] at RoPE
        ``positions`` over the read-only static cache, row b's window from
        ``write_pos[b]`` → (logits [B, W, V] fp32, k_col, v_col
        [L, B, W, Hkv, D])."""
        st = self.state
        cache = {"k": st["k"], "v": st["v"], "pos": write_pos}
        h, cache = self.lm(toks, positions=positions, cache=cache,
                           attn_mask=st["key_valid"][:, None, None, :])
        return self.lm.logits(h).float(), cache["k_col"], cache["v_col"]

    def _spec_tick(self) -> None:
        """One speculative tick of every slot, in place over the static
        state (the reference's ``_get_spec_decode``): proposals, one
        (k + 1)-wide verify, acceptance, the kept span's keys and history.
        Emitted tokens and their mask land in the output buffers. No host
        read of a device value, so it can be captured."""
        st, k, W = self.state, self.speculative_k, self.speculative_k + 1
        B, iw = self.B, self._iota_w
        act = st["active"].clone()
        wp0 = st["write_pos"].clone()
        n_hist = st["hist"].shape[1] - 1      # the last column is a sink
        props = lookup_proposals(st["hist"][:, :n_hist], st["hist_len"], k,
                                 self.speculative_ngram, self.pad)
        if self.ladder is not None:
            props = ladder_propose(st["cur_tok"], props, self.ladder)
        toks = torch.cat([st["cur_tok"][:, None], props], dim=1)   # [B, W]
        lg, k_col, v_col = self._verify(toks, st["rope_pos"][:, None] + iw,
                                        wp0)
        if self.ladder is not None:
            V = lg.shape[-1]
            lg = apply_image_ladder(lg.reshape(B * W, V), toks.reshape(-1),
                                    self.ladder).reshape(B, W, V)
        g = _sample(lg)                                            # [B, W]
        acc = props == g[:, :k]
        if self.enable_sampling:
            # a sampled row keeps a proposal only where the ladder forced
            # it (its logits one-hot: every draw is that token)
            if self.ladder is not None:
                lad = self.ladder.ids_on(lg.device)[:-1]
                forced = (toks[:, :k, None] == lad).any(dim=-1)
                acc_s = acc & forced
            else:
                acc_s = torch.zeros_like(acc)
            acc = torch.where(st["do_sample"][:, None], acc_s, acc)
        m = torch.cumprod(acc.long(), dim=1).sum(dim=1)             # [B]
        emit = g
        if self.enable_sampling:
            # the first position not kept is drawn (output index n_gen + m)
            samp = sample_rows(lg[self._rows, m], st["seed"], st["n_gen"] + m,
                               st["temp"], st["top_p"], st["do_sample"])
            emit = g.scatter(1, m[:, None], samp[:, None])
        rem = (st["max_gen"] - st["n_gen"]).clamp(min=1)
        e = torch.minimum(m + 1, rem)
        eos_idx = torch.where(emit == self.eos, iw, W).min(dim=1).values
        e = torch.where(act, torch.minimum(e, eos_idx + 1), 0)
        done_now = (eos_idx < e) | (st["n_gen"] + e >= st["max_gen"])
        new_active = act & ~done_now
        emit_mask = (iw < e[:, None]) & act[:, None]
        self._toks.copy_(torch.where(emit_mask, emit, self.pad))
        self._emitted.copy_(emit_mask)
        cur = emit.gather(1, (e - 1).clamp(0, W - 1)[:, None])[:, 0]
        st["cur_tok"].copy_(torch.where(new_active, cur, self.pad))
        # every window column is written (capacity_for leaves the room);
        # only the kept span becomes valid, the rest is overwritten later
        write_decode_column(st["k"], k_col, wp0)
        write_decode_column(st["v"], v_col, wp0)
        il = self._iota_len
        st["key_valid"].logical_or_((il >= wp0[:, None])
                                    & (il < (wp0 + e)[:, None]))
        hl = st["hist_len"]
        idx = torch.where(iw < e[:, None], hl[:, None] + iw, n_hist)
        st["hist"].scatter_(1, idx, emit)
        for name in ("hist_len", "write_pos", "rope_pos", "n_gen"):
            st[name].add_(e)
        st["active"].copy_(new_active)

    def _capture(self) -> None:
        """Warm the tick up once on a side stream (every slot is idle, so
        it changes no valid state), then capture one tick into a CUDA
        graph. Raises if the capture fails; there is no eager fallback."""
        t0 = time.perf_counter()
        dev = self.device
        with torch.inference_mode():
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._tick()
            self.eager_blocks += 1
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._tick()
        torch.cuda.synchronize(dev)
        self._graph = graph
        self.capture_s = time.perf_counter() - t0

    def _dispatch_block(self):
        """Run (replay) one tick and queue the copy of its outputs to the
        next pinned host buffer; → (host buffers, event or None)."""
        if self._graph is not None:
            self._graph.replay()
            self.replays += 1
        else:
            self._tick()
            self.eager_blocks += 1
        host = self._host[self._flip]
        self._flip ^= 1
        host[0].copy_(self._toks, non_blocking=True)
        host[1].copy_(self._emitted, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return host, event

    # ------------------------------------------------------------------
    # host-side engine loop
    # ------------------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        return min(_round_up(prompt_len, self.prompt_bucket),
                   self.max_prompt)

    @property
    def headroom(self) -> int:
        """Cache columns an active row may write past its budget: a block,
        or a verify window of k + 1."""
        if self.speculative_k:
            return max(self.block_steps, self.speculative_k + 1)
        return self.block_steps

    def capacity_for(self, prompt_len: int) -> int:
        """Decode-token budget left in a cache row for a prompt of this
        length after bucketing; <= 0 means it will not fit. The headroom
        keeps an active row's block (or verify window) inside the cache."""
        if prompt_len > self.max_prompt:
            return 0
        return self.max_len - self._bucket(prompt_len) - self.headroom

    def submit(self, input_ids, *, images=None, embeds_cmp_mask=None,
               ids_cmp_mask=None, patch_positions=None,
               max_new_tokens: int = 128, do_sample: bool = False,
               temperature: float = 1.0, top_p: float = 1.0,
               seed: int = 0) -> Request:
        if do_sample and not self.enable_sampling:
            raise ValueError("do_sample request on a greedy engine: build "
                             "the engine with enable_sampling=True")
        Sp = len(input_ids)
        bucket = self._bucket(Sp)
        if Sp > bucket:
            raise ValueError(f"prompt of {Sp} tokens exceeds max_prompt="
                             f"{self.max_prompt}")
        if bucket + max_new_tokens + self.headroom > self.max_len:
            raise ValueError(
                f"request cannot fit in a cache row: bucket {bucket} + "
                f"max_new_tokens {max_new_tokens} + headroom "
                f"{self.headroom} > max_len {self.max_len}")
        self._uid += 1
        req = Request(self._uid, np.asarray(input_ids, np.int32),
                      images=images, embeds_cmp_mask=embeds_cmp_mask,
                      ids_cmp_mask=ids_cmp_mask,
                      patch_positions=patch_positions,
                      max_new_tokens=max_new_tokens, do_sample=do_sample,
                      temperature=temperature, top_p=top_p, seed=seed,
                      submitted_at=time.perf_counter())
        self._pending.append(req)
        return req

    def _fail(self, req: Request, e: Exception) -> None:
        req.error = f"{type(e).__name__}: {e}"
        req.done = True
        req.finished_at = time.perf_counter()

    def _admit(self) -> None:
        # chunked mode: one chunk of the prefill in flight per tick, decode
        # blocks between, so a long prompt stalls the batch by one chunk
        if self._prefilling is not None:
            pf = self._prefilling
            try:
                self._prefill_chunk_step(pf)
            except Exception as e:  # noqa: BLE001 — isolate the request
                log.exception("request %d failed mid-prefill", pf["req"].uid)
                self._fail(pf["req"], e)
                self._prefilling = None
            return
        for slot in range(self.B):
            if self._slot_req[slot] is not None or not self._pending:
                continue
            req = self._pending.popleft()
            try:
                if self.prefill_chunk is not None:
                    self._start_chunked_admission(slot, req)
                    return      # one prefill in flight at a time
                self._admit_one(slot, req)
            except Exception as e:  # noqa: BLE001 — isolate the request
                # a malformed request (bad image shapes) fails alone; the
                # engine and the other slots keep serving
                log.exception("request %d failed at admission", req.uid)
                self._fail(req, e)

    def _effective_chunk(self, bucket: int) -> Optional[int]:
        """The chunk that tiles this bucket (``prefill_chunk`` where it
        divides it, else ``prompt_bucket``), or None when none does."""
        C = (self.prefill_chunk if self.prefill_chunk is not None
             else self.prompt_bucket)
        if bucket % C:
            C = self.prompt_bucket
        if bucket % C:
            return None
        return C

    def stats(self) -> dict:
        s = {"slots_busy": sum(r is not None for r in self._slot_req),
             "pending": len(self._pending)}
        if self.prefix_cache is not None:
            s["prefix_cache"] = self.prefix_cache.stats()
        return s

    def _started(self, slot: int, req: Request,
                 first_tok: torch.Tensor) -> None:
        """Book the first token (the one host read of an admission) and
        give the slot to the request unless it is already done."""
        tok0 = int(first_tok)
        req.tokens.append(tok0)
        req.first_token_at = time.perf_counter()
        if tok0 == self.eos or req.max_new_tokens <= 1:
            req.done = True
            req.finished_at = req.first_token_at
            self._slot_req[slot] = None
        else:
            self._slot_req[slot] = req

    def _admit_one(self, slot: int, req: Request) -> None:
        bucket = self._bucket(len(req.input_ids))
        # prefix-cache hit: only the suffix is computed, through the chunk
        # steps run back to back (one admission tick, as monolithic)
        if self.prefix_cache is not None and req.images is None:
            C = self._effective_chunk(bucket)
            entry = (None if C is None else
                     self.prefix_cache.lookup(req.input_ids, align=C))
            if entry is not None:
                pf = self._make_prefill_state(slot, req, bucket, C, entry)
                while pf["filled"] < pf["bucket"]:
                    self._prefill_chunk_step(pf)
                return
        first_tok, k, v = self._prefill(req, bucket)
        self._insert(slot, k, v, req, first_tok)
        if self.prefix_cache is not None and req.images is None:
            self.prefix_cache.insert(req.input_ids, k, v)
        self._started(slot, req, first_tok)

    def _start_chunked_admission(self, slot: int, req: Request) -> None:
        bucket = self._bucket(len(req.input_ids))
        C = self._effective_chunk(bucket)
        if C is None:
            # no chunk tiles this bucket (max_prompt < prompt_bucket):
            # the monolithic prefill is always right
            self._admit_one(slot, req)
            return
        entry = None
        if self.prefix_cache is not None and req.images is None:
            entry = self.prefix_cache.lookup(req.input_ids, align=C)
        self._prefilling = self._make_prefill_state(slot, req, bucket, C,
                                                    entry)
        self._prefill_chunk_step(self._prefilling)

    def _make_prefill_state(self, slot: int, req: Request, bucket: int,
                            C: int, entry=None) -> dict:
        """A chunked prefill's state; a prefix-cache ``entry`` seeds its
        cache, and the chunks start at the cached length."""
        embeds, _ = self._embeds(req, bucket)
        cache = init_cache(self.cfg, 1, bucket, dtype=self.cache_dtype,
                           device=self.device)
        filled = 0
        if entry is not None:
            plen = len(entry.tokens)
            if plen % C or plen >= bucket:
                raise RuntimeError(f"prefix of {plen} tokens does not tile "
                                   f"chunks of {C} in a bucket of {bucket}")
            byte_view(cache["k"])[:, :, :plen] = byte_view(entry.k)
            byte_view(cache["v"])[:, :, :plen] = byte_view(entry.v)
            filled = plen
        return {"req": req, "slot": slot, "embeds": embeds,
                "pk": cache["k"], "pv": cache["v"], "filled": filled,
                "bucket": bucket, "chunk": C, "Sp": len(req.input_ids)}

    def _prefill_chunk_step(self, pf: dict) -> None:
        req, C, off, Sp = pf["req"], pf["chunk"], pf["filled"], pf["Sp"]
        positions = (off + torch.arange(C, device=self.device))[None]
        cache = {"k": pf["pk"], "v": pf["pv"], "pos": off}
        h, _ = self.lm(inputs_embeds=pf["embeds"][:, off:off + C],
                       positions=positions, cache=cache)
        if off <= Sp - 1 < off + C:
            # this chunk holds the prompt's last real token: keep its
            # hidden state (the final chunk may be all padding)
            pf["h_last"] = h[:, Sp - 1 - off]
        pf["filled"] = off + C
        if pf["filled"] < pf["bucket"]:
            return
        first_tok = self._first_token(pf["h_last"], req)
        self._insert(pf["slot"], pf["pk"], pf["pv"], req, first_tok)
        if self.prefix_cache is not None and req.images is None:
            self.prefix_cache.insert(req.input_ids, pf["pk"], pf["pv"])
        self._prefilling = None
        self._started(pf["slot"], req, first_tok)

    def _decode_would_emit(self) -> bool:
        """True iff the next tick could emit a real token for some slot.
        The host's token counts lag the tick in flight, so a request in
        that tick's snapshot gets a ``per_tick`` discount; this skips the
        trailing tick of idle slots the pipeline would otherwise run."""
        inflight = set()
        if self._result is not None:
            inflight = {id(r) for r in self._result[2] if r is not None}
        for r in self._slot_req:
            if r is None:
                continue
            remaining = r.max_new_tokens - len(r.tokens)
            if id(r) in inflight:
                remaining -= self.per_tick
            if remaining > 0:
                return True
        return False

    @torch.inference_mode()
    def step(self) -> bool:
        """One tick, pipelined: admit pending requests, dispatch the next
        decode block, then hand out the PREVIOUS block's tokens (read after
        its event, while this block runs). Slot bookkeeping uses the
        slot → request snapshot taken when each block was dispatched; the
        ``is req`` guard keeps a stale snapshot from freeing a slot that
        was given to a new request. Returns True while work remains."""
        self._admit()
        result = None
        if self._decode_would_emit():
            host, event = self._dispatch_block()
            result = (host, event, list(self._slot_req))
        prev, self._result = self._result, result
        if prev is not None:
            (toks, emitted), event, slots = prev
            if event is not None:
                event.synchronize()
            toks, emitted = toks.numpy(), emitted.numpy()
            now = time.perf_counter()
            for slot, req in enumerate(slots):
                if req is None or req.done:
                    continue
                finished = False
                n = int(emitted[slot].sum())
                self.row_ticks += n > 0
                self.tokens_emitted += n
                for t, m in zip(toks[slot], emitted[slot]):
                    if m:
                        req.tokens.append(int(t))
                        finished |= int(t) == self.eos
                if finished or len(req.tokens) >= req.max_new_tokens:
                    req.done = True
                    req.finished_at = now
                    if self._slot_req[slot] is req:
                        self._slot_req[slot] = None
        return (bool(self._pending)
                or any(r is not None for r in self._slot_req)
                or self._result is not None
                or self._prefilling is not None)

    def run_until_idle(self, max_ticks: int = 10_000) -> None:
        ticks = 0
        while self.step():
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("engine did not drain")
