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
each window to the image-generation features. Eager PyTorch takes the
place of ``jit``.
The Llama's weights may be served in int8 or int4 (``quantize_int8`` /
``quantize_int4``, K4 / K5 on the GPU), with fused q/k/v and gate/up
products (``fuse_projections``); the KV cache in bf16, fp32 or fp8
(``cache_dtype``). The reference's ``unroll_layers`` needs no port, as the
port's layers are already a Python loop.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from mllm_npu_tpu_torch.models.generation.sampler import (
    ImageTokenLadder, SamplingConfig, apply_image_ladder, decode_loop,
    extract_img_windows, pick, row_seeds, speculative_decode_loop)
from mllm_npu_tpu_torch.models.language_models.llama import init_cache
from mllm_npu_tpu_torch.ops import SegmentIds
from mllm_npu_tpu_torch.utils.weights import (fuse_llama_projections_,
                                              merge_lora_, quantize_llama_)

CACHE_DTYPE = torch.bfloat16


class MLLMGenerator:
    """Generation for one ``GeneralizedMultimodalModel`` or ``SEED``.

    Every fp32 parameter is stored in bf16 (the modules still compute in
    their own dtype), as the reference's serving default, and the KV cache
    is ``cache_dtype`` (bf16 by default). ``quantize_int8`` /
    ``quantize_int4`` serve the Llama's projections and ``lm_head`` in
    int8 / int4. The model is changed in place, in the reference's order
    (``generate.py:71-113``): LoRA adapters are merged in their dtype (fp32
    where loaded so) when ``merge_lora``, ``fuse_projections`` or a
    quantization asks for it, then q/k/v and gate/up are fused, then the
    fp32 parameters are cast to bf16, then the Llama is quantized from
    those bf16 values. The scales are fp32 buffers, which the cast does not
    reach. ``speculative_k`` > 0 decodes a single greedy row by
    prompt-lookup speculation (``speculative_ngram``-grams), the cache
    given k of headroom; sampled calls and batches decode one token a
    step.
    ``last_timings`` holds the wall times of the last call, each ending in
    a device synchronisation: the embedding (vision tower, projector and
    scatter), the prefill with the first token, their sum (time to first
    token) and the decode loop.
    """

    def __init__(self, model, *, sampling: SamplingConfig = SamplingConfig(),
                 ladder: Optional[ImageTokenLadder] = None,
                 quantize_int8: bool = False, quantize_int4: bool = False,
                 merge_lora: bool = False, fuse_projections: bool = False,
                 cache_dtype: torch.dtype = CACHE_DTYPE,
                 speculative_k: int = 0, speculative_ngram: int = 3):
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
        self.last_timings: dict = {}

    @torch.inference_mode()
    def generate(self, input_ids, *, prompt_mask=None, images=None,
                 embeds_cmp_mask=None, ids_cmp_mask=None,
                 patch_positions=None,
                 sampling: Optional[SamplingConfig] = None,
                 seed: int = 0, num_img_gen_tokens: int = 64,
                 max_gen_imgs: int = 4) -> dict:
        """input_ids [B, Sp] (right-padded when ``prompt_mask`` is given);
        returns {"generate_ids": [B, T], "hidden_states": [B, T, D]} (T =
        ``max_new_tokens``; column t the hidden state token t was chosen
        from) and, with a ladder, the image windows of each row
        (``sampler.extract_img_windows`` over its first ``max_gen_imgs``
        ``</img>``, ``num_img_gen_tokens`` hidden states each, at most T):
        "img_windows" [B, max_gen_imgs, n, D], "img_valid" [B,
        max_gen_imgs] and "text_mask" [B, T]. ``sampling`` overrides the
        generator's config for this call; a sampled row b draws from
        (``seed``, b) (``sampler.row_seeds``)."""
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

        def step(tok, cache):
            pos_t = (row_len + (cache["pos"] - Sp))[:, None]
            h, cache = lm(tok, positions=pos_t, cache=cache,
                          attn_mask=decode_am)
            return lm.logits(h[:, -1]).float(), h[:, -1], cache

        def step_multi(toks, cache):
            # k + 1 positions from the row's next one; the cache's keys
            # past the accepted ones are masked by the filled length
            pos_t = (row_len[:, None] + (cache["pos"] - Sp)
                     + torch.arange(toks.shape[1], device=dev))
            h, cache = lm(toks, positions=pos_t, cache=cache,
                          attn_mask=decode_am)
            return lm.logits(h).float(), h, cache

        if spec_k:
            tokens, hiddens, _, steps = speculative_decode_loop(
                step_multi, cache, first_token, first_hidden, cfg, input_ids,
                ladder=self.ladder, k=spec_k, ngram=self.speculative_ngram,
                prompt_len=int(row_len[0]))
        else:
            tokens, hiddens, _, steps = decode_loop(
                step, cache, first_token, first_hidden, cfg,
                ladder=self.ladder, seeds=seeds)
        sync()
        t2 = time.perf_counter()
        # decode_steps: the model calls of the decode (verify forwards
        # when speculating)
        self.last_timings = {"embed_s": t_embed - t0,
                             "prefill_s": t1 - t_embed, "ttft_s": t1 - t0,
                             "decode_s": t2 - t1, "decode_steps": steps,
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
