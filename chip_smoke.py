#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports only the port
(``mllm_npu_tpu_torch``), never JAX or the JAX package, and any failure
exits non-zero. Phases, in order:

1. header: the card (``nvidia-smi`` name and power limit) and the build of
   every kernel of the paths from ``mllm_npu_tpu_torch/csrc`` with
   ``nvcc``, one process per source, all started together: K1
   (``flash_fwd.cu``), K2 and K3 (``flash_bwd.cu``), K4 and K5
   (``quant_matmul.cu``);
2. the full-width model: the port's ``mllm_llama3_8b_siglip_vit.yaml``
   (Llama-3-8B with r32 LoRA, SigLIP-so400m, attention resampler), bf16,
   weights drawn from a seed, ``FakeTokenizer`` at vocab 128587;
3. K1 (flash forward) against its plain PyTorch version on the card at
   the path's own shapes (the batched worker's padded bucket, S = 384,
   among them), with times of the kernel, the plain version,
   ``scaled_dot_product_attention`` as a yardstick (with the dense mask,
   and where every segment id is 1 also ``is_causal`` alone: the faster
   counts), the bound, TFLOP/s and the share of the bound, and at
   SEED-X's shapes from its YAML (Qwen-ViT-G's D = 104 over 1024 patches,
   its attention pool, the input projector's D = 160, the output
   projector, the Llama-2-13B MHA prefill at the image request's and the
   caption's lengths), and at the SDXL UNet's at 1024² (phase 11: the
   CFG batch of 2, D = 64, self-attention at S = 4096 over 10 heads and
   1024 over 20, cross-attention over the resampler's 64 tokens at both);
   a sweep over the edges of K1's design (head dims 8 to 160, lengths off
   the tile, causal Sq != Sk, GQA, segments inside a tile, fused strided
   q/k/v);
   then K4 (int8) and K5 (int4) against theirs at the Llama's decode
   (M = 1) and prefill (M = 339) shapes and at the batched worker's: its
   decode block (M = 8, the lm_head included), its image admissions
   (M = 384) and its text admissions and prefill chunks (M = 128 and 512),
   every projection shape, the speculative verify windows (M = 40 and 5)
   and the fused products (N = 6144 and 28672 at M = 1, 5, 8, 40, 512),
   and at the Llama-2-13B's (K, N) pairs at M = 1, 8 and the prefill's,
   with ``F.linear`` on the weight dequantized to bf16 as the yardstick;
4. the bf16 path: ``InferenceEngine.comprehension`` on an 896×896 image
   (2×2 grid + thumbnail), a 384×1152 image and a text-only question,
   with every kernel's launch count set to 0 before and asserted after
   each request; the decode step is a replayed CUDA graph, and the three
   requests run again with it eager: identical ids, ms/token of both;
   then the generator's graphs dropped and the three requests twice in
   interleaved order: the graph cache's hits, TTFT and capture times;
4b. the batched worker over the same model (``BatchedInferenceEngine``,
   the reference worker's defaults: 8 slots, a 2048-token static cache,
   prompts to 1024 in buckets of 128, decode blocks of 16 steps captured
   as one CUDA graph) served by the port's ``ModelWorker`` on 127.0.0.1
   (port 0, ``--no-register``, 16 concurrent generations): 16 concurrent
   POSTs (8 images of 896×896, 4 of 384×1152, 4 text questions, one of
   them streamed, 32 new tokens each) with every reply's error code, K1's
   launches per admission, two of them served again alone (identical ids)
   and the streamed text checked; then, the worker stopped, 8 requests of
   64 tokens with every slot busy through the graphed engine and an
   eager twin (identical ids; ms per decode tick, aggregate tokens/s);
   four of the burst's requests alone through the eager twin (the
   burst's ids) with the logits of each choice recorded, against the
   single-request engine by the logit rule: up to the first divergence
   both rows within twice the control, the same request's prefill logits
   with K1 against K1's fp32 plain version; a ``--prefill-chunk 128
   --prefix-cache 4`` engine on four text requests sharing a 512-word
   preamble (hits and tokens saved), its eager twin's rows against the
   monolithic engine's and the single-request engine's by the same rule;
   one graphed tick under ``torch.profiler``, and ``decode_attention``'s
   cost per tick over the cache as stored (no allocation or copy kernel
   of the cache's size);
4c. sampled, speculative, fp8/f32-cache and fused serving over the same
   model (4 images of 896×896 and 4 texts at once; counts set to 0 before
   and read after): a. the worker's engine with speculation (k = 4 and
   63, 3-grams), graphed and eager (identical ids), a request alone (its
   ids among 8), tokens per busy row and verify tick, acceptance, ms per
   tick and tokens/s against the plain engine, and two requests' logit
   rows against the plain engine's by the logit rule; b. the
   single-request engine with k = 4 on an image and a text (verify
   forwards and ms per token; its ids the plain engine's up to a
   divergence at a near tie); c. 4 sampled rows (0.7, 0.9, seeds 1-4)
   among 4 greedy ones (greedy rows the greedy engine's, sampled rows
   graphed = eager and alone = among 8, with speculation one token a tick
   outside the ladder) and ``sample_rows`` alone on the card: 2^16 draws
   over the vocab, none outside the nucleus, a chi-square over its top 32
   ids; d. the fp8 and f32 static caches (memory, ms per tick, graphed =
   eager; fp8 ``decode_attention`` on the bf16 worker's own filled cache
   within 8% relative RMS of bf16's, f32 logit rows by the logit rule);
   e. after phase 6, the model's LoRA merged and its projections fused in
   place: prefill logits within the logit rule's bound of the unfused
   model's, the worker's decode step and a single request before and
   after (also on phase 7's int8 model: K4 225 → 129 launches a forward,
   counted and in a traced replay);
5. the first image request's prefill logits with K1 against the same
   forward with K1's plain version in every attention;
6. the text-only request once more, at 8 new tokens, under
   ``torch.profiler``: the share of its wall time the device is busy, and
   the kernels that take most;
7. the int8 and the int4 paths (``build_engine(quantize_int8=True)``, then
   ``quantize_int4=True``; same seed, so the same weights before
   quantization), each on the 896×896 image and the text-only question,
   with K1's, K4's and K5's counts asserted per request (of them, 224 per
   image prefill in the prefill regime, M > 16), and the image prefill
   logits with K4 (K5) against the same forward with its plain version in
   every quantized linear, with each side's top-2 logits and margin, then
   that prefill under ``torch.profiler``; and for int8 the batched worker
   over that model (4 images and 4 texts at once, with K4's launches: 225
   per admission, 224 of them in the prefill regime, and 225 × 16 in a
   block, counted at the capture), its graphed and eager decode timing,
   an image and a text against the single-request int8 engine by the
   logit rule, and one replayed tick under ``torch.profiler``, whose
   ``qmm_decode`` events must number 225 × 16; then phase 4c's int8
   parts: the speculative (k = 4) engine, whose captured verify tick
   counts 225 prefill-regime launches (M = 40) and whose traced replay
   holds 225 ``qmm_prefill`` events, and check e;
8. training: ``mllm_npu_tpu_torch.train.train.main`` at full width (the
   same YAML, LoRA dropout 0.05, remat ``dots``, the chunked CE) on a
   webdataset tar of seeded JPEGs and captions through the caption entry of
   the pretrain mixture (``configs/dataset/caption_data.yaml``: max_length
   600, 64 image tokens, anyres over its grids at base 448), at the largest
   batch of 28, 16, 8 or 4 that fits, for a few steps on one repeated
   batch, with a checkpoint at the end. Every step's K1, K2 and K3 counts
   (and that each K2/K3 launch took the Hopper regime) are asserted, its
   loss must be finite, and the loss must fall. Then one step and its
   forward taken apart on the host clock, one step under
   ``torch.profiler``, and one step's LoRA and projector gradients with the
   kernels against the same step with the plain attention forward and
   backward (cos ≥ 0.99);
9. K1 with its LSE against its plain version, with its bound and share,
   then K2 and K3 through ``bench_flash_bwd.bench_shape`` at the training
   shapes (the Llama layer at the training batch, S = 600, causal, two
   packed segments and a padded tail; the resampler over the batch's image
   slots; SigLIP's D = 72; a tiny D = 32): each against its plain version
   and for a bit-identical repeat, timed beside PR 4's mma.sync kernels
   (the regime that keeps them, forced), the plain versions, δ, the pair
   with and without δ and the backward of ``scaled_dot_product_attention``
   as the yardstick, per shape and per training step;
10. SEED-X at full width, after the Llama-3 models are dropped: the port's
   ``seedx_llama2_13b_qwenvl_vitg.yaml`` through ``load_engine_from_config``
   (Llama-2-13B with r32 LoRA, vocab 32330; Qwen-ViT-G-448 and its
   attention pool; the input and output resamplers; bf16, weights from
   seed 0, ``FakeTokenizer``): its parameter count and resident memory;
   ``comprehension`` on an 896×896 image, a 448×448 image and a text
   question with every kernel's count asserted (K1 90 an image request, 40
   a text one); the image request's prefill logits with K1 against K1's
   plain version everywhere; ``text_to_image_features`` on a caption (64
   forced image tokens, ``img_gen_feat`` [1, 64, 4096] against the same
   request on K1's plain version, 41 K1 launches; the graphed decode's
   ids and features equal the eager decode's; a control: the plain
   version with P rounded to bf16, against the plain version); the graph
   cache under the three requests and the caption, twice interleaved; the
   worker from the port's ``seedx_worker.json`` (speculative_k 63, 8 slots,
   a 2048-token cache) on 127.0.0.1: 4 image and 4 text POSTs at once (code
   0), graphed = eager ids, ms per verify tick against a speculative_k = 0
   twin's step, tokens/s, the cache's size, ``decode_attention``'s share of
   the step and a replayed step under ``torch.profiler`` (no copy of the
   cache among its longest kernels); then the Llama quantized to int8 in
   place, one image request (281 K4 launches a forward) and its prefill
   logits with K4 against the plain quantized linears;
11. the SDXL de-tokenizer, after phase 10's model is dropped: the worker's
   engine from ``seedx_worker.json`` with its ``generation_config``
   (``configs/generation/sd_xl_resampler.yaml``) through
   ``load_engine_from_config`` (SEED-X as in phase 10; the SDXL-base UNet,
   2.57 B parameters, the SDXL VAE and the ResamplerXLV2, bf16, weights
   from seed 0; the negative through SEED-X's own Qwen-ViT-G), served on
   127.0.0.1: one ``image_gen`` POST at the reference engine's defaults
   (1024×1024, Euler, 50 steps, guidance 7.5) with every kernel's count
   set to 0 before: code 0, a JPEG that decodes to 1024×1024, K1's
   launches (41 for the features, 49 for the zero-image negative, 140 a
   UNet forward); the time to features, the denoise loop, ms per UNet
   step, the VAE decode, the request and the peak; then the request's
   first UNet forward and the final latents of a 4-step run of the same
   seed with K1, with K1's plain version and with the plain version
   rounding P to bf16 (the control): ε and the latents cos ≥ 0.99 K1
   against plain, with the relative RMS and the control's beside them;
   one UNet forward on CUDA events and under ``torch.profiler``.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import base64
import functools
import gc
import io
import json
import os
import signal
import subprocess
import sys
import tarfile
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# K1 vs its fp32 plain version on the same bf16 inputs: the kernel rounds P
# (before PV) and O to bf16, 2^-9 relative each, so |err| <= ATOL + RTOL·|O|
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
MAX_NEW_TOKENS = 32
# tokens of the text request phase 6 profiles (the profiler's own host
# work grows with every traced event)
PROFILED_TOKENS = 8
# the batched worker's prefill chunk lengths, at which K4/K5 are also timed
CHUNK_M = (128, 512)
# K4/K5 vs their fp32 plain versions on the same bf16 inputs: the output
# is rounded to bf16 (2^-9 relative) and the fp32 sums run in another
# order, so |err| <= QUANT_RTOL·|plain| + QUANT_ATOL_FRAC·max|plain|
QUANT_RTOL, QUANT_ATOL_FRAC = 1e-2, 1e-3
# weight copies cycled through when timing K4/K5, so that each call finds
# its weights outside the 50 MB L2, as every projection of a forward does
COLD_BYTES = 150e6
# K2/K3 vs their fp32 plain versions on the same bf16 inputs: dS and P are
# rounded to bf16 before their products (2^-9 relative each, summed over
# the sequence in another order) and the output to bf16, so
# |err| <= BWD_RTOL·|plain| + BWD_ATOL_FRAC·max|plain|
BWD_RTOL, BWD_ATOL_FRAC = 2e-2, 1e-2
# K1's LSE against the plain version's (fp32 from the same scores)
LSE_ATOL = 1e-3
# training: the recipe's batch first, then smaller ones until one fits
TRAIN_BATCHES = (28, 16, 8, 4)
TRAIN_STEPS = 5
CE_CHUNK = 128
# the kernel and the plain attention give one step's gradients this close
GRAD_COS = 0.99


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def png_b64(w: int, h: int, seed: int) -> str:
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
        buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def cycling(fns):
    """One callable that calls ``fns`` in turn."""
    state = {"i": 0}

    def call():
        fns[state["i"] % len(fns)]()
        state["i"] += 1
    return call


def time_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``. The timed calls are queued behind a
    ~20 ms spin kernel, so the events time the device running them back to
    back and not the host enqueuing them (a short kernel's Python wrapper
    can take longer than the kernel)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_case(name, B, Sq, Sk, Hq, Hkv, D, causal, pad_rows=None, seed=0):
    """K1 against its plain version at one shape; returns the row for the
    JSON line. ``pad_rows`` {batch row: real length} right-pads rows and
    turns on segment ids."""
    import torch
    import torch.nn.functional as F

    from mllm_npu_tpu_torch.ops.flash_attention import (
        SegmentIds, flash_attention, flash_attention_reference, k1_block_q)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q = torch.randn(B, Sq, Hq, D, device=dev, generator=g).bfloat16()
    k = torch.randn(B, Sk, Hkv, D, device=dev, generator=g).bfloat16()
    v = torch.randn(B, Sk, Hkv, D, device=dev, generator=g).bfloat16()
    seg = None
    if pad_rows is not None:
        if Sq != Sk:
            fail("segment case needs Sq == Sk")
        pm = torch.ones(B, Sq, dtype=torch.int32, device=dev)
        for row, n in pad_rows.items():
            pm[row, n:] = 0
        seg = SegmentIds(q=pm, kv=pm)
    kw = dict(causal=causal, segment_ids=seg)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_attention_reference(q, k, v, **kw).float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    check(bool((diff <= BF16_ATOL + BF16_RTOL * ref.abs()).all()),
          f"{name}: max abs err {err} beyond {BF16_ATOL} + "
          f"{BF16_RTOL}·|ref|")

    mask = torch.ones(B, Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= torch.ones(Sq, Sk, dtype=torch.bool, device=dev).tril()
    if seg is not None:
        mask &= seg.q[:, :, None] == seg.kv[:, None, :]
    pairs = int(mask.sum().item()) * Hq
    flops = 4 * D * pairs
    nbytes = 2 * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D)
    if seg is not None:
        nbytes += 4 * B * (Sq + Sk)
    t_c, t_m = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    bound_ms = max(t_c, t_m) * 1e3

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kt = kt.repeat_interleave(Hq // Hkv, dim=1)
    vt = vt.repeat_interleave(Hq // Hkv, dim=1)
    # SDPA on the same function: with segment ids a dense boolean mask,
    # which keeps it off its flash backend; where every id is 1 the mask is
    # the causal one alone, so is_causal without the mask is timed too and
    # the faster of the two is the yardstick
    libs = {}
    if seg is not None:
        libs["SDPA with the dense mask"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask[:, None]))
    if seg is None or bool((seg.q == 1).all() and (seg.kv == 1).all()):
        libs[f"SDPA, is_causal={causal}"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal))
    library = min(libs, key=libs.get)
    ms = time_ms(lambda: flash_attention(q, k, v, **kw))
    row = {
        "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hkv": Hkv,
        "D": D, "causal": causal, "segments": seg is not None,
        "block_q": k1_block_q(B, Sq, Hq, torch.cuda.get_device_properties(
            0).multi_processor_count, D),
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, **kw),
                            iters=5),
        "library_ms": libs[library], "library": library,
        "library_all_ms": libs,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_c >= t_m else "bytes",
        "bound_share": bound_ms / ms,
        "tflops": flops / ms / 1e9,
        "flops": flops, "bytes": nbytes,
    }
    print(f"[K1] {name} (block_q {row['block_q']}): err {err:.3e}  kernel "
          f"{ms:.4f} ms ({row['tflops']:.0f} TFLOP/s, "
          f"{100 * row['bound_share']:.1f}% of the bound)  plain "
          f"{row['plain_ms']:.4f} ms  "
          + "  ".join(f"{k} {v:.4f} ms" for k, v in libs.items())
          + f"  bound {bound_ms:.4f} ms ({row['bound_by']})", flush=True)
    return row


def k1_edge_sweep():
    """K1 against its plain version (output and LSE) at the edges of its
    Hopper design: head dims from 8 to 160 (TMA's zero fill past D, the
    128-byte / 32-byte swizzle split, the 64-row tiles alone at D > 144), lengths below and off the tile,
    causal with Sq != Sk, GQA 32/8 and 8/1, segments that change inside a
    tile with right-padded rows that see no key, and q, k, v as strided
    views of one fused [B, S, 3, H, D] tensor. Any disagreement fails."""
    import torch

    from mllm_npu_tpu_torch.ops.flash_attention import (
        SegmentIds, flash_attention, flash_attention_reference)
    dev = torch.device("cuda")
    cases = [  # B, Sq, Sk, Hq, Hkv, D, causal, segments, fused
        (1, 129, 129, 8, 1, 8, True, False, False),
        (1, 129, 129, 8, 1, 16, False, False, False),
        (2, 65, 65, 8, 1, 24, True, True, False),
        (1, 729, 729, 4, 4, 72, False, False, False),
        (2, 63, 65, 32, 8, 80, False, False, False),
        (1, 1, 1, 4, 1, 128, True, False, False),
        (2, 65, 63, 32, 8, 128, True, False, False),
        (2, 129, 729, 32, 8, 128, True, False, False),
        (1, 729, 129, 8, 1, 64, True, False, False),
        (2, 300, 300, 32, 8, 128, True, True, False),
        (2, 200, 200, 8, 8, 72, True, True, True),
        (2, 300, 300, 16, 16, 104, False, True, True),
        (1, 129, 129, 8, 2, 136, True, False, False),
        (2, 65, 63, 8, 8, 152, True, False, False),
        (1, 729, 729, 8, 8, 160, False, True, False),
        (4, 64, 256, 32, 32, 160, False, False, False),
    ]
    worst = 0.0
    for i, (B, Sq, Sk, Hq, Hkv, D, causal, segs, fused) in enumerate(cases):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + i)
        if fused:
            q, k, v = torch.randn(B, Sq, 3, Hq, D, device=dev,
                                  generator=g).bfloat16().unbind(2)
        else:
            q = torch.randn(B, Sq, Hq, D, device=dev, generator=g).bfloat16()
            k, v = (torch.randn(B, Sk, Hkv, D, device=dev,
                                generator=g).bfloat16() for _ in range(2))
        seg = None
        if segs:
            # segments of 5 to 40 tokens; the last row's tail padded, its
            # queries and keys in segments of their own
            qs = torch.zeros(B, Sq, dtype=torch.int64)
            lens = torch.randint(5, 41, (B, Sq), generator=torch.Generator(
                ).manual_seed(i))
            for b in range(B):
                qs[b] = torch.repeat_interleave(
                    torch.arange(1, Sq + 1), lens[b])[:Sq]
            ks = qs[:, :Sk].clone()
            qs[-1, Sq - Sq // 5:] = -1
            ks[-1, Sk - Sk // 5:] = -2
            seg = SegmentIds(q=qs.to(dev, torch.int32),
                             kv=ks.to(dev, torch.int32))
        kw = dict(causal=causal, segment_ids=seg)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        torch.cuda.synchronize()
        ref, rlse = flash_attention_reference(q, k, v, return_lse=True, **kw)
        diff = (out.float() - ref.float()).abs()
        name = (f"K1 edge B{B} Sq{Sq} Sk{Sk} H{Hq}/{Hkv} D{D}"
                f"{' causal' if causal else ''}{' segments' if segs else ''}"
                f"{' fused' if fused else ''}")
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
        check(bool((diff <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all()),
              f"{name}: max abs err {diff.max().item()} beyond {BF16_ATOL} + "
              f"{BF16_RTOL}·|plain|")
        lse_err = (lse - rlse).abs().max().item()
        check(lse_err <= LSE_ATOL, f"{name}: LSE err {lse_err}")
        if segs:
            check(bool((out[-1, Sq - Sq // 5:] == 0).all()),
                  f"{name}: a row with no visible key is not 0")
        worst = max(worst, diff.max().item())
    print(f"[K1] edge sweep: {len(cases)} shapes agree with the plain "
          f"version, max abs err {worst:.3e}", flush=True)
    return {"shapes": len(cases), "max_abs_err": worst}


def quant_case(bits, M, K, N, group=256, seed=0):
    """K4 (bits 8) or K5 (bits 4) against its plain version at one shape,
    on bf16 x and a weight quantized from a seeded bf16 matrix; returns the
    row for the JSON line."""
    import math

    import torch
    import torch.nn.functional as F

    from mllm_npu_tpu_torch.ops import quant as tq
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = (torch.randn(N, K, device=dev, generator=g) * 0.02).bfloat16()
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    if bits == 8:
        qt = tq.quantize_int8(w)
        kernel, plain = tq.int8_matmul, tq.int8_matmul_reference
        w_deq = tq.dequantize_int8(qt)
    else:
        qt = tq.quantize_int4(w, group)
        kernel, plain = tq.int4_matmul, tq.int4_matmul_reference
        w_deq = tq.dequantize_int4(qt)
    del w
    name = f"{kernel.__name__} M{M} K{K} N{N}"
    out = kernel(x, *qt)
    torch.cuda.synchronize()
    ref = plain(x, *qt).float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    check(bool((diff <= QUANT_RTOL * ref.abs()
                + QUANT_ATOL_FRAC * ref.abs().max()).all()),
          f"{name}: max abs err {err} beyond {QUANT_RTOL}·|plain| + "
          f"{QUANT_ATOL_FRAC}·max|plain|")
    del out, ref, diff

    w_bytes = qt.values.numel() + 4 * qt.scale.numel()
    flops = 2 * M * N * K
    nbytes = 2 * M * K + w_bytes + 2 * M * N
    t_c, t_m = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    copies = [qt] + [type(qt)(qt.values.clone(), qt.scale.clone())
                     for _ in range(math.ceil(COLD_BYTES / w_bytes) - 1)]
    lib_copies = [w_deq] + [w_deq.clone() for _ in range(
        math.ceil(COLD_BYTES / (2 * N * K)) - 1)]
    row = {
        "shape": name, "M": M, "K": K, "N": N,
        "group": group if bits == 4 else None,
        "max_abs_err": err,
        "ms": time_ms(cycling([lambda c=c: kernel(x, *c) for c in copies])),
        "plain_ms": time_ms(cycling([lambda c=c: plain(x, *c)
                                     for c in copies]), iters=5),
        "library_ms": time_ms(cycling([lambda c=c: F.linear(x, c)
                                       for c in lib_copies])),
        "library": "F.linear on the weight dequantized to bf16 once, "
                   "outside the timed region",
        "bound_ms": max(t_c, t_m) * 1e3,
        "bound_by": "operations" if t_c >= t_m else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    print(f"[K{4 if bits == 8 else 5}] {name}: err {err:.3e}  kernel "
          f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  F.linear on "
          f"dequantized bf16 {row['library_ms']:.4f} ms  bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    del copies, lib_copies, w_deq
    torch.cuda.empty_cache()
    return row


def quant_rows(lm_cfg, s_img, bucket, slots, regimes=None):
    """K4 and K5 at the Llama's projection shapes: decode (M = 1, the
    lm_head included), the image prefill (M = prompt length), and the
    batched worker's: its decode block (M = ``slots``, the lm_head
    included), its image admissions (M = ``bucket``) and its text
    admissions and prefill chunks (M = 128 and 512); the speculative
    verify windows (the worker's at k = 4, M = ``slots`` × 5, and the
    single request's, M = 5, the lm_head included); the fused products
    (qkv and gate_up) at M = 1, 5, ``slots``, ``slots`` × 5 and
    ``slots`` × 64 (k = 63). Each row says its regime; ``regimes`` keeps
    only those named."""
    hs, inter = lm_cfg.hidden_size, lm_cfg.intermediate_size
    kv = lm_cfg.num_key_value_heads * lm_cfg.head_dim
    # (MHA: k and v have q's shape)
    proj = list(dict.fromkeys([(hs, hs), (hs, kv), (hs, inter), (inter, hs)]))
    head = [(hs, lm_cfg.vocab_size)]
    fused = [(hs, lm_cfg.hidden_size + 2 * kv), (hs, 2 * inter)]
    shapes = ([("decode", 1, k, n) for k, n in proj + head]
              + [("prefill", s_img, k, n) for k, n in proj]
              + [("slots", slots, k, n) for k, n in proj + head]
              + [("bucket", bucket, k, n) for k, n in proj]
              + [("chunk", m, k, n) for m in CHUNK_M for k, n in proj]
              + [("verify", slots * 5, k, n) for k, n in proj + head]
              + [("verify_single", 5, k, n) for k, n in proj + head]
              + [(f"fused_m{m}", m, k, n)
                 for m in (1, 5, slots, slots * 5, slots * 64)
                 for k, n in fused])
    if regimes is not None:
        shapes = [sh for sh in shapes if sh[0] in regimes]
    return {bits: [dict(quant_case(bits, m, k, n, lm_cfg.quant_group_size),
                        regime=regime)
                   for regime, m, k, n in shapes] for bits in (8, 4)}


def quant_mix(lm_cfg, lm_head=True):
    """Launches of each (K, N) per forward: 32 layers of q, k, v, o, gate,
    up, down, and the lm_head once (a prefill runs it on the last row
    only, in the decode regime: ``lm_head=False`` gives the prefill
    regime's 224)."""
    hs, inter = lm_cfg.hidden_size, lm_cfg.intermediate_size
    kv = lm_cfg.num_key_value_heads * lm_cfg.head_dim
    L = lm_cfg.num_hidden_layers
    mix = {}
    for key, n in (((hs, hs), 2 * L), ((hs, kv), 2 * L), ((hs, inter), 2 * L),
                   ((inter, hs), L)):
        mix[key] = mix.get(key, 0) + n      # MHA: k, v have q's shape
    if lm_head:
        mix[(hs, lm_cfg.vocab_size)] = 1
    return mix


def fused_mix(lm_cfg):
    """Launches of each (K, N) per forward with fused projections: 32
    layers of qkv, o, gate_up, down, and the lm_head once."""
    hs, inter = lm_cfg.hidden_size, lm_cfg.intermediate_size
    kv = lm_cfg.num_key_value_heads * lm_cfg.head_dim
    L = lm_cfg.num_hidden_layers
    return {(hs, hs + 2 * kv): L, (hs, hs): L, (hs, 2 * inter): L,
            (inter, hs): L, (hs, lm_cfg.vocab_size): 1}


def quant_row_mix(rows, mix):
    """The K4/K5 rows of one regime summed over a forward's launch mix:
    ms, plain_ms, bound_ms, library_ms, bound_by and the basis."""
    n_of = {(r["K"], r["N"]): mix[(r["K"], r["N"])] for r in rows}
    agg = {key: sum(r[key] * n_of[(r["K"], r["N"])] for r in rows)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    t_c = sum(r["flops"] * n_of[(r["K"], r["N"])]
              for r in rows) / H100_BF16_FLOPS
    t_m = sum(r["bytes"] * n_of[(r["K"], r["N"])]
              for r in rows) / H100_BYTES_PER_S
    agg["bound_by"] = "operations" if t_c >= t_m else "bytes"
    agg["bound_share"] = agg["bound_ms"] / agg["ms"]
    agg["launch_mix"] = ", ".join(f"{n} x K{k} N{nn}"
                                  for (k, nn), n in n_of.items())
    return agg


def prefill_logits(model, prep):
    """Last-position logits of one request's prefill (for an image the
    vision tower, resampler and scatter; a causal Llama prefill with
    segment ids)."""
    import torch

    from mllm_npu_tpu_torch.ops import SegmentIds
    ids, patches, pos, cmp = prep
    dev = torch.device("cuda")
    input_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)[None]
    lm = model.language_model
    with torch.inference_mode():
        image = (None,) * 4 if patches is None else (
            torch.as_tensor(patches, device=dev),
            torch.ones((patches.shape[0],), dtype=torch.bool, device=dev),
            torch.as_tensor(cmp, device=dev)[None],
            torch.as_tensor(pos, device=dev))
        emb, _ = model.embed_and_scatter(input_ids, *image)
        ones = torch.ones_like(input_ids, dtype=torch.int32)
        h, _ = lm(inputs_embeds=emb, segment_ids=SegmentIds(q=ones, kv=ones))
        return lm.logits(h[:, -1]).float()


def k1_vs_plain_prefill(model, prep, label):
    """Phase 5's check: one image request's prefill logits with K1 against
    the same forward with K1's plain version in every attention (the
    vision tower, the projector, the Llama), K1's count asserted. Random
    weights give flat logits, so the direction (cosine) is held and the
    argmax reported. → (K1 logits, plain logits)."""
    import torch

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    lm_cfg = model.language_model.config
    logits = {}
    for which, fn in (("K1", flash_attention),
                      ("plain", flash_attention_reference)):
        port_ops.flash_attention = fn
        flash_attention.launches = 0
        try:
            logits[which] = prefill_logits(model, prep)
        finally:
            port_ops.flash_attention = flash_attention
        expect = (lm_cfg.num_hidden_layers + k1_per_image(model)
                  if which == "K1" else 0)
        check(flash_attention.launches == expect,
              f"{label} {which} prefill launched K1 "
              f"{flash_attention.launches} times, expected {expect}")
    k1, plain = logits["K1"], logits["plain"]
    cos = torch.nn.functional.cosine_similarity(k1, plain).item()
    diff = (k1 - plain).abs().max().item()
    print(f"[check] {label} image prefill logits, K1 vs plain attention: "
          f"cos {cos:.6f}, max abs diff {diff:.4f}, |logits| max "
          f"{plain.abs().max().item():.3f}, argmax "
          f"{k1.argmax().item()} vs {plain.argmax().item()}", flush=True)
    check(bool(torch.isfinite(k1).all()), f"{label}: non-finite logits")
    check(tuple(k1.shape) == (1, lm_cfg.vocab_size),
          f"{label}: logits shape")
    check(cos >= 0.99,
          f"{label}: K1 and plain-attention logits disagree (cos {cos})")
    return k1, plain


def quant_vs_plain_prefill(model, prep, bits, label, bf16_logits):
    """Phase 7's check: one image request's prefill logits with K4 (bits
    8) or K5 (bits 4) against the same forward with its plain version in
    every quantized linear (cos ≥ 0.99), the counts asserted (7 × layers +
    1 launches, all but the lm_head in the prefill regime), each side's
    top-2 logits and margin printed. → (kernel logits, plain logits)."""
    import torch

    from mllm_npu_tpu_torch.ops import quant as tq
    lm_cfg = model.language_model.config
    name = f"int{bits}"
    kernel = getattr(tq, f"{name}_matmul")
    qlogits = {}
    for which, fn in ((name, kernel),
                      ("plain", getattr(tq, f"{name}_matmul_reference"))):
        setattr(tq, f"{name}_matmul", fn)
        kernel.launches = kernel.prefill_launches = 0
        try:
            qlogits[which] = prefill_logits(model, prep)
        finally:
            setattr(tq, f"{name}_matmul", kernel)
        expect = 7 * lm_cfg.num_hidden_layers + 1 if which == name else 0
        check(kernel.launches == expect,
              f"{label} {which} prefill launched {name}_matmul "
              f"{kernel.launches} times, expected {expect}")
        # all but the lm_head (last row, decode regime) at M = prompt
        expect = 7 * lm_cfg.num_hidden_layers if which == name else 0
        check(kernel.prefill_launches == expect,
              f"{label} {which} prefill launched {name}_matmul's prefill "
              f"kernel {kernel.prefill_launches} times, expected {expect}")
    ql, qp = qlogits[name], qlogits["plain"]
    cos = torch.nn.functional.cosine_similarity(ql, qp).item()
    cos_bf16 = torch.nn.functional.cosine_similarity(ql, bf16_logits).item()
    # random weights give flat logits: the top two and their margin on each
    # side tell a near-tie flip of the argmax from a kernel error
    tops = {}
    for which, lg in (("kernel", ql), ("plain", qp)):
        v, i = lg[0].topk(2)
        tops[which] = (i.tolist(), v.tolist(), (v[0] - v[1]).item())
    print(f"[check] {label} {name} image prefill logits, kernel vs plain "
          f"quantized linears: cos {cos:.6f}, max abs diff "
          f"{(ql - qp).abs().max().item():.4f}, argmax "
          f"{ql.argmax().item()} vs {qp.argmax().item()}; top-2 "
          + "; ".join(f"{w} ids {t[0]} logits {t[1][0]:.4f}, "
                      f"{t[1][1]:.4f} (margin {t[2]:.4f})"
                      for w, t in tops.items())
          + f"; against the bf16 engine's logits (information only): "
          f"cos {cos_bf16:.6f}", flush=True)
    check(bool(torch.isfinite(ql).all()), f"{label}: non-finite {name} "
          "logits")
    check(tuple(ql.shape) == (1, lm_cfg.vocab_size), f"{label}: logits "
          "shape")
    check(cos >= 0.99,
          f"{label}: {name} kernel and plain logits disagree (cos {cos})")
    return ql, qp


def profile_call(fn):
    """``fn()`` under ``torch.profiler``: wall ms, device busy ms (the union
    of the device activity intervals), the five kernels with the most
    device time and every kernel's event count (kernels a CUDA graph
    replays are traced one by one), read from the tracer's raw records.
    The profiler's own host cost slows the host, so the busy share it
    gives is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()       # only fn's device work in the window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [(e.name(), e.start_ns() / 1e3, (e.start_ns() + e.duration_ns())
               / 1e3) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((s, e) for _, s, e in device):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name, counts = {}, {}
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + e - s
        counts[name] = counts.get(name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall_ms, busy_us / 1e3, top, counts


def print_profile(label, wall_ms, busy_ms, top, counts):
    if busy_ms > 0:
        print(f"[profile] {label} under torch.profiler: wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%); most device time: "
              + "; ".join(f"{n[:70]} {t / 1e3:.2f} ms ({counts[n]} events)"
                          for n, t in top), flush=True)
    else:
        print(f"[profile] {label}: torch.profiler recorded no device "
              "activity: the busy share is not measured", flush=True)


def kernel_counters():
    """name → the wrapper whose ``launches`` counts that kernel."""
    from mllm_npu_tpu_torch.ops import quant as tq
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_bwd_dkv, flash_bwd_dq)
    return {"flash_fwd": flash_attention, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "int8_matmul": tq.int8_matmul,
            "int4_matmul": tq.int4_matmul}


def bwd_case(name, B, Sq, Sk, Hq, Hkv, D, causal, segments=False, seed=0):
    """K1 with its LSE against its plain version, with its time, bound and
    share; then K2 and K3 through ``bench_flash_bwd.bench_shape`` (checked
    against their plain versions and for a bit-identical repeat, timed
    beside PR 4's mma.sync kernels, the plain versions, δ and SDPA's
    backward). Returns {kernel: row, "pair": row, "lse": row}.
    ``segments`` packs two segments per row and pads the last row's tail
    (segment 0)."""
    import torch

    from mllm_npu_tpu_torch import bench_flash_bwd as bench
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    q, k, v, do, seg = bench.inputs(B, Sq, Sk, Hq, Hkv, D, segments, seed)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_reference(q, k, v, return_lse=True, **kw)
    lse_err = (lse - rlse).abs().max().item()
    o_diff = (o.float() - ro.float()).abs()
    check(bool(torch.isfinite(lse).all()) and lse_err <= LSE_ATOL,
          f"{name}: K1 LSE err {lse_err} beyond {LSE_ATOL}")
    check(bool((o_diff <= BF16_ATOL + BF16_RTOL * ro.float().abs()).all()),
          f"{name}: K1 output with LSE disagrees")
    del ro, rlse, o_diff
    lse_ms = time_ms(lambda: flash_attention(q, k, v, return_lse=True, **kw))
    # K1 with its LSE: 4·D flops per visible pair; q, k, v read, o and the
    # LSE written once
    flops = bench.work(B, Sq, Sk, Hq, Hkv, D, causal, seg)[
        "flash_bwd_dq"][0] // 6 * 4
    nbytes = 2 * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) \
        + 4 * B * Hq * Sq + (4 * B * (Sq + Sk) if seg is not None else 0)
    lse_bound, lse_by = bench.bound_ms(flops, nbytes)
    del q, k, v, do, o, lse

    r = bench.bench_shape(name, B, Sq, Sk, Hq, Hkv, D, causal, segments,
                          seed=seed)
    check(r["within_tolerance"], f"{name}: K2/K3 errors {r['max_abs_err']} "
          f"beyond {bench.BWD_RTOL}·|plain| + "
          f"{bench.BWD_ATOL_FRAC}·max|plain|")
    check(r["repeat_bit_identical"], f"{name}: K2/K3 repeat differs")
    rows = {}
    for kernel, key, err in (
            ("flash_bwd_dq", "k2", r["max_abs_err"]["dq"]),
            ("flash_bwd_dkv", "k3",
             max(r["max_abs_err"]["dk"], r["max_abs_err"]["dv"]))):
        rows[kernel] = {
            "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hkv": Hkv,
            "D": D, "causal": causal, "segments": segments,
            "max_abs_err": err, "ms": r[f"{key}_ms"],
            "plain_ms": r[f"plain_{key}_ms"], "library_ms": r["sdpa_bwd_ms"],
            "bound_ms": r[f"{key}_bound_ms"], "bound_by": r[f"{key}_bound_by"],
            "bound_share": r[f"{key}_bound_share"],
            "tflops": r[f"{key}_tflops"],
            "flops": r[f"{key}_flops"], "bytes": r[f"{key}_bytes"],
            "design": ("wgmma+tma" if r["regime"] == "wgmma"
                       else "mma.sync"),
            "pr4_ms": r[f"mma_sync_{key}_ms"],
        }
    rows["pair"] = {k: r[k] for k in (
        "shape", "pair_ms", "pair_delta_ms", "delta_ms", "sdpa_bwd_ms",
        "pair_vs_sdpa", "pair_delta_vs_sdpa", "mma_sync_pair_ms")}
    rows["lse"] = {"shape": name, "lse_max_abs_err": lse_err,
                   "k1_with_lse_ms": lse_ms, "bound_ms": lse_bound,
                   "bound_by": lse_by, "bound_share": lse_bound / lse_ms,
                   "tflops": flops / lse_ms / 1e9}
    print(f"[K1] {name} with its LSE: {lse_ms:.4f} ms (LSE err "
          f"{lse_err:.2e}), bound {lse_bound:.4f} ms ({lse_by}), "
          f"{100 * lse_bound / lse_ms:.1f}% of it", flush=True)
    return rows


WORDS = ("a photo of the small large red blue green old new city street "
         "river dog cat man woman child tree house car boat sky cloud sun "
         "night morning near under beside with on in at holding running "
         "standing sitting bright dark view").split()


def caption_tar(path, n, seed=0):
    """A webdataset tar of ``n`` JPEGs of seeded sizes (each side 448 to
    1400 pixels, so the anyres grids vary) and pixels, with the caption in
    the JSON metadata, as LAION-COCO's shards hold it."""
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            w, h = (int(x) for x in rs.randint(448, 1401, 2))
            buf = io.BytesIO()
            Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
                buf, format="JPEG", quality=85)
            caption = " ".join(rs.choice(WORDS, int(rs.randint(8, 20))))
            meta = json.dumps({"caption": caption, "similarity": 0.3})
            for ext, data in ((".jpg", buf.getvalue()),
                              (".json", meta.encode())):
                info = tarfile.TarInfo(f"{i:06d}{ext}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


def forward_parts(model, batch, grad):
    """The training forward of ``batch`` taken apart on the host clock, each
    part ending in a synchronize: the frozen vision tower, the rest of the
    embedding and scatter (compaction, resampler, scatter), the Llama stack
    (with ``grad``: autograd and remat's caching mode), the loss."""
    import torch

    from mllm_npu_tpu_torch.models.language_models.llama import (
        packed_positions)
    from mllm_npu_tpu_torch.ops import SegmentIds
    parts = {}
    with torch.set_grad_enabled(grad):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.forward_images(batch["images"])
        torch.cuda.synchronize()
        parts["vision_tower"] = time.perf_counter() - t
        t = time.perf_counter()
        emb, _ = model.embed_and_scatter(
            batch["input_ids"], batch["images"], batch["embeds_cmp_mask"],
            batch["ids_cmp_mask"], batch["patch_positions"])
        torch.cuda.synchronize()
        parts["embed_and_scatter_less_tower"] = (time.perf_counter() - t
                                                 - parts["vision_tower"])
        t = time.perf_counter()
        seg = batch["attention_mask"].to(torch.int32)
        h, _ = model.language_model(inputs_embeds=emb,
                                    positions=packed_positions(seg),
                                    segment_ids=SegmentIds(q=seg, kv=seg))
        torch.cuda.synchronize()
        parts["llama_layers"] = time.perf_counter() - t
        t = time.perf_counter()
        model.compute_losses(h, batch["labels"])
        torch.cuda.synchronize()
        parts["loss"] = time.perf_counter() - t
    return parts


def train_phase(workdir):
    """Phase 8; returns what the JSON line and phase 9 need."""
    import torch
    import yaml

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.models.language_models.llama import (
        set_lora_dropout_seed)
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention_reference)
    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import (compute_grads,
                                                      make_train_step)
    from mllm_npu_tpu_torch.utils.weights import set_llama_config

    model_yaml = (ROOT / "mllm_npu_tpu_torch" / "configs" / "models"
                  / "mllm_llama3_8b_siglip_vit.yaml")
    ds = yaml.safe_load((ROOT / "mllm_npu_tpu_torch" / "configs" / "dataset"
                         / "caption_data.yaml").read_text())
    counters = kernel_counters()
    run, per_step, B = None, [], None
    for B in TRAIN_BATCHES:
        data_dir = workdir / f"data_b{B}"
        data_dir.mkdir()
        caption_tar(data_dir / "shard-000000.tar", B, seed=0)
        node = ds["datapipes"][0]
        # one batch's worth of samples, every one an image-first
        # (comprehension) sample, so every step sees the same batch
        node.update(data_dir=[str(data_dir)], batch_size=B,
                    img_first_ratio=1.0, cycle_count=100000)
        data_yaml = workdir / f"data_b{B}.yaml"
        data_yaml.write_text(yaml.safe_dump(ds))
        argv = ["--model", str(model_yaml), "--train_dataset", str(data_yaml),
                "--output_dir", str(workdir / f"out_b{B}"),
                "--max_steps", str(TRAIN_STEPS), "--save_steps", "1000000",
                "--log_steps", "1", "--learning_rate", "3e-4",
                "--lr_scheduler_type", "constant", "--warmup_steps", "0",
                "--ce_loss_chunk", str(CE_CHUNK), "--fake_tokenizer",
                "--device", "cuda", "--seed", "0"]
        per_step = []

        def on_step(rec):
            got = {k: fn.launches for k, fn in counters.items()}
            for k in ("flash_bwd_dq", "flash_bwd_dkv"):
                got[f"{k}_wgmma"] = counters[k].wgmma_launches
                counters[k].wgmma_launches = 0
            for fn in counters.values():
                fn.launches = 0
            per_step.append((rec, got))
            print(f"[train] B{B} step {rec['step']}: loss {rec['loss']:.4f}, "
                  f"grad_norm {rec['grad_norm']:.4f}, sec/step "
                  f"{rec['sec/step']:.3f}, tokens/s {rec['tokens/s']:.0f}, "
                  f"images/s {rec['images/s']:.1f}; launches K1 "
                  f"{got['flash_fwd']}, K2 {got['flash_bwd_dq']}, K3 "
                  f"{got['flash_bwd_dkv']} (Hopper regime "
                  f"{got['flash_bwd_dq_wgmma']}/{got['flash_bwd_dkv_wgmma']})",
                  flush=True)

        for fn in counters.values():
            fn.launches = 0
        counters["flash_bwd_dq"].wgmma_launches = 0
        counters["flash_bwd_dkv"].wgmma_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            run = trainer.main(argv, on_step=on_step)
        except torch.cuda.OutOfMemoryError:
            print(f"[train] batch {B} does not fit in "
                  f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
                  f" GiB (out of memory at step {len(per_step) + 1}); "
                  "trying a smaller one", flush=True)
            run = None
        signal.signal(signal.SIGTERM, signal.SIG_DFL)   # drop the closure
        gc.collect()
        torch.cuda.empty_cache()
        if run is not None:
            break
    check(run is not None, "no training batch fits")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    model = run.model
    lm_cfg = model.language_model.config
    n_vis = model.vision_encoder.config.num_hidden_layers
    L = lm_cfg.num_hidden_layers
    # the frozen tower's layers (no gradient: K1 alone), the resampler and
    # each Llama layer (K1 with LSE, K2, K3), whose forward remat re-runs;
    # every K2/K3 launch of the step (D = 128) in the Hopper regime
    expect = {k: 0 for k in counters}
    expect.update(flash_fwd=n_vis + 1 + (2 if lm_cfg.remat else 1) * L,
                  flash_bwd_dq=L + 1, flash_bwd_dkv=L + 1,
                  flash_bwd_dq_wgmma=L + 1, flash_bwd_dkv_wgmma=L + 1)
    check(len(per_step) == TRAIN_STEPS, f"{len(per_step)} steps ran")
    import math
    for rec, got in per_step:
        check(got == expect, f"train step {rec['step']}: launches {got}, "
              f"expected {expect}")
        check(math.isfinite(rec["loss"]), f"step {rec['step']}: loss "
              f"{rec['loss']}")
    losses = [rec["loss"] for rec, _ in per_step]
    check(losses[-1] < losses[0], f"the loss did not fall on a repeated "
          f"batch: {losses}")
    ckpt = workdir / f"out_b{B}" / f"checkpoint_{TRAIN_STEPS}"
    check((ckpt / "state.pt").is_file(), f"no checkpoint at {ckpt}")
    ckpt_gib = (ckpt / "state.pt").stat().st_size / 2**30
    batch = run.last_batches
    n_images = int(batch[0]["images"].shape[0])
    seq = int(batch[0]["input_ids"].shape[1])
    steady = per_step[1:]
    summary = {
        "batch": B, "cut_from": TRAIN_BATCHES[0], "seq": seq,
        "images": n_images, "steps": TRAIN_STEPS, "losses": losses,
        "sec_per_step": sum(r["sec/step"] for r, _ in steady) / len(steady),
        "tokens_per_s": sum(r["tokens/s"] for r, _ in steady) / len(steady),
        "images_per_s": sum(r["images/s"] for r, _ in steady) / len(steady),
        "peak_gib": peak, "wall_s": wall, "checkpoint_gib": ckpt_gib,
        "launches": {k: sum(g[k] for _, g in per_step) for k in expect},
        "trainable_m": sum(p.numel() for p in model.parameters()
                           if p.requires_grad) / 1e6,
    }
    print(f"[train] batch {B} (the recipe's {TRAIN_BATCHES[0]} cut to fit), "
          f"S {seq}, {n_images} image slots: {TRAIN_STEPS} steps in "
          f"{wall:.1f} s with the build; steps 2-{TRAIN_STEPS}: "
          f"{summary['sec_per_step']:.3f} sec/step, "
          f"{summary['tokens_per_s']:.0f} tokens/s, "
          f"{summary['images_per_s']:.1f} images/s; peak "
          f"{peak:.2f} GiB; {summary['trainable_m']:.1f} M trainable; "
          f"losses {[round(x, 4) for x in losses]}; checkpoint "
          f"{ckpt_gib:.2f} GiB", flush=True)
    import shutil
    shutil.rmtree(workdir / f"out_b{B}", ignore_errors=True)

    # one step taken apart on the host clock, each part ending in a
    # synchronize: forward, backward, optimizer (the batch is already on
    # the card, so the rest of the loop's sec/step is data and logging)
    parts = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for p in model.parameters():
        p.grad = None
    loss, _ = trainer.mllm_loss(model, batch[0])
    torch.cuda.synchronize()
    parts["forward"] = time.perf_counter() - t
    t = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    parts["backward"] = time.perf_counter() - t
    t = time.perf_counter()
    run.optimizer.step()
    torch.cuda.synchronize()
    parts["optimizer"] = time.perf_counter() - t
    summary["step_parts_s"] = parts
    print(f"[train] one step at batch {B} taken apart: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()) * 1e3:.1f} ms against "
        f"{summary['sec_per_step'] * 1e3:.1f} ms per step in the loop",
        flush=True)
    del loss
    summary["forward_parts_s"] = {
        mode: forward_parts(model, batch[0], grad=(mode == "training"))
        for mode in ("training", "no_grad")}
    for mode, fp in summary["forward_parts_s"].items():
        print(f"[train] the forward taken apart ({mode}): " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in fp.items()), flush=True)

    # one step (gradients and the update) under the profiler
    step = make_train_step(model, trainer.mllm_loss, run.optimizer)
    summary["profile"] = profile_call(lambda: step(batch))
    print_profile(f"one training step at batch {B}", *summary["profile"])

    # one step's gradients with the kernels against the plain attention
    # forward and backward; dropout off, and remat 'nothing' for both so
    # the plain attention's saved logits do not stay for all 32 layers
    run.optimizer = None
    gc.collect()
    torch.cuda.empty_cache()
    set_lora_dropout_seed(model, None)
    set_llama_config(model.language_model, remat_policy="nothing")
    grads = {}
    for route in ("kernels", "plain"):
        fns = (port_ops.flash_attention, port_ops.flash_attention_trainable)
        if route == "plain":
            port_ops.flash_attention = flash_attention_reference
            port_ops.flash_attention_trainable = flash_attention_reference
        try:
            compute_grads(model, trainer.mllm_loss, batch)
        finally:
            port_ops.flash_attention, port_ops.flash_attention_trainable = \
                fns
        grads[route] = {
            part: torch.cat([p.grad.float().flatten()
                             for n, p in model.named_parameters()
                             if p.requires_grad and part in n])
            for part in ("lora_", "projector.")}
        for p in model.parameters():
            p.grad = None
    summary["grad_cos"] = {}
    for part in ("lora_", "projector."):
        a, b = grads["kernels"][part], grads["plain"][part]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        summary["grad_cos"][part] = cos
        print(f"[check] one training step's {part.rstrip('._')} gradients "
              f"({a.numel() / 1e6:.1f} M), K1/K2/K3 vs plain attention: cos "
              f"{cos:.6f}, |g| {a.norm().item():.4e} vs "
              f"{b.norm().item():.4e}", flush=True)
        check(cos >= GRAD_COS, f"{part} gradients disagree (cos {cos})")
    del grads, run, model, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    return summary


def k1_per_image(model):
    """K1 launches an image prompt's embedding makes: one for every
    attention of the vision tower (its pool included) and of the
    projector."""
    from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
        VisualAttention)
    from mllm_npu_tpu_torch.models.vit_common import (TorchMHA,
                                                      ViTSelfAttention)
    kinds = (TorchMHA, ViTSelfAttention, VisualAttention)
    return sum(isinstance(m, kinds) for part in (model.vision_encoder,
                                                  model.projector)
               for m in part.modules())


def serve(engine, requests, preps, label, lm_cfg):
    """Each request once, with every kernel's count set to 0 just before
    and read just after; asserts K1's count and, for a quantized engine,
    K4's or K5's: 225 per forward (7 projections × 32 layers + lm_head) ×
    the forwards the host ran (the prefill, each decode step run eagerly,
    among them the first step of a request that captured the decode
    step's CUDA graph, and that capture's recording; a replayed step
    launches without the host, uncounted),
    the other quantized kernel never, and of those 224 in the prefill
    regime (M > 16) where the prompt is longer than 16 tokens. Returns the
    launches summed over the requests, and the prefill-regime launches of
    K4 and K5 summed likewise."""
    import torch

    from mllm_npu_tpu_torch.ops import quant as tq
    counters = kernel_counters()
    quant = engine.generator.model.language_model.config.quantization
    per_forward = 7 * lm_cfg.num_hidden_layers + 1
    k1_image = k1_per_image(engine.generator.model)
    total = dict.fromkeys(counters, 0)
    prefill_total = {8: 0, 4: 0}
    for i, ((q, b64), prep) in enumerate(zip(requests, preps), 1):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        tq.int8_matmul.prefill_launches = tq.int4_matmul.prefill_launches = 0
        t0 = time.perf_counter()
        text = engine.comprehension(q, b64)
        wall = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counters.items()}
        tm = engine.generator.last_timings
        steps = tm["decode_steps"]
        expect = {k: 0 for k in counters}
        expect["flash_fwd"] = lm_cfg.num_hidden_layers + (
            k1_image if b64 else 0)
        prefill_got = (tq.int8_matmul.prefill_launches,
                       tq.int4_matmul.prefill_launches)
        prefill_expect = [0, 0]
        replays = tm["graph_replays"]
        if quant != "none":
            expect[f"{quant}_matmul"] = per_forward * (
                1 + steps - replays + tm["graph_captured"])
            # the prefill's 224 products at M = prompt length run the
            # prefill kernel where the prompt is longer than 16 tokens;
            # the lm_head (last row) and every decode step run the decode
            # kernel
            if len(prep[0]) > tq.DECODE_MAX_M:
                prefill_expect[0 if quant == "int8" else 1] = \
                    per_forward - 1
        print(f"[{label}] request {i} ({'image' if b64 else 'text'}, prompt "
              f"{len(prep[0])} tokens): launches K1 {got['flash_fwd']}, K2/K3 "
              f"{got['flash_bwd_dq']}/{got['flash_bwd_dkv']}, K4 "
              f"{got['int8_matmul']}, K5 {got['int4_matmul']}, of them in the "
              f"prefill regime {prefill_got[0]}/{prefill_got[1]} (expected "
              f"{expect['flash_fwd']}, {expect['int8_matmul']}, "
              f"{expect['int4_matmul']}, {prefill_expect[0]}/"
              f"{prefill_expect[1]}); vision+projector "
              f"{tm['embed_s'] * 1e3:.1f} ms; prefill "
              f"{tm['prefill_s'] * 1e3:.1f} ms; ttft "
              f"{tm['ttft_s'] * 1e3:.1f} ms; decode {steps} steps ("
              f"{replays} graph replays"
              + (f", captured here in {tm['capture_s'] * 1e3:.1f} ms"
                 if tm['graph_captured'] else '') + "), "
              f"{ms_per_token(tm):.2f} ms/token; wall "
              f"{wall:.2f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; text "
              f"{text[:60]!r}", flush=True)
        check(isinstance(text, str), "comprehension returned no text")
        check(got == expect, f"{label} request {i}: launches {got}, "
              f"expected {expect}")
        check(list(prefill_got) == prefill_expect,
              f"{label} request {i}: prefill-regime launches of K4/K5 "
              f"{prefill_got}, expected {prefill_expect}")
        for k in total:
            total[k] += got[k]
        prefill_total[8] += prefill_got[0]
        prefill_total[4] += prefill_got[1]
    return total, prefill_total


def single_graph_check(engine, requests, label):
    """Each request again through the single-request generator with its
    decode step replayed from the CUDA graph and run eagerly: the ids must
    be identical; ms/token of both. → summary."""
    out = []
    gen = engine.generator
    for q, b64 in requests:
        runs = {}
        for graphed in (True, False):
            gen.cuda_graph = graphed
            try:
                ids = engine.comprehension_ids(q, b64)
            finally:
                gen.cuda_graph = True
            tm = gen.last_timings
            runs[graphed] = (ids.tolist(), ms_per_token(tm),
                             tm["graph_replays"] + tm["graph_captured"],
                             tm["decode_steps"])
        (ids_g, ms_g, rep, steps), (ids_e, ms_e, rep_e, _) = (runs[True],
                                                             runs[False])
        print(f"[{label}] {'image' if b64 else 'text'} request: decode "
              f"{steps} steps, graphed {ms_g:.2f} ms/token ({rep} replays), "
              f"eager {ms_e:.2f} ms/token; ids identical: {ids_g == ids_e}",
              flush=True)
        check(ids_g == ids_e, f"{label}: graphed and eager ids differ")
        check(rep == steps and rep_e == 0, f"{label}: {rep} replayed or "
              f"captured of {steps} steps graphed, {rep_e} eager")
        out.append({"image": bool(b64), "steps": steps,
                    "graphed_ms_per_token": ms_g,
                    "eager_ms_per_token": ms_e})
    return out

def ms_per_token(tm):
    """A single-request decode's ms per token, its capture left out (a
    capturing call's first step runs eagerly, then the step is recorded:
    ``capture_s``, reported on its own)."""
    n = tm["decode_steps"] - tm["graph_captured"]
    return (tm["decode_s"] - tm["capture_s"]) * 1e3 / max(n, 1)


def graph_mix(gen, calls, label):
    """The single-request generator's graph cache under a mix: every kept
    graph dropped, then ``calls`` ((name, fn) pairs, each serving one
    request) run twice in interleaved order. Prints each request's TTFT,
    ms per token, whether it found its graph kept (a hit) or captured one
    (a miss, and the capture's time), then the hit rate and the graphs
    kept with the memory they hold. Every request of the second round must
    hit. → summary."""
    import torch

    from mllm_npu_tpu_torch.models.generation import generate as gen_mod
    gen.drop_graphs()
    torch.cuda.empty_cache()
    rows = []
    for rnd in (1, 2):
        for name, fn in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
            tm = gen.last_timings
            rows.append({"round": rnd, "request": name,
                         "hit": not tm["graph_captured"],
                         "ttft_ms": tm["ttft_s"] * 1e3,
                         "capture_ms": tm["capture_s"] * 1e3,
                         "ms_per_token": ms_per_token(tm), "wall_s": wall})
            r = rows[-1]
            print(f"[{label} graph mix] round {rnd}, {name}: "
                  + ("hit" if r["hit"] else
                     f"miss, captured in {r['capture_ms']:.1f} ms")
                  + f"; ttft {r['ttft_ms']:.1f} ms, {r['ms_per_token']:.2f} "
                  f"ms/token, wall {wall:.3f} s", flush=True)
    kept = list(gen._graphs.values())
    out = {"requests": rows, "hits": sum(r["hit"] for r in rows),
           "graphs_kept": len(kept),
           "graphs_gib": sum(g.nbytes for g in kept) / 2**30,
           "budget_gib": gen_mod.DECODE_GRAPH_MEMORY_SHARE
           * torch.cuda.get_device_properties(0).total_memory / 2**30}
    print(f"[{label} graph mix] {out['hits']} hits of {len(rows)}; "
          f"{out['graphs_kept']} graphs kept holding {out['graphs_gib']:.3f} "
          f"GiB (budget {out['budget_gib']:.2f} GiB)", flush=True)
    check(all(r["hit"] for r in rows if r["round"] == 2),
          f"{label}: a request of the mix's second round captured anew")
    return out

# the batched worker (phase 4b, and int8 in phase 7): the reference worker's
# engine defaults, a concurrency limit that fills every slot twice over
WORKER = dict(num_slots=8, max_len=2048, max_prompt=1024, block_steps=16,
              batch_prompt_bucket=128)
WORKER_CONCURRENCY = 16
# tokens per request of the graph-vs-eager check and the decode timing
LONG_TOKENS = 64
# the logit rule of checks d and f: where a batched stream and the
# single-request engine's are held against each other, their logit rows
# (fp32, after the ladder) at every position up to the first divergence
# lie within this many times the control's max |delta|: the same
# request's prefill logits with K1 against K1's fp32 plain version in
# every attention, bf16 rounding alone on the same weights and inputs
LOGIT_BOUND_FACTOR = 2.0
QUESTIONS = ("What is unusual in this image?", "Describe the picture.",
             "What colour dominates?", "How many objects are there?",
             "Where was this taken?", "What is in the top left corner?",
             "Is it day or night?", "What is the texture like?",
             "Name three things you see.", "What happens next?",
             "Is there any text?", "What is the mood of the scene?",
             "What is the capital of France?", "Explain photosynthesis.",
             "Write a haiku about rivers.", "Who painted the Mona Lisa?")


def worker_traffic(n896=8, n384=4, n_text=4):
    """(label, question, b64) requests: 896×896 images (5 tiles, 339
    tokens), 384×1152 images (4 tiles, 270 tokens) and text questions, each
    image with its own seed and question."""
    out = [(f"img896_{i}", QUESTIONS[i], png_b64(896, 896, 100 + i))
           for i in range(n896)]
    out += [(f"img384x1152_{i}", QUESTIONS[8 + i], png_b64(384, 1152, 200 + i))
            for i in range(n384)]
    out += [(f"text_{i}", QUESTIONS[12 + i], "") for i in range(n_text)]
    return out


def post_worker(url, body, timeout=600):
    """One POST to the worker; → the decoded ``b"\0"``-delimited chunks."""
    import urllib.request
    req = urllib.request.Request(url + "/worker_generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        raw = r.read()
    return [json.loads(c) for c in raw.split(b"\0") if c]


class ServedWorker:
    """The port's worker (``ModelWorker`` over ``engine``) on 127.0.0.1 and
    a free port, ``--no-register``, served from a thread; it records every
    request its engine takes (the ids and host times the wire does not
    carry)."""

    def __init__(self, engine, model_name="mllm-8b",
                 concurrency=WORKER_CONCURRENCY):
        import threading

        from mllm_npu_tpu_torch.serve.worker import ModelWorker, make_server
        self.engine = engine
        self.worker = ModelWorker(
            "http://unused", "http://127.0.0.1", "smoke", model_name, engine,
            no_register=True, limit_model_concurrency=concurrency)
        self.server = make_server(self.worker, "127.0.0.1", 0)
        self.url = "http://127.0.0.1:%d" % self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.taken = []
        submit = engine.batch_engine.submit

        def recording_submit(*a, **kw):
            req = submit(*a, **kw)
            self.taken.append(req)
            return req
        engine.batch_engine.submit = recording_submit

    def request_of(self, ids):
        """The last request taken whose prompt is ``ids``."""
        import numpy as np
        for req in reversed(self.taken):
            if np.array_equal(req.input_ids, ids):
                return req
        fail("no request with that prompt was taken")

    def close(self):
        """Stop serving and the engine's drain thread: the caller's thread
        then owns ``engine.batch_engine``."""
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)
        check(not self.thread.is_alive(), "the worker's server did not stop")
        self.engine.close()


def http_burst(served, traffic, stream_label=None):
    """Every request of ``traffic`` POSTed at once, one thread each
    (``stream_label``'s with ``"stream": true``); → {label: (chunks, wall
    s)}. Fails unless every reply has error_code 0."""
    from concurrent.futures import ThreadPoolExecutor

    def one(item):
        label, q, b64 = item
        t0 = time.perf_counter()
        chunks = post_worker(served.url, {"input_text": q, "image": b64,
                                          "stream": label == stream_label})
        return label, (chunks, time.perf_counter() - t0)
    with ThreadPoolExecutor(len(traffic)) as ex:
        replies = dict(ex.map(one, traffic))
    bad = {k: [c["error_code"] for c in v[0]] for k, v in replies.items()
           if not v[0] or any(c["error_code"] != 0 for c in v[0])}
    check(not bad, f"worker replies with an error: {bad}")
    return replies


def ttft_stats(reqs):
    """min / median / max of first-token minus submit time (host clock, s)."""
    import statistics
    t = sorted(r.first_token_at - r.submitted_at for r in reqs)
    return {"min": t[0], "median": statistics.median(t), "max": t[-1]}


def single_stream(engine, q, b64):
    """The single-request engine's greedy ids for one request, and at each
    position its logits after the ladder (fp32 [V], on the card): the
    logits each greedy choice was made from. The decode step runs eagerly
    here (a replayed graph calls no Python to record with); phase 4 holds
    the graphed ids to the eager ones."""
    from mllm_npu_tpu_torch.models.generation import generate as gen_mod
    from mllm_npu_tpu_torch.models.generation import sampler
    rows, orig = [], sampler._sample

    def recording(logits):
        rows.append(logits[0].float().clone())
        return orig(logits)
    sampler._sample = gen_mod._sample = recording
    engine.generator.cuda_graph = False
    try:
        ids = engine.comprehension_ids(q, b64)
    finally:
        sampler._sample = gen_mod._sample = orig
        engine.generator.cuda_graph = True
    return [int(t) for t in ids], rows


def submit_prepared(engine, item, tokens, **sampling):
    """One prepared request (ids, patches, positions, compare mask) into a
    ContinuousBatchingEngine (``sampling``: do_sample, temperature, top_p,
    seed); → its Request."""
    import numpy as np
    ids, patches, pos, cmp = item
    kw = {}
    if patches is not None:
        kw = dict(images=patches, ids_cmp_mask=cmp, patch_positions=pos,
                  embeds_cmp_mask=np.ones((patches.shape[0],), bool))
    return engine.submit(ids, max_new_tokens=tokens, **kw, **sampling)


def recorded_stream(engine, item, tokens):
    """One prepared request alone through an idle eager
    ContinuousBatchingEngine (so in slot 0), and the logits (fp32, after
    the ladder) each of its greedy choices was made from: the prefill's
    first-token row, then slot 0's row of each decode step."""
    from mllm_npu_tpu_torch.serve import batched_engine as be_mod
    check(engine._graph is None and engine.stats()["slots_busy"] == 0,
          "recorded_stream needs an idle eager engine")
    rows, orig = [], be_mod._sample

    def recording(logits):
        rows.append(logits[0].float().clone())
        return orig(logits)
    be_mod._sample = recording
    try:
        req = submit_prepared(engine, item, tokens)
        engine.run_until_idle()
    finally:
        be_mod._sample = orig
    check(req.done and req.error is None, f"recorded request: {req.error}")
    ids = [int(t) for t in req.tokens]
    return ids, rows[:len(ids)]


def attention_control(model, prep):
    """The logit rule's control reading for one request: max |delta| of its
    prefill logits with K1 against the same forward with K1's fp32 plain
    version in every attention (bf16 rounding alone)."""
    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    port_ops.flash_attention = flash_attention_reference
    try:
        plain = prefill_logits(model, prep)
    finally:
        port_ops.flash_attention = flash_attention
    return (prefill_logits(model, prep) - plain).abs().max().item()


def logit_rule(label, batched, b_rows, single, s_rows, bound):
    """A batched stream against the single-request engine's, held on the
    logits: at every position up to the first where the ids differ (all
    of them where none does), each engine took its top logit and the two
    rows lie within ``bound`` of each other. → (identical, worst max
    |delta|, description); fails otherwise."""
    import torch
    n = min(len(batched), len(single))
    t = next((i for i in range(n) if batched[i] != single[i]), None)
    last = n - 1 if t is None else t
    worst, at = 0.0, 0
    for p in range(last + 1):
        a, b = b_rows[p], s_rows[p]
        fin = torch.isfinite(a)
        check(bool((fin == torch.isfinite(b)).all()),
              f"{label}: position {p}: the engines mask different logits")
        check(int(a.argmax()) == batched[p] and int(b.argmax()) == single[p],
              f"{label}: position {p}: a token is not its row's argmax")
        d = (a[fin] - b[fin]).abs().max().item()
        if d > worst:
            worst, at = d, p
    same = t is None and len(batched) == len(single)
    desc = ("identical ids" if t is None else
            f"first divergence at token {t}: batched {batched[t]}, single "
            f"{single[t]}") + (f"; logits max |delta| {worst:.4f} (at "
                               f"position {at} of 0..{last}), bound "
                               f"{bound:.4f}")
    check(worst <= bound, f"{label}: {desc}: beyond the bound")
    return same, worst, desc


def timed_decode(engine, items, tokens):
    """``items`` (prepared requests) through a ContinuousBatchingEngine at
    ``tokens`` each, driven from this thread: the first tick admits them
    all and dispatches the first block; the rest, to idle, is timed (host
    clock, ending in a synchronize). → (ids per request, ms per decode
    tick = one step of every slot, aggregate decode tokens/s)."""
    import torch
    reqs = [submit_prepared(engine, item, tokens) for item in items]
    engine.step()
    check(engine.stats()["slots_busy"] == len(items),
          "the first tick did not admit every request")
    torch.cuda.synchronize()
    blocks0 = engine.replays + engine.eager_blocks
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    blocks = engine.replays + engine.eager_blocks - blocks0
    check(all(r.done and r.error is None for r in reqs), "a request failed")
    # tokens computed in the window: all but each row's first (the
    # prefill's) and the first block's (run before the window)
    decoded = sum(max(len(r.tokens) - 1 - engine.block_steps, 0)
                  for r in reqs)
    return ([[int(t) for t in r.tokens] for r in reqs],
            wall * 1e3 / (blocks * engine.block_steps), decoded / wall)


def batched_engine_for(single, **kw):
    """A BatchedInferenceEngine (the worker's defaults) over the model the
    single-request engine serves: no second copy of the weights."""
    from mllm_npu_tpu_torch.serve.engine import BatchedInferenceEngine
    model = single.generator.model
    nq = model.projector.num_queries
    return BatchedInferenceEngine(
        model=model, tokenizer=single.tokenizer,
        image_transform=single.image_transform, num_img_in_tokens=nq,
        num_img_out_tokens=nq, max_new_tokens=MAX_NEW_TOKENS, device="cuda",
        **dict(WORKER, **kw))


def worker_checks(single, label, traffic, lm_cfg, stream_label):
    """Build the batched engine (its decode block captured as a CUDA graph)
    over the single engine's model, serve ``traffic`` through the worker
    at once, then two of its requests alone; checks a (error codes, the
    streamed text), b (alone = among) and e (launch counts). Returns the
    served worker (still up) and what was measured."""
    import torch

    from mllm_npu_tpu_torch.ops import quant as tq
    counters = kernel_counters()
    quant = single.generator.model.language_model.config.quantization
    per_forward = 7 * lm_cfg.num_hidden_layers + 1
    for fn in counters.values():
        fn.launches = 0
    tq.int8_matmul.prefill_launches = tq.int4_matmul.prefill_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batched = batched_engine_for(single)
    built_s = time.perf_counter() - t0
    be = batched.batch_engine
    captured = {k: fn.launches for k, fn in counters.items()}
    # the capture runs the block once eagerly (its warm-up) and records it
    # once: each counted every launch of one block
    check(be.eager_blocks == 1 and be.capture_s is not None,
          f"{label}: the decode block was not captured")
    per_block = {k: n // 2 for k, n in captured.items()}
    expect_block = dict.fromkeys(counters, 0)
    if quant != "none":
        expect_block[f"{quant}_matmul"] = per_forward * be.block_steps
    check(per_block == expect_block and all(n % 2 == 0 for n in
                                            captured.values()),
          f"{label}: launches at the capture {captured}, expected twice "
          f"{expect_block}")
    check(tq.int8_matmul.prefill_launches + tq.int4_matmul.prefill_launches
          == 0, f"{label}: the decode block ran a prefill-regime product")
    print(f"[{label} worker] engine built in {built_s:.2f} s, the decode "
          f"block ({be.B} slots x {be.block_steps} steps) captured in "
          f"{be.capture_s:.3f} s; one block launches "
          + ", ".join(f"{k} {n}" for k, n in per_block.items() if n)
          + f" (Python counts it at the capture only); static cache "
          f"{2 * be.state['k'].numel() * 2 / 2**30:.2f} GiB", flush=True)

    served = ServedWorker(batched)
    for fn in counters.values():
        fn.launches = 0
    tq.int8_matmul.prefill_launches = tq.int4_matmul.prefill_launches = 0
    replays0 = be.replays
    t0 = time.perf_counter()
    replies = http_burst(served, traffic, stream_label)
    burst_s = time.perf_counter() - t0
    replays = be.replays - replays0
    got = {k: fn.launches for k, fn in counters.items()}
    got_prefill = (tq.int8_matmul.prefill_launches,
                   tq.int4_matmul.prefill_launches)
    preps = {lab: batched._prepare_comprehension(q, b) for lab, q, b in
             traffic}
    reqs = {lab: served.request_of(preps[lab][0]) for lab, _, _ in traffic}
    n_img = sum(1 for _, _, b in traffic if b)
    n_text = len(traffic) - n_img
    L = lm_cfg.num_hidden_layers
    expect = dict.fromkeys(counters, 0)
    expect["flash_fwd"] = (L + k1_per_image(single.generator.model)) * n_img \
        + L * n_text
    prefill_expect = [0, 0]
    if quant != "none":
        # each admission's prefill (bucket > 16 rows: the prefill regime,
        # the lm_head's last row the decode one); decode only in replays
        expect[f"{quant}_matmul"] = per_forward * len(traffic)
        prefill_expect[0 if quant == "int8" else 1] = \
            (per_forward - 1) * len(traffic)
    print(f"[{label} worker] {len(traffic)} concurrent POSTs ({n_img} "
          f"image, {n_text} text, {stream_label} streamed) in {burst_s:.2f} "
          f"s, {replays} graph replays; launches counted K1 "
          f"{got['flash_fwd']}, K4 {got['int8_matmul']}, K5 "
          f"{got['int4_matmul']} (prefill regime {got_prefill[0]}/"
          f"{got_prefill[1]}), the replays' own not counted by Python"
          f"; expected {expect['flash_fwd']}, {expect['int8_matmul']}, "
          f"{expect['int4_matmul']} ({prefill_expect[0]}/"
          f"{prefill_expect[1]})", flush=True)
    check(got == expect, f"{label} worker burst: launches {got}, expected "
          f"{expect}")
    check(list(got_prefill) == prefill_expect,
          f"{label} worker burst: prefill-regime launches {got_prefill}, "
          f"expected {prefill_expect}")
    check(replays > 0, f"{label} worker burst: no graph replay")
    for lab, r in reqs.items():
        check(r.done and r.error is None and 0 < len(r.tokens)
              <= MAX_NEW_TOKENS, f"{label} {lab}: {len(r.tokens)} tokens, "
              f"error {r.error}")
    burst_ttft = ttft_stats(reqs.values())
    walls = sorted(w for _, w in replies.values())

    # b: two of the requests again through the worker with nothing else in
    # flight; the streamed one's last snapshot against its text alone
    alone = {}
    first_img = next(lab for lab, _, b in traffic if b)
    for lab in (first_img, stream_label):
        _, q, b64 = next(t for t in traffic if t[0] == lab)
        chunks = post_worker(served.url, {"input_text": q, "image": b64})
        check(len(chunks) == 1 and chunks[0]["error_code"] == 0,
              f"{label} {lab} alone: {chunks}")
        r = served.request_of(preps[lab][0])
        check(r is not reqs[lab], "the request alone was not taken")
        check(r.tokens == reqs[lab].tokens, f"{label} {lab}: ids alone "
              f"{r.tokens} differ from among {len(traffic)}: "
              f"{reqs[lab].tokens}")
        alone[lab] = {"text": chunks[0]["text"], "request": r}
    streamed = replies[stream_label][0]
    check(len(streamed) >= 2 and streamed[-1]["text"]
          == alone[stream_label]["text"],
          f"{label}: the streamed request's last snapshot "
          f"{streamed[-1]['text']!r} differs from its text "
          f"{alone[stream_label]['text']!r}")
    alone_ttft = {lab: a["request"].first_token_at
                  - a["request"].submitted_at for lab, a in alone.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label} worker] TTFT among {len(traffic)} (host, submit to "
          f"first token): min {burst_ttft['min'] * 1e3:.1f} ms, median "
          f"{burst_ttft['median'] * 1e3:.1f} ms, max "
          f"{burst_ttft['max'] * 1e3:.1f} ms; alone "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in alone_ttft.items())
          + f"; request wall (HTTP) min {walls[0]:.2f} s, median "
          f"{walls[len(walls) // 2]:.2f} s, max {walls[-1]:.2f} s; the "
          f"streamed request gave {len(streamed)} snapshots; ids alone = "
          f"among for {', '.join(alone)}; peak {peak:.2f} GiB", flush=True)
    return served, {
        "capture_s": be.capture_s, "per_block": per_block,
        "burst_s": burst_s, "replays": replays, "launches": got,
        "prefill_launches": got_prefill,
        "ttft_burst_s": burst_ttft, "ttft_alone_s": alone_ttft,
        "wall_s": {"min": walls[0], "median": walls[len(walls) // 2],
                   "max": walls[-1]},
        "peak_gib": peak, "stream_snapshots": len(streamed),
        "ids": {lab: r.tokens for lab, r in reqs.items()},
    }


def twin_of(engine, **kw):
    """A ContinuousBatchingEngine on ``engine``'s model with its settings,
    ``kw`` changed."""
    from mllm_npu_tpu_torch.serve.batched_engine import (
        ContinuousBatchingEngine)
    return ContinuousBatchingEngine(engine.model, **dict(dict(
        num_slots=engine.B, max_len=engine.max_len,
        block_steps=engine.block_steps, prompt_bucket=engine.prompt_bucket,
        max_prompt=engine.max_prompt, eos_token_id=engine.eos,
        pad_token_id=engine.pad, cache_dtype=engine.cache_dtype,
        ladder=engine.ladder), **kw))


def decode_timing(served, label, traffic, lm_cfg):
    """After the worker stops: LONG_TOKENS per request, every slot busy,
    through the worker's graphed engine and an eager twin on the same
    model; the ids must be identical (check c). → (summary, graphed
    engine, eager engine)."""
    served.close()
    graphed = served.engine.batch_engine
    eager = twin_of(graphed, cuda_graph=False)
    items = [served.engine._prepare_comprehension(q, b)
             for _, q, b in traffic]
    out = {}
    for name, eng in (("graphed", graphed), ("eager", eager)):
        ids, tick_ms, tps = timed_decode(eng, items, LONG_TOKENS)
        out[name] = {"ids": ids, "tick_ms": tick_ms, "tokens_per_s": tps}
    same = [a == b for a, b in zip(out["graphed"]["ids"],
                                   out["eager"]["ids"])]
    print(f"[{label} worker] {len(items)} requests x {LONG_TOKENS} tokens, "
          f"{graphed.B} slots busy: decode tick (one step of every slot) "
          f"graphed {out['graphed']['tick_ms']:.3f} ms, eager "
          f"{out['eager']['tick_ms']:.3f} ms; aggregate decode "
          f"{out['graphed']['tokens_per_s']:.1f} tokens/s graphed, "
          f"{out['eager']['tokens_per_s']:.1f} eager; graphed ids = eager "
          f"ids for {sum(same)} of {len(same)}", flush=True)
    check(all(same), f"{label}: graphed and eager ids differ: {same}")
    return {k: {kk: vv for kk, vv in v.items() if kk != "ids"}
            for k, v in out.items()}, graphed, eager


def profile_block(engine, single, label):
    """One tick with every slot busy (one replayed block and the previous
    block's tokens handed out) under ``torch.profiler``; → profile_call's
    tuple."""
    prompts = [single._prepare_comprehension(q, "")[0]
               for q in QUESTIONS[:engine.B]]
    reqs = [engine.submit(p, max_new_tokens=3 * engine.block_steps)
            for p in prompts]
    engine.step()                      # admit, dispatch block 1
    engine.step()                      # block 2 in flight
    replays0 = engine.replays
    prof = profile_call(engine.step)
    check(engine.replays == replays0 + 1,
          f"{label}: the profiled tick replayed "
          f"{engine.replays - replays0} blocks, not one")
    engine.run_until_idle()
    check(all(r.done and r.error is None for r in reqs), "profiled run")
    print_profile(f"{label} worker: one tick ({engine.B} slots x "
                  f"{engine.block_steps} steps)", *prof)
    return prof


TRACED_TICKS = ("block", "verify", "fused_block")


def traced_replays(tick):
    """``python3 chip_smoke.py --traced-replays <tick>``: one replayed
    tick's kernel counts, the only trace of a process of its own over
    phase 7's int8 model (the same seed): a decode block of the worker
    engine (``block``), a verify tick of its speculative (k = 4) twin
    (``verify``), or a block after the projections are fused in place
    (``fused_block``). Prints one JSON line. (Late in the long main process
    the tracer lost 1-3 of a replayed block's ~41k records in some runs,
    and the third trace of one process 11% of its records once; every
    first trace of a fresh process held them all.)"""
    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    from mllm_npu_tpu_torch.utils.weights import fuse_llama_projections_
    check(tick in TRACED_TICKS, f"--traced-replays takes one of "
          f"{TRACED_TICKS}")
    single = build_engine(device="cuda", seed=0, fake_tokenizer=True,
                          max_new_tokens=MAX_NEW_TOKENS, quantize_int8=True)
    kw, label = {}, "int8"
    if tick == "verify":
        kw, label = dict(speculative_k=4, speculative_ngram=SPEC_NGRAM), \
            "int8 speculative k=4"
    elif tick == "fused_block":
        fuse_llama_projections_(single.generator.model.language_model)
        label = "int8 fused"
    prof = profile_block(worker_engine(single, **kw), single,
                         f"{label} (traced alone)")
    print(json.dumps({"traced": {
        k: sum(n for name, n in prof[3].items() if k in name)
        for k in ("qmm_decode", "qmm_prefill", "qmm_split_sum")}}))


def traced_replay_checks(lm_cfg, block_steps):
    """Run traced_replays once for each tick, each in a child process of
    its own (one after the other, each exiting before the next starts),
    and hold their counts: a block 225 × 16 ``qmm_decode`` events and no
    prefill kernel; a verify tick 225 ``qmm_prefill`` (M = 40) and no
    decode kernel; a fused block 129 × 16. → the counts."""
    got = {}
    for tick in TRACED_TICKS:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--traced-replays", tick],
                              capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines()[:-1]:
            if line.startswith("[profile]"):
                print(line, flush=True)
        check(proc.returncode == 0, f"traced replays ({tick}): exit "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        got[tick] = json.loads(proc.stdout.strip().splitlines()[-1])[
            "traced"]
    L = lm_cfg.num_hidden_layers
    want = {"block": {"qmm_decode": (7 * L + 1) * block_steps,
                      "qmm_prefill": 0},
            "verify": {"qmm_decode": 0, "qmm_prefill": 7 * L + 1},
            "fused_block": {"qmm_decode": (4 * L + 1) * block_steps,
                            "qmm_prefill": 0}}
    print(f"[int8 traced] one replay each, traced in a process of its own: "
          f"decode block {got['block']['qmm_decode']} qmm_decode (expected "
          f"{want['block']['qmm_decode']}); verify tick "
          f"{got['verify']['qmm_prefill']} qmm_prefill (expected "
          f"{want['verify']['qmm_prefill']}, M = 40) and "
          f"{got['verify']['qmm_split_sum']} split-K sums; fused block "
          f"{got['fused_block']['qmm_decode']} qmm_decode (expected "
          f"{want['fused_block']['qmm_decode']})", flush=True)
    for tick, kernels in want.items():
        for k, n in kernels.items():
            check(got[tick][k] == n, f"traced {tick}: {got[tick][k]} {k} "
                  f"events, expected {n}")
    return got


def decode_attention_cost(engine, lm_cfg, tick_ms):
    """``decode_attention`` at the decode block's shapes (one layer: every
    slot's query over the whole static cache, as stored) on CUDA events,
    × layers, against one tick; and that call once under the allocator's
    peak and once under ``torch.profiler``: it reads the cache in place,
    so the memory it takes beyond its inputs (fp32 logits of every query
    head, a few times over) stays under half of one layer's K, where a copy
    of K or V would take all of it and the fp32 widening four times it;
    and none of its five longest kernels is a copy as long as the least a
    copy of that K could take (reading and writing it at the card's
    peak). Then the same call over an fp8 copy of that layer's cache,
    reported only: an 8-bit cache is widened to bf16 before the products
    (as the reference does), a copy of K and V each call."""
    import torch

    from mllm_npu_tpu_torch.ops import decode_attention
    st = engine.state
    k, v = st["k"][0], st["v"][0]
    B, H, D = engine.B, lm_cfg.num_attention_heads, lm_cfg.head_dim
    L = lm_cfg.num_hidden_layers
    k_bytes = k.numel() * k.element_size()
    with torch.inference_mode():
        q = torch.randn(B, 1, H, D, device=k.device).bfloat16()
        cur = torch.randn(B, 1, lm_cfg.num_key_value_heads, D,
                          device=k.device).bfloat16()
        mask = torch.ones(B, 1, 1, k.shape[1], dtype=torch.bool,
                          device=k.device)

        def call():
            return decode_attention(q, k, v, mask, k_cur=cur, v_cur=cur)
        attn = time_ms(call) * L
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        prof = profile_call(call)
        k8, v8 = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)

        def call8():
            return decode_attention(q, k8, v8, mask, k_cur=cur, v_cur=cur)
        attn8 = time_ms(call8) * L
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call8()
        torch.cuda.synchronize()
        extra8 = torch.cuda.max_memory_allocated() - base
        del k8, v8
    copy_ms = 2 * k_bytes / H100_BYTES_PER_S * 1e3
    copies = [(n, t / 1e3) for n, t in prof[2] if "copy" in n.lower()
              and t / 1e3 >= copy_ms]
    print(f"[worker] decode_attention over the [{B}, {engine.max_len}] "
          f"static cache ({k.dtype}, as stored): {attn:.3f} ms a tick ({L} "
          f"layers, {100 * attn / tick_ms:.1f}% of the graphed tick); one "
          f"layer's call allocates {extra / 2**20:.2f} MiB beyond its inputs "
          f"(K alone {k_bytes / 2**20:.1f} MiB); its kernels: "
          + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in prof[2]),
          flush=True)
    print(f"[worker] decode_attention over an fp8 copy of that cache: "
          f"{attn8:.3f} ms a tick; one layer's call allocates "
          f"{extra8 / 2**20:.2f} MiB beyond its inputs (the bf16 widening "
          f"of K and V: {2 * k_bytes / 2**20:.1f} MiB)", flush=True)
    check(extra < 0.5 * k_bytes, f"decode_attention allocated {extra} "
          f"bytes beyond its inputs: a copy of the cache?")
    check(not copies, f"decode_attention ran cache-sized copies: {copies}")
    return {"attention_ms_per_tick": attn, "extra_bytes": extra,
            "top_kernels": prof[2], "fp8_attention_ms_per_tick": attn8,
            "fp8_extra_bytes": extra8}


def single_engine_check(single, eager, label, traffic, labels, ids_of):
    """Check d: each of ``labels`` through the single-request engine and,
    alone, through the eager batched twin, whose ids must equal
    ``ids_of[label]`` (the graphed worker's among its burst); the two held
    by the logit rule, its bound LOGIT_BOUND_FACTOR × the largest control
    reading among these requests. → summary."""
    reqs = {lab: (q, b) for lab, q, b in traffic if lab in labels}
    preps = {lab: single._prepare_comprehension(q, b)
             for lab, (q, b) in reqs.items()}
    control = {lab: attention_control(single.generator.model, preps[lab])
               for lab in labels}
    bound = LOGIT_BOUND_FACTOR * max(control.values())
    print(f"[check] {label} logit rule: control max |delta| (K1 vs its fp32 "
          f"plain version, prefill logits) "
          + ", ".join(f"{k} {v:.4f}" for k, v in control.items())
          + f"; bound {bound:.4f}", flush=True)
    identical, worst = 0, {}
    for lab in labels:
        single_ids, s_rows = single_stream(single, *reqs[lab])
        ids, b_rows = recorded_stream(eager, preps[lab], MAX_NEW_TOKENS)
        check(ids == ids_of[lab], f"{label} {lab}: eager ids alone {ids} "
              f"differ from the graphed worker's {ids_of[lab]}")
        same, worst[lab], desc = logit_rule(f"{label} {lab}", ids, b_rows,
                                            single_ids, s_rows, bound)
        identical += same
        print(f"[check] {label} worker vs single-request engine, {lab}: "
              f"{desc}", flush=True)
    print(f"[check] {label} worker streams identical to the single-request "
          f"engine's: {identical} of {len(labels)}", flush=True)
    return {"control": control, "bound": bound, "max_abs_delta": worst,
            "identical": identical}


def chunked_prefix_check(single, graphed, eager):
    """Check f: a --prefill-chunk 128 --prefix-cache 4 engine serves four
    text requests that share a 512-word preamble (one at a time to
    admission, as the engine admits chunked prefills): at least 3 hits and
    1536 tokens saved. Its eager twin then serves each alone (the same
    hits, the same ids) and its logit rows are held by the logit rule
    against the monolithic eager engine's and the single-request
    engine's; the graphed monolithic engine's ids equal the eager one's."""
    import numpy as np
    rs = np.random.RandomState(7)
    preamble = " ".join(rs.choice(WORDS, 512))
    texts = [f"{preamble} {q}" for q in QUESTIONS[12:16]]
    model = single.generator.model
    eng = twin_of(graphed, prefill_chunk=128, prefix_cache=4)
    preps = [single._prepare_comprehension(t, "") for t in texts]
    reqs = [eng.submit(p[0], max_new_tokens=MAX_NEW_TOKENS) for p in preps]
    eng.run_until_idle()
    st = eng.stats()["prefix_cache"]
    check(all(r.done and r.error is None for r in reqs), "chunked requests")
    check(st["hits"] >= 3 and st["tokens_saved"] >= 1536,
          f"prefix cache: {st}")
    mono = [submit_prepared(graphed, p, MAX_NEW_TOKENS) for p in preps]
    graphed.run_until_idle()
    check(all(r.done and r.error is None for r in mono), "monolithic requests")
    twin = twin_of(eng, prefill_chunk=128, prefix_cache=4, cuda_graph=False)
    control = [attention_control(model, p) for p in preps]
    bound = LOGIT_BOUND_FACTOR * max(control)
    identical = {"monolithic": 0, "single": 0}
    worst = {"monolithic": 0.0, "single": 0.0}
    for i, (t, p) in enumerate(zip(texts, preps)):
        ids, rows = recorded_stream(twin, p, MAX_NEW_TOKENS)
        check(ids == reqs[i].tokens, f"prefix request {i}: the eager "
              f"chunked ids alone {ids} differ from the graphed engine's "
              f"among four {reqs[i].tokens}")
        m_ids, m_rows = recorded_stream(eager, p, MAX_NEW_TOKENS)
        check(m_ids == mono[i].tokens, f"prefix request {i}: the eager "
              f"monolithic ids {m_ids} differ from the graphed engine's "
              f"{mono[i].tokens}")
        s_ids, s_rows = single_stream(single, t, "")
        for name, ref_ids, ref_rows in (("monolithic", m_ids, m_rows),
                                        ("single", s_ids, s_rows)):
            same, d, desc = logit_rule(f"prefix request {i} (chunked vs "
                                       f"{name})", ids, rows, ref_ids,
                                       ref_rows, bound)
            identical[name] += same
            worst[name] = max(worst[name], d)
            print(f"[check] prefix request {i}, chunked vs {name}: {desc}",
                  flush=True)
    check(twin.stats()["prefix_cache"]["hits"] >= 3,
          f"the eager chunked twin: {twin.stats()['prefix_cache']}")
    print(f"[worker] chunked (128) + prefix cache (4) engine, 4 text "
          f"requests with a 512-word preamble ({len(preps[0][0])} tokens): "
          f"prefix cache {st}; control max |delta| "
          + ", ".join(f"{c:.4f}" for c in control)
          + f", bound {bound:.4f}; the chunked ids equal the monolithic "
          f"engine's for {identical['monolithic']} of 4 (logits max |delta| "
          f"{worst['monolithic']:.4f}) and the single-request engine's for "
          f"{identical['single']} of 4 ({worst['single']:.4f}); capture "
          f"{eng.capture_s:.3f} s", flush=True)
    return {"prefix_cache": st, "control": control, "bound": bound,
            "identical": identical, "max_abs_delta": worst}


def worker_phase(single, lm_cfg):
    """Phase 4b on the bf16 model of phases 2-4."""
    import torch
    traffic = worker_traffic()
    served, summary = worker_checks(single, "bf16", traffic, lm_cfg,
                                    stream_label="text_1")
    # c and the timing, the worker stopped
    mixed = [t for t in traffic if t[0].startswith("img896")][:4] + \
        [t for t in traffic if t[0].startswith("text")]
    timing, graphed, eager = decode_timing(served, "bf16", mixed, lm_cfg)
    summary["decode"] = timing
    # d: the worker's ids against the single-request engine's on the same
    # card, both image shapes and two texts
    summary["single_engine"] = single_engine_check(
        single, eager, "bf16", traffic,
        ("img896_0", "img384x1152_0", "text_0", "text_2"), summary["ids"])
    summary["chunked_prefix"] = chunked_prefix_check(single, graphed, eager)
    summary["profile"] = profile_block(graphed, single, "bf16")[:3]
    summary["decode_attention"] = decode_attention_cost(
        graphed, lm_cfg, timing["graphed"]["tick_ms"])
    del served, graphed, eager
    gc.collect()
    torch.cuda.empty_cache()
    summary.pop("ids")
    return summary


def int8_worker_phase(single, lm_cfg):
    """The int8 sub-run of phase 7: 4 image and 4 text requests at once
    through the worker over phase 7's int8 model (checks a, b and e), the
    graphed and eager decode timing (check c), an image and a text against
    the single-request int8 engine (check d), and one replayed tick under
    the profiler."""
    import torch
    traffic = worker_traffic(n896=4, n384=0, n_text=4)
    served, summary = worker_checks(single, "int8", traffic, lm_cfg,
                                    stream_label="text_1")
    timing, graphed, eager = decode_timing(served, "int8", traffic, lm_cfg)
    summary["decode"] = timing
    summary["single_engine"] = single_engine_check(
        single, eager, "int8", traffic, ("img896_0", "text_0"),
        summary["ids"])
    # one replayed tick under the profiler: the busy share (its K4 events
    # are counted by traced_replay_checks, in a process of its own)
    prof = profile_block(graphed, single, "int8")
    summary["profile"] = prof[:3]
    del served, graphed, eager
    gc.collect()
    torch.cuda.empty_cache()
    summary.pop("ids")
    return summary


# -- phase 4c: sampled, speculative, fp8/f32-cache and fused serving ------
# speculation in the worker at these k (3-gram prompt lookup); tokens per
# request of phase 4c's graphed (timed) runs and of its eager, alone and
# recorded runs (held against a graphed run's first tokens)
SPEC_KS = (4, 63)
SPEC_NGRAM = 3
SPEC_TOKENS = 64
C_TOKENS = 32
# the sampled rows of check c: temperature, top-p, seeds 1-4
SAMPLED = dict(do_sample=True, temperature=0.7, top_p=0.9)
# check c's distribution test: draws, rows a call, the nucleus's top ids
# binned alone, and the least p-value a chi-square may give
DRAWS, DRAW_ROWS, CHI2_TOP, CHI2_P_MIN = 1 << 16, 1024, 32, 1e-3
# the reference's bound on fp8 storage (tests/test_batched_engine.py:
# 689-716): decode_attention's relative RMS error against a finer cache
FP8_RMS_BOUND = 0.08


def mixed_items(single):
    """The worker's mixed traffic: 4 images of 896×896 and 4 text questions,
    prepared (ids, tiles, positions, compare mask)."""
    traffic = worker_traffic(n896=4, n384=0, n_text=4)
    return traffic, [single._prepare_comprehension(q, b)
                     for _, q, b in traffic]


def timed_ticks(engine, items, tokens, sampling=None):
    """``items`` through ``engine`` (every slot busy) at ``tokens`` each,
    driven from this thread: the first tick admits them all; the rest, to
    idle, is timed (host clock, ending in a synchronize). → dict: ids,
    ms per tick, decode tokens/s, tokens per busy row and tick, and the
    acceptance of proposals (speculative engines)."""
    import torch
    reqs = [submit_prepared(engine, it, tokens,
                            **(sampling[i] if sampling else {}))
            for i, it in enumerate(items)]
    engine.step()
    check(engine.stats()["slots_busy"] == len(items),
          "the first tick did not admit every request")
    torch.cuda.synchronize()
    first = int(engine._emitted.sum())      # the first tick, before t0
    ticks0 = engine.replays + engine.eager_blocks
    rt0, te0 = engine.row_ticks, engine.tokens_emitted
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = engine.replays + engine.eager_blocks - ticks0
    check(all(r.done and r.error is None for r in reqs), "a request failed")
    rows, toks = engine.row_ticks - rt0, engine.tokens_emitted - te0
    out = {"ids": [[int(t) for t in r.tokens] for r in reqs],
           "tick_ms": wall * 1e3 / ticks, "ticks": ticks,
           # one step of every slot: a verify tick, or a block's step
           "step_ms": wall * 1e3 / ticks / (
               1 if engine.speculative_k else engine.block_steps),
           "tokens_per_s": (toks - first) / wall,
           "tokens_per_row_tick": toks / rows}
    if engine.speculative_k:
        out["acceptance"] = (toks - rows) / (engine.speculative_k * rows)
    return out


def recorded_spec_stream(engine, item, tokens):
    """recorded_stream for an idle eager speculative engine: one request
    alone (slot 0); the logits (fp32, after the ladder) each emitted token
    was chosen from: the prefill's row, then the kept rows of each verify
    window."""
    from mllm_npu_tpu_torch.serve import batched_engine as be_mod
    check(engine._graph is None and engine.stats()["slots_busy"] == 0,
          "recorded_spec_stream needs an idle eager engine")
    rows, window, orig, tick = [], [], be_mod._sample, engine._tick

    def recording(logits):
        if logits.ndim == 2:
            rows.append(logits[0].float().clone())
        else:
            window[:] = [logits[0].float().clone()]
        return orig(logits)

    def recorded_tick():
        tick()
        rows.extend(window[0][:int(engine._emitted[0].sum())])
    be_mod._sample, engine._tick = recording, recorded_tick
    try:
        req = submit_prepared(engine, item, tokens)
        engine.run_until_idle()
    finally:
        be_mod._sample, engine._tick = orig, tick
    check(req.done and req.error is None, f"recorded request: {req.error}")
    ids = [int(t) for t in req.tokens]
    return ids, rows[:len(ids)]


def logit_control(single, traffic, labels):
    """The logit rule's bound for ``labels``: LOGIT_BOUND_FACTOR × the
    largest control reading (phase 4b's rule)."""
    preps = {lab: single._prepare_comprehension(q, b)
             for lab, q, b in traffic if lab in labels}
    control = {lab: attention_control(single.generator.model, p)
               for lab, p in preps.items()}
    return preps, control, LOGIT_BOUND_FACTOR * max(control.values())


def spec_batched_check(plain_graphed, plain_eager, items, plain_tps, rule):
    """Check a: the worker's engine with speculation (k = 4 and 63) on the
    mixed traffic, graphed and eager (identical ids), a request alone
    (its ids among 8), and two requests alone through the eager engine
    held against the non-speculative eager engine by the logit rule."""
    preps, control, bound = rule
    labels = tuple(preps)
    plain_rows = {lab: recorded_stream(plain_eager, preps[lab], C_TOKENS)
                  for lab in labels}
    out = {"control": control, "bound": bound}
    for k in SPEC_KS:
        graphed = twin_of(plain_graphed, speculative_k=k,
                          speculative_ngram=SPEC_NGRAM)
        eager = twin_of(plain_graphed, speculative_k=k,
                        speculative_ngram=SPEC_NGRAM, cuda_graph=False)
        runs = {name: timed_ticks(eng, items, SPEC_TOKENS if name ==
                                  "graphed" else C_TOKENS)
                for name, eng in (("graphed", graphed), ("eager", eager))}
        n = min(len(runs["eager"]["ids"][0]), len(runs["graphed"]["ids"][0]))
        same = [a[:len(b)] == b for a, b in zip(runs["graphed"]["ids"],
                                                runs["eager"]["ids"])]
        check(all(same), f"speculative k={k}: graphed and eager ids differ: "
              f"{same}")
        alone = timed_ticks(graphed, items[:1], C_TOKENS)["ids"][0]
        check(alone == runs["graphed"]["ids"][0][:len(alone)],
              f"speculative k={k}: the request alone {alone} differs from "
              f"among 8")
        rule = {}
        for lab in labels:
            ids, rows = recorded_spec_stream(eager, preps[lab], C_TOKENS)
            rule[lab] = logit_rule(f"speculative k={k} {lab} vs plain", ids,
                                   rows, *plain_rows[lab], bound)[1:]
            print(f"[check] speculative k={k} worker vs the plain worker, "
                  f"{lab}: {rule[lab][1]}", flush=True)
        g = runs["graphed"]
        print(f"[spec worker] k={k}: {len(items)} requests x {SPEC_TOKENS} "
              f"tokens: {g['tokens_per_row_tick']:.3f} tokens per busy row "
              f"and verify tick (acceptance {100 * g['acceptance']:.1f}% of "
              f"proposals), verify tick graphed {g['tick_ms']:.3f} ms, "
              f"eager {runs['eager']['tick_ms']:.3f} ms; aggregate decode "
              f"{g['tokens_per_s']:.1f} tokens/s graphed (without "
              f"speculation {plain_tps:.1f}), "
              f"{runs['eager']['tokens_per_s']:.1f} eager; graphed = eager "
              f"over {n} tokens a request; capture {graphed.capture_s:.3f} s",
              flush=True)
        out[f"k{k}"] = {"graphed": {kk: v for kk, v in g.items()
                                    if kk != "ids"},
                        "eager": {kk: v for kk, v in runs["eager"].items()
                                  if kk != "ids"},
                        "capture_s": graphed.capture_s,
                        "logit_rule": {lab: r[0] for lab, r in rule.items()}}
        if k == SPEC_KS[0]:
            out["k4_ids"] = runs["graphed"]["ids"]
        else:
            out["ladder_burst"] = ladder_burst(graphed, plain_graphed)
        del graphed, eager
    return out


def ladder_burst(spec, plain):
    """The forced image ladder through the k = 63 engine: 8 text prompts
    ending in ``<img>``; after the prefill's first forced token one verify
    tick emits the other 64 (the chain and ``</img>``) of every row, the
    ids those of the plain engine, which takes 64 steps for them."""
    import numpy as np
    import torch
    ladder = spec.ladder.ids
    n = len(ladder) - 1                  # the forced tokens after <img>
    items = [(np.asarray(list(range(100 + 7 * i, 112 + 7 * i)) + [ladder[0]],
                         np.int32), None, None, None) for i in range(spec.B)]
    out = {}
    for name, eng in (("speculative", spec), ("plain", plain)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [submit_prepared(eng, it, n) for it in items]
        ticks0 = eng.replays + eng.eager_blocks
        eng.run_until_idle()
        torch.cuda.synchronize()
        out[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                     "ticks": eng.replays + eng.eager_blocks - ticks0,
                     "ids": [r.tokens for r in reqs]}
        check(all(r.tokens[:n] == list(ladder[1:]) for r in reqs),
              f"ladder burst ({name}): a row did not emit the forced ladder")
    check(out["speculative"]["ids"] == out["plain"]["ids"],
          "ladder burst: the speculative ids differ from the plain ones")
    check(out["speculative"]["ticks"] == 1, f"ladder burst: "
          f"{out['speculative']['ticks']} verify ticks, expected 1")
    print(f"[spec worker] ladder burst: {spec.B} rows x {n} forced tokens "
          f"in {out['speculative']['ticks']} verify tick (k="
          f"{spec.speculative_k}), {out['speculative']['ms']:.1f} ms with "
          f"the admissions; the plain engine {out['plain']['ticks']} blocks, "
          f"{out['plain']['ms']:.1f} ms; the same ids", flush=True)
    return {name: {k: v for k, v in o.items() if k != "ids"}
            for name, o in out.items()}


def spec_single_check(single, traffic, rule):
    """Check b: the single-request engine with speculation (k = 4) on an
    image and a text request against the same engine without: verify
    forwards per token, ms per token, and the ids equal up to the first
    divergence, where the plain engine's logit for the speculative token
    lies within the logit rule's bound of its top logit."""
    import copy

    from mllm_npu_tpu_torch.models.generation.generate import MLLMGenerator
    gen = single.generator
    spec = copy.copy(single)
    spec.generator = MLLMGenerator(gen.model, sampling=gen.sampling,
                                   ladder=gen.ladder, speculative_k=4,
                                   speculative_ngram=SPEC_NGRAM)
    preps, control, bound = rule
    labels = tuple(preps)
    out = {"control": control, "bound": bound}
    for lab, q, b in traffic:
        if lab not in labels:
            continue
        plain_ids, rows = single_stream(single, q, b)
        tp = dict(gen.last_timings)
        ids = [int(t) for t in spec.comprehension_ids(q, b)]
        ts = dict(spec.generator.last_timings)
        t = next((i for i, (a, c) in enumerate(zip(ids, plain_ids))
                  if a != c), None)
        gap = 0.0
        if t is not None:
            gap = (rows[t].max() - rows[t][ids[t]]).item()
            check(gap <= bound, f"single-request speculation {lab}: first "
                  f"divergence at {t} ({ids[t]} vs {plain_ids[t]}), the "
                  f"plain engine's logit gap {gap:.4f} beyond {bound:.4f}")
        n_tok = len(ids) - 1
        out[lab] = {"verify_per_token": ts["decode_steps"] / n_tok,
                    "ms_per_token": ts["decode_s"] * 1e3 / n_tok,
                    "plain_ms_per_token": tp["decode_s"] * 1e3 / n_tok,
                    "first_divergence": t, "logit_gap": gap}
        print(f"[spec single] {lab}: {ts['decode_steps']} verify forwards for "
              f"{n_tok} tokens ({out[lab]['verify_per_token']:.3f} a token); "
              f"decode {out[lab]['ms_per_token']:.2f} ms/token against "
              f"{out[lab]['plain_ms_per_token']:.2f} without speculation; "
              + ("identical ids" if t is None else
                 f"first divergence at token {t}, the plain engine's logit "
                 f"gap {gap:.4f} (bound {bound:.4f})"), flush=True)
    return out


def sampling_check(single, plain_graphed, items, plain_ids, spec_ids):
    """Check c: 4 sampled rows (2 images, 2 texts; temperature 0.7, top-p
    0.9, seeds 1-4) among 4 greedy ones: the greedy rows are the greedy
    engine's; the sampled rows graphed = eager and alone = among 8; with
    speculation (k = 4) the greedy rows are the greedy speculative
    engine's and a sampled row emits one token a tick outside the ladder.
    Then ``sample_rows`` alone: 2^16 draws over the full vocab."""
    sampled = (0, 1, 4, 5)
    sampling = [dict(SAMPLED, seed=sampled.index(i) + 1) if i in sampled
                else {} for i in range(len(items))]
    graphed = twin_of(plain_graphed, enable_sampling=True)
    eager = twin_of(plain_graphed, enable_sampling=True, cuda_graph=False)
    timed = timed_ticks(graphed, items, SPEC_TOKENS, sampling)
    g = timed["ids"]
    e = timed_ticks(eager, items, C_TOKENS, sampling)["ids"]
    check(all(a[:len(b)] == b for a, b in zip(g, e)),
          "sampled engine: graphed and eager ids differ")
    for i in range(len(items)):
        if i not in sampled:
            check(g[i] == plain_ids[i][:len(g[i])], f"greedy row {i} among "
                  f"sampled ones differs from the greedy engine's")
    alone = timed_ticks(graphed, [items[4]], C_TOKENS, [sampling[4]])["ids"]
    check(alone[0] == g[4][:len(alone[0])],
          "a sampled request alone differs from among 8")
    del graphed, eager
    spec = twin_of(plain_graphed, enable_sampling=True, speculative_k=4,
                   speculative_ngram=SPEC_NGRAM)
    reqs = [submit_prepared(spec, it, C_TOKENS, **sampling[i])
            for i, it in enumerate(items)]
    ladder = set(spec.ladder.ids[1:])
    seen = [0] * len(reqs)
    burst_ok = True
    while spec.step():
        for i, r in enumerate(reqs):
            new = r.tokens[seen[i]:]
            if i in sampled and seen[i] and len(new) > 1:
                burst_ok &= all(t in ladder for t in new[:-1])
            seen[i] = len(r.tokens)
    check(all(r.done and r.error is None for r in reqs), "spec sampled run")
    check(burst_ok, "a sampled row emitted more than one token a tick "
          "outside the ladder")
    for i in range(len(items)):
        if i not in sampled:
            check(reqs[i].tokens == spec_ids[i][:len(reqs[i].tokens)],
                  f"greedy row {i} among sampled ones under speculation "
                  f"differs from the greedy speculative engine's")
    del spec
    dist = sampling_distribution(single.generator.model.language_model
                                 .config.vocab_size)
    print(f"[sampling] 4 sampled rows (t {SAMPLED['temperature']}, top-p "
          f"{SAMPLED['top_p']}, seeds 1-4) among 4 greedy: greedy rows = the "
          f"greedy engine's, graphed = eager, alone = among 8; with "
          f"speculation k=4 greedy rows unchanged and sampled rows one token "
          f"a tick outside the ladder; {dist['draws']} draws over "
          f"{dist['vocab']} ids: nucleus {dist['nucleus']} ids, none drawn "
          f"outside, chi-square over its top {CHI2_TOP} and the rest "
          f"{dist['chi2']:.2f} (df {CHI2_TOP}), p {dist['p']:.4f}; "
          f"{dist['ms_per_call']:.3f} ms per sample_rows call of "
          f"{DRAW_ROWS} rows; the sampling engine's decode step (8 busy) "
          f"{timed['step_ms']:.3f} ms, {timed['tokens_per_s']:.1f} tokens/s",
          flush=True)
    return dict(dist, step_ms=timed["step_ms"],
                tokens_per_s=timed["tokens_per_s"])


def sampling_distribution(vocab):
    """``sample_rows`` on the card: DRAWS draws (token indices 0..DRAWS-1
    under one seed) of one row of seeded logits over the vocab at
    (0.7, 0.9): none outside the nucleus, and a chi-square over the
    nucleus's top CHI2_TOP ids and the rest of it at p >= CHI2_P_MIN."""
    import torch

    from mllm_npu_tpu_torch.models.generation.sampler import (
        NEG_INF, nucleus_filter, sample_rows)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    logits = torch.randn(1, vocab, device=dev, generator=g) * 3.0
    full = lambda x, dt=torch.float32: torch.full((DRAW_ROWS,), x, dtype=dt,
                                                  device=dev)
    temp, top_p = full(SAMPLED["temperature"]), full(SAMPLED["top_p"])
    filtered = nucleus_filter(logits, temp[:1], top_p[:1])[0]
    support = filtered > NEG_INF / 2
    probs = torch.softmax(filtered.double(), dim=-1)
    lg = logits.expand(DRAW_ROWS, vocab)
    draw = lambda i: sample_rows(
        lg, full(77, torch.long), torch.arange(i, i + DRAW_ROWS, device=dev),
        temp, top_p, full(True, torch.bool))
    ms = time_ms(lambda: draw(0), iters=5)
    draws = torch.cat([draw(i) for i in range(0, DRAWS, DRAW_ROWS)])
    check(bool(support[draws].all()), "a draw outside the nucleus")
    top = torch.argsort(probs, descending=True)[:CHI2_TOP]
    counts = torch.bincount(draws, minlength=vocab).double()
    c = torch.cat([counts[top], (DRAWS - counts[top].sum())[None]])
    p = torch.cat([probs[top], (1 - probs[top].sum())[None]]) * DRAWS
    stat = float(((c - p) ** 2 / p).sum())
    pval = float(torch.special.gammaincc(
        torch.tensor(CHI2_TOP / 2.0, dtype=torch.float64),
        torch.tensor(stat / 2.0, dtype=torch.float64)))
    check(pval >= CHI2_P_MIN, f"sampled draws: chi-square {stat:.2f}, "
          f"p {pval:.2e} below {CHI2_P_MIN}")
    return {"draws": DRAWS, "vocab": vocab, "nucleus": int(support.sum()),
            "chi2": stat, "p": pval, "ms_per_call": ms}


def cache_dtype_check(single, plain_graphed, plain_eager, items, plain_ids,
                      rule):
    """Check d: the same 8 requests with the fp8 and the f32 static cache,
    graphed and eager (identical ids): memory, cache bytes and ms per tick;
    decode_attention with the fp8 cache against the bf16 cache on the
    bf16 worker's own filled cache; two requests' logit rows against the
    bf16 cache's (f32: the logit rule; fp8: printed)."""
    import torch

    from mllm_npu_tpu_torch.models.language_models.llama import to_cache
    from mllm_npu_tpu_torch.ops import decode_attention
    preps, control, bound = rule
    labels = tuple(preps)
    bf16_rows = {lab: recorded_stream(plain_eager, preps[lab], C_TOKENS)
                 for lab in labels}
    # fp8 against bf16 on the worker's filled cache (the mixed run's keys)
    st = plain_graphed.state
    gen = torch.Generator(device=st["k"].device)
    gen.manual_seed(5)
    lm_cfg = single.generator.model.language_model.config
    mask = st["key_valid"][:, None, None, :]
    worst = 0.0
    with torch.inference_mode():
        for layer in (0, lm_cfg.num_hidden_layers // 2,
                      lm_cfg.num_hidden_layers - 1):
            k, v = st["k"][layer], st["v"][layer]
            q = torch.randn(plain_graphed.B, 1, lm_cfg.num_attention_heads,
                            lm_cfg.head_dim, device=k.device,
                            generator=gen).bfloat16()
            ref = decode_attention(q, k, v, mask).float()
            f8 = decode_attention(q, to_cache(k, torch.float8_e4m3fn),
                                  to_cache(v, torch.float8_e4m3fn),
                                  mask).float()
            rms = ((f8 - ref).pow(2).mean().sqrt()
                   / ref.pow(2).mean().sqrt()).item()
            worst = max(worst, rms)
    check(worst < FP8_RMS_BOUND, f"fp8 cache: decode_attention relative RMS "
          f"{worst:.4f} against the bf16 cache, beyond {FP8_RMS_BOUND}")
    bf16_bytes = 2 * st["k"].numel() * st["k"].element_size()
    out = {"fp8_attention_rel_rms": worst, "bf16_cache_bytes": bf16_bytes,
           "control": control, "bound": bound}
    for name, dt in (("fp8", torch.float8_e4m3fn), ("f32", torch.float32)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        graphed = twin_of(plain_graphed, cache_dtype=dt)
        eager = twin_of(plain_graphed, cache_dtype=dt, cuda_graph=False)
        g = timed_ticks(graphed, items, SPEC_TOKENS)
        e = timed_ticks(eager, items, C_TOKENS)
        check(all(a[:len(b)] == b for a, b in zip(g["ids"], e["ids"])),
              f"{name} cache: graphed and eager ids differ")
        peak = torch.cuda.max_memory_allocated() / 2**30
        nbytes = 2 * graphed.state["k"].numel() \
            * graphed.state["k"].element_size()
        rule, identical = {}, 0
        for lab in labels:
            ids, rows = recorded_stream(eager, preps[lab], C_TOKENS)
            same, d, desc = logit_rule(
                f"{name} cache {lab} vs bf16 cache", ids, rows,
                *bf16_rows[lab], bound if name == "f32" else float("inf"))
            rule[lab] = d
            identical += same
            print(f"[check] {name} cache vs bf16 cache, {lab}: {desc}"
                  + ("" if name == "f32" else " (not gated)"), flush=True)
        same_bf16 = sum(a == b[:len(a)] for a, b in zip(g["ids"], plain_ids))
        print(f"[cache {name}] static cache {nbytes / 2**30:.3f} GiB (bf16 "
              f"{bf16_bytes / 2**30:.3f}); peak {peak:.2f} GiB with the "
              f"graphed and eager engines; decode step of 8 busy slots "
              f"graphed {g['step_ms']:.3f} ms, eager {e['step_ms']:.3f} ms; "
              f"{g['tokens_per_s']:.1f} "
              f"tokens/s graphed; graphed = eager; {same_bf16} of "
              f"{len(items)} streams identical to the bf16 cache's",
              flush=True)
        out[name] = {"cache_bytes": nbytes, "peak_gib": peak,
                     "step_ms": g["step_ms"], "eager_step_ms": e["step_ms"],
                     "tokens_per_s": g["tokens_per_s"],
                     "logit_max_abs_delta": rule,
                     "identical_to_bf16": same_bf16}
        del graphed, eager
    print(f"[check] fp8 cache: decode_attention on the bf16 worker's filled "
          f"cache, relative RMS against the bf16 cache {worst:.4f} (bound "
          f"{FP8_RMS_BOUND})", flush=True)
    return out


def worker_engine(single, **kw):
    """A ContinuousBatchingEngine with the worker's settings over the
    single-request engine's model (no second copy of the weights), driven
    from this thread; ``kw`` adds or changes settings."""
    from mllm_npu_tpu_torch.serve.batched_engine import (
        ContinuousBatchingEngine)
    gen = single.generator
    return ContinuousBatchingEngine(gen.model, **dict(dict(
        num_slots=WORKER["num_slots"], max_len=WORKER["max_len"],
        block_steps=WORKER["block_steps"],
        prompt_bucket=WORKER["batch_prompt_bucket"],
        max_prompt=WORKER["max_prompt"],
        eos_token_id=gen.sampling.eos_token_id,
        pad_token_id=gen.sampling.pad_token_id, cache_dtype=gen.cache_dtype,
        ladder=gen.ladder), **kw))


def fused_check(single, prep, label, items):
    """Check e on ``single``'s model, its LoRA merged (fusion needs the
    merge: the reference's generate.py:71-76): before and after fusing
    q/k/v and gate/up in place, the image request's prefill logits (the
    fused within the logit rule's bound of the unfused), K4/K5's launches
    per forward (int8: 225, then 129), a worker engine's decode step with
    every slot busy and a text request's ms per token (the fused int8
    block's traced replay: traced_replay_checks)."""
    import torch

    from mllm_npu_tpu_torch.ops import quant as tq
    from mllm_npu_tpu_torch.utils.weights import (fuse_llama_projections_,
                                                  merge_lora_)
    model = single.generator.model
    lm = model.language_model
    if lm.config.lora_rank > 0:
        merge_lora_(lm)
    L = lm.config.num_hidden_layers
    quant = lm.config.quantization
    bound = LOGIT_BOUND_FACTOR * attention_control(model, prep)
    out = {"bound": bound}
    logits = {}
    for which, per_forward in (("unfused", 7 * L + 1), ("fused", 4 * L + 1)):
        if which == "fused":
            t0 = time.perf_counter()
            fuse_llama_projections_(lm)
            torch.cuda.synchronize()
            out["fuse_s"] = time.perf_counter() - t0
        tq.int8_matmul.launches = tq.int4_matmul.launches = 0
        logits[which] = prefill_logits(model, prep)
        n = tq.int8_matmul.launches + tq.int4_matmul.launches
        want = per_forward if quant != "none" else 0
        check(n == want, f"{label} {which}: K4/K5 launches per prefill {n},"
              f" expected {want}")
        single.comprehension(QUESTIONS[12], "")
        tm = single.generator.last_timings
        engine = worker_engine(single)
        run = timed_ticks(engine, items, SPEC_TOKENS)
        out[which] = {"launches_per_forward": n,
                      "step_ms": run["step_ms"],
                      "tokens_per_s": run["tokens_per_s"],
                      "single_ms_per_token": ms_per_token(tm)}
        del engine
    d = (logits["fused"] - logits["unfused"]).abs().max().item()
    check(d <= bound, f"{label} fused: prefill logits max |delta| {d:.4f} "
          f"against the unfused model's, beyond {bound:.4f}")
    out["logit_max_abs_delta"] = d
    u, f = out["unfused"], out["fused"]
    print(f"[fused {label}] LoRA merged; q/k/v and gate/up fused in "
          f"{out['fuse_s']:.2f} s: prefill logits max |delta| {d:.4f} against "
          f"unfused (bound {bound:.4f}); K4/K5 launches per forward "
          f"{u['launches_per_forward']} -> {f['launches_per_forward']}"
          f"; worker decode step (8 busy) {u['step_ms']:.3f} -> "
          f"{f['step_ms']:.3f} ms, {u['tokens_per_s']:.1f} -> "
          f"{f['tokens_per_s']:.1f} tokens/s; single request "
          f"{u['single_ms_per_token']:.2f} -> {f['single_ms_per_token']:.2f} "
          f"ms/token", flush=True)
    return out


def int8_spec_check(single):
    """The int8 sub-run of check a: the speculative (k = 4) worker engine
    over the int8 model; at the capture each recording of the verify tick
    counts 225 K4 launches, all in the prefill regime (M = 8 × 5 = 40:
    each product and the lm_head); then 8 requests through it, one verify
    tick under the profiler (its events are counted by
    traced_replay_checks). Every kernel's count is set to 0 before and
    read after."""
    from mllm_npu_tpu_torch.ops import quant as tq
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    tq.int8_matmul.prefill_launches = 0
    eng = worker_engine(single, speculative_k=4,
                        speculative_ngram=SPEC_NGRAM)
    per = 7 * eng.lm.config.num_hidden_layers + 1
    check(tq.int8_matmul.launches == tq.int8_matmul.prefill_launches
          == 2 * per, f"int8 verify tick at the capture (warm-up and "
          f"recording): {tq.int8_matmul.launches} launches "
          f"({tq.int8_matmul.prefill_launches} prefill regime), expected "
          f"{2 * per}, all prefill regime")
    prof = profile_block(eng, single, "int8 speculative k=4")
    print(f"[int8 spec worker] the verify tick captured in "
          f"{eng.capture_s:.3f} s", flush=True)
    del eng
    return {"profile": prof[:3],
            "launches": {k: fn.launches for k, fn in counters.items()},
            "prefill_launches": tq.int8_matmul.prefill_launches}


def phase_4c(single):
    """Phase 4c on the bf16 model (checks a-d; e runs after phase 6, on the
    model LoRA-merged): every kernel's count set to 0 before, read after.
    → summary."""
    import torch
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    traffic, items = mixed_items(single)
    plain_graphed = worker_engine(single)
    plain_eager = worker_engine(single, cuda_graph=False)
    plain = timed_ticks(plain_graphed, items, SPEC_TOKENS)
    plain_ids = plain.pop("ids")
    print(f"[phase 4c] the plain worker engine, {len(items)} requests x "
          f"{SPEC_TOKENS} tokens: decode step {plain['step_ms']:.3f} ms, "
          f"{plain['tokens_per_s']:.1f} tokens/s", flush=True)
    out = {"plain": plain}
    rule = logit_control(single, traffic, ("img896_0", "text_0"))
    print(f"[check] phase 4c logit rule: control max |delta| "
          + ", ".join(f"{k} {v:.4f}" for k, v in rule[1].items())
          + f"; bound {rule[2]:.4f}", flush=True)
    out["a"] = spec_batched_check(plain_graphed, plain_eager, items,
                                  plain["tokens_per_s"], rule)
    spec_ids = out["a"].pop("k4_ids")
    out["b"] = spec_single_check(single, traffic, rule)
    out["c"] = sampling_check(single, plain_graphed, items, plain_ids,
                              spec_ids)
    out["d"] = cache_dtype_check(single, plain_graphed, plain_eager, items,
                                 plain_ids, rule)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    check(out["launches"]["flash_fwd"] > 0, "phase 4c launched no K1")
    del plain_graphed, plain_eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 10: SEED-X at full width --------------------------------------
SEEDX_YAML = "mllm_npu_tpu_torch/configs/models/seedx_llama2_13b_qwenvl_vitg.yaml"
SEEDX_WORKER = "mllm_npu_tpu_torch/configs/workers/seedx_worker.json"
SEEDX_CAPTION = "A red bicycle leaning on a stone wall in the rain"
# tokens of the caption → features request: the 64 forced image tokens,
# </img> and one more
T2I_TOKENS = 66
# img_gen_feat with K1 against the same request with K1's plain version
T2I_COS = 0.99
# tokens per request of the worker's timed runs (k = 63 graphed and eager,
# the k = 0 twin)
SEEDX_TOKENS = 32


def k1_mix(rows, mix, basis):
    """K1's rows summed over one request's launch mix {shape: launches}:
    ms, plain_ms, bound_ms, library_ms, the share of the bound, what
    bounds it and the basis."""
    by = {r["shape"]: r for r in rows}
    agg = {key: sum(by[s][key] * n for s, n in mix.items())
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    t_c = sum(by[s]["flops"] * n for s, n in mix.items()) / H100_BF16_FLOPS
    t_m = sum(by[s]["bytes"] * n for s, n in mix.items()) / H100_BYTES_PER_S
    return {**agg, "bound_share": agg["bound_ms"] / agg["ms"],
            "bound_by": "operations" if t_c >= t_m else "bytes",
            "ms_basis": f"{basis}: the launch mix "
                        + ", ".join(f"{n} x {s}" for s, n in mix.items())}


def seedx_quant(rows, lm_cfg, s_img):
    """K4's or K5's rows at the Llama-2-13B's shapes summed over its
    launch mixes: one decode token (M = 1), one worker step (M = 8) and
    one image prefill (M = ``s_img``, the lm_head's last row aside)."""
    out = {}
    for regime, key, lm_head, basis in (
            ("decode", "decode", True, "one decode token (M=1)"),
            ("slots", "worker_step", True,
             f"one worker step (M={WORKER['num_slots']})"),
            ("prefill", "prefill", False, f"one image prefill (M={s_img})")):
        agg = quant_row_mix([r for r in rows if r["regime"] == regime],
                            quant_mix(lm_cfg, lm_head=lm_head))
        out[key] = {**{k: agg[k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "bound_by",
            "bound_share")}, "ms_basis": f"SEED-X's Llama-2-13B, {basis}: "
            "the launch mix " + agg["launch_mix"]}
    return out


def seedx_specs():
    """The SEED-X components as the port's YAML configures them, built
    only as specs (no weights): → (vision config, projector config,
    output projector config, LlamaConfig)."""
    from mllm_npu_tpu_torch.configs import instantiate, load_config
    m = load_config(ROOT / SEEDX_YAML)["mllm"]
    node = m["mllm_model"]
    return (instantiate(node["vision_encoder"]).config,
            instantiate(node["projector"]).config,
            instantiate(node["output_projector"]).config,
            instantiate(m["language_model"]).config)


def seedx_kernel_cases(n_tiles, s_img, caption_len):
    """Phase 3's K1 cases at SEED-X's shapes, from its YAML: Qwen-ViT-G's
    self-attention (D = 104) and its attention pool over ``n_tiles``
    tiles, the input projector (D = 160), the output projector over one
    window, and the Llama-2-13B causal prefill (MHA 40/40) at the image
    request's length and at the caption's."""
    vis, proj, outp, lm = seedx_specs()
    P, pool_h = vis.num_patches, max(vis.output_dim // 128, 1)
    H, D = lm.num_attention_heads, lm.head_dim
    return [
        kernel_case("seedx_qwen_vit", n_tiles, P, P, vis.heads, vis.heads,
                    vis.width // vis.heads, False),
        kernel_case("seedx_attn_pool", n_tiles, vis.n_queries, P, pool_h,
                    pool_h, vis.output_dim // pool_h, False),
        kernel_case("seedx_input_projector", n_tiles, proj["num_queries"],
                    vis.n_queries, proj["num_heads"], proj["num_heads"],
                    proj["embed_dim"] // proj["num_heads"], False),
        kernel_case("seedx_output_projector", 1, outp["num_queries"],
                    outp["num_queries"], outp["num_heads"],
                    outp["num_heads"],
                    outp["embed_dim"] // outp["num_heads"], False),
        kernel_case("seedx_llama2_prefill", 1, s_img, s_img, H,
                    lm.num_key_value_heads, D, True, pad_rows={}),
        kernel_case("seedx_llama2_caption", 1, caption_len, caption_len, H,
                    lm.num_key_value_heads, D, True, pad_rows={}),
    ]


def seedx_worker_check(single, lm_cfg):
    """Phase 10's worker: the port's seedx_worker.json parsed as the
    worker's command line would, its engine (speculative_k 63, 8 slots, a
    2048-token cache) over the single engine's model, served on 127.0.0.1
    port 0: 4 image and 4 text POSTs at once (code 0, K1's launches per
    admission); then, the worker stopped, the same requests graphed and
    eager (identical ids), a speculative_k = 0 twin, and decode_attention's
    share of its step (phase 11 serves the config's image_gen requests).
    → summary."""
    import torch

    from mllm_npu_tpu_torch.serve.engine import BatchedInferenceEngine
    from mllm_npu_tpu_torch.serve.worker import (KV_CACHE_DTYPES,
                                                 parse_worker_args)
    args = parse_worker_args(["--worker-config", str(ROOT / SEEDX_WORKER),
                              "--host", "127.0.0.1", "--port", "0",
                              "--no-register"])
    check(args.batched and args.speculative_k == 63 and args.num_slots == 8
          and args.max_cache_len == 2048, f"seedx_worker.json: {args}")
    model = single.generator.model
    nq = model.projector.num_queries
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # load_engine_from_config's batched engine from these args, over the
    # model already built (no second copy of the weights)
    batched = BatchedInferenceEngine(
        model=model, tokenizer=single.tokenizer,
        image_transform=single.image_transform, num_img_in_tokens=nq,
        num_img_out_tokens=nq, max_new_tokens=MAX_NEW_TOKENS, device="cuda",
        quantize_int8=args.quantize_int8, quantize_int4=args.quantize_int4,
        fuse_projections=args.fuse_projections,
        speculative_k=args.speculative_k,
        speculative_ngram=args.speculative_ngram,
        cache_dtype=KV_CACHE_DTYPES[args.kv_cache_dtype],
        num_slots=args.num_slots, max_len=args.max_cache_len,
        max_prompt=args.max_cache_len // 2,
        batch_prompt_bucket=args.prompt_bucket,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache)
    be = batched.batch_engine
    check(be.capture_s is not None, "seedx: the verify tick was not captured")
    cache_gib = 2 * be.state["k"].numel() * be.state["k"].element_size() \
        / 2**30
    print(f"[seedx worker] engine from {SEEDX_WORKER} built in "
          f"{time.perf_counter() - t0:.2f} s: {be.B} slots x {be.max_len}, "
          f"speculative_k {be.speculative_k}, the verify tick captured in "
          f"{be.capture_s:.3f} s; static cache {cache_gib:.3f} GiB",
          flush=True)

    served = ServedWorker(batched, model_name=args.model_name,
                          concurrency=max(args.limit_model_concurrency,
                                          args.num_slots))
    traffic = worker_traffic(n896=4, n384=0, n_text=4)
    for fn in counters.values():
        fn.launches = 0
    replays0 = be.replays
    t0 = time.perf_counter()
    http_burst(served, traffic)
    burst_s = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in counters.items()}
    L = lm_cfg.num_hidden_layers
    expect = dict.fromkeys(counters, 0)
    expect["flash_fwd"] = (L + k1_per_image(model)) * 4 + L * 4
    print(f"[seedx worker] 8 concurrent POSTs (4 images, 4 texts) in "
          f"{burst_s:.2f} s, every reply code 0, {be.replays - replays0} "
          f"verify-tick replays; launches counted {got} (expected {expect})",
          flush=True)
    check(got == expect, f"seedx worker burst: launches {got}, expected "
          f"{expect}")
    served.close()

    items = [batched._prepare_comprehension(q, b) for _, q, b in traffic]
    graphed = timed_ticks(be, items, SEEDX_TOKENS)
    eager_engine = twin_of(be, cuda_graph=False,
                           speculative_k=be.speculative_k,
                           speculative_ngram=be.speculative_ngram)
    eager = timed_ticks(eager_engine, items, SEEDX_TOKENS)
    del eager_engine
    gc.collect()
    torch.cuda.empty_cache()
    same = [a == b for a, b in zip(graphed["ids"], eager["ids"])]
    check(all(same), f"seedx: graphed and eager ids differ: {same}")
    plain_engine = twin_of(be, speculative_k=0)
    plain = timed_ticks(plain_engine, items, SEEDX_TOKENS)
    attn = decode_attention_cost(plain_engine, lm_cfg, plain["step_ms"])
    # a replayed tick of the k = 0 twin under the profiler: none of the
    # five longest kernels is a copy as long as the least a copy of one
    # layer's K could take (read and written at the peak), summed over the
    # tick's steps and layers as the profiler sums a kernel's events
    prof = profile_block(plain_engine, single, "seedx k=0")
    k_bytes = plain_engine.state["k"][0].numel() * 2
    copy_ms = (2 * k_bytes / H100_BYTES_PER_S * 1e3
               * plain_engine.block_steps * lm_cfg.num_hidden_layers)
    copies = [(nm, t / 1e3) for nm, t in prof[2]
              if "copy" in nm.lower() and t / 1e3 >= copy_ms]
    check(not copies, f"seedx k=0 tick: cache-sized copies {copies}")
    attn["tick_profile"] = {"wall_ms": prof[0], "busy_ms": prof[1],
                            "top": prof[2]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[seedx worker] {len(items)} requests x {SEEDX_TOKENS} tokens, "
          f"every slot busy: k = 63 verify tick {graphed['tick_ms']:.2f} ms "
          f"graphed, {eager['tick_ms']:.2f} ms eager (ids identical), "
          f"{graphed['tokens_per_row_tick']:.3f} tokens per row and tick, "
          f"acceptance {100 * graphed['acceptance']:.1f}%, "
          f"{graphed['tokens_per_s']:.1f} tokens/s; speculative_k = 0 twin "
          f"{plain['step_ms']:.2f} ms a step graphed, "
          f"{plain['tokens_per_s']:.1f} tokens/s; static cache "
          f"{cache_gib:.3f} GiB an engine; peak {peak:.2f} GiB", flush=True)
    del plain_engine, be, batched, served
    gc.collect()
    torch.cuda.empty_cache()
    strip = lambda d: {k: v for k, v in d.items() if k != "ids"}
    return {"launches": got, "burst_s": burst_s,
            "spec_graphed": strip(graphed), "spec_eager": strip(eager),
            "plain_graphed": strip(plain), "decode_attention": attn,
            "cache_gib": cache_gib, "peak_gib": peak}


def seedx_phase(s_img):
    """Phase 10 (see the module's docstring). → summary, its launches
    among them."""
    import torch

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from mllm_npu_tpu_torch.serve.engine import InferenceEngine
    from mllm_npu_tpu_torch.serve.worker import load_engine_from_config
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[seedx] device memory before the build: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)
    launches = dict.fromkeys(kernel_counters(), 0)
    t0 = time.perf_counter()
    single = load_engine_from_config(str(ROOT / SEEDX_YAML),
                                     max_new_tokens=MAX_NEW_TOKENS,
                                     device="cuda", seed=0,
                                     fake_tokenizer=True)
    torch.cuda.synchronize()
    model = single.generator.model
    lm_cfg = model.language_model.config
    vis = model.vision_encoder
    n = lambda mod: sum(p.numel() for p in mod.parameters())
    parts = {"llama": n(model.language_model),
             "qwen_vit": n(vis) - n(vis.attn_pool),
             "pool_and_projectors": n(vis.attn_pool) + n(model.projector)
             + n(model.output_projector) + model.patch_pos_embed.numel()}
    check(sum(parts.values()) == n(model), f"seedx parameter parts {parts}")
    print(f"[seedx] {SEEDX_YAML} built in {time.perf_counter() - t0:.1f} s: "
          f"{n(model) / 1e9:.3f} B params ("
          + ", ".join(f"{k} {v / 1e9:.3f} B" for k, v in parts.items())
          + f"), {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident; "
          f"llama {lm_cfg.num_hidden_layers} layers, MHA "
          f"{lm_cfg.num_attention_heads}/{lm_cfg.num_key_value_heads}, LoRA "
          f"r{lm_cfg.lora_rank}, vocab {lm_cfg.vocab_size}; qwen "
          f"{vis.config.layers} layers, D {vis.config.width // vis.config.heads}",
          flush=True)
    check(vis.config.width // vis.config.heads == 104
          and model.projector.embed_dim // model.projector.attn.num_heads
          == 160, "seedx: the head dims are not 104 and 160")

    requests = [("What is unusual in this image?", png_b64(896, 896, 0)),
                ("Describe the picture.", png_b64(448, 448, 1)),
                ("What is the capital of France?", "")]
    preps = [single._prepare_comprehension(q, b) for q, b in requests]
    check(len(preps[0][0]) == s_img, f"seedx: the image prompt has "
          f"{len(preps[0][0])} tokens, phase 3 timed {s_img}")
    got, _ = serve(single, requests, preps, "seedx", lm_cfg)
    for k in launches:
        launches[k] += got[k]
    k1_logits, _ = k1_vs_plain_prefill(model, preps[0], "SEED-X")

    # caption → features with K1 (the decode step graphed, then eager),
    # with K1's plain version everywhere, and with that plain version
    # rounding P to bf16 (the control)
    feats, t2i_ids, t2i_ms = {}, {}, {}
    for which, fn, graphed in (
            ("K1", flash_attention, True), ("K1 eager", flash_attention, False),
            ("plain", flash_attention_reference, True),
            ("plain_p_bf16", plain_attention_p_bf16, True)):
        port_ops.flash_attention = fn
        flash_attention.launches = 0
        single.generator.cuda_graph = graphed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = single.text_to_image_features(SEEDX_CAPTION,
                                                max_new_tokens=T2I_TOKENS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            port_ops.flash_attention = flash_attention
            single.generator.cuda_graph = True
        ids = res["generate_ids"][0].tolist()
        ladder = list(single.generator.ladder.ids)
        f = res["img_gen_feat"]
        check(ids[:len(ladder) - 1] == ladder[1:],
              f"seedx {which}: not the forced ladder: {ids}")
        check(res["num_gen_imgs"] == 1 and tuple(f.shape) == (
            1, model.num_img_out_tokens, model.output_projector.embed_dim)
              and bool(torch.isfinite(f.float()).all()),
              f"seedx {which}: img_gen_feat {None if f is None else f.shape}")
        expect = (lm_cfg.num_hidden_layers + 1 if fn is flash_attention
                  else 0)
        check(flash_attention.launches == expect, f"seedx {which} "
              f"text_to_image_features launched K1 "
              f"{flash_attention.launches} times, expected {expect}")
        launches["flash_fwd"] += flash_attention.launches
        tm = single.generator.last_timings
        print(f"[seedx] text_to_image_features ({which}): {len(ladder) - 2} "
              f"forced image tokens and </img> in {len(ids)} tokens, "
              f"img_gen_feat {tuple(f.shape)}; K1 {expect} launches; ttft "
              f"{tm['ttft_s'] * 1e3:.1f} ms, decode "
              f"{ms_per_token(tm):.2f} "
              f"ms/token, wall {wall:.2f} s", flush=True)
        feats[which] = f.float()
        t2i_ids[which] = ids
        t2i_ms[which] = ms_per_token(tm)
    check(t2i_ids["K1"] == t2i_ids["K1 eager"]
          and torch.equal(feats["K1"], feats["K1 eager"]),
          "seedx caption: the graphed decode's ids or features differ from "
          "the eager decode's")
    t2i = agreement(feats["K1"], feats["plain"])
    t2i["control"] = agreement(feats["plain_p_bf16"], feats["plain"])
    t2i["ms_per_token"] = {"graphed": t2i_ms["K1"],
                           "eager": t2i_ms["K1 eager"]}
    print(f"[check] SEED-X img_gen_feat, K1 vs plain attention: cos "
          f"{t2i['cos']:.6f}, relative RMS {t2i['rel_rms']:.4f}; control "
          f"(plain with P in bf16 vs plain): cos "
          f"{t2i['control']['cos']:.6f}, relative RMS "
          f"{t2i['control']['rel_rms']:.4f}; graphed = eager (ids and "
          f"features), {t2i_ms['K1']:.2f} vs {t2i_ms['K1 eager']:.2f} "
          f"ms/token", flush=True)
    check(t2i["cos"] >= T2I_COS, f"seedx img_gen_feat disagree: {t2i}")
    t2i["graph_mix"] = graph_mix(single.generator, [
        (lab, functools.partial(single.comprehension, q, b))
        for lab, (q, b) in zip(("896x896", "448x448", "text"), requests)
    ] + [("caption", functools.partial(
        single.text_to_image_features, SEEDX_CAPTION,
        max_new_tokens=T2I_TOKENS))], "seedx")

    worker = seedx_worker_check(single, lm_cfg)
    for k in launches:
        launches[k] += worker["launches"][k]

    # int8: the Llama's LoRA merged and quantized in place, one image
    # request, its prefill logits with K4 against the plain quantized linears
    nq = model.projector.num_queries
    t0 = time.perf_counter()
    q8 = InferenceEngine(model=model, tokenizer=single.tokenizer,
                         image_transform=single.image_transform,
                         num_img_in_tokens=nq, num_img_out_tokens=nq,
                         max_new_tokens=MAX_NEW_TOKENS, device="cuda",
                         quantize_int8=True)
    torch.cuda.synchronize()
    check(model.language_model.config.quantization == "int8",
          "seedx: not quantized")
    print(f"[seedx int8] quantized in place in {time.perf_counter() - t0:.1f}"
          f" s: {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident",
          flush=True)
    got, got_prefill = serve(q8, requests[:1], preps[:1], "seedx int8",
                             lm_cfg)
    for k in launches:
        launches[k] += got[k]
    quant_vs_plain_prefill(model, preps[0], 8, "SEED-X", k1_logits)
    del q8, single, model, feats, k1_logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "int8_prefill_launches": got_prefill[8],
            "params": parts, "t2i": t2i, "worker": worker}


# -- phase 11: the SDXL de-tokenizer -------------------------------------
# the reference engine's defaults for an image_gen request
# (mllm_npu_tpu/serve/engine.py:168-184)
GEN_STEPS = 50
GEN_GUIDANCE = 7.5
GEN_SEED = 42
# the de-tokenizer's native size: SDXL-base's 128 latents × the VAE's 8
GEN_SIZE = 1024
GEN_CONFIG = "mllm_npu_tpu_torch/configs/generation/sd_xl_resampler.yaml"
# the UNet's ε and the final latents with K1 against the plain attention
UNET_COS = 0.99
# steps of the short runs whose final latents are compared
SHORT_STEPS = 4


def plain_attention_p_bf16(q, k, v, *, causal=False, segment_ids=None,
                           scale=None, return_lse=False):
    """K1's plain version with one change: P rounded to bf16 before P·V,
    where K1 rounds it. Against the plain version it is the bf16 control:
    what that rounding alone moves, beside what K1 moves."""
    import torch

    from mllm_npu_tpu_torch.ops.flash_attention import _masked_logits
    B, Sq, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    logits, _ = _masked_logits(q, k, causal, segment_ids, scale)
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = (p / torch.where(l > 0, l, torch.ones_like(l))).bfloat16().float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def agreement(a, b):
    """cos and relative RMS of ``a`` against ``b`` (flattened, fp32)."""
    import torch
    a, b = a.float().flatten(), b.float().flatten()
    return {"cos": torch.nn.functional.cosine_similarity(a, b, dim=0).item(),
            "rel_rms": ((a - b).norm() / b.norm()).item()}


def unet_kernel_cases():
    """Phase 3's K1 cases at the SDXL UNet's attentions at 1024² (from
    ``UNetConfig.sdxl_base`` and the generation config's resampler): the
    CFG batch of 2, self-attention over each cross-attention level's
    positions and cross-attention over the resampler's tokens. → (rows,
    {shape: launches a UNet forward})."""
    from mllm_npu_tpu_torch.configs import load_config
    from mllm_npu_tpu_torch.models.generation.unet import UNetConfig
    cfg = UNetConfig.sdxl_base()
    n_ctx = load_config(ROOT / GEN_CONFIG)["resampler"]["num_queries"]
    n = len(cfg.block_out_channels)
    rows, mix = [], {}
    for i, (btype, ch) in enumerate(zip(cfg.down_block_types,
                                        cfg.block_out_channels)):
        if btype != "CrossAttnDownBlock2D":
            continue
        S = (cfg.sample_size >> i) ** 2
        H = cfg.num_attention_heads[i]
        # down: layers_per_block attentions, up: one more, mid at the last
        blocks = cfg.transformer_layers_per_block[i] * (
            2 * cfg.layers_per_block + 1 + (i == n - 1))
        for kind, Sk in (("self", S), ("cross", n_ctx)):
            name = f"unet_{kind}_s{S}"
            rows.append(kernel_case(name, 2, S, Sk, H, H, ch // H, False))
            mix[name] = blocks
    return rows, mix


def detokenizer_phase():
    """Phase 11 (see the module's docstring). → summary, its launches
    among them."""
    import numpy as np
    import torch
    from PIL import Image

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        compute_time_ids)
    from mllm_npu_tpu_torch.models.generation.unet import CrossAttention
    from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
        VisualAttention)
    from mllm_npu_tpu_torch.models.vit_common import TorchMHA
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from mllm_npu_tpu_torch.serve.worker import (load_engine_from_config,
                                                 parse_worker_args)
    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    args = parse_worker_args(["--worker-config", str(ROOT / SEEDX_WORKER),
                              "--host", "127.0.0.1", "--port", "0",
                              "--no-register"])
    check(args.generation_config == GEN_CONFIG,
          f"seedx_worker.json: generation_config {args.generation_config}")
    # the worker's main() path: load_engine_from_config from these args
    t0 = time.perf_counter()
    engine = load_engine_from_config(
        str(ROOT / args.model_config), max_new_tokens=MAX_NEW_TOKENS,
        batched=args.batched, num_slots=args.num_slots,
        max_len=args.max_cache_len, prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache, prompt_bucket=args.prompt_bucket,
        quantize_int8=args.quantize_int8, quantize_int4=args.quantize_int4,
        fuse_projections=args.fuse_projections,
        speculative_k=args.speculative_k,
        speculative_ngram=args.speculative_ngram,
        kv_cache_dtype=args.kv_cache_dtype,
        generation_config=str(ROOT / args.generation_config), device="cuda",
        seed=0, fake_tokenizer=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ad = engine.adapter
    model = engine.generator.model
    L = model.language_model.config.num_hidden_layers
    n = lambda m: sum(p.numel() for p in m.parameters())
    parts = {"unet": n(ad.unet), "vae": n(ad.vae),
             "resampler": n(ad.resampler)}
    check(ad.visual_encoder is model.vision_encoder,
          "the adapter's negative is not the SEED model's vision encoder")
    print(f"[detok] the worker's engine from {SEEDX_WORKER} with "
          f"{args.generation_config} built in {build_s:.1f} s: SEED-X "
          f"{n(model) / 1e9:.3f} B params, the de-tokenizer "
          + ", ".join(f"{k} {v / 1e9:.3f} B" for k, v in parts.items())
          + f" (bf16); {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"resident with the worker's {args.num_slots} x "
          f"{args.max_cache_len} cache", flush=True)

    served = ServedWorker(engine, model_name=args.model_name,
                          concurrency=max(args.limit_model_concurrency,
                                          args.num_slots))
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    unet_attn = sum(isinstance(m, CrossAttention) for m in ad.unet.modules())
    vis_attn = sum(isinstance(m, (VisualAttention, TorchMHA))
                   for m in ad.visual_encoder.modules())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    chunks = post_worker(served.url, {"input_text": SEEDX_CAPTION,
                                      "image_gen": True}, timeout=1200)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    served.close()
    got = {k: fn.launches for k, fn in counters.items()}
    expect = dict.fromkeys(counters, 0)
    # the caption's prefill and the output projector, the zero image's
    # vision tower and pool (once), 140 attentions a UNet forward
    expect["flash_fwd"] = L + 1 + vis_attn + unet_attn * GEN_STEPS
    check([c["error_code"] for c in chunks] == [0],
          f"image_gen: {[(c['error_code'], c['text']) for c in chunks]}")
    jpeg = base64.b64decode(chunks[0]["image"])
    img = Image.open(io.BytesIO(jpeg))
    img.load()
    t = engine.last_timings
    ms_step = t["denoise_s"] * 1e3 / t["steps"]
    print(f"[detok] image_gen POST ({SEEDX_CAPTION!r}): code 0, a "
          f"{img.format} of {img.size[0]}x{img.size[1]} ({len(jpeg)} bytes) "
          f"in {wall:.2f} s: features {t['features_s']:.3f} s, embeds "
          f"{t['embeds_s'] * 1e3:.1f} ms, denoise {t['denoise_s']:.3f} s "
          f"({t['steps']} steps, {ms_step:.2f} ms a UNet step at batch 2), "
          f"VAE decode {t['vae_s'] * 1e3:.1f} ms, request "
          f"{t['request_s']:.3f} s; peak {peak:.2f} GiB; launches {got} "
          f"(expected {expect}: K1 {L + 1} + {vis_attn} + {unet_attn} x "
          f"{GEN_STEPS})", flush=True)
    size = ad.unet.config.sample_size * ad.vae.config.spatial_scale_factor
    check(img.format == "JPEG" and img.size == (size, size) == (
        GEN_SIZE, GEN_SIZE) and img.mode == "RGB",
          f"image_gen image {img.format} {img.size}")
    check(np.asarray(img).std() > 0, "image_gen: a flat image")
    check(got == expect, f"image_gen launches {got}, expected {expect}")

    # the request's first UNet forward, and short runs of the same seed,
    # with K1, K1's plain version and the plain version with P in bf16
    attn = {"K1": flash_attention, "plain": flash_attention_reference,
            "plain_p_bf16": plain_attention_p_bf16}
    with torch.inference_mode():
        feats = engine.text_to_image_features(
            SEEDX_CAPTION, max_new_tokens=engine.num_img_out_tokens + 2)[
                "img_gen_feat"]
        pe, pe_neg, pooled, pooled_neg = ad.get_image_embeds(
            image_embeds=feats, image_size=engine.base_resolution)
        f = ad.vae.config.spatial_scale_factor
        g = torch.Generator(device=dev)
        g.manual_seed(GEN_SEED)
        lat = torch.randn((1, 4, size // f, size // f), generator=g,
                          device=dev)
        ts, sigmas = ad.scheduler.make_schedule(GEN_STEPS, device=dev)
        lat_in = ad.scheduler.scale_model_input(
            torch.cat([lat, lat]) * ad.scheduler.init_noise_sigma, sigmas[0])
        tids = torch.as_tensor(compute_time_ids((size, size), (0, 0), size),
                               device=dev)
        added = {"text_embeds": torch.cat([pooled_neg, pooled]),
                 "time_ids": torch.cat([tids, tids])}
        prompt = torch.cat([pe_neg, pe])

        def unet_forward():
            return ad.unet(lat_in, ts[0].expand(2), prompt, added_cond=added)
        eps, lats = {}, {}
        for which, fn in attn.items():
            port_ops.flash_attention = fn
            flash_attention.launches = 0
            try:
                eps[which] = unet_forward().float()
                want = unet_attn if which == "K1" else 0
                check(flash_attention.launches == want,
                      f"UNet forward ({which}): {flash_attention.launches} "
                      f"K1 launches, expected {want}")
                lats[which] = ad.denoise(
                    lat * ad.scheduler.init_noise_sigma, pe, pe_neg, pooled,
                    pooled_neg, tids, GEN_GUIDANCE, SHORT_STEPS)
            finally:
                port_ops.flash_attention = flash_attention
        unet_ms = time_ms(unet_forward, iters=5)
        prof = profile_call(unet_forward)
    for x in (*eps.values(), *lats.values()):
        check(bool(torch.isfinite(x).all()), "non-finite UNet output")
    eps_k1 = agreement(eps["K1"], eps["plain"])
    eps_ctl = agreement(eps["plain_p_bf16"], eps["plain"])
    lat_k1 = agreement(lats["K1"], lats["plain"])
    lat_ctl = agreement(lats["plain_p_bf16"], lats["plain"])
    print(f"[check] SDXL UNet ε at the request's first step (full width, "
          f"{list(lat_in.shape)}), K1 vs plain attention: cos "
          f"{eps_k1['cos']:.6f}, relative RMS {eps_k1['rel_rms']:.4f}; "
          f"control (plain with P in bf16 vs plain): cos "
          f"{eps_ctl['cos']:.6f}, relative RMS {eps_ctl['rel_rms']:.4f}",
          flush=True)
    print(f"[check] final latents of a {SHORT_STEPS}-step run (seed "
          f"{GEN_SEED}), K1 vs plain: cos {lat_k1['cos']:.6f}, relative RMS "
          f"{lat_k1['rel_rms']:.4f}; control: cos {lat_ctl['cos']:.6f}, "
          f"relative RMS {lat_ctl['rel_rms']:.4f}", flush=True)
    check(eps_k1["cos"] >= UNET_COS, f"UNet ε K1 vs plain: {eps_k1}")
    check(lat_k1["cos"] >= UNET_COS, f"final latents K1 vs plain: {lat_k1}")
    print(f"[detok] one UNet forward (batch 2, K1): {unet_ms:.2f} ms on "
          f"CUDA events, back to back", flush=True)
    print_profile("one UNet forward (batch 2, 1024²)", *prof)
    engine.close()
    del engine, model, ad, served, eps, lats, feats
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "params": parts, "build_s": build_s,
            "wall_s": wall, "timings": t, "ms_per_unet_step": ms_step,
            "peak_gib": peak, "image": [img.format, *img.size],
            "unet_forward_ms": unet_ms, "eps": eps_k1, "eps_control": eps_ctl,
            "latents": lat_k1, "latents_control": lat_ctl,
            "profile": {"wall_ms": prof[0], "busy_ms": prof[1],
                        "top": prof[2]}}


def main():
    # the training phase runs near the card's memory: let the allocator grow
    # segments instead of fragmenting (read when CUDA initialises)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "GPU")
    if not (ROOT / "mllm_npu_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    os.environ.pop("DEBUG_FLAG", None)       # full width, never tiny

    from mllm_npu_tpu_torch.constant import BOI_TOKEN
    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    from mllm_npu_tpu_torch.ops import quant as tq
    from mllm_npu_tpu_torch.ops.flash_attention import flash_attention
    from mllm_npu_tpu_torch.utils.cuda_build import build_all

    # fp32 reference products in full fp32 (the plain K1 is an fp32
    # einsum; cuDNN would run an fp32 conv in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--traced-replays"]:
        traced_replays(sys.argv[2] if len(sys.argv) > 2 else "")
        return

    t_start = time.perf_counter()
    # -- 1. header and kernel builds, all started together --------------
    smi = nvidia_smi()
    print(f"[card] {smi}")
    print(f"[card] torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}"
          f"  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    builds = build_all(["flash_fwd", "flash_bwd", "quant_matmul"])
    print(f"[build] all kernels: {time.perf_counter() - t0:.1f} s")
    for name, (secs, log) in builds.items():
        print(f"[build] nvcc {name}.cu: {secs:.1f} s")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "C7513")):
                print(f"[build] {name}: {line.strip()}")

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 2",
          flush=True)
    # -- 2. full-width model ------------------------------------------
    t0 = time.perf_counter()
    engine = build_engine(device="cuda", seed=0, fake_tokenizer=True,
                          max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    model = engine.generator.model
    lm_cfg = model.language_model.config
    vis_cfg = model.vision_encoder.config
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] built in {time.perf_counter() - t0:.1f} s: "
          f"{n_params / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; llama "
          f"{lm_cfg.num_hidden_layers} layers, LoRA r{lm_cfg.lora_rank}, "
          f"vocab {lm_cfg.vocab_size}; siglip {vis_cfg.num_hidden_layers} "
          f"layers; resampler {model.projector.num_queries} queries")

    requests = [("What is unusual in this image?", png_b64(896, 896, 0)),
                ("Describe the picture.", png_b64(384, 1152, 1)),
                ("What is the capital of France?", "")]
    preps = [engine._prepare_comprehension(q, b) for q, b in requests]
    s_img, n_tiles = len(preps[0][0]), preps[0][1].shape[0]
    bucket = -(-s_img // WORKER["batch_prompt_bucket"]) \
        * WORKER["batch_prompt_bucket"]
    print(f"[model] request 1: prompt {s_img} tokens, {n_tiles} tiles; the "
          f"batched worker's bucket {bucket}")

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 3",
          flush=True)
    # -- 3. K1, K4 and K5 against their plain versions at the path's shapes
    H, Hkv, D = (lm_cfg.num_attention_heads, lm_cfg.num_key_value_heads,
                 lm_cfg.head_dim)
    vh = vis_cfg.num_attention_heads
    n_vis = vis_cfg.num_patches
    n_queries = model.projector.num_queries
    res_heads = model.projector.attn.num_heads
    res_d = model.projector.embed_dim // res_heads
    cases = [
        kernel_case("llama_prefill", 1, s_img, s_img, H, Hkv, D, True,
                    pad_rows={}),
        kernel_case("llama_prefill_padded_b2", 2, s_img, s_img, H, Hkv, D,
                    True, pad_rows={1: s_img - 57}),
        # the batched worker's admission: the prompt padded to its bucket,
        # the tail segment 0
        kernel_case("llama_bucket_padded", 1, bucket, bucket, H, Hkv, D,
                    True, pad_rows={0: s_img}),
        kernel_case("siglip", n_tiles, n_vis, n_vis, vh, vh,
                    vis_cfg.hidden_size // vh, False),
        kernel_case("resampler", n_tiles, n_queries, n_vis, res_heads,
                    res_heads, res_d, False),
        kernel_case("tiny_llama_d32", 1, 77, 77, 4, 2, 32, True,
                    pad_rows={}),
    ]
    # SEED-X's shapes (phase 10 serves the same 896×896 request: the same
    # prompt length; and the caption of its text_to_image_features)
    caption_len = 1 + len(engine.tokenizer.encode(SEEDX_CAPTION + BOI_TOKEN))
    seedx_cases = seedx_kernel_cases(n_tiles, s_img, caption_len)
    edges = k1_edge_sweep()
    # the SDXL UNet's attentions at 1024² (phase 11's request)
    unet_cases, unet_mix = unet_kernel_cases()
    qrows = quant_rows(lm_cfg, s_img, bucket, WORKER["num_slots"])
    seedx_lm = seedx_specs()[3]
    qrows13 = quant_rows(seedx_lm, s_img, bucket, WORKER["num_slots"],
                         regimes=("decode", "slots", "prefill"))

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 4",
          flush=True)
    # -- 4. the bf16 path, counts set to 0 before each request ---------
    launches, quant_prefill = serve(engine, requests, preps, "bf16",
                                    lm_cfg)
    single_graph = {"bf16": single_graph_check(engine, requests,
                                               "bf16 graphed vs eager")}
    single_graph["bf16_mix"] = graph_mix(
        engine.generator,
        [(lab, functools.partial(engine.comprehension, q, b))
         for lab, (q, b) in zip(("896x896", "384x1152", "text"), requests)],
        "bf16")

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 4b",
          flush=True)
    # -- 4b. the batched worker over the same model, counts set to 0 before
    #        its burst: HTTP, the slot engine, the captured decode block
    worker = {"bf16": worker_phase(engine, lm_cfg)}
    for k, n in worker["bf16"]["launches"].items():
        launches[k] += n

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 4c",
          flush=True)
    # -- 4c. sampled, speculative and fp8/f32-cache serving over the same
    #        model, counts set to 0 before and read after (e: after 6)
    worker["bf16_4c"] = phase_4c(engine)
    for k, n in worker["bf16_4c"]["launches"].items():
        launches[k] += n

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 5",
          flush=True)
    # -- 5. the image request's prefill with K1 against the same forward
    #       with K1's plain version in every attention (SigLIP, resampler,
    #       Llama): random weights give flat logits, so hold the direction
    #       (cosine) and report the argmax
    k1, plain = k1_vs_plain_prefill(model, preps[0], "full-width")
    bf16_logits = k1

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 6",
          flush=True)
    # -- 6. how busy the device is during a text-only request (its decode
    #       step's graph captured by a first call, outside the trace) ----
    engine.comprehension(*requests[2], PROFILED_TOKENS)
    print_profile(f"text request ({PROFILED_TOKENS} tokens)", *profile_call(
        lambda: engine.comprehension(*requests[2], PROFILED_TOKENS)))

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 4c check e "
          "starts", flush=True)
    # -- 4c, check e (bf16): the model's LoRA merged, then its projections
    #    fused in place (the bf16 model's last use)
    for fn in kernel_counters().values():
        fn.launches = 0
    worker["bf16_4c"]["e"] = fused_check(engine, preps[0], "bf16",
                                         mixed_items(engine)[1])
    launches["flash_fwd"] += flash_attention.launches
    check(flash_attention.launches > 0, "check e launched no K1")
    del engine, model, k1, plain
    torch.cuda.empty_cache()

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 7",
          flush=True)
    # -- 7. the int8 and int4 paths: the image and the text request each,
    #       then the image prefill with K4 (K5) against the same forward
    #       with its plain version in every quantized linear
    for bits in (8, 4):
        label = f"int{bits}"
        t0 = time.perf_counter()
        engine = build_engine(device="cuda", seed=0, fake_tokenizer=True,
                              max_new_tokens=MAX_NEW_TOKENS,
                              **{f"quantize_int{bits}": True})
        torch.cuda.synchronize()
        model = engine.generator.model
        print(f"[{label}] engine built and quantized in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        got, got_prefill = serve(engine, [requests[0], requests[2]],
                                 [preps[0], preps[2]], label, lm_cfg)
        for k in launches:
            launches[k] += got[k]
        for b in quant_prefill:
            quant_prefill[b] += got_prefill[b]
        if bits == 8:
            # the int8 worker: its burst's counts (its graph replays'
            # launches are traced, not counted)
            w = worker["int8"] = int8_worker_phase(engine, lm_cfg)
            for k, n in w["launches"].items():
                launches[k] += n
            quant_prefill[8] += w["prefill_launches"][0]
            # 4c, int8 sub-run of check a: the captured verify tick
            w["spec"] = int8_spec_check(engine)
            for k, n in w["spec"]["launches"].items():
                launches[k] += n
            quant_prefill[8] += w["spec"]["prefill_launches"]

        kernel = getattr(tq, f"{label}_matmul")
        ql, qp = quant_vs_plain_prefill(model, preps[0], bits, "full-width",
                                        bf16_logits)
        # the image prefill once more under the profiler: how much of it
        # the device is busy, and K4's (K5's) share of the device time
        print_profile(f"{label} image prefill", *profile_call(
            lambda: prefill_logits(model, preps[0])))
        if bits == 8:
            # 4c, check e (int8): the quantized projections fused in place,
            # counts set to 0 before and read after
            for fn in kernel_counters().values():
                fn.launches = 0
            kernel.prefill_launches = 0
            worker["int8"]["fused"] = fused_check(
                engine, preps[0], label, mixed_items(engine)[1])
            check(kernel.launches > 0, "check e launched no K4")
            launches["int8_matmul"] += kernel.launches
            launches["flash_fwd"] += flash_attention.launches
            quant_prefill[8] += kernel.prefill_launches
        del engine, model, ql, qp
        torch.cuda.empty_cache()

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 8",
          flush=True)
    # -- 7b. the replayed ticks' K4 events, traced in a process of their own
    traced = traced_replay_checks(lm_cfg, WORKER["block_steps"])
    worker["int8"]["traced"] = traced

    # -- 8. training at full width, the counts set to 0 before each step
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train = train_phase(Path(tmp))
    for k in launches:
        launches[k] += train["launches"][k]

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 9",
          flush=True)
    # -- 9. K1 with its LSE, K2 and K3 at the training shapes ------------
    S, B = train["seq"], train["batch"]
    bwd = [
        bwd_case("llama_train", B, S, S, H, Hkv, D, True, segments=True),
        bwd_case("resampler_train", train["images"], n_queries, n_vis,
                 res_heads, res_heads, res_d, False),
        bwd_case("siglip_d72", n_tiles, n_vis, n_vis, vh, vh,
                 vis_cfg.hidden_size // vh, False),
        bwd_case("tiny_d32", 1, 77, 77, 4, 2, 32, True, segments=True),
    ]

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 10",
          flush=True)
    # -- 10. SEED-X at full width, the Llama-3 models dropped ------------
    seedx = seedx_phase(s_img)
    for k in launches:
        launches[k] += seedx["launches"][k]
    quant_prefill[8] += seedx["int8_prefill_launches"]

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 11",
          flush=True)
    # -- 11. the SDXL de-tokenizer: an image_gen POST through the worker -
    detok = detokenizer_phase()
    for k in launches:
        launches[k] += detok["launches"][k]
    unet_forward = k1_mix(unet_cases, unet_mix, "one SDXL UNet forward "
                          "(CFG batch 2, 1024x1024)")
    unet_image = {k: v * GEN_STEPS if k in ("ms", "plain_ms", "bound_ms",
                                           "library_ms") else v
                  for k, v in unet_forward.items()}
    unet_image["ms_basis"] = (f"one {GEN_STEPS}-step 1024x1024 image: "
                              + unet_forward["ms_basis"] + f", x {GEN_STEPS}")
    print(f"[K1] SDXL UNet per forward ({sum(unet_mix.values()) // 2} "
          f"transformer blocks, {sum(unet_mix.values())} launches): "
          f"kernel {unet_forward['ms']:.3f} ms, plain "
          f"{unet_forward['plain_ms']:.3f} ms, SDPA "
          f"{unet_forward['library_ms']:.3f} ms, bound "
          f"{unet_forward['bound_ms']:.3f} ms ({unet_forward['bound_by']}, "
          f"{100 * unet_forward['bound_share']:.1f}% of it); per image x "
          f"{GEN_STEPS}: kernel {unet_image['ms']:.1f} ms, SDPA "
          f"{unet_image['library_ms']:.1f} ms", flush=True)

    L13 = seedx_lm.num_hidden_layers
    seedx_image = k1_mix(seedx_cases, {
        "seedx_llama2_prefill": L13, "seedx_qwen_vit": seedx_specs()[0].layers,
        "seedx_attn_pool": 1, "seedx_input_projector": 1},
        "one SEED-X 896x896 request")
    seedx_caption = k1_mix(seedx_cases, {
        "seedx_llama2_caption": L13, "seedx_output_projector": 1},
        "one SEED-X caption -> features request")
    rows = [{
        "name": "flash_fwd", "route": "cuda", "design": "wgmma+tma",
        "source": "mllm_npu_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mllm_npu_tpu/ops/flash_attention.py:100",
        "launches": launches["flash_fwd"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in cases + seedx_cases + unet_cases),
        **k1_mix(cases, {"llama_prefill": lm_cfg.num_hidden_layers,
                         "siglip": vis_cfg.num_hidden_layers,
                         "resampler": 1}, "one 896x896 request"),
        "library": "SDPA per shape, the faster of its calls (see shapes)",
        "shapes": cases,
        "edge_sweep": edges,
        "lse_shapes": [b["lse"] for b in bwd],
        "seedx_image_request": seedx_image,
        "seedx_caption_request": seedx_caption,
        "seedx_shapes": seedx_cases,
        "unet_forward": unet_forward,
        "unet_image": unet_image,
        "unet_shapes": unet_cases,
        "detokenizer_request_launches": detok["launches"]["flash_fwd"],
    }]
    tmix = {"llama_train": lm_cfg.num_hidden_layers, "resampler_train": 1}
    tby = {b["flash_bwd_dq"]["shape"]: b for b in bwd}
    pair_step = {key: sum(tby[s]["pair"][key] * n for s, n in tmix.items())
                 for key in ("pair_ms", "pair_delta_ms", "delta_ms",
                             "sdpa_bwd_ms", "mma_sync_pair_ms")}
    pair_step["pair_vs_sdpa"] = pair_step["pair_ms"] / pair_step["sdpa_bwd_ms"]
    pair_step["pair_delta_vs_sdpa"] = (pair_step["pair_delta_ms"]
                                       / pair_step["sdpa_bwd_ms"])
    print(f"[K2/K3] per training step at batch {B}: K2 + K3 "
          f"{pair_step['pair_ms']:.3f} ms, + delta "
          f"{pair_step['pair_delta_ms']:.3f} ms, SDPA backward "
          f"{pair_step['sdpa_bwd_ms']:.3f} ms (ratio "
          f"{pair_step['pair_vs_sdpa']:.3f}, with delta "
          f"{pair_step['pair_delta_vs_sdpa']:.3f}); PR 4's mma.sync kernels "
          f"{pair_step['mma_sync_pair_ms']:.3f} ms", flush=True)
    for name, symbol, replaces in (
            ("flash_bwd_dq", "K2", "mllm_npu_tpu/ops/flash_attention.py:333"),
            ("flash_bwd_dkv", "K3",
             "mllm_npu_tpu/ops/flash_attention.py:407")):
        agg = {key: sum(tby[s][name][key] * n for s, n in tmix.items())
               for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                           "pr4_ms")}
        flops = sum(tby[s][name]["flops"] * n for s, n in tmix.items())
        t_c = flops / H100_BF16_FLOPS
        t_m = sum(tby[s][name]["bytes"] * n
                  for s, n in tmix.items()) / H100_BYTES_PER_S
        rows.append({
            "name": name, "route": "cuda",
            "source": "mllm_npu_tpu_torch/csrc/flash_bwd.cu",
            "replaces": replaces,
            "launches": launches[name],
            "wgmma_launches": train["launches"][f"{name}_wgmma"],
            "max_abs_err": max(b[name]["max_abs_err"] for b in bwd),
            **agg,
            "bound_by": "operations" if t_c >= t_m else "bytes",
            "bound_share": agg["bound_ms"] / agg["ms"],
            "tflops": flops / agg["ms"] / 1e9,
            "design": "wgmma+tma: persistent blocks, a producer warp's TMA "
                      "rings, a consumer warpgroup, dS/P^T as register A "
                      "operands, segment-range tile skips (head dims < 32: "
                      "mma.sync)",
            "ms_basis": f"one training step at batch {B}: the launch mix "
                        + ", ".join(f"{n} x {s}" for s, n in tmix.items()),
            "pr4_basis": "PR 4's mma.sync kernels (the mma_sync regime, "
                         "forced) on the same inputs in this run",
            "library": "torch.autograd.grad of scaled_dot_product_attention "
                       "with K/V repeated for GQA (dq, dk and dv together; "
                       "the forward excluded)",
            "pair_per_step": pair_step,
            "pair_shapes": [b["pair"] for b in bwd],
            "shapes": [b[name] for b in bwd],
        })
    for bits, replaces in ((8, "mllm_npu_tpu/ops/quant.py:50"),
                           (4, "mllm_npu_tpu/ops/quant.py:330")):
        dec = quant_row_mix([r for r in qrows[bits]
                             if r["regime"] == "decode"], quant_mix(lm_cfg))
        pre = quant_row_mix([r for r in qrows[bits]
                             if r["regime"] == "prefill"],
                            quant_mix(lm_cfg, lm_head=False))
        slots = quant_row_mix([r for r in qrows[bits]
                               if r["regime"] == "slots"], quant_mix(lm_cfg))
        verify = quant_row_mix([r for r in qrows[bits]
                                if r["regime"] == "verify"],
                               quant_mix(lm_cfg))
        fmix = fused_mix(lm_cfg)
        fused_dec = quant_row_mix(
            [r for r in qrows[bits] if (r["regime"] == "fused_m1" or (
                r["regime"] == "decode" and (r["K"], r["N"]) in fmix))],
            fmix)
        rows.append({
            "name": f"int{bits}_matmul", "route": "cuda",
            "source": "mllm_npu_tpu_torch/csrc/quant_matmul.cu",
            "replaces": replaces,
            "launches": launches[f"int{bits}_matmul"],
            "prefill_launches": quant_prefill[bits],
            # the int8 worker's replayed blocks, which no counter sees:
            # qmm_decode's events in one traced replay, and the replays
            "graph_replay_launches": (traced["block"]["qmm_decode"]
                                      if bits == 8 else None),
            "graph_replays": (worker["int8"]["replays"] if bits == 8
                              else None),
            "graph_replay_basis": "qmm_decode kernel events in one replayed "
                                  "block under torch.profiler (int8 worker; "
                                  "no int4 worker runs)",
            "max_abs_err": max(r["max_abs_err"] for r in qrows[bits]),
            **{k: dec[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms", "bound_by")},
            "ms_basis": "one decode token (M=1): the launch mix "
                        + dec["launch_mix"],
            "design": "decode: mma.sync, weights streamed from memory",
            "prefill": {
                **{k: pre[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "library_ms", "bound_by",
                                       "bound_share")},
                "ms_basis": f"one image prefill (M={s_img}): the launch mix "
                            + pre["launch_mix"],
                "design": "tma+wgmma: persistent blocks, TMA ring, weight "
                          "converted to wgmma's register A operand, split-K",
            },
            "worker_decode": {
                **{k: slots[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms", "bound_by",
                                         "bound_share")},
                "ms_basis": f"one decode step of the batched worker "
                            f"(M={WORKER['num_slots']}): the launch mix "
                            + slots["launch_mix"],
            },
            "verify": {
                **{k: verify[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "library_ms", "bound_by",
                                          "bound_share")},
                "ms_basis": f"one speculative verify tick of the worker at "
                            f"k=4 (M={5 * WORKER['num_slots']}): the launch "
                            "mix " + verify["launch_mix"],
                "graph_replay_launches": (
                    traced["verify"]["qmm_prefill"]
                    if bits == 8 else None),
                "graph_replay_split_sums": (
                    traced["verify"]["qmm_split_sum"] if bits == 8
                    else None),
            },
            "fused_decode": {
                **{k: fused_dec[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms", "bound_by",
                                             "bound_share")},
                "ms_basis": "one decode token (M=1) with fused projections: "
                            "the launch mix " + fused_dec["launch_mix"],
                "graph_replay_launches": (
                    traced["fused_block"]["qmm_decode"]
                    if bits == 8 else None),
            },
            "library": "F.linear on the weight dequantized to bf16",
            "shapes": qrows[bits],
            "seedx": seedx_quant(qrows13[bits], seedx_lm, s_img),
        })
    print("[train] summary " + json.dumps(
        {k: v for k, v in train.items() if k != "profile"}))
    print("[worker] summary " + json.dumps(worker, default=str))
    print("[single] summary " + json.dumps(single_graph))
    print("[seedx] summary " + json.dumps(seedx, default=str))
    print("[detok] summary " + json.dumps(detok, default=str))
    print(f"[time] {time.perf_counter() - t_start:.1f} s: all phases done",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
