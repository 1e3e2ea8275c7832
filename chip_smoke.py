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
   weights drawn from seed 0, ``FakeTokenizer`` at vocab 128587;
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
   1024 over 20, cross-attention over the resampler's 64 tokens at both),
   and at phase 15's (SEED-X-Edit's batch of 3; SD-2.1 at 768²: S = 9216,
   2304, 576, 144; SD-1.5 at 512²: D = 40, 80, 160 over 77 text and 16
   image keys);
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
   and at the int8 / int4 SDXL UNet's projections (phase 15b: M = 8192,
   2048 and 128 context rows; int4 G = 640 where K = 640), with
   ``F.linear`` on the weight dequantized to bf16 as the yardstick;
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
   captured graph must hold 225 × 16 ``qmm_decode`` kernel nodes, every
   one the tracer saw launched; then phase 4c's int8
   parts: the speculative (k = 4) engine, whose captured verify tick
   counts 225 prefill-regime launches (M = 40) and whose graph holds 225
   ``qmm_prefill`` nodes, and check e;
8. training: ``mllm_npu_tpu_torch.train.train.main`` at full width (the
   same YAML, LoRA dropout 0.05, remat ``dots``, the chunked CE) on a
   webdataset tar of seeded JPEGs and captions through the caption entry of
   the pretrain mixture (``configs/dataset/caption_data.yaml``: max_length
   600, 64 image tokens, anyres over its grids at base 448), at the largest
   batch of 8 or 4 that fits (the recipe's 28, and 16, run out of memory
   on one H100 and are not tried), for a few steps on one repeated
   batch, its checkpoint write skipped (phase 13 writes the trainer's
   checkpoint). Every step's K1, K2 and K3 counts
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
   one UNet forward on CUDA events and under ``torch.profiler``;
12. the evaluator (``mllm_npu_tpu_torch.evaluate``), every count set to 0
   before each part and read after it: b. on the resident 8B models (bf16
   after phase 6, int8 in phase 7 before check e),
   ``bench_eval_speed``'s probes through ``EvalModel``, one reading
   each (``SPEED_READINGS``): the mmlu probe (10 synthetic 5-shot items
   of ~700 words, 10-token answers) on the single-request engine and (48
   items, six waves) through a batched engine of 8 slots with an 8-entry prefix
   cache (hits and tokens saved checked), the mme probe (5 768×1024
   JPEGs, 2 questions each): the warm pass, steady items/s and the
   readings' spread, the hours projected to the full MMLU and MME, the
   peak; on bf16 one
   ``lm_loss`` call (K1 60 launches, asserted), on int8 its refusal of
   the quantized weights; a. after phase 11, SEED-X at full width through
   ``evaluate.run.build_eval_model`` (``FakeTokenizer``, seed 0; answers
   with an image cut to 32 new tokens, run.py's engine takes 512): the
   seven benchmarks on ``tests/fixtures`` through ``run.dispatch``, each
   result file checked against its fixture's keys and rows; every
   ``lm_loss`` call's K1 launches asserted (91: the tower, its pool, the
   two resamplers, 40 Llama layers) and timed; one question's four
   choices with K1 against K1's plain version everywhere, every loss term
   within twice the bf16 control's largest reading and the ranking the
   same where the two lowest losses differ by more; then run.py's
   prefix-cache engine (2 slots, 2560 tokens, prompts to 2048 in buckets
   of 512, 4 entries) over the same model on the four text benchmarks and
   a synthetic subject whose preamble passes the 512-token alignment
   (hits and tokens saved), its prompts alone through an eager twin
   against the single-request engine by the logit rule, and the graphed
   engine's answers equal to the twin's;
13. SEED-X pretraining at full width, after phase 12a's model is dropped
   (the counts set to 0 before each training step and read after it): b.
   ``train.main`` on ``seedx_llama2_13b_qwenvl_vitg.yaml`` (Llama-2-13B
   with r32 LoRA, Qwen-ViT-G's 48 layers, both resamplers, vocab 32330,
   bf16 frozen and fp32 trainable weights, seed 0) and the port's
   ``pretrain_data.yaml`` with both entries at the recipe's values
   (caption tars and LLaVAR-style OCR jsonl, 1.0 : 0.2, img_first_ratio
   0.1), over one batch's worth of seeded data each, the caption batch cut
   from 28 to the largest of 4, 2 that fits (printed), with the SEED-X
   launcher's lr, cosine schedule, warmup and bf16: every step's K1, K2,
   K3 counts (131, 42, 42 under remat; K2/K3 by head dim: one each at
   D = 160, the input projector; all in the Hopper regime) asserted for
   either entry's batch, both entries run, a finite loss, ``rec_loss`` >
   0 on a caption batch, a checkpoint; then a few steps on one repeated
   batch at lr 1e-4 (the loss falls), one step taken apart (forward,
   backward, optimizer) and one under ``torch.profiler``; c. one step's
   gradients with K1/K2/K3 against plain attention (remat ``nothing``,
   dropout off): the LoRA, the input projector, the output projector and
   ``patch_pos_embed`` cos ≥ 0.99; d. the int4 QLoRA recipe
   (``--quantize_base int4``) the same way, K5 asserted per step (561:
   the 280 quantized bases twice under remat, and the lm_head) and K4
   never, its peak against the bf16 recipe's and the loss falling on a
   repeated batch, then one int8 step (K4 561); a. with the model
   dropped: K2 and K3 at head dims 144 and 160 against their plain
   versions across an edge sweep (causal GQA with segments, lengths off
   the tile, Sq != Sk, MHA at 600), then K1 with its LSE, K2 and K3 at the
   run's shapes (the input projector's windows × 64 × 256 keys, 32 heads
   of 160; the Llama-2-13B layer, 40/40 heads of 128 at the run's batch
   and length; the output projector) and at D = 144, timed beside SDPA's
   backward and the bound; and K4 / K5 at the training rows (batch × 600)
   of the 13B's projections and lm_head;
14. the reference's checkpoints, after phase 13 (the counts set to 0
   before each request and forward, read after): phase 2's seeded 8B
   assembly built again and written in the reference's layouts under a
   temporary directory (removed at the end): the base Llama as an HF
   directory of safetensors shards of at most 5 GB at its own vocabulary
   of 128256 without adapters, SigLIP as an HF directory, the assembly as
   a peft ``pytorch_model.bin`` (the adapters as ``lora_*.default``, the
   norms as ``modules_to_save.default`` beside zeroed ``original_module``
   copies, the resized ``embed_tokens`` and ``lm_head``, the projector,
   ``patch_pos_embed``); the engine built from a copy of the 8B YAML
   naming them: every tensor equal to its source bit for bit, phase 4's
   three requests' greedy ids and K1 counts (60, 60, 32); the same model
   loaded again and quantized to int8: phase 7's two requests' ids and
   K4 counts; the time from
   a new process's start to the first token, from the files;
   ``tools.convert_checkpoint`` on the
   same YAML in a process of its own, then the worker's engine from
   ``--params-checkpoint`` on the YAML with null paths: every tensor
   equal, the same ids and counts; b. phase 11's seeded UNet and VAE
   written as diffusers directories (the UNet's ``attn2`` ``to_k`` /
   ``to_v`` zeroed) and the de-tokenizer checkpoint as the resampler and
   that subset, built through ``sd_xl_resampler.yaml``'s copy: every
   tensor equal, one UNet forward's ε bit for bit the seeded adapter's,
   140 K1 launches. Each part prints the GiB written and seconds, the load
   seconds and GiB/s per component, and the peaks of host and device
   memory;
15. the de-tokenizer's variants, after phase 14 (SEED-X's vision encoder
   alone and the SDXL adapter from ``sd_xl_resampler.yaml``, seed 0, bf16;
   features of the output projector's shape seeded at the zero-image
   negative's RMS; every count set to 0 before each path and read after,
   each path's wall time, peak and launches printed): b. the 1024²
   caption → image path (``SDXLAdapter.generate``, 10 steps) with the UNet
   bf16, then ``quantize_unet_params`` int8 and int4 (K4 / K5 722 a
   forward, asserted): ms a step, the UNet's GiB, the first step's ε
   against the plain int8 / int4 products (cos ≥ 0.99) and against the
   bf16 UNet; c. de-tokenizer training: ``SDXLAdapter.loss_fn`` over
   ``adapter_trainable_patterns()`` (the resampler and the 140 ``attn2``
   ``to_k`` / ``to_v``, fp32; the modules in bf16) at 1024², the largest
   batch of 4, 2, 1 that fits: VAE latents of seeded images × the scaling
   factor, ``DDPMScheduler.add_noise`` at seeded timesteps; 4 AdamW steps
   at lr 1e-5; on one more batch an SGD step along the gradient, sized for
   a first-order drop of 1% of the loss (the drop measured within 20% of
   it), then a fresh AdamW's 4 steps (every later loss below the first);
   every step K1 with its LSE 280 (remat), K2 = K3 = 140, all wgmma, asserted;
   one batch's gradients against plain attention (cos ≥ 0.99); then K1
   with its LSE, K2 and K3 at the run's batch and the UNet's shapes; a.
   SEED-X-Edit (``build_sdxl_adapter(with_latent_image=True)``: the
   8-channel UNet) on a seeded 1024² image: 30 steps at batch 3, guidance
   7.5 and 1.5: VAE encode, ms a step, VAE decode, K1 140 × 30; the first
   step's ε and a 4-step run's latents against plain attention beside the
   bf16 control; d. ``SDXLText2ImageAndEditAdapter`` over the 8-channel
   UNet with r16 LoRA (15a's resampler and VAE): one training step over
   ``trainable_patterns(True)`` (K1 280, K2 = K3 = 140) and a 4-step edit
   generate; e. ``SD21Text2ImageAndEditAdapter`` (the 8-channel SD-2.1
   UNet, a plain ``Resampler``, the SD VAE) at 768² and
   ``IPAdapterSDPipe`` over SD-1.5 with 16 image tokens after 77 zero text
   tokens at 512², a 4-step generate each, and one IP UNet forward's ε
   (D = 40, 80, 160) against plain attention;
16. the trainer's host side, right after phase 8 and on its model (no
   second 8B build), with N = min(8, cores / 2) loader workers and every
   count set to 0 before each part and read after: a. the loader alone
   (the caption task at phase 8's batch and ``max_length`` 600 over N
   tars that each hold the same B 896² JPEGs, so every batch is the same
   batch): batches/s at 0 workers and N spawned ones, the seconds to the
   first batch, a ready batch's transfer into the parent (ms), and each
   worker's modules (no JAX, no CUDA context); b. phase 8's trainer run
   (``train.main``, its build of the assembly handed phase 8's model) with
   ``--dataloader_workers N`` (spawned workers, or the phase fails), its
   sec/step over 3 steps beside phase 8's threaded loader's and beside 3
   steps fed from memory (one collated batch on the card through
   ``make_train_step``), each with a traced step's device busy share; c. one step's gradients under each remat policy (``dots``,
   ``nothing``, ``dots_no_batch``, ``dots_lite``, ``hoist_attn``): s,
   peak, K1 92 a step (60 under ``hoist_attn``), K2 = K3 = 33, the
   gradients' cosine against ``dots``' (≥ 0.9999); d. Adafactor
   (``OptimizerConfig(optimizer="adafactor")``) three steps on the
   repeated batch without weight decay (every later loss below the
   first), then one at the default 0.05 and the loss after it, and its
   state's GiB beside AdamW's; e. caption, interleaved and pure text
   (1.0 : 0.5 : 0.5) through a pool of one spawned worker, two steps of
   enough micro-batches that each task reaches the loss (text rows without
   image slots).

Phases 2 to 16 build from copies of the shipped configs with their
checkpoint paths null (``use_seeded_configs``): the repository holds no
weights, and a configured path that does not exist raises.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import base64
import contextlib
import functools
import gc
import io
import json
import math
import os
import signal
import subprocess
import sys
import tarfile
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# training: the recipe's batch is 28; 28 and 16 run out of memory on one
# H100 (PERF.md §4), so the phase starts at 8, then smaller ones until one
# fits
TRAIN_RECIPE_BATCH = 28
TRAIN_BATCHES = (8, 4)
TRAIN_STEPS = 5
CE_CHUNK = 128
# the kernel and the plain attention give one step's gradients this close
GRAD_COS = 0.99
LLAMA3_YAML = "mllm_npu_tpu_torch/configs/models/mllm_llama3_8b_siglip_vit.yaml"
# the checkpoint paths a config names; the shipped ones point at the
# reference's pretrained/ files, which the repository does not hold
CHECKPOINT_KEYS = ("pretrained_model_name_or_path", "pretrained_model_path",
                   "unet_checkpoint", "vae_checkpoint", "adapter_checkpoint")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def null_checkpoints(node):
    """``node`` (a loaded config) with every checkpoint path set to null
    (seeded weights), the tokenizer's left as it is."""
    if isinstance(node, dict):
        return {k: None if k in CHECKPOINT_KEYS else
                v if k == "tokenizer" else null_checkpoints(v)
                for k, v in node.items()}
    return node


def use_seeded_configs():
    """Outside DEBUG_FLAG a configured checkpoint path that does not exist
    raises. The phases that run on seeded weights take copies of the
    shipped configs with null checkpoint paths, written under
    ``build/seeded_configs`` (the worker's JSON pointing at the copies)."""
    global LLAMA3_YAML, SEEDX_YAML, SEEDX_WORKER, GEN_CONFIG
    import yaml
    out = ROOT / "build" / "seeded_configs"
    out.mkdir(parents=True, exist_ok=True)

    def write(name, text):
        tmp = out / f".{name}.{os.getpid()}"
        tmp.write_text(text)
        os.replace(tmp, out / name)
        return str(out / name)

    def copy(rel):
        node = yaml.safe_load((ROOT / rel).read_text())
        return write(Path(rel).name,
                     yaml.safe_dump(null_checkpoints(node), sort_keys=False))
    LLAMA3_YAML, SEEDX_YAML, GEN_CONFIG = map(
        copy, (LLAMA3_YAML, SEEDX_YAML, GEN_CONFIG))
    wc = json.loads((ROOT / SEEDX_WORKER).read_text())
    wc.update(model_config=SEEDX_YAML, generation_config=GEN_CONFIG)
    SEEDX_WORKER = write(Path(SEEDX_WORKER).name, json.dumps(wc, indent=1))


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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()       # only fn's device work in the window
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_activity(prof, wall_ms)


def device_activity(prof, wall_ms):
    """``profile_call``'s readings from a finished profiler."""
    from torch.autograd import DeviceType
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


def caption_tar(path, n, seed=0, size=None):
    """A webdataset tar of ``n`` JPEGs of seeded sizes (each side 448 to
    1400 pixels, so the anyres grids vary; or ``size``² each) and pixels,
    with the caption in the JSON metadata, as LAION-COCO's shards hold
    it."""
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            w, h = (int(x) for x in rs.randint(448, 1401, 2))
            if size is not None:
                w = h = size
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

    from mllm_npu_tpu_torch.models.language_models.llama import (
        set_lora_dropout_seed)
    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import (compute_grads,
                                                      make_train_step)
    from mllm_npu_tpu_torch.utils.weights import set_llama_config

    model_yaml = ROOT / LLAMA3_YAML
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
        # the earlier phases' engines can outlive their names in reference
        # cycles: collect them, so the peak is the run's own
        resident = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train] before batch {B}: {resident / 2**30:.2f} GiB "
              f"allocated, {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
              "after gc.collect", flush=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            # no checkpoint written: phase 13 drives the trainer's save (cut
            # for the time limit, PERF.md §4)
            with no_checkpoints():
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
    batch = run.last_batches
    n_images = int(batch[0]["images"].shape[0])
    seq = int(batch[0]["input_ids"].shape[1])
    steady = per_step[1:]
    summary = {
        "batch": B, "cut_from": TRAIN_RECIPE_BATCH, "seq": seq,
        "images": n_images, "steps": TRAIN_STEPS, "losses": losses,
        "sec_per_step": sum(r["sec/step"] for r, _ in steady) / len(steady),
        "tokens_per_s": sum(r["tokens/s"] for r, _ in steady) / len(steady),
        "images_per_s": sum(r["images/s"] for r, _ in steady) / len(steady),
        "peak_gib": peak, "wall_s": wall,
        "launches": {k: sum(g[k] for _, g in per_step) for k in expect},
        "trainable_m": sum(p.numel() for p in model.parameters()
                           if p.requires_grad) / 1e6,
    }
    print(f"[train] batch {B} (the recipe's {TRAIN_RECIPE_BATCH} cut to fit), "
          f"S {seq}, {n_images} image slots: {TRAIN_STEPS} steps in "
          f"{wall:.1f} s with the build; steps 2-{TRAIN_STEPS}: "
          f"{summary['sec_per_step']:.3f} sec/step, "
          f"{summary['tokens_per_s']:.0f} tokens/s, "
          f"{summary['images_per_s']:.1f} images/s; peak "
          f"{peak:.2f} GiB; {summary['trainable_m']:.1f} M trainable; "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    import shutil
    shutil.rmtree(workdir / f"out_b{B}", ignore_errors=True)
    t_part = [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        print(f"[time] phase 8 {name}: {now - t_part[0]:.1f} s", flush=True)
        t_part[0] = now

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

    part_done("a step and its forward taken apart")

    # one step (gradients and the update) under the profiler
    step = make_train_step(model, trainer.mllm_loss, run.optimizer)
    summary["profile"] = profile_call(lambda: step(batch))
    print_profile(f"one training step at batch {B}", *summary["profile"])
    part_done("the profiled step")

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
        with plain_attention() if route == "plain" else \
                contextlib.nullcontext():
            compute_grads(model, trainer.mllm_loss, batch)
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
    del grads, run, step
    gc.collect()
    torch.cuda.empty_cache()
    part_done("the gradient check")

    # -- 16. the trainer's host side, on this model ----------------------
    summary["host"] = host_phase(model, batch, workdir, B,
                                 summary["sec_per_step"])
    for k, n in summary["host"]["launches"].items():
        summary["launches"][k] += n
    del model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return summary


# -- phase 16: the trainer's host side, on phase 8's model ----------------

# the loader's worker count: the reference's launcher uses 8, and a worker
# per two of the host's cores leaves the rest to the training process
HOST_WORKERS = min(8, (os.cpu_count() or 2) // 2)
HOST_IMAGE = 896          # each side of 16a/16b's JPEGs (a 2x2 grid + thumb)
LOADER_BATCHES = 3        # batches per loader reading (16a), 2 a worker
HOST_STEPS = 5            # the pool-fed trainer run: steps 2-4 timed, 5 traced
MEMORY_STEPS = 3          # the step fed from memory, timed
# dots first (the gradients the others are held to) and last (the order's
# effect on its time)
REMAT_POLICIES = ("dots", "nothing", "dots_no_batch", "dots_lite",
                  "hoist_attn", "dots")
REMAT_COS = 0.9999
ADAFACTOR_STEPS = 3
DECAY_STEPS = 1
# 16e: the mixture, in the YAML's order, and its batch and workers
MIX = (("interleaved", 0.5), ("caption", 1.0), ("text", 0.5))
MIX_BATCH = 2
MIX_WORKERS = 1
MIX_STEPS = 2


def worker_env() -> dict:
    """What this process has loaded: JAX, the JAX package, a CUDA
    context."""
    torch = sys.modules.get("torch")
    return {"pid": os.getpid(), "jax": "jax" in sys.modules,
            "reference": any(m.split(".")[0] == "mllm_npu_tpu"
                             for m in sys.modules),
            "cuda": bool(torch is not None
                         and torch.cuda.is_initialized())}


class WorkerCheckFactory:
    """``factory``'s batches, each with its worker's ``worker_env()``
    (16a's pool: a spawned worker must load neither JAX nor CUDA)."""

    def __init__(self, factory):
        self.factory = factory

    def __call__(self, seed):
        env = worker_env()
        for batch in self.factory(seed):
            yield dict(batch, worker_env=env)


def host_data(root, shards, B, size, seed=0):
    """``shards`` tars that each hold the same ``B`` JPEGs of size² pixels:
    with a worker a shard, every batch is the same batch."""
    root.mkdir(parents=True)
    caption_tar(root / "shard-000000.tar", B, seed=seed, size=size)
    for s in range(1, shards):
        (root / f"shard-{s:06d}.tar").write_bytes(
            (root / "shard-000000.tar").read_bytes())
    return root


def caption_node(data_dir, B):
    """The caption entry of ``caption_data.yaml`` over ``data_dir``, every
    sample image-first (as phase 8's)."""
    import yaml
    ds = yaml.safe_load((ROOT / "mllm_npu_tpu_torch" / "configs" / "dataset"
                         / "caption_data.yaml").read_text())
    node = ds["datapipes"][0]
    node.update(data_dir=[str(data_dir)], batch_size=B, img_first_ratio=1.0,
                cycle_count=100000)
    return ds, node


def host_factory(ds, lm_vocab):
    from mllm_npu_tpu_torch.configs import instantiate, load_config
    from mllm_npu_tpu_torch.data.datapipes import PipeFactory
    from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
    proc = instantiate(load_config(str(ROOT / LLAMA3_YAML))["mllm"][
        "processor"])
    return PipeFactory(ds, FakeTokenizer(vocab_size=lm_vocab), proc)


def loader_reading(factory, workers):
    """16a: the loader alone on the host: s to the first batch, batches/s
    over LOADER_BATCHES more, and (pool) the parent's ms to take a batch
    that is ready (its transfer: mapping the worker's shared-memory
    segment) and the workers' environments."""
    from mllm_npu_tpu_torch.data.dataloader import (DataLoader,
                                                    MultiProcessDataLoader)
    if workers:
        loader = MultiProcessDataLoader(WorkerCheckFactory(factory),
                                        num_workers=workers, prefetch=4)
    else:
        loader = DataLoader(factory, prefetch=4)
    envs = []
    it = iter(loader)
    try:
        t0 = time.perf_counter()
        batch = next(it)
        first_s = time.perf_counter() - t0
        n = max(LOADER_BATCHES, 2 * workers)
        t0 = time.perf_counter()
        for _ in range(n):
            envs.append(next(it).pop("worker_env", None))
        rate = n / (time.perf_counter() - t0)
        transfer = []
        if workers:
            # the queues fill while nothing is read; then each get finds
            # its batch waiting
            time.sleep(0.5)
            for _ in range(workers):
                t0 = time.perf_counter()
                next(it)
                transfer.append(time.perf_counter() - t0)
    finally:
        loader.shutdown()
    batch.pop("worker_env", None)
    mb = sum(v.nbytes for v in batch.values()
             if hasattr(v, "nbytes")) / 2**20
    return {"workers": workers, "first_batch_s": first_s,
            "batches_per_s": rate, "batch_mib": mb,
            "transfer_ms": sorted(t * 1e3 for t in transfer),
            "worker_envs": [e for e in envs if e]}


class ProfileWindow:
    """``torch.profiler`` over a window opened by ``start()`` and closed by
    ``stop()`` (each after a synchronize); ``stop`` returns
    ``profile_call``'s (wall ms, busy ms, top, counts)."""

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(None, None, None)
        return device_activity(self.prof, wall_ms)


def trainer_argv(data_yaml, out, steps, extra=()):
    return ["--model", str(ROOT / LLAMA3_YAML),
            "--train_dataset", str(data_yaml), "--output_dir", str(out),
            "--max_steps", str(steps), "--save_steps", "1000000",
            "--log_steps", "1", "--learning_rate", "3e-4",
            "--lr_scheduler_type", "constant", "--warmup_steps", "0",
            "--ce_loss_chunk", str(CE_CHUNK), "--fake_tokenizer",
            "--device", "cuda", "--seed", "0", *extra]


@contextlib.contextmanager
def trained_model(model):
    """``train.main``'s build of its ``--model`` assembly (the one
    ``instantiate`` call given ``language_model=``) returns ``model``
    instead (16b, 16e: phase 8's, on the card with its trainable set
    marked; no second 8B build)."""
    from mllm_npu_tpu_torch import configs
    build = configs.instantiate

    def instantiate(node, *args, **kwargs):
        if "language_model" in kwargs:
            return model
        return build(node, *args, **kwargs)

    configs.instantiate = instantiate
    try:
        yield
    finally:
        configs.instantiate = build


@contextlib.contextmanager
def no_checkpoints():
    """The trainer's checkpoint writes skipped (phases 8 and 16: phase 13
    drives the save; each final save of the 8B run writes 11.27 GiB), and
    its SIGTERM handler dropped after."""
    from mllm_npu_tpu_torch.train.checkpoint import CheckpointManager
    save = CheckpointManager.save
    CheckpointManager.save = lambda self, *a, **k: None
    try:
        yield
    finally:
        CheckpointManager.save = save
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def read_launches(counters):
    got = {k: fn.launches for k, fn in counters.items()}
    for fn in counters.values():
        fn.launches = 0
    return got


def pool_trainer_run(model, data_yaml, workdir, counters):
    """16b: phase 8's trainer run on the same model, fed by the pool."""
    from mllm_npu_tpu_torch.train import train as trainer
    records, window, traced = [], ProfileWindow(), {}

    def on_step(rec):
        records.append(rec)
        if rec["step"] == HOST_STEPS - 1:
            window.start()
        elif rec["step"] == HOST_STEPS:
            traced["profile"] = window.stop()

    read_launches(counters)
    with no_checkpoints(), trained_model(model):
        run = trainer.main(trainer_argv(
            data_yaml, workdir / "out_pool", HOST_STEPS,
            ("--dataloader_workers", str(HOST_WORKERS))), on_step=on_step)
    check(run.model is model, "16b trained another model than phase 8's")
    launches = read_launches(counters)
    kind = run.loader.worker_kind
    del run
    gc.collect()
    check(kind == "spawn", f"the trainer's loader ran {kind} workers, not "
          "spawned processes: its PipeFactory did not pickle")
    steady = [r["sec/step"] for r in records[1:HOST_STEPS - 1]]
    check(all(math.isfinite(r["loss"]) for r in records),
          f"pool-fed losses {[r['loss'] for r in records]}")
    return {"worker_kind": kind, "steps": len(records),
            "sec_per_step": sum(steady) / len(steady),
            "sec_per_step_each": [r["sec/step"] for r in records],
            "losses": [r["loss"] for r in records],
            "profile": traced["profile"], "launches": launches}


def memory_fed_steps(model, batch, optimizer):
    """16b: the step fed from memory: one collated batch already on the
    card through ``make_train_step``, MEMORY_STEPS each timed as the
    trainer's loop times its steps (to the loss read after the update),
    then one more under the profiler."""
    import torch

    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import make_train_step
    step = make_train_step(model, trainer.mllm_loss, optimizer)
    torch.cuda.synchronize()
    secs, losses = [], []
    for _ in range(MEMORY_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(batch)[0]))
        secs.append(time.perf_counter() - t0)
    return {"sec_per_step": sum(secs) / len(secs), "sec_per_step_each": secs,
            "losses": losses, "profile": profile_call(lambda: step(batch))}


def state_gib(optimizer) -> float:
    return sum(t.numel() * t.element_size()
               for k in optimizer._STATE
               for t in getattr(optimizer, k).values()) / 2**30


def remat_policies(model, batch, counters, n_vis):
    """16c: one step's gradients (no update) under each remat policy: s,
    peak, K1/K2/K3 launches, and the gradients' cosine against ``dots``'."""
    import torch

    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import (compute_grads,
                                                      trainable_parameters)
    from mllm_npu_tpu_torch.utils.weights import set_llama_config
    lm = model.language_model
    L = lm.config.num_hidden_layers
    before = (lm.config.remat, lm.config.remat_policy)
    params = [p for _, p in trainable_parameters(model)]
    for p in params:
        p.grad = None
    out, ref = {}, None
    for policy in REMAT_POLICIES:
        set_llama_config(lm, remat=True, remat_policy=policy)
        read_launches(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        compute_grads(model, trainer.mllm_loss, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        got = read_launches(counters)
        k1 = n_vis + 1 + (1 if policy == "hoist_attn" else 2) * L
        expect_counts(got, f"16c {policy}", flash_fwd=k1,
                      flash_bwd_dq=L + 1, flash_bwd_dkv=L + 1)
        if ref is None:
            ref = [p.grad.clone() for p in params]
            cos = 1.0
        else:
            dot = sum(float((p.grad.float() * r.float()).sum())
                      for p, r in zip(params, ref))
            na = sum(float(p.grad.float().pow(2).sum()) for p in params)
            nb = sum(float(r.float().pow(2).sum()) for r in ref)
            cos = dot / math.sqrt(na * nb)
        label = policy if policy not in out else f"{policy} (again)"
        out[label] = {"sec": sec, "peak_gib": peak / 2**30,
                       "activations_gib": (peak - resident) / 2**30,
                       "grad_cos_vs_dots": cos, "launches": got}
        print(f"[phase 16c] remat {label}: {sec:.3f} s a step's gradients, "
              f"peak {peak / 2**30:.2f} GiB ({(peak - resident) / 2**30:.2f} "
              f"above the resident), K1 {got['flash_fwd']}, K2 "
              f"{got['flash_bwd_dq']}, K3 {got['flash_bwd_dkv']}; gradient "
              f"cos vs dots {cos:.7f}", flush=True)
        check(cos >= REMAT_COS, f"remat {policy}: gradients cos {cos} vs "
              "dots")
        for p in params:
            p.grad = None
    del ref
    set_llama_config(lm, remat=before[0], remat_policy=before[1])
    return out


def adafactor_steps(model, batch, adamw_gib, counters):
    """16d: Adafactor (``OptimizerConfig(optimizer="adafactor")``, as the
    reference's ``build_optimizer`` configures optax's) for ADAFACTOR_STEPS
    on the repeated batch without weight decay (the losses must fall), then
    DECAY_STEPS more (and the loss after them) at the default rate 0.05,
    which the reference adds
    after the learning rate: each step takes 5% off every trainable weight
    (ROADMAP, known issues of the reference)."""
    import torch

    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import (
        OptimizerConfig, build_optimizer, make_train_step,
        trainable_parameters)
    read_launches(counters)
    out = {}
    for wd, steps in ((0.0, ADAFACTOR_STEPS), (0.05, DECAY_STEPS)):
        opt = build_optimizer(trainable_parameters(model), OptimizerConfig(
            optimizer="adafactor", lr=3e-4, warmup_steps=0,
            scheduler="constant", mu_dtype="bfloat16", weight_decay=wd))
        step = make_train_step(model, trainer.mllm_loss, opt)
        t0 = time.perf_counter()
        losses = [float(step(batch)[0]) for _ in range(steps)]
        sec = (time.perf_counter() - t0) / steps
        if wd:
            with torch.no_grad():       # the loss after the last update
                losses.append(float(trainer.mllm_loss(model, batch[0])[0]))
        out[f"weight_decay_{wd:g}"] = {"losses": losses, "sec_per_step": sec}
        print(f"[phase 16d] Adafactor at weight decay {wd:g}, {steps} "
              f"step(s) on the repeated batch: losses "
              f"{[round(x, 5) for x in losses]}"
              + (" (the last after the update, no gradient)" if wd else "")
              + f", {sec:.3f} s a step", flush=True)
        check(all(math.isfinite(x) for x in losses),
              f"Adafactor's losses {losses}")
        if wd == 0.0:
            out["state_gib"] = state_gib(opt)
            out["factored"] = len(opt.v_row)
            check(all(x < losses[0] for x in losses[1:]),
                  f"Adafactor's losses did not fall below the first: "
                  f"{losses}")
        del opt, step
        gc.collect()
    print(f"[phase 16d] Adafactor's state {out['state_gib']:.3f} GiB "
          f"({out['factored']} factored tensors) against AdamW's "
          f"{adamw_gib:.3f} GiB (bf16 mu)", flush=True)
    out["adamw_state_gib"] = adamw_gib
    out["launches"] = read_launches(counters)
    return out


def mixture_draws(seed, weights, n):
    """The multiplexer's first ``n`` picks (``SampleMultiplexer`` while no
    stream is exhausted)."""
    from mllm_npu_tpu_torch.data.streams import derive_rng
    picks = []
    for d in range(n):
        r = derive_rng(seed, "mux", d).uniform(0, sum(weights))
        acc = 0.0
        for i, w in enumerate(weights):
            acc += w
            if r <= acc:
                picks.append(i)
                break
    return picks


def interleaved_tar(path, n, seed):
    """``n`` pickled interleaved records (a 448² JPEG, then text, one to
    two times) in a tar."""
    import pickle

    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            images, texts = [], []
            for _ in range(int(rs.randint(1, 3))):
                buf = io.BytesIO()
                Image.fromarray((rs.rand(448, 448, 3) * 255).astype(
                    np.uint8)).save(buf, format="JPEG", quality=85)
                images += [base64.b64encode(buf.getvalue()).decode(), None]
                texts += [None, " ".join(rs.choice(WORDS, 40))]
            data = pickle.dumps({"images": images, "texts": texts})
            info = tarfile.TarInfo(f"{i:06d}.pkl")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def mixture_run(model, workdir, counters, proc_size):
    """16e: caption, interleaved and pure text (1.0 : 0.5 : 0.5) through
    the pool, MIX_STEPS steps on phase 8's model; every micro-batch's
    dataset, image slots and supervised labels recorded where the trainer
    moves it to the card."""
    import numpy as np
    import yaml

    from mllm_npu_tpu_torch.train import train as trainer
    root = workdir / "mix"
    caption = host_data(root / "caption", MIX_WORKERS, 2 * MIX_BATCH, 448,
                        seed=3)
    (root / "interleaved").mkdir()
    (root / "text").mkdir()
    rs = np.random.RandomState(5)
    for w in range(MIX_WORKERS):
        interleaved_tar(root / "interleaved" / f"part-{w}.tar", 4, seed=w)
        (root / "text" / f"part-{w}.jsonl").write_text("".join(
            json.dumps({"text": " ".join(rs.choice(WORDS, 300))}) + "\n"
            for _ in range(8)))
    ds, cap = caption_node(caption, MIX_BATCH)
    nodes = {
        "caption": dict(cap, dataset_name="caption"),
        "interleaved": {
            "_target_": "mllm_npu_tpu_torch.data.tasks."
                        "interleaved_image_text."
                        "build_interleave_datapipes_with_pixels",
            "data_dir": [str(root / "interleaved")], "max_length": 600,
            "batch_size": MIX_BATCH, "img_first_ratio": 0.5,
            "num_img_in_tokens": 64, "num_img_out_tokens": 64,
            "cycle_count": 100000, "dataset_name": "interleaved"},
        "text": {
            "_target_": "mllm_npu_tpu_torch.data.tasks.pure_text."
                        "build_text_datapipes",
            "data_dir": [str(root / "text")], "max_length": 600,
            "batch_size": MIX_BATCH, "image_size": proc_size,
            "cycle_count": 100000, "dataset_name": "text"},
    }
    ds["datapipes"] = [nodes[name] for name, _ in MIX]
    ds["sample_weights"] = [w for _, w in MIX]
    data_yaml = workdir / "mix.yaml"
    data_yaml.write_text(yaml.safe_dump(ds))
    # every worker's multiplexer draws the same picks from the loader's
    # seed, so the pool yields MIX_WORKERS batches of each pick in turn:
    # accumulate enough micro-batches that the steps meet every task
    picks = mixture_draws(888, [w for _, w in MIX], 64)
    draws = 1 + max(picks.index(i) for i in range(len(MIX)))
    ga = -(-MIX_WORKERS * draws // MIX_STEPS)
    seen, records = [], []
    to_device = trainer.batch_to_device

    def recording(batch, device):
        seen.append({
            "dataset": batch.get("dataset_name"),
            "image_slots": int(batch["embeds_cmp_mask"].sum()
                               + batch["embeds_gen_mask"].sum()),
            "image_tokens": int(batch["ids_cmp_mask"].sum()
                                + batch["ids_gen_mask"].sum()),
            "supervised": int((batch["labels"] != -100).sum())})
        return to_device(batch, device)

    read_launches(counters)
    trainer.batch_to_device = recording
    try:
        with no_checkpoints(), trained_model(model):
            run = trainer.main(trainer_argv(
                data_yaml, workdir / "out_mix", MIX_STEPS,
                ("--dataloader_workers", str(MIX_WORKERS),
                 "--gradient_accumulation_steps", str(ga))),
                on_step=records.append)
    finally:
        trainer.batch_to_device = to_device
    check(run.model is model, "16e trained another model than phase 8's")
    kind = run.loader.worker_kind
    del run
    gc.collect()
    launches = read_launches(counters)
    names = {s["dataset"] for s in seen}
    print(f"[phase 16e] mixture {dict(MIX)} through {MIX_WORKERS} {kind} "
          f"workers, {MIX_STEPS} steps of {ga} micro-batches at batch "
          f"{MIX_BATCH}: " + "; ".join(
              f"step {r['step']} loss {r['loss']:.4f} over {r['datasets']}"
              for r in records) + "; micro-batches " + json.dumps(seen),
          flush=True)
    check(kind == "spawn", f"16e ran {kind} workers")
    check(names == {name for name, _ in MIX}, f"16e met {names}")
    for s in seen:
        check(s["supervised"] > 0, f"16e: no supervised label in {s}")
        if s["dataset"] == "text":
            check(s["image_slots"] == 0 and s["image_tokens"] == 0,
                  f"16e: a text-only batch carries image slots: {s}")
        else:
            check(s["image_slots"] > 0 and s["image_tokens"] > 0,
                  f"16e: an image task's batch without images: {s}")
    check(len(records) == MIX_STEPS
          and all(math.isfinite(r["loss"]) for r in records),
          f"16e losses {[r['loss'] for r in records]}")
    return {"grad_accum": ga, "micro_batches": seen,
            "losses": [r["loss"] for r in records],
            "datasets": [r["datasets"] for r in records],
            "launches": launches}


def host_phase(model, batch, workdir, B, threaded_sec):
    """Phase 16 on phase 8's model; returns its readings."""
    import torch

    from mllm_npu_tpu_torch.train.train_state import (
        AdamW, OptimizerConfig, trainable_parameters)
    t_phase = time.perf_counter()
    print(f"[phase 16] the trainer's host side on phase 8's model, "
          f"{HOST_WORKERS} workers ({os.cpu_count()} cores)", flush=True)
    from mllm_npu_tpu_torch.utils.weights import set_llama_config
    counters = kernel_counters()
    n_vis = model.vision_encoder.config.num_hidden_layers
    vocab = model.language_model.config.vocab_size
    # phase 8's policy (its gradient check left 'nothing')
    set_llama_config(model.language_model, remat_policy="dots")
    out = {"workers": HOST_WORKERS, "cores": os.cpu_count(),
           "launches": {k: 0 for k in counters}, "part_s": {}}
    t_part = [time.perf_counter()]

    def add(launches):
        for k, n in launches.items():
            out["launches"][k] += n

    def part_done(name):
        now = time.perf_counter()
        out["part_s"][name] = now - t_part[0]
        t_part[0] = now
        print(f"[time] phase {name}: {out['part_s'][name]:.1f} s", flush=True)

    # 16a: the loader alone
    data = host_data(workdir / "host_data", HOST_WORKERS, B, HOST_IMAGE)
    ds, _ = caption_node(data, B)
    factory = host_factory(ds, vocab)
    out["loader"] = [loader_reading(factory, w) for w in (0, HOST_WORKERS)]
    for r in out["loader"]:
        print(f"[phase 16a] loader, {r['workers']} workers, batch {B} of "
              f"{HOST_IMAGE}² JPEGs ({r['batch_mib']:.1f} MiB a batch): "
              f"first batch {r['first_batch_s']:.2f} s, then "
              f"{r['batches_per_s']:.2f} batches/s"
              + (f"; a ready batch's transfer {r['transfer_ms'][0]:.1f} to "
                 f"{r['transfer_ms'][-1]:.1f} ms" if r["workers"] else ""),
              flush=True)
    envs = out["loader"][1].pop("worker_envs")
    check(len({e["pid"] for e in envs}) == HOST_WORKERS,
          f"16a: batches from {len({e['pid'] for e in envs})} workers")
    check(not any(e["jax"] or e["reference"] or e["cuda"] for e in envs),
          f"16a: a worker loaded JAX or CUDA: {envs}")
    part_done("16a")

    # 16b: the trainer fed by the pool, then a step fed from memory
    data_yaml = workdir / "host_data.yaml"
    import yaml
    data_yaml.write_text(yaml.safe_dump(ds))
    pool = out["pool"] = pool_trainer_run(model, data_yaml, workdir,
                                          counters)
    add(pool.pop("launches"))
    adamw = AdamW(trainable_parameters(model), OptimizerConfig(
        lr=3e-4, warmup_steps=0, scheduler="constant", mu_dtype="bfloat16"))
    read_launches(counters)
    mem = out["memory"] = memory_fed_steps(model, batch, adamw)
    add(read_launches(counters))
    adamw_gib = state_gib(adamw)
    # freed, not returned to the card: the allocator keeps its segments,
    # so 16c's first step does not time their regrowth
    del adamw
    gc.collect()
    busy = {k: r["profile"][1] / r["profile"][0] for k, r in
            (("pool", pool), ("memory", mem))}
    out["threaded_sec_per_step"] = threaded_sec
    each = lambda xs: ", ".join(f"{x:.3f}" for x in xs)
    print(f"[phase 16b] sec/step at batch {B}: the pool ({HOST_WORKERS} "
          f"{pool['worker_kind']} workers) {pool['sec_per_step']:.3f} (steps "
          f"2-{HOST_STEPS - 1}; every step {each(pool['sec_per_step_each'])}"
          f"), the threaded loader (phase 8) {threaded_sec:.3f}, fed from "
          f"memory {mem['sec_per_step']:.3f} ({each(mem['sec_per_step_each'])}"
          f"); a traced step's device busy share: "
          f"pool {100 * busy['pool']:.1f}%, memory {100 * busy['memory']:.1f}%"
          f"; pool losses {[round(x, 4) for x in pool['losses']]}",
          flush=True)
    print_profile("16b: a pool-fed trainer step", *pool["profile"])
    print_profile("16b: a step fed from memory", *mem["profile"])
    part_done("16b")

    # 16c: the remat policies
    out["remat"] = remat_policies(model, batch, counters, n_vis)
    for r in out["remat"].values():
        add(r["launches"])
    gc.collect()
    part_done("16c")

    # 16d: Adafactor
    out["adafactor"] = adafactor_steps(model, batch, adamw_gib, counters)
    add(out["adafactor"].pop("launches"))
    gc.collect()
    part_done("16d")

    # 16e: the three-task mixture through the pool
    proc_size = factory.processor.image_size
    out["mixture"] = mixture_run(model, workdir, counters, proc_size)
    add(out["mixture"].pop("launches"))
    part_done("16e")
    for k in ("pool", "memory"):
        out[k]["profile"] = out[k]["profile"][:2]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[phase 16] done in {out['seconds']:.1f} s", flush=True)
    return out


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
    launches summed over the requests, the prefill-regime launches of K4
    and K5 summed likewise, and each request's greedy ids."""
    import torch

    from mllm_npu_tpu_torch.ops import quant as tq
    counters = kernel_counters()
    quant = engine.generator.model.language_model.config.quantization
    per_forward = 7 * lm_cfg.num_hidden_layers + 1
    k1_image = k1_per_image(engine.generator.model)
    total = dict.fromkeys(counters, 0)
    prefill_total = {8: 0, 4: 0}
    all_ids = []
    for i, ((q, b64), prep) in enumerate(zip(requests, preps), 1):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        tq.int8_matmul.prefill_launches = tq.int4_matmul.prefill_launches = 0
        t0 = time.perf_counter()
        ids = engine.comprehension_ids(q, b64)
        text = engine._strip_text(ids)
        wall = time.perf_counter() - t0
        all_ids.append(ids)
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
    return total, prefill_total, all_ids


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
# tokens per request of checks d and f's recorded (eager) streams, held
# against the first tokens of the graphed runs' MAX_NEW_TOKENS (cut from 32
# for the time limit, PERF.md §4)
CHECK_TOKENS = 16
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


def single_stream(engine, q, b64, tokens=None):
    """The single-request engine's greedy ids for one request (``tokens``
    of them, the engine's ``max_new_tokens`` by default), and at each
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
        ids = engine.comprehension_ids(q, b64, max_new_tokens=tokens)
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


def graph_kernel_nodes(graph, names):
    """The kernel nodes of a captured CUDA graph whose function name holds
    each of ``names``, read from the graph itself (``debug_dump``, which
    needs a graph made with ``keep_graph``) → ({name: nodes}, all nodes)."""
    import re
    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        check(os.path.exists(path) and os.path.getsize(path) > 0,
              "debug_dump wrote no graph")
        text = Path(path).read_text(errors="replace")
    heads = list(re.finditer(r'^\s*"?(\w+_node_\d+)"?\s*\[', text, re.M))
    check(heads, f"no node in the graph's dump: {text[:2000]}")
    ends = [h.start() for h in heads[1:]] + [len(text)]
    nodes = [text[h.end():e] for h, e in zip(heads, ends)]
    return {n: sum(n in node for node in nodes) for n in names}, len(nodes)


TRACED_KERNELS = ("qmm_decode", "qmm_prefill", "qmm_split_sum")
TRACED_TICKS = ("block", "verify", "fused_block")


def traced_replays():
    """``python3 chip_smoke.py --traced-replays``: over phase 7's int8 model
    (the same seed), in a process of its own, a decode block of the worker
    engine (``block``), a verify tick of its speculative (k = 4) twin
    (``verify``), then a block after the projections are fused in place
    (``fused_block``). Each tick's graph is captured with ``keep_graph`` and
    replayed once under ``torch.profiler``. Prints one JSON line: per tick,
    the graph's kernel nodes by name (what every replay launches) and the
    tracer's events for them. (The tracer loses records: 1-3 of a replayed
    block's ~41k late in the long main process, 11% of a third trace in one
    process, and 4 of 2064 ``qmm_decode`` in the first trace of a fresh
    process once; so the counts held are the graph's.)"""
    import torch

    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    from mllm_npu_tpu_torch.utils.weights import fuse_llama_projections_
    single = build_engine(LLAMA3_YAML, device="cuda", seed=0,
                          fake_tokenizer=True, max_new_tokens=MAX_NEW_TOKENS,
                          quantize_int8=True)
    cuda_graph = torch.cuda.CUDAGraph

    class KeptGraph(cuda_graph):
        """A CUDA graph that keeps its cudaGraph_t after the capture, for
        ``debug_dump`` (it instantiates at the first replay)."""

        def __new__(cls, keep_graph=False):
            return super().__new__(cls, True)

        def __init__(self, keep_graph=False):
            super().__init__(True)

    out = {}
    for tick in TRACED_TICKS:
        kw, label = {}, "int8"
        if tick == "verify":
            kw, label = dict(speculative_k=4, speculative_ngram=SPEC_NGRAM), \
                "int8 speculative k=4"
        elif tick == "fused_block":
            fuse_llama_projections_(single.generator.model.language_model)
            label = "int8 fused"
        torch.cuda.CUDAGraph = KeptGraph   # for the worker's capture only
        try:
            engine = worker_engine(single, **kw)
        finally:
            torch.cuda.CUDAGraph = cuda_graph
        check(isinstance(engine._graph, KeptGraph), f"{tick}: the worker "
              "captured no graph")
        prof = profile_block(engine, single, f"{label} (traced alone)")
        graph, total = graph_kernel_nodes(engine._graph, TRACED_KERNELS)
        out[tick] = {"graph": graph, "graph_nodes": total, "traced": {
            k: sum(n for name, n in prof[3].items() if k in name)
            for k in TRACED_KERNELS}}
        del engine, prof
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps(out))


def traced_replay_checks(lm_cfg, block_steps):
    """Run traced_replays in a child process, and hold the kernel nodes of
    each captured graph: a block 225 × 16 ``qmm_decode`` and no prefill
    kernel; a verify tick 225 ``qmm_prefill`` (M = 40) and no decode
    kernel; a fused block 129 × 16. The tracer's events of the replay may
    fall short of the graph's nodes (it loses records) but may not exceed
    them, and each kernel the graph holds must have been seen launched.
    → {tick: {"graph": ..., "traced": ...}}."""
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--traced-replays"],
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines()[:-1]:
        if line.startswith("[profile]"):
            print(line, flush=True)
    check(proc.returncode == 0, f"traced replays: exit {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    L = lm_cfg.num_hidden_layers
    want = {"block": {"qmm_decode": (7 * L + 1) * block_steps,
                      "qmm_prefill": 0},
            "verify": {"qmm_decode": 0, "qmm_prefill": 7 * L + 1},
            "fused_block": {"qmm_decode": (4 * L + 1) * block_steps,
                            "qmm_prefill": 0}}

    def seen(tick, k):
        return (f"{got[tick]['graph'][k]} {k} nodes ({got[tick]['traced'][k]}"
                f" traced; expected {want[tick][k]})")
    print(f"[int8 traced] three captured ticks in a process of their own, "
          f"each graph's kernel nodes and one replay's traced events: decode "
          f"block {seen('block', 'qmm_decode')}; verify tick "
          f"{seen('verify', 'qmm_prefill')}, M = 40, and "
          f"{got['verify']['graph']['qmm_split_sum']} split-K sums; fused "
          f"block {seen('fused_block', 'qmm_decode')}", flush=True)
    for tick, kernels in want.items():
        for k, n in kernels.items():
            nodes, events = got[tick]["graph"][k], got[tick]["traced"][k]
            check(nodes == n, f"{tick}: the graph holds {nodes} {k} nodes, "
                  f"expected {n}")
            check(events <= nodes and (events > 0) == (nodes > 0),
                  f"{tick}: the replay's trace holds {events} {k} events "
                  f"against the graph's {nodes} nodes")
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
        single_ids, s_rows = single_stream(single, *reqs[lab], CHECK_TOKENS)
        ids, b_rows = recorded_stream(eager, preps[lab], CHECK_TOKENS)
        check(ids == ids_of[lab][:len(ids)], f"{label} {lab}: eager ids "
              f"alone {ids} differ from the graphed worker's {ids_of[lab]}")
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
        ids, rows = recorded_stream(twin, p, CHECK_TOKENS)
        check(ids == reqs[i].tokens[:len(ids)], f"prefix request {i}: the "
              f"eager chunked ids alone {ids} differ from the graphed "
              f"engine's among four {reqs[i].tokens}")
        m_ids, m_rows = recorded_stream(eager, p, CHECK_TOKENS)
        check(m_ids == mono[i].tokens[:len(m_ids)], f"prefix request {i}: "
              f"the eager monolithic ids {m_ids} differ from the graphed "
              f"engine's {mono[i].tokens}")
        s_ids, s_rows = single_stream(single, t, "", CHECK_TOKENS)
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
# request of phase 4c's graphed (timed) runs and of its speculative eager
# and alone runs and recorded streams (held against a graphed run's first
# tokens; cut from 32 for the time limit, PERF.md §4)
SPEC_KS = (4, 63)
SPEC_NGRAM = 3
SPEC_TOKENS = 64
C_TOKENS = 16
# tokens per request of a timed run through a non-speculative engine other
# than the timed graphed one: its first tick's block (not timed) takes 16,
# the rest one more block
BLOCK_TOKENS = 2 * WORKER["block_steps"]
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
            out["plain_rows"] = plain_rows
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
        plain_ids, rows = single_stream(single, q, b, C_TOKENS)
        tp = dict(gen.last_timings)
        ids = [int(t) for t in spec.comprehension_ids(
            q, b, max_new_tokens=C_TOKENS)]
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
    e = timed_ticks(eager, items, BLOCK_TOKENS, sampling)["ids"]
    check(all(a[:len(b)] == b for a, b in zip(g, e)),
          "sampled engine: graphed and eager ids differ")
    for i in range(len(items)):
        if i not in sampled:
            check(g[i] == plain_ids[i][:len(g[i])], f"greedy row {i} among "
                  f"sampled ones differs from the greedy engine's")
    alone = timed_ticks(graphed, [items[4]], BLOCK_TOKENS,
                        [sampling[4]])["ids"]
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


def cache_dtype_check(single, plain_graphed, items, plain_ids, rule,
                      bf16_rows):
    """Check d: the same 8 requests with the fp8 and the f32 static cache,
    graphed and eager (identical ids): memory, cache bytes and ms per tick;
    decode_attention with the fp8 cache against the bf16 cache on the
    bf16 worker's own filled cache; two requests' logit rows against the
    bf16 cache's (``bf16_rows``, check a's; f32: the logit rule; fp8:
    printed)."""
    import torch

    from mllm_npu_tpu_torch.models.language_models.llama import to_cache
    from mllm_npu_tpu_torch.ops import decode_attention
    preps, control, bound = rule
    labels = tuple(preps)
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
        e = timed_ticks(eager, items, BLOCK_TOKENS)
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
    t_part = [time.perf_counter()]

    def part_done(name):
        now = time.perf_counter()
        print(f"[time] phase 4c {name}: {now - t_part[0]:.1f} s", flush=True)
        t_part[0] = now
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
    part_done("plain run and control")
    out["a"] = spec_batched_check(plain_graphed, plain_eager, items,
                                  plain["tokens_per_s"], rule)
    spec_ids = out["a"].pop("k4_ids")
    plain_rows = out["a"].pop("plain_rows")
    part_done("a")
    out["b"] = spec_single_check(single, traffic, rule)
    part_done("b")
    out["c"] = sampling_check(single, plain_graphed, items, plain_ids,
                              spec_ids)
    part_done("c")
    out["d"] = cache_dtype_check(single, plain_graphed, items, plain_ids,
                                 rule, plain_rows)
    part_done("d")
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


def row_mix(rows, mix, basis, key=lambda r: r["shape"], name=str, sums=()):
    """A kernel's rows summed over one call's launch mix {key: launches}
    (``key`` gives a row's key, ``name`` prints it): ms, plain_ms,
    bound_ms, library_ms and ``sums``, the share of the bound, what
    bounds it and the basis."""
    by = {key(r): r for r in rows}
    agg = {k: sum(by[s][k] * n for s, n in mix.items())
           for k in ("ms", "plain_ms", "bound_ms", "library_ms", *sums)}
    t_c = sum(by[s]["flops"] * n for s, n in mix.items()) / H100_BF16_FLOPS
    t_m = sum(by[s]["bytes"] * n for s, n in mix.items()) / H100_BYTES_PER_S
    return {**agg, "bound_share": agg["bound_ms"] / agg["ms"],
            "bound_by": "operations" if t_c >= t_m else "bytes",
            "ms_basis": f"{basis}: the launch mix "
                        + ", ".join(f"{n} x {name(s)}" for s, n in mix.items())}


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
        flash_attention, flash_attention_reference, plain_attention_p_bf16)
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
    got, _, _ = serve(single, requests, preps, "seedx", lm_cfg)
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
    got, got_prefill, _ = serve(q8, requests[:1], preps[:1], "seedx int8",
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

    from mllm_npu_tpu_torch.serve.worker import (load_engine_from_config,
                                                 parse_worker_args)
    gc.collect()
    torch.cuda.empty_cache()
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
    unet_attn = attention_count(ad.unet)
    vis_attn = vision_attention_count(ad.visual_encoder)
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
    with torch.inference_mode():
        feats = engine.text_to_image_features(
            SEEDX_CAPTION, max_new_tokens=engine.num_img_out_tokens + 2)[
                "img_gen_feat"]
        x = first_step_inputs(ad, feats, 2, size, GEN_STEPS,
                              engine.base_resolution)

        def unet_forward():
            return ad.unet(x["lat_in"], x["t"], x["prompt"],
                           added_cond=x["added"])
        eps = route_outputs(unet_forward, unet_attn,
                            f"SDXL UNet ε at the request's first step (full "
                            f"width, {list(x['lat_in'].shape)})")
        lats = route_outputs(lambda: ad.denoise(
            x["noise"], *x["embeds"], x["tids"], GEN_GUIDANCE, SHORT_STEPS),
            unet_attn * SHORT_STEPS,
            f"final latents of a {SHORT_STEPS}-step run (seed {GEN_SEED})")
        unet_ms = time_ms(unet_forward, iters=5)
        prof = profile_call(unet_forward)
    print(f"[detok] one UNet forward (batch 2, K1): {unet_ms:.2f} ms on "
          f"CUDA events, back to back", flush=True)
    print_profile("one UNet forward (batch 2, 1024²)", *prof)
    engine.close()
    del engine, model, ad, served, x, feats
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "params": parts, "build_s": build_s,
            "wall_s": wall, "timings": t, "ms_per_unet_step": ms_step,
            "peak_gib": peak, "image": [img.format, *img.size],
            "unet_forward_ms": unet_ms, "eps": eps["k1"],
            "eps_control": eps["control"], "latents": lats["k1"],
            "latents_control": lats["control"],
            "profile": {"wall_ms": prof[0], "busy_ms": prof[1],
                        "top": prof[2]}}


# -- phase 12: the evaluator ----------------------------------------------
EVAL_FIXTURES = ROOT / "tests" / "fixtures"
# run.py's dataset names and their fixture directories
EVAL_SETS = (("mmlu", "mmlu"), ("cmmlu", "cmmlu"), ("ceval", "ceval"),
             ("bbh", "bbh"), ("mme", "mme"), ("mm_vet", "mmvet"),
             ("seed_bench", "seed_bench2"))
EVAL_TEXT_SETS = ("mmlu", "cmmlu", "ceval", "bbh")
# generate_with_image answers at the engine's max_new_tokens (run.py: 512;
# random weights never emit EOS): cut to this many here
EVAL_IMAGE_TOKENS = 32
EVAL_PREFIX_CACHE = 4
# the synthetic 5-shot subject (bench_eval_speed.mk_mmlu) run through the
# prefix-cache engine: its ~700-token prompts share a preamble longer than
# the 512-token alignment, which the fixtures' (~150 tokens) are not
EVAL_SYNTH_ITEMS = 4
# the speed probes on the 8B (phase 12b): the reference harness's defaults
# (10 mmlu items, 5 mme images), the prefix-cache probe's items (six waves
# through the slots, so the steady pass outlasts the ramp), and readings
# of each probe in one run
SPEED_MMLU_ITEMS = 10
SPEED_MME_IMAGES = 5
SPEED_SLOTS = 8
SPEED_PREFIX_ITEMS = 6 * SPEED_SLOTS
SPEED_READINGS = 1


def k1_per_loss(model):
    """K1 launches of one ``lm_loss`` forward: every attention of the vision
    tower (its pool included), of the projector and, for SEED, of the
    output projector (``compute_losses`` runs it over the generation slots
    even when none holds a target), and one a Llama layer."""
    n = k1_per_image(model) + model.language_model.config.num_hidden_layers
    if hasattr(model, "output_projector"):
        from mllm_npu_tpu_torch.models.vit_common import TorchMHA
        n += sum(isinstance(m, TorchMHA)
                 for m in model.output_projector.modules())
    return n


class EvalRecorder:
    """The ``EvalModel`` the benchmark functions see: every call passes
    through; text prompts and answers are recorded, and each ``lm_loss``
    call is timed with its K1 launches counted."""

    def __init__(self, em):
        self.em, self.texts, self.losses = em, [], []

    def __getattr__(self, name):
        return getattr(self.em, name)

    def generate_text(self, prompt, max_new_tokens=10):
        text = self.em.generate_text(prompt, max_new_tokens)
        self.texts.append((prompt, text))
        return text

    def generate_text_many(self, prompts, max_new_tokens=10):
        texts = self.em.generate_text_many(prompts, max_new_tokens)
        self.texts += list(zip(prompts, texts))
        return texts

    def lm_loss(self, text, image_paths):
        import torch

        from mllm_npu_tpu_torch.ops.flash_attention import flash_attention
        n = flash_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = self.em.lm_loss(text, image_paths)
        torch.cuda.synchronize()
        self.losses.append({"s": time.perf_counter() - t0, "loss": loss,
                            "k1": flash_attention.launches - n,
                            "images": len(image_paths)})
        return loss


def run_benchmark(model, dataset, fixture, workdir):
    """``run.dispatch`` of one benchmark on its fixture, in ``workdir``
    (where its result file goes). → (result, seconds)."""
    import torch

    from mllm_npu_tpu_torch.evaluate import run
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        res = run.dispatch(model, dataset, str(fixture))
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0
    finally:
        os.chdir(cwd)


def check_result_file(dataset, fixture, workdir, prompts):
    """The benchmark's result file exists, parses, and has the fixture's
    keys and rows (``prompts``: the text prompts it sent). → rows."""
    from mllm_npu_tpu_torch.evaluate import mm_benchmarks as mm
    from mllm_npu_tpu_torch.evaluate.table import read_csv
    wd = Path(workdir)
    if dataset in ("mmlu", "cmmlu", "ceval"):
        suffix = {"mmlu": "_test.csv", "cmmlu": ".csv",
                  "ceval": "_test.csv"}[dataset]
        subjects = sorted(f[:-len(suffix)]
                          for f in os.listdir(fixture / "test")
                          if f.endswith(suffix))
        rows = sum(read_csv(fixture / "test" / f"{s}{suffix}",
                            header=None if dataset == "mmlu" else "infer"
                            ).shape[0] for s in subjects)
    if dataset == "bbh":
        subjects = sorted(f[:-5] for f in os.listdir(fixture / "data"))
        rows = sum(len(json.loads((fixture / "data" / f"{s}.json")
                                  .read_text())["examples"]) - 5
                   for s in subjects)
    if dataset in ("mmlu", "cmmlu", "bbh"):
        res = json.loads((wd / f"result_{dataset}.json").read_text())
        check(sorted(res) == sorted(subjects + ["average"])
              and all(0.0 <= v <= 1.0 for v in res.values()),
              f"{dataset} result: {res}")
    elif dataset == "ceval":
        res = json.loads((wd / "result_ceval.json").read_text())
        check(sorted(res) == subjects and sum(len(v) for v in res.values())
              == rows, f"ceval result: {res}")
    elif dataset == "mme":
        rows = 0
        for task in sorted(p for p in fixture.iterdir() if p.is_dir()):
            qa = (task / "questions_answers_YN" if (
                task / "questions_answers_YN").is_dir() else task)
            want = sum(len(line.split("\t")) >= 2 for f in qa.glob("*.txt")
                       for line in f.read_text().splitlines())
            lines = (wd / "res_mme" / f"{task.name}.txt").read_text() \
                .split("\n")
            check(len(lines) == want and all(len(x.split("\t")) == 4
                                              for x in lines),
                  f"mme {task.name}: {lines}")
            rows += want
    elif dataset == "mm_vet":
        res = json.loads((wd / "res_mmvet.json").read_text())
        want = json.loads((fixture / "mm-vet.json").read_text())
        check(sorted(res) == sorted(want), f"mm_vet result: {res}")
        rows = len(res)
    elif dataset == "seed_bench":
        qs = mm.filter_questions(json.loads(
            (fixture / "SEED-Bench_v2_level1_2_3.json").read_text())
            ["questions"])
        got = [json.loads(x) for x in
               (wd / "results.json").read_text().splitlines()]
        check([g["question_id"] for g in got] == [q["question_id"]
                                                  for q in qs]
              and all(g["prediction"] in "ABCD" for g in got),
              f"seed_bench results: {got}")
        rows = len(got)
    if dataset in EVAL_TEXT_SETS:
        check(len(prompts) == rows, f"{dataset}: {len(prompts)} prompts for "
              f"{rows} fixture rows")
    return rows


def loss_terms(em, text, paths, fn):
    """``em.lm_loss`` with ``fn`` as every attention (K1's wrapper, its
    plain version or the bf16 control), and the loss's terms (the CE at
    each supervised position, fp32). → (loss, terms, K1 launches)."""
    import torch

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.ops.flash_attention import flash_attention
    model = em.model
    orig, terms = model._lm_loss, []

    def recording(h, labels):
        logits = model.language_model.logits(h)[:, :-1].float()
        t = labels[:, 1:]
        nll = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), t.clamp(min=0), reduction="none")
        terms.append(nll[t != -100])
        return orig(h, labels)
    model._lm_loss = recording
    port_ops.flash_attention = fn
    n = flash_attention.launches
    try:
        loss = em.lm_loss(text, paths)
    finally:
        port_ops.flash_attention = flash_attention
        del model._lm_loss
    return loss, terms[0], flash_attention.launches - n


def loss_rule(em, label, cases):
    """``lm_loss`` with K1 against K1's plain version everywhere on
    ``cases`` ((text, paths), the choices of one question): every loss
    term within twice the bf16 control's largest reading (plain with P
    rounded to bf16, against plain), so the loss too; where the two lowest
    plain losses differ by more than that bound, the same choice ranks
    first. → summary."""
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, plain_attention_p_bf16)
    k1n = k1_per_loss(em.model)
    out = {r: [] for r in ("K1", "plain", "control")}
    for text, paths in cases:
        for route, fn in (("K1", flash_attention),
                          ("plain", flash_attention_reference),
                          ("control", plain_attention_p_bf16)):
            loss, terms, n = loss_terms(em, text, paths, fn)
            check(n == (k1n if route == "K1" else 0),
                  f"{label} {route} lm_loss launched K1 {n} times")
            check(abs(terms.mean().item() - loss) < 1e-3 * abs(loss),
                  f"{label} {route}: the terms' mean {terms.mean().item()} "
                  f"is not the loss {loss}")
            out[route].append((loss, terms))
    d_ctl = max((c[1] - p[1]).abs().max().item()
                for c, p in zip(out["control"], out["plain"]))
    d_k1 = max((k[1] - p[1]).abs().max().item()
               for k, p in zip(out["K1"], out["plain"]))
    d_loss = max(abs(k[0] - p[0]) for k, p in zip(out["K1"], out["plain"]))
    bound = LOGIT_BOUND_FACTOR * d_ctl
    k1_l = [x[0] for x in out["K1"]]
    pl_l = [x[0] for x in out["plain"]]
    first, second = sorted(pl_l)[:2]
    ranked = second - first > bound
    same_rank = k1_l.index(min(k1_l)) == pl_l.index(min(pl_l))
    print(f"[check] {label} lm_loss, K1 vs plain attention over "
          f"{len(cases)} choices ({k1n} K1 launches a call): loss terms max "
          f"|delta| {d_k1:.5f}, losses max |delta| {d_loss:.6f}; control "
          f"(plain with P in bf16 vs plain) terms max |delta| {d_ctl:.5f}, "
          f"bound {bound:.5f}; K1 losses "
          + ", ".join(f"{x:.5f}" for x in k1_l) + "; plain "
          + ", ".join(f"{x:.5f}" for x in pl_l)
          + f"; lowest two plain differ by {second - first:.5f} ("
          + ("beyond" if ranked else "within") + " the bound): argmin "
          + ("agrees" if same_rank else "differs"), flush=True)
    check(d_k1 <= bound and d_loss <= bound,
          f"{label}: K1's loss terms beyond twice the control's")
    check(same_rank or not ranked, f"{label}: the ranking differs beyond "
          "the bound")
    return {"k1_launches": k1n, "terms_max_delta": d_k1,
            "loss_max_delta": d_loss, "control_terms_max_delta": d_ctl,
            "bound": bound, "losses_k1": k1_l, "losses_plain": pl_l,
            "argmin_agrees": same_rank, "ranking_resolved": ranked}


def single_stream_ids(engine, ids, tokens):
    """The single-request engine's greedy ids for raw prompt ids (the
    evaluator's ``generate_text``) at ``tokens``, and the logits each
    choice was made from (the decode step eager, as ``single_stream``)."""
    import dataclasses

    import torch

    from mllm_npu_tpu_torch.models.generation import generate as gen_mod
    from mllm_npu_tpu_torch.models.generation import sampler
    gen = engine.generator
    rows, orig = [], sampler._sample

    def recording(logits):
        rows.append(logits[0].float().clone())
        return orig(logits)
    sampler._sample = gen_mod._sample = recording
    gen.cuda_graph = False
    try:
        out = gen.generate(
            torch.as_tensor(ids, dtype=torch.long, device="cuda")[None],
            sampling=dataclasses.replace(gen.sampling,
                                         max_new_tokens=tokens))
    finally:
        sampler._sample = gen_mod._sample = orig
        gen.cuda_graph = True
    return [int(t) for t in out["generate_ids"][0]], rows


def prefix_logit_check(single, batched, prompts, tokens=10):
    """The prefix-cache engine's text prompts held against the
    single-request engine by the logit rule (phase 4b's): each prompt,
    in the order the benchmarks sent them, alone through an eager twin of
    the batched engine with its own prefix cache (so later prompts hit as
    they did), against the single engine's eager stream; the bound twice
    the largest control reading over these prompts. → summary."""
    import numpy as np
    ids = [np.asarray(single._prompt_ids(p), np.int32) for p in prompts]
    control = [attention_control(single.model, (x, None, None, None))
               for x in ids]
    bound = LOGIT_BOUND_FACTOR * max(control)
    eng = batched.engine.batch_engine
    twin = twin_of(eng, prefix_cache=EVAL_PREFIX_CACHE, cuda_graph=False)
    identical, worst, texts = 0, 0.0, []
    for i, x in enumerate(ids):
        b_ids, b_rows = recorded_stream(twin, (x, None, None, None), tokens)
        s_ids, s_rows = single_stream_ids(single.engine, x, tokens)
        same, d, desc = logit_rule(f"evaluator prefix prompt {i}", b_ids,
                                   b_rows, s_ids, s_rows, bound)
        identical += same
        worst = max(worst, d)
        texts.append(batched.engine._decode_text(np.asarray(b_ids)))
        print(f"[check] evaluator prefix-cache prompt {i} ({len(x)} tokens) "
              f"vs the single-request engine: {desc}", flush=True)
    st = twin.stats()["prefix_cache"]
    check(st["hits"] > 0, f"the eager prefix twin: {st}")
    return {"control": control, "bound": bound, "identical": identical,
            "max_abs_delta": worst, "twin_prefix_cache": st,
            "twin_texts": texts}


def seed_question_cases(index=0):
    """The (text, image paths) of each choice of the fixture's
    SEED-Bench2 question ``index``, as ``rank_choices`` builds them."""
    from mllm_npu_tpu_torch.evaluate import mm_benchmarks as mm
    fx = EVAL_FIXTURES / "seed_bench2"
    qa = mm.filter_questions(json.loads(
        (fx / "SEED-Bench_v2_level1_2_3.json").read_text())["questions"])[index]
    ids = qa["data_id"] if isinstance(qa["data_id"], list) else [qa["data_id"]]
    paths = [str(fx / "cc3m-image" / p) for p in ids]
    cases = []
    for c in "abcd":
        text = "Question: {}\nAnswer: {}".format(qa["question"],
                                                 qa[f"choice_{c}"])
        text = ("<img>" * (len(paths) - text.count("<img>")) + text
                if len(paths) > 1 else "<img>\n" + text)
        cases.append((text, paths))
    return cases


def spread(xs):
    """(max - min) / mean of readings."""
    return (max(xs) - min(xs)) / (sum(xs) / len(xs))


def eval_speed_phase(engine, label):
    """Phase 12b on a resident 8B engine (phase 4's bf16 model after phase
    6, phase 7's int8 model): ``bench_eval_speed``'s probes through
    ``EvalModel``s over its model, with every count set to 0 before and
    read after: mmlu on the single-request engine, its answers at the
    harness's 10 tokens (the engine's own budget restored after), mme the
    same, then mmlu (``SPEED_PREFIX_ITEMS``) through a batched engine of
    ``SPEED_SLOTS`` slots with an 8-entry prefix cache (the harness's
    ``--prefix_cache 8 --slots 8``), each probe ``SPEED_READINGS`` times;
    on bf16 one ``lm_loss`` call with its K1 count asserted, on int8 its
    refusal of the quantized weights. → summary."""
    import dataclasses

    import torch

    from mllm_npu_tpu_torch import bench_eval_speed as bes
    from mllm_npu_tpu_torch.evaluate import run
    from mllm_npu_tpu_torch.evaluate.evaluator import EvalModel
    from mllm_npu_tpu_torch.ops import quant as tq
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    tq.int8_matmul.prefill_launches = 0
    gen = engine.generator
    model = gen.model
    em = EvalModel(engine)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    own = gen.sampling
    gen.sampling = dataclasses.replace(own, max_new_tokens=bes.NEW_TOKENS)
    try:
        out["mmlu"], out["mme"] = [], []
        for _ in range(SPEED_READINGS):
            out["mmlu"].append(bes.probe_mmlu(em, SPEED_MMLU_ITEMS))
            # a call's own budget (10) keys no new graph: the steady pass's
            # items, in the warm pass's cache bucket, replay its capture
            check(not gen.last_timings["graph_captured"],
                  f"{label}: an mmlu item of the steady pass captured a "
                  "graph")
        for _ in range(SPEED_READINGS):
            out["mme"].append(bes.probe_mme(em, SPEED_MME_IMAGES))
    finally:
        gen.sampling = own
    t0 = time.perf_counter()
    emp = run.eval_model_for(
        model, engine.tokenizer, engine.image_transform,
        max_new_tokens=bes.NEW_TOKENS, prefix_cache=8,
        prefix_engine=dict(num_slots=SPEED_SLOTS, **bes.PREFIX_ENGINE),
        device="cuda", base_resolution=engine.base_resolution)
    out["prefix_engine_build_s"] = time.perf_counter() - t0
    try:
        out["mmlu_prefix"] = [bes.probe_mmlu(emp, SPEED_PREFIX_ITEMS)
                              for _ in range(SPEED_READINGS)]
        out["prefix_cache"] = emp.engine.batch_engine.stats()["prefix_cache"]
    finally:
        emp.engine.close()
    if label == "bf16":
        text, paths = seed_question_cases()[0]
        k1n = k1_per_loss(model)
        n = counters["flash_fwd"].launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = em.lm_loss(text, paths)
        torch.cuda.synchronize()
        out["lm_loss"] = {"s": time.perf_counter() - t0, "loss": loss,
                          "k1": counters["flash_fwd"].launches - n}
        check(out["lm_loss"]["k1"] == k1n and loss == loss,
              f"8B lm_loss: {out['lm_loss']}, expected {k1n} K1 launches")
    else:
        try:
            em.lm_loss(*seed_question_cases()[0])
        except ValueError as e:
            out["lm_loss"] = f"refused: {e}"
        else:
            fail(f"{label}: lm_loss scored the quantized weights")
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    out["prefill_launches"] = tq.int8_matmul.prefill_launches
    check(out["launches"]["flash_fwd"] > 0, f"{label} probes: no K1")
    if label == "int8":
        check(out["launches"]["int8_matmul"] > 0, "int8 probes: no K4")
    st = out["prefix_cache"]
    check(st["hits"] > 0 and st["tokens_saved"] > 0,
          f"{label} mmlu probe's prefix cache: {st}")
    for name in ("mmlu", "mmlu_prefix"):
        rates = [p["steady_items_per_sec"] for p in out[name]]
        for i, p in enumerate(out[name]):
            print(f"[eval speed] 8B {label} mmlu probe"
                  + (f" (prefix cache 8, {SPEED_SLOTS} slots)"
                     if name == "mmlu_prefix" else " (single-request)")
                  + f", reading {i + 1} of {len(rates)}: {p['items']} items "
                  f"of ~700 words, warm pass (2 items) "
                  f"{p['first2_with_compile_s']} s, steady "
                  f"{p['steady_items_per_sec']} items/s "
                  f"({p['steady_sec_per_item']} s/item, "
                  f"{p['items'] * p['steady_sec_per_item']} s in all), "
                  f"projected full MMLU (14042 items) "
                  f"{p['projected_full_mmlu_hours']} h", flush=True)
        print(f"[eval speed] 8B {label} mmlu probe ({name}): readings "
              f"{rates} items/s, spread (max - min) / mean "
              f"{spread(rates)}", flush=True)
    rates = [p["steady_qa_per_sec"] for p in out["mme"]]
    for i, p in enumerate(out["mme"]):
        print(f"[eval speed] 8B {label} mme probe, reading {i + 1} of "
              f"{len(rates)}: {p['qa_pairs']} QA pairs on {p['images']} "
              f"768x1024 JPEGs, warm pass {p['first_with_compile_s']} s, "
              f"steady {p['steady_qa_per_sec']} QA/s "
              f"({p['steady_sec_per_qa']} s/QA, "
              f"{p['qa_pairs'] * p['steady_sec_per_qa']} s in all), "
              f"projected full MME (2374 pairs) "
              f"{p['projected_full_mme_hours']} h", flush=True)
    print(f"[eval speed] 8B {label} mme probe: readings {rates} QA/s, spread "
          f"(max - min) / mean {spread(rates)}; prefix cache {st}; lm_loss "
          f"{out['lm_loss']}; peak {out['peak_gib']:.2f} GiB; launches "
          f"{out['launches']}", flush=True)
    return out


def evaluator_phase():
    """Phase 12a (see the module's docstring). → summary, its launches
    among them."""
    import torch

    from mllm_npu_tpu_torch import bench_eval_speed as bes
    from mllm_npu_tpu_torch.evaluate import run
    gc.collect()
    torch.cuda.empty_cache()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    em = run.build_eval_model(str(ROOT / SEEDX_YAML),
                              max_new_tokens=EVAL_IMAGE_TOKENS, device="cuda",
                              seed=0, fake_tokenizer=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = em.model
    lm_cfg = model.language_model.config
    k1n = k1_per_loss(model)
    check(hasattr(model, "output_projector") and lm_cfg.num_hidden_layers
          == 40 and lm_cfg.vocab_size == 32330, "phase 12: not SEED-X")
    print(f"[eval] run.build_eval_model({SEEDX_YAML}, FakeTokenizer, seed 0) "
          f"in {build_s:.1f} s: {torch.cuda.memory_allocated() / 2**30:.2f} "
          f"GiB resident; generate_with_image answers cut to "
          f"{EVAL_IMAGE_TOKENS} new tokens (run.py's engine: 512); lm_loss "
          f"{k1n} K1 launches a call", flush=True)
    rec = EvalRecorder(em)
    per = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        for ds, fx in EVAL_SETS:
            wd = Path(tmp) / ds
            wd.mkdir()
            n = len(rec.texts)
            _, secs = run_benchmark(rec, ds, EVAL_FIXTURES / fx, wd)
            rows = check_result_file(ds, EVAL_FIXTURES / fx, wd,
                                     rec.texts[n:])
            per[ds] = {"items": rows, "s": secs, "items_per_s": rows / secs}
            print(f"[eval] {ds} on tests/fixtures/{fx}: {rows} items in "
                  f"{secs:.3f} s ({rows / secs:.3f} items/s); result file "
                  "checked", flush=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    calls = rec.losses
    check(len(calls) == 4 * per["seed_bench"]["items"]
          and all(c["k1"] == k1n for c in calls),
          f"lm_loss calls {[c['k1'] for c in calls]}, expected {k1n} each")
    secs = [c["s"] for c in calls]
    loss_s = {"calls": len(calls), "k1_each": k1n,
              "mean_s": sum(secs) / len(secs), "min_s": min(secs),
              "max_s": max(secs)}
    print(f"[eval] SEED-X lm_loss: {len(calls)} calls (seed_bench, one image "
          f"each), {k1n} K1 launches each (asserted); "
          f"{loss_s['mean_s']:.4f} s per call (min {min(secs):.4f}, max "
          f"{max(secs):.4f})", flush=True)
    rule = loss_rule(em, "SEED-X", seed_question_cases())

    # the text benchmarks through run.py's prefix-cache engine over the
    # same model, counts set to 0 before and read after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    emp = run.eval_model_for(model, em.tokenizer, em.engine.image_transform,
                             max_new_tokens=EVAL_IMAGE_TOKENS,
                             prefix_cache=EVAL_PREFIX_CACHE, device="cuda")
    torch.cuda.synchronize()
    pbuild_s = time.perf_counter() - t0
    recp = EvalRecorder(emp)
    held, prefix_per = [], {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
            for ds in EVAL_TEXT_SETS + ("synthetic",):
                wd = Path(tmp) / ds
                wd.mkdir()
                fx = EVAL_FIXTURES / ds
                if ds == "synthetic":
                    fx = Path(tmp) / "synthetic_mmlu"
                    bes.mk_mmlu(fx, EVAL_SYNTH_ITEMS)
                n = len(recp.texts)
                _, secs = run_benchmark(recp, "mmlu" if ds == "synthetic"
                                        else ds, fx, wd)
                rows = check_result_file("mmlu" if ds == "synthetic" else ds,
                                         fx, wd, recp.texts[n:])
                prefix_per[ds] = {"items": rows, "s": secs}
                new = [p for p, _ in recp.texts[n:]]
                held += new if ds == "synthetic" else new[:1]
        st = emp.engine.batch_engine.stats()["prefix_cache"]
    finally:
        emp.engine.close()
    for k, fn in counters.items():
        launches[k] += fn.launches
    check(st["hits"] > 0 and st["tokens_saved"] > 0,
          f"prefix-cache engine: {st}")
    single_text = dict(rec.texts)
    graphed = dict(recp.texts)
    same_single = sum(graphed[p] == t for p, t in single_text.items()
                      if p in graphed)
    print(f"[eval] prefix-cache engine (run.py's: 2 slots, a 2560-token "
          f"cache, prompts to 2048 in buckets of 512, {EVAL_PREFIX_CACHE} "
          f"entries; built and captured in {pbuild_s:.2f} s): "
          + ", ".join(f"{k} {v['items']} items {v['s']:.3f} s"
                      for k, v in prefix_per.items())
          + f"; prefix cache {st} (the fixtures' prompts are shorter than "
          f"the 512-token alignment: the synthetic subject's hit); answers "
          f"equal to the single-request engine's on {same_single} of "
          f"{len(single_text)} fixture prompts", flush=True)
    chk = prefix_logit_check(em, emp, held)
    same_twin = sum(graphed[p] == t for p, t in zip(held, chk["twin_texts"]))
    print(f"[check] evaluator prefix-cache prompts vs the single-request "
          f"engine by the logit rule: {len(held)} prompts, control max "
          f"|delta| {max(chk['control']):.4f}, bound {chk['bound']:.4f}, "
          f"worst {chk['max_abs_delta']:.4f}, identical streams "
          f"{chk['identical']} of {len(held)}; the graphed run's answers "
          f"equal the eager twin's on {same_twin} of {len(held)}", flush=True)
    check(same_twin == len(held),
          f"the graphed prefix-cache engine's answers equal the eager twin's "
          f"on {same_twin} of {len(held)} prompts")
    del em, emp, rec, recp, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "build_s": build_s, "benchmarks": per,
            "lm_loss": loss_s, "loss_rule": rule, "prefix_cache": st,
            "prefix_benchmarks": prefix_per, "prefix_build_s": pbuild_s,
            "prefix_same_as_single": same_single,
            "prefix_logit_rule": {k: v for k, v in chk.items()
                                  if k != "twin_texts"},
            "prefix_same_as_twin": same_twin}


# -- phase 13: SEED-X pretraining at full width ---------------------------
PRETRAIN_DATA = "mllm_npu_tpu_torch/configs/dataset/pretrain_data.yaml"
# the recipe's caption batch of 28, reckoned down: a frozen bf16 base of
# ~29 GiB, ~0.67 B trainable parameters at 14 bytes (~9 GiB), activations
# about 1.5x the 8B's a token (phase 8 fits 8 rows of 600, not 16); 8 rows
# ran out of memory at its first backward on an H100 80GB (76.8 GiB
# allocated at the peak), so no run rebuilds the 15 B model to try them
SEEDX_TRAIN_BATCHES = (4, 2)
SEEDX_TRAIN_STEPS = 6
SEEDX_QLORA_STEPS = 4
# optimizer steps on one repeated batch, after the mixture's run
SEEDX_REPEAT_STEPS = 3


def ocr_data(root, n, seed=0):
    """``n`` seeded OCR/conversation records as LLaVAR's pretraining jsonl
    holds them (``{"image", "data": [question, answer, ...]}``, one or two
    exchanges) over seeded JPEGs of 448 to 1400 pixels a side. Returns
    (jsonl dir, image dir)."""
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(seed)
    jdir, idir = root / "ocr_jsonl", root / "ocr_images"
    jdir.mkdir(parents=True)
    idir.mkdir(parents=True)
    lines = []
    for i in range(n):
        w, h = (int(x) for x in rs.randint(448, 1401, 2))
        Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8)).save(
            idir / f"{i:06d}.jpg", format="JPEG", quality=85)
        turns = []
        for _ in range(1 + i % 2):
            turns += ["what does the text in the image say",
                      " ".join(rs.choice(WORDS, int(rs.randint(10, 40))))]
        lines.append(json.dumps({"image": f"{i:06d}.jpg", "data": turns}))
    (jdir / "part-000000.jsonl").write_text("\n".join(lines) + "\n")
    return jdir, idir


def seedx_train_yaml(workdir, B):
    """The port's ``pretrain_data.yaml`` with both entries at the recipe's
    values, pointed at one batch's worth of seeded data each (a caption
    tar of ``B`` samples; an OCR jsonl of the OCR entry's batch), the
    caption batch cut from 28 to ``B`` (the OCR batch of 4 to ``B`` if
    less). → (the YAML's path, {entry: (recipe batch, batch)})."""
    import yaml
    root = workdir / f"seedx_data_b{B}"
    (root / "tars").mkdir(parents=True)
    caption_tar(root / "tars" / "shard-000000.tar", B, seed=13)
    ds = yaml.safe_load((ROOT / PRETRAIN_DATA).read_text())
    cuts = {}
    for node in ds["datapipes"]:
        recipe = node["batch_size"]
        node["batch_size"] = min(recipe, B)
        cuts[node["dataset_name"]] = (recipe, node["batch_size"])
        node["cycle_count"] = 100000
        if node["_target_"].endswith("build_ocr_datapipes_caption"):
            jdir, idir = ocr_data(root, node["batch_size"], seed=14)
            node.update(data_dir=str(jdir), image_dir=str(idir))
        else:
            node["data_dir"] = [str(root / "tars")]
    path = workdir / f"seedx_data_b{B}.yaml"
    path.write_text(yaml.safe_dump(ds))
    return path, cuts


class HeadDimCounts:
    """Within the block, K2 and K3 launches counted by head dim: a shim
    around ``FlashAttention.backward`` reads the wrappers' own counts
    before and after each call (which count as ever)."""

    def __enter__(self):
        import importlib
        fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")
        self.cls, self.saved, self.counts = fa.FlashAttention, None, {}
        self.saved = fa.FlashAttention.backward
        original = self.saved

        def backward(ctx, do):
            D = do.shape[-1]    # dO is shaped like q
            before = {k: getattr(fa, k).launches
                      for k in ("flash_bwd_dq", "flash_bwd_dkv")}
            out = original(ctx, do)
            for k, n in before.items():
                if getattr(fa, k).launches > n:
                    self.counts[(k, D)] = (self.counts.get((k, D), 0)
                                           + getattr(fa, k).launches - n)
            return out
        self.cls.backward = staticmethod(backward)
        return self

    def take(self):
        out, self.counts = self.counts, {}
        return out

    def __exit__(self, *exc):
        self.cls.backward = staticmethod(self.saved)


def seedx_expected(model, quant=""):
    """One training step's launches, from the model's structure: the
    frozen Qwen-ViT-G (no gradient: K1 alone) and its attention pool; the
    input projector (K1 with its LSE, K2, K3 at its head dim); each Llama
    layer (K1 with its LSE, twice under remat, K2, K3); the output
    projector (as the input one, over the generation slots); with
    ``quant`` the quantized projections (every adapter's base, run again
    by remat) and the lm_head through K4 or K5. → (the counts, K2/K3
    launches by head dim)."""
    vis = model.vision_encoder.config
    lm = model.language_model.config
    L = lm.num_hidden_layers
    fwd = 2 if lm.remat else 1
    d_in = model.projector.embed_dim // model.projector.attn.num_heads
    d_out = (model.output_projector.embed_dim
             // model.output_projector.attn.num_heads)
    counts = {k: 0 for k in kernel_counters()}
    counts.update(flash_fwd=vis.layers + 1 + 1 + fwd * L + 1,
                  flash_bwd_dq=L + 2, flash_bwd_dkv=L + 2,
                  flash_bwd_dq_wgmma=L + 2, flash_bwd_dkv_wgmma=L + 2)
    if quant:
        n_proj = L * len(lm.lora_targets)
        counts[f"{quant}_matmul"] = fwd * n_proj + 1
    by_dim = {}
    for d, n in ((d_in, 1), (lm.head_dim, L), (d_out, 1)):
        for k in ("flash_bwd_dq", "flash_bwd_dkv"):
            by_dim[(k, d)] = by_dim.get((k, d), 0) + n
    return counts, by_dim


def seedx_train_run(workdir, argv_extra, steps, batches, label):
    """``train.main`` on the SEED-X YAML over the pretrain mixture at the
    first batch of ``batches`` that fits, every step's launches read (and
    by head dim) and set to 0. → (run, per-step [(record, launches,
    by head dim)], batch, cuts, peak GiB, wall s)."""
    import torch

    from mllm_npu_tpu_torch.train import train as trainer
    counters = kernel_counters()
    (workdir / label).mkdir(parents=True, exist_ok=True)
    for B in batches:
        data_yaml, cuts = seedx_train_yaml(workdir / label, B)
        argv = ["--model", str(ROOT / SEEDX_YAML),
                "--train_dataset", str(data_yaml),
                "--output_dir", str(workdir / label / f"out_b{B}"),
                "--max_steps", str(steps), "--save_steps", str(steps),
                "--log_steps", "1",
                # the SEED-X launcher's recipe, its mesh flags taken out
                "--learning_rate", "1e-4", "--lr_scheduler_type", "cosine",
                "--warmup_steps", "500", "--min_lr_ratio", "0.05",
                "--mixed_precision", "bf16",
                "--fake_tokenizer", "--device", "cuda", "--seed", "0",
                *argv_extra]
        per_step = []

        with HeadDimCounts() as dims:
            def on_step(rec):
                got = {k: fn.launches for k, fn in counters.items()}
                for k in ("flash_bwd_dq", "flash_bwd_dkv"):
                    got[f"{k}_wgmma"] = counters[k].wgmma_launches
                    counters[k].wgmma_launches = 0
                for fn in counters.values():
                    fn.launches = 0
                per_step.append((rec, got, dims.take()))
                print(f"[seedx-train] {label} B{B} step {rec['step']} "
                      f"({'+'.join(str(d) for d in rec['datasets'])}): loss "
                      f"{rec['loss']:.4f} (lm {rec['lm_loss']:.4f}, rec "
                      f"{rec['rec_loss']:.4f}), grad_norm "
                      f"{rec['grad_norm']:.4f}, sec/step "
                      f"{rec['sec/step']:.3f}, tokens/s "
                      f"{rec['tokens/s']:.0f}, images/s "
                      f"{rec['images/s']:.1f}; launches " + ", ".join(
                          f"{k} {v}" for k, v in got.items() if v),
                      flush=True)

            for fn in counters.values():
                fn.launches = 0
            counters["flash_bwd_dq"].wgmma_launches = 0
            counters["flash_bwd_dkv"].wgmma_launches = 0
            dims.take()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                run = trainer.main(argv, on_step=on_step)
            except (torch.cuda.OutOfMemoryError, RuntimeError) as e:
                # the card full: the caching allocator's error, or a
                # library's own allocation failing (cuBLAS's handle)
                if not isinstance(e, torch.cuda.OutOfMemoryError) and \
                        "ALLOC_FAILED" not in str(e):
                    raise
                print(f"[seedx-train] {label}: batch {B} does not fit "
                      f"({type(e).__name__} at step {len(per_step) + 1}, "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                      "allocated at the peak); trying a smaller one",
                      flush=True)
                run = None
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        gc.collect()
        torch.cuda.empty_cache()
        if run is not None:
            return (run, per_step, B, cuts,
                    torch.cuda.max_memory_allocated() / 2**30,
                    time.perf_counter() - t0)
    fail(f"{label}: no batch of {batches} fits")


def check_seedx_steps(per_step, model, label, quant=""):
    """Every step's launches against ``seedx_expected``, whatever its
    batch's mixture entry; the loss finite. → the launches summed."""
    import math
    expect, by_dim = seedx_expected(model, quant)
    for rec, got, dims in per_step:
        kinds = "+".join(str(d) for d in rec["datasets"])
        check(got == expect, f"{label} step {rec['step']} ({kinds}): "
              f"launches {got}, expected {expect}")
        check(dims == by_dim, f"{label} step {rec['step']} ({kinds}): K2/K3 "
              f"by head dim {dims}, expected {by_dim}")
        check(math.isfinite(rec["loss"]), f"{label} step {rec['step']}: "
              f"loss {rec['loss']}")
    return {k: sum(g[k] for _, g, _ in per_step) for k in expect}


def repeated_batch_steps(model, optimizer, batch, label):
    """``SEEDX_REPEAT_STEPS`` optimizer steps on one batch at a constant lr
    of 1e-4 (the recipe's peak, where its warmup has not reached): the
    loss must fall. → the losses."""
    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import make_train_step
    optimizer.schedule = lambda count: 1e-4
    step = make_train_step(model, trainer.mllm_loss, optimizer)
    losses = [float(step(batch)[0]) for _ in range(SEEDX_REPEAT_STEPS + 1)]
    print(f"[seedx-train] {label}: {SEEDX_REPEAT_STEPS + 1} steps on one "
          f"repeated batch: losses {[round(x, 4) for x in losses]}",
          flush=True)
    check(losses[-1] < losses[0], f"{label}: the loss did not fall on a "
          f"repeated batch: {losses}")
    return losses


def seedx_grad_check(model, batch):
    """Phase 13c: one step's gradients with K1/K2/K3 against the same step
    with the plain attention forward and backward, remat 'nothing' and
    dropout off for both: cos ≥ GRAD_COS over the LoRA, the input
    projector, the output projector and patch_pos_embed."""
    import torch

    from mllm_npu_tpu_torch.models.language_models.llama import (
        set_lora_dropout_seed)
    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import compute_grads
    from mllm_npu_tpu_torch.utils.weights import set_llama_config
    set_lora_dropout_seed(model, None)
    set_llama_config(model.language_model, remat_policy="nothing")
    parts = {"lora": lambda n: "lora_" in n,
             "input_projector": lambda n: n.startswith("projector."),
             "output_projector": lambda n: n.startswith("output_projector."),
             "patch_pos_embed": lambda n: n == "patch_pos_embed"}
    grads, losses = {}, {}
    for route in ("kernels", "plain"):
        with plain_attention() if route == "plain" else \
                contextlib.nullcontext():
            loss, metrics = compute_grads(model, trainer.mllm_loss, [batch])
        losses[route] = {"loss": float(loss),
                         **{k: float(v) for k, v in metrics.items()}}
        grads[route] = {
            part: torch.cat([p.grad.float().flatten()
                             for n, p in model.named_parameters()
                             if p.requires_grad and sel(n)])
            for part, sel in parts.items()}
        for p in model.parameters():
            p.grad = None
    out = {"losses": losses, "cos": {}}
    for part in parts:
        a, b = grads["kernels"][part], grads["plain"][part]
        check(a.numel() > 0, f"no {part} gradient")
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        out["cos"][part] = cos
        print(f"[check] SEED-X training step's {part} gradients "
              f"({a.numel() / 1e6:.2f} M), K1/K2/K3 vs plain attention: cos "
              f"{cos:.6f}, |g| {a.norm().item():.4e} vs "
              f"{b.norm().item():.4e}", flush=True)
        check(cos >= GRAD_COS, f"SEED-X {part} gradients disagree (cos "
              f"{cos})")
    print(f"[check] SEED-X step losses, kernels {losses['kernels']} vs plain "
          f"{losses['plain']}", flush=True)
    return out


def k23_wide_sweep():
    """K2 and K3 against their plain versions at head dims 144 and 160 (one
    block an SM; K3's two consumer warpgroups) across the edges the
    training shapes hold: causal with GQA and packed segments, lengths off
    the tile, Sq != Sk both ways, rows whose keys are all masked, MHA;
    each in the Hopper regime."""
    import torch

    from mllm_npu_tpu_torch import bench_flash_bwd as bench
    from mllm_npu_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention, flash_bwd_dkv,
        flash_bwd_dkv_reference, flash_bwd_dq, flash_bwd_dq_reference)
    cases = [  # B, Sq, Sk, Hq, Hkv, causal, segments
        (2, 300, 300, 8, 2, True, True),
        (1, 77, 77, 4, 2, True, True),
        (2, 100, 130, 8, 2, False, False),
        (2, 130, 100, 8, 8, True, False),
        (1, 1, 70, 4, 1, False, False),
        (2, 65, 63, 8, 1, True, False),
        (2, 600, 600, 40, 40, True, True),
    ]
    worst, n = 0.0, 0
    for D in (144, 160):
        for i, (B, Sq, Sk, Hq, Hkv, causal, segs) in enumerate(cases):
            q, k, v, do, seg = bench.inputs(B, Sq, Sk, Hq, Hkv, D, segs,
                                            seed=200 + i)
            kw = dict(causal=causal, segment_ids=seg)
            o, lse = flash_attention(q, k, v, return_lse=True, **kw)
            delta = attention_delta(o, do)
            w = (flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches)
            got = (flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                   *flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
            torch.cuda.synchronize()
            check((flash_bwd_dq.wgmma_launches, flash_bwd_dkv.wgmma_launches)
                  == (w[0] + 1, w[1] + 1), "K2/K3 left the Hopper regime")
            ref = (flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw),
                   *flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw))
            name = (f"K2/K3 edge B{B} Sq{Sq} Sk{Sk} H{Hq}/{Hkv} D{D}"
                    f"{' causal' if causal else ''}"
                    f"{' segments' if seg is not None else ''}")
            for g, r, which in zip(got, ref, ("dq", "dk", "dv")):
                g, r = g.float(), r.float()
                diff = (g - r).abs()
                check(bool(torch.isfinite(g).all()), f"{name} {which}: "
                      "non-finite")
                check(bool((diff <= BWD_RTOL * r.abs()
                            + BWD_ATOL_FRAC * r.abs().max()).all()),
                      f"{name} {which}: max abs err {diff.max().item()}")
                worst = max(worst, diff.max().item())
            n += 1
            del q, k, v, do, o, lse, delta, got, ref
    torch.cuda.empty_cache()
    print(f"[K2/K3] head dims 144 and 160: {n} edge shapes agree with the "
          f"plain versions in the Hopper regime, max abs err {worst:.3e}",
          flush=True)
    return {"shapes": n, "max_abs_err": worst}


def seedx_train_fields(seedtrain, lm):
    """Phase 13's fields of each kernel's row in the JSON line: K1's
    launches a training step and its LSE rows; K2's and K3's times per
    SEED-X training step (40 Llama layers at D = 128, the input projector
    at D = 160, the output projector), their rows and the D = 144 / 160
    edge sweep; K4's and K5's per QLoRA step."""
    smix = {"seedx_llama2_train": lm.num_hidden_layers,
            "seedx_input_projector_train": 1,
            "seedx_output_projector_train": 1}
    b = seedtrain["bf16"]
    out = {"flash_fwd": {
        "seedx_train_launches_per_step": b["expected_per_step"]["flash_fwd"],
        "seedx_train_lse_shapes": [r["lse"] for r in seedtrain["bwd"]]}}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out[name] = {
            "seedx_step": {
                **row_mix([r[name] for r in seedtrain["bwd"]], smix,
                          f"one SEED-X training step at batch {b['batch']}",
                          sums=("pr4_ms",)),
                "launches_per_step": b["k23_by_head_dim"]},
            "seedx_shapes": [r[name] for r in seedtrain["bwd"]],
            "d144_d160_edge_sweep": seedtrain["k23_sweep"]}
    for bits in (8, 4):
        out[f"int{bits}_matmul"] = {"seedx_qlora_step": seedx_qlora_mix(
            seedtrain["quant"][bits], lm, b["batch"] * b["seq"],
            seedtrain[f"int{bits}"])}
    return out


def seedx_qlora_mix(rows, lm, M, run):
    """K4's or K5's rows at one SEED-X training step's shapes (M = batch ×
    sequence) summed over its launch mix: every adapter's quantized base
    in the forward and again under remat, and the lm_head once."""
    hs, inter = lm.hidden_size, lm.intermediate_size
    fwd = 2 if lm.remat else 1
    L = lm.num_hidden_layers
    agg = quant_row_mix(rows, {(hs, hs): fwd * 4 * L,
                               (hs, inter): fwd * 2 * L,
                               (inter, hs): fwd * L,
                               (hs, lm.vocab_size): 1})
    return {**{k: agg[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms", "bound_by", "bound_share")},
            "ms_basis": f"one SEED-X QLoRA training step (M={M}): the "
                        "launch mix " + agg["launch_mix"],
            "launches_per_step": sum(run["launches"][k] for k in (
                "int8_matmul", "int4_matmul")) // run["steps"],
            "peak_gib": run["peak_gib"], "sec_per_step": run["sec_per_step"],
            "shapes": rows}


def seedx_train_phase(workdir):
    """Phase 13: the SEED-X launcher's recipe through ``train.main`` (b),
    one step's gradients against plain attention (c), the int4 QLoRA
    recipe and one int8 step (d), then K2/K3 at head dims 144 and 160, K1
    with its LSE and K4/K5 at the run's training shapes (a)."""
    import torch
    out = {}
    # -- b. the bf16 recipe ---------------------------------------------
    run, per_step, B, cuts, peak, wall = seedx_train_run(
        workdir, [], SEEDX_TRAIN_STEPS, SEEDX_TRAIN_BATCHES, "bf16")
    model = run.model
    kinds = {d for rec, _, _ in per_step for d in rec["datasets"]}
    check(kinds == set(cuts), f"the mixture's entries {sorted(cuts)}: only "
          f"{sorted(kinds)} ran")
    launches = check_seedx_steps(per_step, model, "bf16")
    gen = [rec["rec_loss"] for rec, _, _ in per_step
           if "laion-coco" in rec["datasets"]]
    check(any(r > 0 for r in gen), f"no caption step has rec_loss > 0: {gen}")
    ckpt = workdir / "bf16" / f"out_b{B}" / f"checkpoint_{SEEDX_TRAIN_STEPS}"
    check((ckpt / "state.pt").is_file(), f"no checkpoint at {ckpt}")
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    steady = [rec for rec, _, _ in per_step[1:]]
    batch = run.last_batches
    caption = [rec for rec, _, _ in per_step[1:]
               if rec["datasets"] == ["laion-coco"]]
    b = {
        "batch": B, "cuts": cuts, "steps": SEEDX_TRAIN_STEPS,
        "datasets": [rec["datasets"] for rec, _, _ in per_step],
        "losses": [rec["loss"] for rec, _, _ in per_step],
        "rec_losses": [rec["rec_loss"] for rec, _, _ in per_step],
        "sec_per_step": sum(r["sec/step"] for r in steady) / len(steady),
        "tokens_per_s": sum(r["tokens/s"] for r in steady) / len(steady),
        "images_per_s": sum(r["images/s"] for r in steady) / len(steady),
        "caption_sec_per_step": (sum(r["sec/step"] for r in caption)
                                 / len(caption) if caption else None),
        "peak_gib": peak, "wall_s": wall, "trainable_m": n_train / 1e6,
        "checkpoint_gib": (ckpt / "state.pt").stat().st_size / 2**30,
        "launches": dict(launches),
        "expected_per_step": {k: v for k, v in seedx_expected(model)[0]
                              .items() if v},
        "k23_by_head_dim": {f"{k}_D{d}": n for (k, d), n
                            in seedx_expected(model)[1].items()},
        "seq": int(batch[0]["input_ids"].shape[1]),
        "images": int(batch[0]["images"].shape[0]),
    }
    print(f"[seedx-train] bf16 recipe at batch {B} (cuts {cuts}): "
          f"{SEEDX_TRAIN_STEPS} steps in {wall:.1f} s with the build; "
          f"steps 2-{SEEDX_TRAIN_STEPS}: {b['sec_per_step']:.3f} sec/step, "
          f"{b['tokens_per_s']:.0f} tokens/s, {b['images_per_s']:.1f} "
          f"images/s; peak {peak:.2f} GiB; {b['trainable_m']:.1f} M "
          f"trainable; checkpoint {b['checkpoint_gib']:.2f} GiB; per step "
          f"{b['expected_per_step']}, K2/K3 by head dim "
          f"{b['k23_by_head_dim']}", flush=True)
    import shutil
    shutil.rmtree(workdir / "bf16" / f"out_b{B}", ignore_errors=True)
    b["repeated_losses"] = repeated_batch_steps(model, run.optimizer, batch,
                                                "bf16")
    # one step taken apart, each part ending in a synchronize
    from mllm_npu_tpu_torch.train import train as trainer
    from mllm_npu_tpu_torch.train.train_state import make_train_step
    parts = {}
    for p in model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    t = time.perf_counter()
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
    b["step_parts_s"] = parts
    del loss
    print(f"[seedx-train] one step at batch {B} taken apart: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in parts.items()), flush=True)
    step = make_train_step(model, trainer.mllm_loss, run.optimizer)
    b["profile"] = profile_call(lambda: step(batch))
    print_profile(f"one SEED-X training step at batch {B}", *b["profile"])
    out["bf16"] = b
    for fn in kernel_counters().values():    # the extra steps: not counted
        fn.launches = 0
    # -- c. one step's gradients against plain attention -----------------
    check(bool(batch[0]["ids_gen_mask"].any()), "the last step's batch has "
          "no generation slot: the output projector's gradient would be 0")
    run.optimizer = None
    del step
    gc.collect()
    torch.cuda.empty_cache()
    out["grads"] = seedx_grad_check(model, batch[0])
    del run, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    # -- d. the int4 QLoRA recipe, then one int8 step --------------------
    for quant, steps in (("int4", SEEDX_QLORA_STEPS), ("int8", 1)):
        batches = tuple(x for x in SEEDX_TRAIN_BATCHES if x <= B)
        if quant == "int8":
            batches = (out["int4"]["batch"],)
        qrun, qsteps, QB, qcuts, qpeak, qwall = seedx_train_run(
            workdir, ["--quantize_base", quant], steps, batches, quant)
        qlaunch = check_seedx_steps(qsteps, qrun.model, quant, quant)
        other = "int8" if quant == "int4" else "int4"
        check(qlaunch[f"{other}_matmul"] == 0, f"{quant}: {other} launched")
        q = {"batch": QB, "steps": steps, "peak_gib": qpeak, "wall_s": qwall,
             "datasets": [rec["datasets"] for rec, _, _ in qsteps],
             "losses": [rec["loss"] for rec, _, _ in qsteps],
             "sec_per_step": (sum(r["sec/step"] for r, _, _ in
                                  qsteps[1:] or qsteps)
                              / len(qsteps[1:] or qsteps)),
             "launches": qlaunch,
             "trainable_m": sum(p.numel() for p in qrun.model.parameters()
                                if p.requires_grad) / 1e6,
             "resident_gib_after": torch.cuda.memory_allocated() / 2**30}
        print(f"[seedx-train] {quant} QLoRA at batch {QB}: {steps} steps in "
              f"{qwall:.1f} s with the build and quantization; "
              f"{q['sec_per_step']:.3f} sec/step; peak {qpeak:.2f} GiB "
              f"(bf16 recipe {peak:.2f} GiB at batch {B}); "
              f"{q['trainable_m']:.1f} M trainable; K{5 if quant == 'int4' else 4}"
              f" {qlaunch[f'{quant}_matmul'] // steps} a step", flush=True)
        if quant == "int4":
            q["repeated_losses"] = repeated_batch_steps(
                qrun.model, qrun.optimizer, qrun.last_batches, quant)
            for fn in kernel_counters().values():
                fn.launches = 0
        out[quant] = q
        for k, n in qlaunch.items():
            launches[k] = launches.get(k, 0) + n
        import shutil
        shutil.rmtree(workdir / quant, ignore_errors=True)
        del qrun
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = launches
    # -- a. the kernels at this run's shapes, the model dropped -----------
    out.update(seedx_kernel_phase(B, out["bf16"]["seq"],
                                  out["bf16"]["images"]))
    return out


def seedx_kernel_phase(B, S, n_img):
    """Phase 13a: K2/K3 at head dims 144 and 160 across the edge sweep,
    then K1 with its LSE, K2 and K3 at the training run's shapes (batch
    ``B`` of ``S`` tokens, ``n_img`` image slots) and at D = 144, and K4 /
    K5 at its training rows (M = B·S)."""
    out = {}
    vis, proj, outp, lm = seedx_specs()
    out["k23_sweep"] = k23_wide_sweep()
    d_in = proj["embed_dim"] // proj["num_heads"]
    d_out = outp["embed_dim"] // outp["num_heads"]
    out["bwd"] = [
        bwd_case("seedx_input_projector_train", n_img, proj["num_queries"],
                 vis.n_queries, proj["num_heads"], proj["num_heads"], d_in,
                 False),
        bwd_case("seedx_llama2_train", B, S, S, lm.num_attention_heads,
                 lm.num_key_value_heads, lm.head_dim, True, segments=True),
        bwd_case("seedx_output_projector_train", n_img,
                 outp["num_queries"], outp["num_queries"],
                 outp["num_heads"], outp["num_heads"], d_out, False),
        bwd_case("wide_d144_causal_gqa", 2, 300, 300, 8, 2, 144, True,
                 segments=True),
    ]
    hs, inter = lm.hidden_size, lm.intermediate_size
    M = B * S
    out["quant"] = {bits: [dict(quant_case(bits, M, k, n,
                                           lm.quant_group_size),
                                regime="train")
                           for k, n in ((hs, hs), (hs, inter), (inter, hs),
                                        (hs, lm.vocab_size))]
                    for bits in (8, 4)}
    return out


# -- phase 14: the reference's checkpoints, written and loaded back -------
CKPT_SHARD_BYTES = 5 * 10 ** 9        # HF's shard size
# what the phase holds on disk at once: the 8B assembly's files and the
# converter's copy (the UNet's and the VAE's come after both are gone)
CKPT_DISK_BYTES = 40e9
CKPT_QUESTION = "What is the capital of France?"


def page_cache_share(paths):
    """The share of the bytes of ``paths`` in the page cache (``mincore``
    over a private mapping of each file, which reads nothing), or None
    where the system does not say."""
    import ctypes
    import mmap
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p)
    resident = total = 0
    try:
        for p in paths:
            size = os.path.getsize(p)
            if not size:
                continue
            with open(p, "rb") as f:
                mm = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
            view = ctypes.c_char.from_buffer(mm)
            pages = -(-size // mmap.PAGESIZE)
            vec = (ctypes.c_ubyte * pages)()
            rc = libc.mincore(ctypes.addressof(view), size, vec)
            del view
            mm.close()
            if rc:
                return None
            resident += sum(v & 1 for v in vec) * mmap.PAGESIZE
            total += pages * mmap.PAGESIZE
    except (OSError, ValueError, AttributeError):
        return None
    return resident / total if total else None


def rss_gib():
    """This process's resident set (``VmRSS``), or None where ``/proc``
    does not give it."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) / 2**20
    return None


class RssPeak:
    """The peak of :func:`rss_gib` over a block, sampled every 10 ms on a
    thread (``peak_gib``; None where it cannot be read)."""

    def __enter__(self):
        import threading
        self.peak_gib = rss_gib()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.01):
                now = rss_gib()
                if now is not None and self.peak_gib is not None:
                    self.peak_gib = max(self.peak_gib, now)
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        now = rss_gib()
        if now is not None and self.peak_gib is not None:
            self.peak_gib = max(self.peak_gib, now)


def first_token(config):
    """``python3 chip_smoke.py --first-token <yaml>``: the worker's engine
    from the YAML, then the text question's first token; prints one JSON
    line with the wall clock at that token, the build's seconds, and the
    process's peak host and device memory."""
    import torch
    from mllm_npu_tpu_torch.serve.worker import load_engine_from_config
    t0 = time.time()
    with RssPeak() as rss:
        engine = load_engine_from_config(
            config, max_new_tokens=1, device="cuda", seed=0,
            fake_tokenizer=True)
        torch.cuda.synchronize()
        built = time.time()
        ids = engine.comprehension_ids(CKPT_QUESTION, "", max_new_tokens=1)
        torch.cuda.synchronize()
        t1 = time.time()
    print(json.dumps({"first_token_unix": t1, "build_s": built - t0,
                      "first_token_s": t1 - built, "id": int(ids[0]),
                      "host_peak_gib": rss.peak_gib,
                      "device_peak_gib":
                          torch.cuda.max_memory_allocated() / 2**30}))


def first_token_child(label, config, files=()):
    """:func:`first_token` in a process of its own: → its JSON plus the
    seconds from the process's start to its first token, and the share of
    ``files`` in the page cache when it started."""
    cache = page_cache_share(files) if files else None
    argv = [sys.executable, str(ROOT / "chip_smoke.py"), "--first-token",
            str(config)]
    t0 = time.time()
    res = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"first token ({label}): exit "
          f"{res.returncode}: {res.stderr[-2000:]}")
    got = json.loads(res.stdout.strip().splitlines()[-1])
    got.update(start_to_first_token_s=got["first_token_unix"] - t0,
               page_cache_share=cache)
    print(f"[ckpt] first token from a new process ({label}): "
          f"{got['start_to_first_token_s']:.1f} s from its start (the build "
          f"{got['build_s']:.1f} s, the token {got['first_token_s']:.2f} s); "
          f"peak host " + ("not measured" if got["host_peak_gib"] is None
                           else f"{got['host_peak_gib']:.2f} GiB")
          + f" from the build to the token, device "
          f"{got['device_peak_gib']:.2f} GiB"
          + ("" if cache is None else
             f"; its files {100 * cache:.1f}% in the page cache at its start"),
          flush=True)
    return got


def load_report(model, label):
    """Print a build's checkpoint report per component: → {component:
    {tensors, GiB, s, GiB/s}}."""
    rep = model.checkpoint_report
    out = {}
    for part, r in rep["loaded"].items():
        gib = r["bytes"] / 2**30
        out[part] = {"tensors": r["tensors"], "gib": gib, "s": r["seconds"],
                     "gib_per_s": gib / r["seconds"] if r["seconds"] else None}
    print(f"[ckpt] {label} loaded per component: " + "; ".join(
        f"{k} {v['tensors']} tensors, {v['gib']:.3f} GiB in {v['s']:.2f} s "
        f"({v['gib_per_s']:.2f} GiB/s)" for k, v in out.items())
        + f"; seeded {rep['seeded']}, skipped {rep['skipped']}", flush=True)
    return out


def same_tensors(a, b, label):
    """Every tensor of the module ``b`` equals ``a``'s of its name, bit for
    bit. → the count."""
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    check(sa.keys() == sb.keys(), f"{label}: the state_dicts' names differ")
    bad = [k for k in sa if sa[k].dtype != sb[k].dtype
           or not torch.equal(sa[k], sb[k])]
    check(not bad, f"{label}: {len(bad)} tensors differ from their source, "
          f"e.g. {bad[:3]}")
    return len(sa)


def timed_writes(work, writers):
    """Run each ``(part, fn)`` writer (``fn`` fills ``work / part``), sync
    the disk after it and print its GiB, seconds and files. → {part:
    (GiB, seconds)}."""
    written = {}
    for part, fn in writers:
        (work / part).mkdir(exist_ok=True)
        t0 = time.perf_counter()
        fn(work / part)
        os.sync()
        secs = time.perf_counter() - t0
        files = sorted((work / part).iterdir())
        gib = sum(f.stat().st_size for f in files) / 2**30
        written[part] = (gib, secs)
        print(f"[ckpt] wrote {part}: {gib:.3f} GiB in {secs:.1f} s "
              f"({gib / secs:.2f} GiB/s): "
              + ", ".join(f.name for f in files), flush=True)
    return written


def write_8b_layouts(model, work):
    """The seeded 8B assembly in the reference's layouts: the base Llama as
    an HF directory of safetensors shards at its own vocabulary without
    adapters, SigLIP as an HF directory, and the assembly as a peft
    ``pytorch_model.bin`` (the adapters, the trained norms beside zeroed
    ``original_module`` copies, the resized ``embed_tokens`` and
    ``lm_head``, the projector, ``patch_pos_embed``). → ({part: (GiB,
    seconds)}, the YAML naming them)."""
    import torch
    import yaml
    from mllm_npu_tpu_torch.models.language_models.llama import LlamaConfig
    from mllm_npu_tpu_torch.utils.checkpoint_files import save_sharded
    lm = model.language_model.state_dict()
    base_vocab = LlamaConfig.llama3_8b().vocab_size
    heads = ("model.embed_tokens.weight", "lm_head.weight")
    base = {k: (v[:base_vocab] if k in heads else v) for k, v in lm.items()
            if ".lora_" not in k}
    peft = "language_model.base_model.model."
    asm = {"patch_pos_embed": model.patch_pos_embed.detach()}
    for k, v in lm.items():
        if ".lora_" in k:
            asm[peft + k.replace(".lora_A.", ".lora_A.default.").replace(
                ".lora_B.", ".lora_B.default.")] = v
        elif k in heads:
            asm[peft + k] = v
        elif k.endswith("layernorm.weight") or k == "model.norm.weight":
            mod = k[:-len(".weight")]
            asm[f"{peft}{mod}.modules_to_save.default.weight"] = v
            asm[f"{peft}{mod}.original_module.weight"] = torch.zeros_like(v)
    asm.update({f"projector.{k}": v
                for k, v in model.projector.state_dict().items()})
    written = timed_writes(work, (
        ("llama", lambda d: save_sharded(base, d, CKPT_SHARD_BYTES)),
        ("siglip", lambda d: save_sharded(model.vision_encoder.state_dict(),
                                          d, CKPT_SHARD_BYTES)),
        ("assembly", lambda d: torch.save(
            {k: v.detach().cpu() for k, v in asm.items()},
            d / "pytorch_model.bin"))))
    cfg = yaml.safe_load(Path(LLAMA3_YAML).read_text())
    m = cfg["mllm"]
    m["mllm_model"]["pretrained_model_path"] = str(
        work / "assembly" / "pytorch_model.bin")
    m["mllm_model"]["vision_encoder"]["pretrained_model_name_or_path"] = \
        str(work / "siglip")
    m["language_model"]["model"]["pretrained_model_name_or_path"] = \
        str(work / "llama")
    path = work / "mllm_llama3_8b_siglip_vit.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return written, path


def llama_checkpoint_check(work, requests, preps, lm_cfg, phase4_ids,
                           phase7_ids, launches):
    """Phase 14 on the 8B assembly (see the module's docstring)."""
    import shutil

    import numpy as np
    import torch

    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    from mllm_npu_tpu_torch.serve.worker import (load_engine_from_config,
                                                 parse_worker_args)
    out = {}

    def serve_ids(engine, label, picked=(0, 1, 2), want=phase4_ids,
                  phase="phase 4's three requests"):
        got, _, ids = serve(engine, [requests[i] for i in picked],
                            [preps[i] for i in picked], label, lm_cfg)
        for k, n in got.items():
            launches[k] += n
        same = all(np.array_equal(a, b) for a, b in zip(ids, want))
        print(f"[check] {label}: the greedy ids of {phase} "
              f"{'identical' if same else 'DIFFER'}", flush=True)
        check(same, f"{label}: greedy ids differ from {phase}")
        return got

    t0 = time.perf_counter()
    src = build_engine(LLAMA3_YAML, device="cuda", seed=0,
                       fake_tokenizer=True, max_new_tokens=MAX_NEW_TOKENS)
    torch.cuda.synchronize()
    out["seeded_build_s"] = time.perf_counter() - t0
    print(f"[ckpt] the seeded 8B assembly (seed 0, phase 2's) built in "
          f"{out['seeded_build_s']:.1f} s", flush=True)
    out["written"], yaml_path = write_8b_layouts(src.generator.model, work)
    files = [f for part in ("llama", "siglip", "assembly")
             for f in sorted((work / part).iterdir())]
    out["page_cache_before_load"] = page_cache_share(files)
    gc.collect()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    host_before = rss_gib()
    t0 = time.perf_counter()
    with RssPeak() as rss:
        eng = build_engine(str(yaml_path), device="cuda", seed=0,
                           fake_tokenizer=True, max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_device_peak_gib"] = (torch.cuda.max_memory_allocated()
                                   - resident) / 2**30
    out["load_host_peak_gib"] = (None if rss.peak_gib is None else
                                 rss.peak_gib - host_before)
    model = eng.generator.model
    out["components"] = load_report(model, "the 8B assembly")
    check(model.checkpoint_report["seeded"] == 0
          and not model.checkpoint_report["skipped"],
          f"the loaded 8B assembly seeded or skipped parameters: "
          f"{model.checkpoint_report}")
    out["tensors_equal"] = same_tensors(src.generator.model, model,
                                        "the loaded 8B assembly")
    print(f"[ckpt] the 8B assembly from its files in {out['load_s']:.1f} s "
          f"(the YAML's three checkpoints; the page cache held "
          + ("an unknown share" if out["page_cache_before_load"] is None
             else f"{100 * out['page_cache_before_load']:.1f}%")
          + f" of them): {out['tensors_equal']} tensors equal their source "
          f"bit for bit; device peak above the resident "
          f"{out['load_device_peak_gib']:.2f} GiB, host peak above the "
          "resident " + ("not measured" if out["load_host_peak_gib"] is None
                         else f"{out['load_host_peak_gib']:.2f} GiB"),
          flush=True)
    del src
    gc.collect()
    torch.cuda.empty_cache()
    out["served_launches"] = serve_ids(eng, "loaded bf16")

    # the loaded model quantized to int8: phase 7's requests and ids
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    q8 = build_engine(str(yaml_path), device="cuda", seed=0,
                      fake_tokenizer=True, max_new_tokens=MAX_NEW_TOKENS,
                      quantize_int8=True)
    out["int8_launches"] = serve_ids(q8, "loaded int8", (0, 2), phase7_ids,
                                     "phase 7's int8 requests")
    del q8
    gc.collect()
    torch.cuda.empty_cache()
    # a first token from a new process, from the files
    out["first_token"] = {
        "loaded": first_token_child("the reference's files", yaml_path,
                                    files=files)}

    # the converter on the same YAML, in a process of its own
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mllm_npu_tpu_torch.tools.convert_checkpoint",
         "--model-config", str(yaml_path), "--out", str(work / "converted")],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    check(res.returncode == 0, f"the converter: exit {res.returncode}: "
          f"{res.stderr[-2000:]}")
    info = json.loads(res.stdout.strip().splitlines()[-1])
    info["wall_s"] = time.perf_counter() - t0
    out["converter"] = info
    print(f"[ckpt] the converter: {info['n_params'] / 1e9:.3f} B parameters, "
          f"{info['bytes'] / 2**30:.3f} GiB in {info['shards']} shards, "
          f"convert_seconds {info['convert_seconds']} ({info['wall_s']:.1f} "
          f"s with the process's start)", flush=True)
    for part in ("llama", "siglip", "assembly"):
        shutil.rmtree(work / part)
    # the worker from --params-checkpoint, on the YAML with null paths
    args = parse_worker_args(["--model-config", LLAMA3_YAML,
                              "--params-checkpoint", str(work / "converted"),
                              "--no-register", "--host", "127.0.0.1",
                              "--port", "0"])
    t0 = time.perf_counter()
    conv = load_engine_from_config(
        args.model_config, max_new_tokens=MAX_NEW_TOKENS, device="cuda",
        seed=0, fake_tokenizer=True,
        params_checkpoint=args.params_checkpoint)
    torch.cuda.synchronize()
    out["params_checkpoint_load_s"] = time.perf_counter() - t0
    out["params_checkpoint_components"] = load_report(
        conv.generator.model, "--params-checkpoint")
    check(conv.generator.model.checkpoint_report["seeded"] == 0,
          "the converter's directory left parameters seeded")
    same_tensors(model, conv.generator.model, "--params-checkpoint")
    print(f"[ckpt] the worker's engine from --params-checkpoint in "
          f"{out['params_checkpoint_load_s']:.1f} s: every tensor equal to "
          "the files' load", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["params_checkpoint_launches"] = serve_ids(conv,
                                                  "--params-checkpoint")
    del conv
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(work / "converted")
    return out


def unet_eps(unet, seed=GEN_SEED):
    """One UNet forward at the CFG batch of 2 on seeded inputs (latents,
    the resampler's 64 tokens, pooled embeddings, the 1024² time ids)."""
    import torch

    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        compute_time_ids)
    cfg = unet.config
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    S = cfg.sample_size
    pooled = cfg.projection_class_embeddings_input_dim \
        - 6 * cfg.addition_time_embed_dim
    from mllm_npu_tpu_torch.configs import load_config
    n_ctx = load_config(ROOT / GEN_CONFIG)["resampler"]["num_queries"]
    lat = torch.randn((2, cfg.in_channels, S, S), generator=g, device=dev)
    ctx = torch.randn((2, n_ctx, cfg.cross_attention_dim), generator=g,
                      device=dev)
    pool = torch.randn((2, pooled), generator=g, device=dev)
    tids = torch.as_tensor(compute_time_ids((GEN_SIZE, GEN_SIZE), (0, 0),
                                            GEN_SIZE), device=dev)
    with torch.inference_mode():
        return unet(lat, torch.full((2,), 500.0, device=dev), ctx,
                    added_cond={"text_embeds": pool,
                                "time_ids": torch.cat([tids, tids])})


def detokenizer_checkpoint_check(work, launches):
    """Phase 14 on the de-tokenizer (see the module's docstring)."""
    import torch
    import yaml

    from mllm_npu_tpu_torch.configs import load_config
    from mllm_npu_tpu_torch.models.factory import build_sdxl_adapter
    from mllm_npu_tpu_torch.models.generation.unet import CrossAttention
    from mllm_npu_tpu_torch.utils.checkpoint_files import save_sharded
    out = {}
    gen = load_config(ROOT / GEN_CONFIG)
    t0 = time.perf_counter()
    seeded = build_sdxl_adapter(**gen, device="cuda", seed=0)
    torch.cuda.synchronize()
    out["seeded_build_s"] = time.perf_counter() - t0
    eps = unet_eps(seeded.unet)
    check(torch.equal(eps, unet_eps(seeded.unet)),
          "two seeded UNet forwards on the same inputs differ")
    sd = seeded.unet.state_dict()
    tuned = {k: v for k, v in sd.items()
             if ".attn2.to_k." in k or ".attn2.to_v." in k}
    # the directory's tuned keys are zeros: the de-tokenizer checkpoint's
    # subset must be merged over them for the UNet to be the seeded one
    unet_file = {k: torch.zeros_like(v) if k in tuned else v
                 for k, v in sd.items()}
    diffusers = dict(max_shard_bytes=10 ** 10,
                     prefix="diffusion_pytorch_model")
    out["written"] = timed_writes(work, (
        ("unet", lambda d: save_sharded(unet_file, d, **diffusers)),
        ("vae", lambda d: save_sharded(seeded.vae.state_dict(), d,
                                       **diffusers)),
        ("detokenizer", lambda d: torch.save(
            {**{f"resampler.{k}": v.cpu() for k, v in
                seeded.resampler.state_dict().items()},
             **{f"unet.{k}": v.cpu() for k, v in tuned.items()}},
            d / "pytorch_model.bin"))))
    out["tuned_tensors"] = len(tuned)
    gen.update(unet_checkpoint=str(work / "unet"),
               vae_checkpoint=str(work / "vae"),
               adapter_checkpoint=str(work / "detokenizer" /
                                      "pytorch_model.bin"))
    path = work / "sd_xl_resampler.yaml"
    path.write_text(yaml.safe_dump(gen, sort_keys=False))
    t0 = time.perf_counter()
    ad = build_sdxl_adapter(**load_config(path), device="cuda", seed=0)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["components"] = {}
    n = 0
    for part in ("unet", "vae", "resampler"):
        mod = getattr(ad, part)
        out["components"].update(load_report(mod, f"the de-tokenizer's {part}"))
        check(mod.checkpoint_report["seeded"] == 0,
              f"the loaded {part} left parameters seeded")
        n += same_tensors(getattr(seeded, part), mod,
                          f"the loaded de-tokenizer's {part}")
    out["tensors_equal"] = n
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    eps_loaded = unet_eps(ad.unet)
    got = {k: fn.launches for k, fn in counters.items()}
    for k, v in got.items():
        launches[k] += v
    want = dict.fromkeys(counters, 0)
    want["flash_fwd"] = sum(isinstance(m, CrossAttention)
                            for m in ad.unet.modules())
    same = torch.equal(eps_loaded, eps)
    print(f"[ckpt] the de-tokenizer from {path.name} in {out['load_s']:.1f} s "
          f"(UNet directory with {len(tuned)} to_k/to_v tensors zeroed, the "
          f"de-tokenizer checkpoint's subset merged over them): {n} tensors "
          f"equal their source bit for bit; one UNet forward's ε "
          f"{'equals' if same else 'DIFFERS from'} the seeded adapter's bit "
          f"for bit; launches {got} (expected {want})", flush=True)
    check(same, "the loaded UNet's ε differs from the seeded one's")
    check(got == want, f"loaded UNet forward: launches {got}, expected "
          f"{want}")
    out["unet_launches"] = got["flash_fwd"]
    del seeded, ad, eps, eps_loaded
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase4_requests():
    return [("What is unusual in this image?", png_b64(896, 896, 0)),
            ("Describe the picture.", png_b64(384, 1152, 1)),
            ("What is the capital of France?", "")]


def checkpoint_phase(requests, preps, lm_cfg, phase4_ids, phase7_ids):
    """Phase 14. → its summary, the launches it counted among them."""
    import shutil

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    launches = dict.fromkeys(kernel_counters(), 0)
    try:
        free = shutil.disk_usage(work).free
        print(f"[ckpt] writing under {work}: {free / 1e9:.1f} GB free",
              flush=True)
        check(free > CKPT_DISK_BYTES, f"phase 14 needs "
              f"{CKPT_DISK_BYTES / 1e9:.0f} GB of disk, {free / 1e9:.1f} "
              "free")
        out = {"llama3_8b": llama_checkpoint_check(
            work, requests, preps, lm_cfg, phase4_ids, phase7_ids,
            launches)}
        print("[ckpt] phase 14 b: the de-tokenizer", flush=True)
        out["detokenizer"] = detokenizer_checkpoint_check(work, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["launches"] = launches
    return out


# -- phase 15: the de-tokenizer's variants and its training ---------------
# the int8 / int4 UNet's ε against the bf16 UNet's at the first step: a
# measure of the weights' rounding, not of K4 / K5 (those are held to
# UNET_COS against the plain int8 / int4 products); int4 rounds seeded
# Gaussian weights to 15 levels of each group's largest (cos 0.9647 on an
# NVIDIA H100 80GB HBM3 at 700 W)
QUANT_EPS_COS = {8: 0.99, 4: 0.9}
# SEED-X-Edit's generate: the reference's defaults (adapter_modules.py:244)
EDIT_STEPS = 30
EDIT_IMAGE_GUIDANCE = 1.5
# steps of each of 15b's generates (bf16, int8, int4: ms per step each)
QUANT_STEPS = 10
# de-tokenizer training: the largest batch of these that fits at 1024²,
# the steps on fresh batches, then the steps on one repeated batch
DETOK_BATCHES = (4, 2, 1)
DETOK_STEPS = 4
DETOK_REPEAT_STEPS = 3
# a fresh AdamW's first update moves each of the 402 M trainable weights
# by lr (m / sqrt(v) = sign(g)): at 1e-5 its first-order drop lr·|g|₁ is
# 27% of the loss and the loss falls 3%; at 1e-4 it is 274% and the loss
# rises 50%, with plain attention alike (15c prints both; an NVIDIA H100
# 80GB HBM3 at 700 W)
DETOK_LR = 1e-5
# 15c's step along -g is sized for a first-order drop of this share of the
# loss; the drop measured must be within DESCENT_TOL of it (a random
# direction of the same norm reads 0.3% of it)
DESCENT_SHARE = 0.01
DESCENT_TOL = 0.2
# 15d's LoRA rank (SDXLText2ImageAndEditAdapter's) and the variants' steps
LORA_RANK = 16
VARIANT_STEPS = 4
# SD-2.1 at its native 768², SD-1.5 with IP-Adapter-plus's 16 image tokens
# after 77 text tokens at 512²; the SD VAE's latent scaling
SD21_SIZE = 768
SD15_SIZE = 512
IP_TOKENS = 16
TEXT_TOKENS = 77
SD_SCALING = 0.18215
# the input image of the vision encoder (the IP-Adapter's), as SEED-X's
VISION_SIZE = 448


def unet_attention_mix(cfg, ctx_keys):
    """{(S, heads, D, Sk): K1 launches a forward} of a UNet config at its
    sample size: each transformer block's self-attention (Sk = S) and a
    cross-attention over each length of ``ctx_keys`` (the resampler's
    tokens; with the IP-Adapter the text's and the image tokens')."""
    n = len(cfg.block_out_channels)
    mix = {}

    def add(i, stages):
        S = (cfg.sample_size >> i) ** 2
        H = cfg.num_attention_heads[i]
        blocks = stages * cfg.transformer_layers_per_block[i]
        for Sk in (S, *ctx_keys):
            key = (S, H, cfg.block_out_channels[i] // H, Sk)
            mix[key] = mix.get(key, 0) + blocks
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            add(i, 2 * cfg.layers_per_block + 1)   # down, then up
    add(n - 1, 1)                                  # the mid block
    return mix


def unet_quant_mix(cfg, batch, n_ctx):
    """{(M, K, N): K4 / K5 launches a forward} of the quantized UNet at
    ``batch``: per transformer stage proj_in and proj_out, per block the
    attentions' q, k, v, out (the cross-attention's k and v over the
    ``n_ctx`` context rows), GEGLU's proj and out."""
    n = len(cfg.block_out_channels)
    mix = {}

    def add(key, k):
        mix[key] = mix.get(key, 0) + k

    def level(i, stages):
        C = cfg.block_out_channels[i]
        M = batch * (cfg.sample_size >> i) ** 2
        blocks = stages * cfg.transformer_layers_per_block[i]
        add((M, C, C), 6 * blocks + 2 * stages)
        add((M, C, 8 * C), blocks)
        add((M, 4 * C, C), blocks)
        add((batch * n_ctx, cfg.cross_attention_dim, C), 2 * blocks)
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            level(i, 2 * cfg.layers_per_block + 1)
    level(n - 1, 1)
    return mix


def variant_configs():
    """Phase 15's UNets with their CFG batch and context lengths:
    SEED-X-Edit's (SDXL-base, 8 channels, batch 3), SD-2.1's (8 channels,
    batch 3, the resampler's tokens) and the IP-Adapter's SD-1.5 (batch 2,
    77 text and 16 image tokens)."""
    from mllm_npu_tpu_torch.configs import load_config
    from mllm_npu_tpu_torch.models.generation.unet import UNetConfig
    n_ctx = load_config(ROOT / GEN_CONFIG)["resampler"]["num_queries"]
    return {"edit": (UNetConfig.sdxl_base(in_channels=8), 3, (n_ctx,)),
            "sd21": (UNetConfig.sd21(in_channels=8), 3, (n_ctx,)),
            "sd15_ip": (UNetConfig.sd15(ip_num_image_tokens=IP_TOKENS), 2,
                        (TEXT_TOKENS, IP_TOKENS))}


def variant_kernel_cases():
    """Phase 3's K1 cases at phase 15's UNets (``variant_configs``): →
    (rows, {variant: {shape name: launches a forward}})."""
    rows, mixes = [], {}
    for label, (cfg, B, ctx) in variant_configs().items():
        mixes[label] = {}
        for (S, H, D, Sk), n in unet_attention_mix(cfg, ctx).items():
            name = f"{label}_s{S}_k{Sk}_d{D}_b{B}"
            rows.append(kernel_case(name, B, S, Sk, H, H, D, False))
            mixes[label][name] = n
    return rows, mixes


def unet_quant_cases():
    """Phase 3's K4 / K5 cases at the SDXL UNet's projections (phase 15b:
    CFG batch 2 at 1024², the resampler's 64 tokens; int4 groups of 256,
    or K where 256 does not divide it: 640) → ({bits: rows}, the mix)."""
    from mllm_npu_tpu_torch.configs import load_config
    from mllm_npu_tpu_torch.models.generation.unet import UNetConfig
    from mllm_npu_tpu_torch.ops.quant import group_size_for
    n_ctx = load_config(ROOT / GEN_CONFIG)["resampler"]["num_queries"]
    mix = unet_quant_mix(UNetConfig.sdxl_base(), 2, n_ctx)
    rows = {bits: [] for bits in (8, 4)}
    for bits in (8, 4):
        for (M, K, N) in mix:
            rows[bits].append(quant_case(bits, M, K, N,
                                         group=group_size_for(K, 256)))
    return rows, mix


def module_gib(module) -> float:
    """GiB of a module's parameters and buffers."""
    import itertools
    return sum(t.numel() * t.element_size() for t in itertools.chain(
        module.parameters(), module.buffers())) / 2**30


def zeroed_counters():
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def expect_counts(got, label, **want):
    """Check ``got`` against ``want`` (every other kernel 0)."""
    expect = dict.fromkeys(got, 0)
    expect.update(want)
    check(got == expect, f"{label}: launches {got}, expected {expect}")
    return got


def attention_count(unet):
    """K1 launches of one forward of ``unet``: one per attention, two for
    an IP-Adapter cross-attention."""
    from mllm_npu_tpu_torch.models.generation.unet import CrossAttention
    return sum(1 + (m.ip_tokens > 0) for m in unet.modules()
               if isinstance(m, CrossAttention))


def vision_attention_count(vis):
    from mllm_npu_tpu_torch.models.multimodal_encoder.qwenvl_vit import (
        VisualAttention)
    from mllm_npu_tpu_torch.models.vit_common import TorchMHA
    return sum(isinstance(m, (VisualAttention, TorchMHA))
               for m in vis.modules())


def attention_routes():
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, plain_attention_p_bf16)
    return {"K1": flash_attention, "plain": flash_attention_reference,
            "plain_p_bf16": plain_attention_p_bf16}


def route_outputs(fn, n_k1, label):
    """``fn()`` with K1, with K1's plain version and with the plain version
    rounding P to bf16 (the control): {route: fp32 output}, K1's launches
    checked (``n_k1`` with K1, none otherwise); then the agreements of K1
    and of the control with plain, each printed and K1's checked."""
    import torch

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.ops.flash_attention import flash_attention
    out = {}
    for which, attn in attention_routes().items():
        port_ops.flash_attention = attn
        flash_attention.launches = 0
        try:
            out[which] = fn().float()
        finally:
            port_ops.flash_attention = flash_attention
        want = n_k1 if which == "K1" else 0
        check(flash_attention.launches == want, f"{label} ({which}): "
              f"{flash_attention.launches} K1 launches, expected {want}")
        check(bool(torch.isfinite(out[which]).all()),
              f"{label} ({which}): non-finite")
    k1 = agreement(out["K1"], out["plain"])
    ctl = agreement(out["plain_p_bf16"], out["plain"])
    print(f"[check] {label}, K1 vs plain attention: cos {k1['cos']:.6f}, "
          f"relative RMS {k1['rel_rms']:.4f}; control (plain with P in "
          f"bf16 vs plain): cos {ctl['cos']:.6f}, relative RMS "
          f"{ctl['rel_rms']:.4f}", flush=True)
    check(k1["cos"] >= UNET_COS, f"{label}: K1 vs plain {k1}")
    return {"k1": k1, "control": ctl}


def seeded(shape, seed, dev, scale=1.0, uniform=False):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if uniform:
        return torch.rand(shape, generator=g, device=dev) * 2 - 1
    return torch.randn(shape, generator=g, device=dev) * scale


def timed(fn):
    """``fn()`` with every count set to 0 before and read after, its wall
    seconds and the device's peak: → (result, counts, seconds, peak GiB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = zeroed_counters()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, read_counts(counters), wall, \
        torch.cuda.max_memory_allocated() / 2**30


def first_step_inputs(ad, feats, ways, size, steps, image_size,
                      image_latents=None):
    """The UNet's inputs at the first of ``steps`` Euler steps of ``ad``'s
    ``ways``-way guidance (2: SDXLAdapter, 3: the edit adapter over
    ``image_latents``) on the seeded first noise → {lat_in, t, prompt,
    added: the UNet's arguments; noise: the first latents × σ; embeds:
    (pe, pe_neg, pooled, pooled_neg); tids: [1, 6]; batch3: the edit's
    guidance batch}."""
    import torch

    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        compute_time_ids)
    dev = torch.device("cuda")
    sched = ad.scheduler
    embeds = ad.get_image_embeds(image_embeds=feats, image_size=image_size)
    pe, pe_neg, pooled, pooled_neg = embeds
    f = ad.vae.config.spatial_scale_factor
    noise = seeded((1, 4, size // f, size // f), GEN_SEED, dev) \
        * sched.init_noise_sigma
    ts, sigmas = sched.make_schedule(steps, device=dev)
    tids = torch.as_tensor(compute_time_ids((size, size), (0, 0), size),
                           device=dev)
    lat_in = sched.scale_model_input(torch.cat([noise] * ways), sigmas[0])
    out = {"t": ts[0].expand(ways), "noise": noise, "embeds": embeds,
           "tids": tids}
    if ways == 3:
        out["batch3"] = prompt, pooled_all, tids3, img_lat_all = \
            ad.guidance_batch(*embeds, tids, image_latents)
        lat_in = torch.cat([lat_in, img_lat_all], dim=1)
        added = {"text_embeds": pooled_all, "time_ids": tids3}
    else:
        prompt = torch.cat([pe_neg, pe])
        added = {"text_embeds": torch.cat([pooled_neg, pooled]),
                 "time_ids": torch.cat([tids, tids])}
    out.update(lat_in=lat_in, prompt=prompt, added=added)
    return out


def quantized_unet(unet, bits):
    """``unet``'s int8 / int4 twin: ``quantize_unet_params`` on its state
    (the convolutions, norms and skipped layers shared, not copied) loaded
    into a UNet built on ``meta`` with ``quantization``."""
    import dataclasses

    import torch

    from mllm_npu_tpu_torch.models.generation.unet import (
        UNet2DConditionModel, quantize_unet_params)
    state = quantize_unet_params(unet.state_dict(), bits=bits)
    with torch.device("meta"):
        q = UNet2DConditionModel(dataclasses.replace(
            unet.config, quantization=f"int{bits}"), dtype=unet.dtype)
    q.load_state_dict(state, strict=True, assign=True)
    return q.eval()


def quantized_unet_phase(ad, feats, n_k1):
    """15b: phase 11's caption → image path (the SDXL adapter's generate on
    the output projector's features) with the UNet bf16, int8 and int4."""
    import torch

    from mllm_npu_tpu_torch.ops import quant as tq
    size = GEN_SIZE
    unets = {"bf16": ad.unet}
    for bits in (8, 4):
        unets[f"int{bits}"] = quantized_unet(ad.unet, bits)
    n_q = sum(isinstance(m, tq.Int8Linear) for m in unets["int8"].modules())
    with torch.inference_mode():
        x = first_step_inputs(ad, feats, 2, size, QUANT_STEPS, VISION_SIZE)
    out = {"quantized_linears": n_q}
    eps = {}
    for label, unet in unets.items():
        ad.unet = unet
        bits = {"bf16": None, "int8": 8, "int4": 4}[label]
        kernel = {8: "int8_matmul", 4: "int4_matmul"}.get(bits)
        q_want = {kernel: n_q * QUANT_STEPS} if kernel else {}
        imgs, got, wall, peak = timed(lambda: ad.generate(
            image_embeds=feats, seed=GEN_SEED, height=size, width=size,
            guidance_scale=GEN_GUIDANCE, num_inference_steps=QUANT_STEPS,
            input_image_size=VISION_SIZE))
        t = dict(ad.last_timings)
        expect_counts(got, f"15b {label} generate",
                      flash_fwd=n_k1 * QUANT_STEPS, **q_want)
        check(imgs[0].size == (size, size), f"15b {label}: image size")
        with torch.inference_mode():
            fwd = lambda: unet(x["lat_in"], x["t"], x["prompt"],
                               added_cond=x["added"])
            e, got_f, _, _ = timed(fwd)
            expect_counts(got_f, f"15b {label} UNet forward",
                          flash_fwd=n_k1, **({kernel: n_q} if kernel else {}))
            eps[label] = e.float()
            fwd_ms = time_ms(fwd, iters=3)
            row = {"generate_s": wall, "ms_per_step":
                   t["denoise_s"] * 1e3 / t["steps"], "timings": t,
                   "peak_gib": peak, "unet_gib": module_gib(unet),
                   "unet_forward_ms": fwd_ms, "launches": got,
                   "forward_launches": got_f}
            if bits:
                # the same quantized UNet with the plain int8 / int4
                # products: the kernels' own agreement
                plain = {8: tq.int8_matmul_reference,
                         4: tq.int4_matmul_reference}[bits]
                saved = getattr(tq, kernel)
                setattr(tq, kernel, plain)
                try:
                    e_plain = fwd().float()
                finally:
                    setattr(tq, kernel, saved)
                row["eps_vs_plain_products"] = agreement(eps[label], e_plain)
                row["eps_vs_bf16"] = agreement(eps[label], eps["bf16"])
                check(row["eps_vs_plain_products"]["cos"] >= UNET_COS,
                      f"15b {label}: ε with K{4 if bits == 8 else 5} vs the "
                      f"plain products {row['eps_vs_plain_products']}")
                check(row["eps_vs_bf16"]["cos"] >= QUANT_EPS_COS[bits],
                      f"15b {label}: ε vs the bf16 UNet "
                      f"{row['eps_vs_bf16']}")
        out[label] = row
        print(f"[phase 15b] {label} UNet ({row['unet_gib']:.2f} GiB): a "
              f"{QUANT_STEPS}-step {size}² generate in {wall:.2f} s, "
              f"{row['ms_per_step']:.2f} ms a UNet step at batch 2, one "
              f"forward {fwd_ms:.2f} ms on CUDA events; peak {peak:.2f} GiB;"
              f" launches {got}, a forward {got_f}"
              + (f"; ε vs the plain products cos "
                 f"{row['eps_vs_plain_products']['cos']:.6f}, vs bf16 cos "
                 f"{row['eps_vs_bf16']['cos']:.6f} (relative RMS "
                 f"{row['eps_vs_bf16']['rel_rms']:.4f})" if bits else ""),
              flush=True)
    ad.unet = unets["bf16"]
    del unets
    gc.collect()
    torch.cuda.empty_cache()
    return out


def edit_phase(ad, feats, n_k1):
    """15a: SEED-X-Edit at 1024² (the seeded input image VAE-encoded, three
    guidance ways, 30 Euler steps)."""
    import torch
    dev = torch.device("cuda")
    size = GEN_SIZE
    image = seeded((1, 3, size, size), GEN_SEED + 1, dev, uniform=True)
    imgs, got, wall, peak = timed(lambda: ad.generate(
        image_embeds=feats, latent_image=image, seed=GEN_SEED, height=size,
        width=size, guidance_scale=GEN_GUIDANCE,
        image_guidance_scale=EDIT_IMAGE_GUIDANCE,
        num_inference_steps=EDIT_STEPS, input_image_size=VISION_SIZE))
    t = dict(ad.last_timings)
    expect_counts(got, "15a edit generate", flash_fwd=n_k1 * EDIT_STEPS)
    check(imgs[0].size == (size, size), "15a: image size")
    ms_step = t["denoise_s"] * 1e3 / t["steps"]
    print(f"[phase 15a] edit generate ({size}², {EDIT_STEPS} steps, guidance "
          f"{GEN_GUIDANCE} / image {EDIT_IMAGE_GUIDANCE}) in {wall:.2f} s: "
          f"embeds {t['embeds_s'] * 1e3:.1f} ms, VAE encode "
          f"{t['encode_s'] * 1e3:.1f} ms, denoise {t['denoise_s']:.3f} s "
          f"({ms_step:.2f} ms a UNet step at batch 3), VAE decode "
          f"{t['vae_s'] * 1e3:.1f} ms; peak {peak:.2f} GiB; launches {got} "
          f"({n_k1} x {EDIT_STEPS})", flush=True)
    with torch.inference_mode():
        # the VAE again, warm: the generate's first encode and decode
        # against the same work repeated
        lat, _, enc_s, _ = timed(lambda: ad.encode_image(image))
        _, _, dec_s, _ = timed(lambda: ad.vae.decode(
            lat / ad.vae.config.scaling_factor))
        t["warm_encode_s"], t["warm_decode_s"] = enc_s, dec_s
        print(f"[phase 15a] the VAE again (warm): encode {enc_s * 1e3:.1f} "
              f"ms, decode {dec_s * 1e3:.1f} ms", flush=True)
        x = first_step_inputs(ad, feats, 3, size, EDIT_STEPS, VISION_SIZE,
                              ad.encode_image(image))

        def fwd():
            return ad.unet(x["lat_in"], x["t"], x["prompt"],
                           added_cond=x["added"])
        eps = route_outputs(fwd, n_k1,
                            "15a edit UNet ε at the first step (batch 3)")
        lats = route_outputs(lambda: ad.denoise3(
            x["noise"], *x["batch3"], GEN_GUIDANCE, EDIT_IMAGE_GUIDANCE,
            SHORT_STEPS), n_k1 * SHORT_STEPS,
            f"15a edit final latents of a {SHORT_STEPS}-step run")
        fwd_ms = time_ms(fwd, iters=3)
    return {"generate_s": wall, "timings": t, "ms_per_step": ms_step,
            "peak_gib": peak, "launches": got, "eps": eps,
            "latents": lats, "unet_forward_ms": fwd_ms}


def detok_batch(ad, feats_shape, B, seed, edit=False):
    """A training batch at 1024²: the VAE latents of B seeded images × the
    scaling factor, noised by ``DDPMScheduler.add_noise`` at seeded
    timesteps, seeded features of the vision tower's shape, the time ids
    (``edit``: the images' latents beside the noisy ones, the edit UNet's
    8 channels)."""
    import torch

    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        compute_time_ids)
    from mllm_npu_tpu_torch.models.generation.schedulers import DDPMScheduler
    dev = torch.device("cuda")
    size = GEN_SIZE
    with torch.no_grad():
        images = seeded((B, 3, size, size), seed, dev, uniform=True)
        mean = torch.cat([ad.vae.encode(images[i:i + 1]).float()
                          for i in range(B)])
        lat = mean * ad.vae.config.scaling_factor
        noise = seeded(lat.shape, seed + 1, dev)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 2)
        t = torch.randint(0, 1000, (B,), generator=g, device=dev)
        noisy = DDPMScheduler().add_noise(lat, noise, t)
        if edit:
            noisy = torch.cat([noisy, mean], dim=1)
        feats = seeded((B, *feats_shape[1:]), seed + 3, dev)
    tids = torch.as_tensor(compute_time_ids((size, size), (0, 0), size),
                           device=dev).repeat(B, 1)
    return {"noisy_latents": noisy, "timesteps": t.float(),
            "image_embeds": feats.to(ad.unet.dtype), "noise": noise,
            "time_ids": tids}


def trainable_fp32(parts, patterns):
    """Mark the trainable set by the patterns and hold it in fp32 (the
    modules compute in bf16); → its parameter count."""
    from mllm_npu_tpu_torch.train.train_state import apply_frozen_patterns
    apply_frozen_patterns(parts, patterns)
    n = 0
    for p in parts.parameters():
        if p.requires_grad:
            p.data = p.data.float()
            n += p.numel()
    return n


def adapter_optimizer(ad, lr=DETOK_LR):
    """The port's AdamW over ``ad.parts``' trainable set at a constant
    ``lr``."""
    from mllm_npu_tpu_torch.train.train_state import (
        AdamW, OptimizerConfig, trainable_parameters)
    return AdamW(trainable_parameters(ad.parts),
                 OptimizerConfig(lr=lr, warmup_steps=0,
                                 scheduler="constant"))


def train_steps(ad, opt, batches, n_k1, label):
    """One step of ``opt`` per batch over ``ad.parts``' trainable set,
    every count set to 0 before each step and read after: K1 with its LSE
    twice a forward (the remat recompute), K2 and K3 once each, all in the
    Hopper regime (K1 once without remat). → (losses, seconds per step,
    counts per step, peak)."""
    import torch

    from mllm_npu_tpu_torch.ops.flash_attention import (flash_bwd_dkv,
                                                        flash_bwd_dq)
    from mllm_npu_tpu_torch.train.train_state import make_train_step
    step = make_train_step(ad.parts, lambda m, b: ad.loss_fn(b), opt)
    losses, secs, counts, peak = [], [], [], 0.0
    for batch in batches:
        flash_bwd_dq.wgmma_launches = flash_bwd_dkv.wgmma_launches = 0
        (loss, _), got, wall, p = timed(lambda: step([batch]))
        peak = max(peak, p)
        expect_counts(got, f"{label} step",
                      flash_fwd=(1 + ad.unet.config.remat) * n_k1,
                      flash_bwd_dq=n_k1, flash_bwd_dkv=n_k1)
        check(flash_bwd_dq.wgmma_launches == flash_bwd_dkv.wgmma_launches
              == n_k1, f"{label}: K2/K3 not all in the Hopper regime")
        check(bool(torch.isfinite(loss)), f"{label}: non-finite loss")
        losses.append(float(loss))
        secs.append(wall)
        counts.append(got)
    return losses, secs, counts, peak


def detok_grad_check(ad, batch):
    """15c: one batch's trainable gradients with K1/K2/K3 against plain
    attention forward and backward: cos ≥ GRAD_COS for the UNet's tuned
    projections and for the resampler."""
    import torch

    from mllm_npu_tpu_torch.train.train_state import compute_grads
    groups = {"unet attn2 to_k/to_v": lambda n: n.startswith("unet."),
              "resampler": lambda n: n.startswith("resampler.")}
    grads, losses = {}, {}
    for route in ("kernels", "plain"):
        with plain_attention() if route == "plain" else \
                contextlib.nullcontext():
            loss, _ = compute_grads(ad.parts, lambda m, b: ad.loss_fn(b),
                                    [batch])
        losses[route] = float(loss)
        grads[route] = {g: torch.cat([p.grad.float().flatten() for n, p in
                                      ad.parts.named_parameters()
                                      if p.requires_grad and sel(n)])
                        for g, sel in groups.items()}
        for p in ad.parts.parameters():
            p.grad = None
    out = {"losses": losses, "cos": {}}
    for g in groups:
        a, b = grads["kernels"][g], grads["plain"][g]
        cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
        out["cos"][g] = cos
        print(f"[check] 15c {g} gradients ({a.numel() / 1e6:.2f} M), "
              f"K1/K2/K3 vs plain attention: cos {cos:.6f}, |g| "
              f"{a.norm().item():.4e} vs {b.norm().item():.4e}", flush=True)
        check(cos >= GRAD_COS, f"15c {g} gradients disagree (cos {cos})")
    return out


@contextlib.contextmanager
def plain_attention():
    """K1, and the training route through K1/K2/K3, swapped for their plain
    version inside the block."""
    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention_reference)
    fns = (port_ops.flash_attention, port_ops.flash_attention_trainable)
    port_ops.flash_attention = flash_attention_reference
    port_ops.flash_attention_trainable = flash_attention_reference
    try:
        yield
    finally:
        port_ops.flash_attention, port_ops.flash_attention_trainable = fns


def first_update_check(ad, batch):
    """15c on one batch: the loss after an SGD step along the kernels'
    gradient -g, sized so that its first-order drop η·|g|² is
    DESCENT_SHARE of the loss, against that prediction (checked); then
    the loss after a fresh AdamW's first update at DETOK_LR and at 10×,
    with the kernels and (10×) with plain attention, beside the
    first-order drop of a step of lr · sign(g), lr·|g|₁ (printed). The
    weights are restored after each."""
    import torch

    from mllm_npu_tpu_torch.train.train_state import (
        compute_grads, make_train_step, trainable_parameters)
    params = [p for _, p in trainable_parameters(ad.parts)]
    saved = [p.detach().clone() for p in params]

    def loss_now():
        with torch.no_grad():
            return float(ad.loss_fn(batch)[0])

    def restore():
        with torch.no_grad():
            for p, x in zip(params, saved):
                p.copy_(x)
                p.grad = None
    l0 = loss_now()
    compute_grads(ad.parts, lambda m, b: ad.loss_fn(b), [batch])
    g2 = sum(float(p.grad.float().square().sum()) for p in params)
    g1 = sum(float(p.grad.float().abs().sum()) for p in params)
    eta = DESCENT_SHARE * l0 / g2
    with torch.no_grad():
        for p in params:
            p.sub_(eta * p.grad)
    l1 = loss_now()
    restore()
    ratio = (l0 - l1) / (DESCENT_SHARE * l0)
    print(f"[check] 15c an SGD step along -g (η {eta:.3e}, |g|₂ "
          f"{g2 ** 0.5:.4e}): the loss {l0:.6f} → {l1:.6f}, the drop "
          f"{ratio:.4f} of its first-order prediction", flush=True)
    check(abs(ratio - 1) <= DESCENT_TOL, f"15c: a step along the gradient "
          f"dropped the loss by {ratio:.4f} of the first-order prediction")
    out = {"loss": l0, "sgd_loss": l1, "sgd_eta": eta, "grad_l2": g2 ** 0.5,
           "grad_l1": g1, "sgd_drop_vs_first_order": ratio, "adamw": {}}
    for lr, route in ((DETOK_LR, "kernels"), (10 * DETOK_LR, "kernels"),
                      (10 * DETOK_LR, "plain")):
        with plain_attention() if route == "plain" else \
                contextlib.nullcontext():
            make_train_step(ad.parts, lambda m, b: ad.loss_fn(b),
                            adapter_optimizer(ad, lr))([batch])
            l1 = loss_now()
        restore()
        out["adamw"][f"{lr:g} {route}"] = l1 - l0
        print(f"[phase 15c] a fresh AdamW's first update at lr {lr:g} "
              f"({route}): the loss {l0:.6f} → {l1:.6f}; a sign step's "
              f"first-order drop lr·|g|₁ = {lr * g1:.4f}", flush=True)
    return out


def detok_training_phase(ad, feats_shape, n_k1):
    """15c: ``SDXLAdapter.loss_fn`` over ``adapter_trainable_patterns()``
    at 1024², the largest batch of DETOK_BATCHES that fits."""
    import torch

    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        adapter_trainable_patterns)
    n_train = trainable_fp32(ad.parts, adapter_trainable_patterns())
    out = {"trainable": n_train, "tried": []}
    for B in DETOK_BATCHES:
        out["tried"].append(B)
        opt = adapter_optimizer(ad)
        try:
            batches = [detok_batch(ad, feats_shape, B, 100 + 10 * i)
                       for i in range(DETOK_STEPS)]
            losses, secs, counts, peak = train_steps(
                ad, opt, batches[:1], n_k1, f"15c batch {B}")
            break
        except torch.cuda.OutOfMemoryError:
            del opt
            batches = None
            for p in ad.parts.parameters():
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
            print(f"[phase 15c] batch {B} does not fit", flush=True)
    else:
        fail("15c: not even batch 1 fits")
    more = train_steps(ad, opt, batches[1:], n_k1, f"15c batch {B}")
    losses += more[0]
    secs += more[1]
    counts += more[2]
    peak = max(peak, more[3])
    sec_step = sum(secs[1:]) / len(secs[1:])
    print(f"[phase 15c] de-tokenizer training at 1024², batch {B} (tried "
          f"{out['tried']}), {n_train / 1e6:.1f} M trainable: losses "
          f"{[round(x, 4) for x in losses]}, {sec_step:.3f} s a step (steps "
          f"2-{DETOK_STEPS}; the first {secs[0]:.3f} s), peak {peak:.2f} GiB;"
          f" launches a step {counts[0]} (K1 with its LSE {2 * n_k1} under "
          f"remat, K2/K3 {n_k1}, all wgmma)", flush=True)
    # a fresh AdamW on one batch: its first update follows that batch's
    # gradient alone
    del opt
    rep = detok_batch(ad, feats_shape, B, 999)
    first = first_update_check(ad, rep)
    rep_run = train_steps(ad, adapter_optimizer(ad),
                          [rep] * (DETOK_REPEAT_STEPS + 1), n_k1,
                          "15c repeated batch")
    rep_losses = rep_run[0]
    counts += rep_run[2]
    print(f"[phase 15c] {DETOK_REPEAT_STEPS + 1} steps on one repeated "
          f"batch (a fresh AdamW at lr {DETOK_LR}): losses "
          f"{[round(x, 5) for x in rep_losses]}", flush=True)
    check(max(rep_losses[1:]) < rep_losses[0], f"15c: the loss did not "
          f"stay below its start on a repeated batch: {rep_losses}")
    grad = detok_grad_check(ad, {k: v[:1] for k, v in rep.items()})
    for p in ad.parts.parameters():
        p.requires_grad_(False)
    out.update(batch=B, losses=losses, sec_per_step=sec_step,
               first_step_s=secs[0], peak_gib=peak,
               launches_per_step=counts[0], step_counts=counts,
               repeated_losses=rep_losses, first_update=first, grads=grad)
    return out


def lora_phase(ad_e, vis, feats, n_k1):
    """15d: SDXLText2ImageAndEditAdapter over the 8-channel SDXL UNet with
    rank-16 LoRA on to_q / to_out (seed 0), the resampler, VAE and vision
    encoder of 15a's: one training step over trainable_patterns(True) and
    a 4-step edit generate."""
    import torch

    from mllm_npu_tpu_torch.models.factory import materialize
    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        SDXLText2ImageAndEditAdapter)
    from mllm_npu_tpu_torch.models.generation.unet import (
        UNet2DConditionModel, UNetConfig)
    from mllm_npu_tpu_torch.models.language_models.llama import LoRALinear
    cfg = UNetConfig.sdxl_base(in_channels=8, lora_rank=LORA_RANK)
    unet = materialize(lambda: UNet2DConditionModel(cfg,
                                                    dtype=torch.bfloat16),
                       device="cuda", seed=0).eval()
    ad = SDXLText2ImageAndEditAdapter(unet=unet, resampler=ad_e.resampler,
                                      vit_down=ad_e.vit_down)
    ad.init_pipe(ad_e.vae, ad_e.scheduler, visual_encoder=vis)
    n_lora = sum(isinstance(m, LoRALinear) for m in unet.modules())
    n_train = trainable_fp32(ad.parts, ad.trainable_patterns(True))
    batch = detok_batch(ad, feats.shape, 1, 7, edit=True)
    losses, secs, counts, peak = train_steps(ad, adapter_optimizer(ad),
                                             [batch], n_k1, "15d LoRA")
    for p in ad.parts.parameters():
        p.requires_grad_(False)
        p.grad = None
    with torch.inference_mode():
        ad.get_image_embeds(image_embeds=feats, image_size=VISION_SIZE)
    size = GEN_SIZE
    image = seeded((1, 3, size, size), GEN_SEED + 1, torch.device("cuda"),
                   uniform=True)
    imgs, got, wall, gpeak = timed(lambda: ad.generate(
        image_embeds=feats, latent_image=image, seed=GEN_SEED, height=size,
        width=size, num_inference_steps=VARIANT_STEPS,
        input_image_size=VISION_SIZE))
    expect_counts(got, "15d generate", flash_fwd=n_k1 * VARIANT_STEPS)
    check(imgs[0].size == (size, size) and np_std(imgs[0]) > 0,
          "15d: image")
    print(f"[phase 15d] LoRA t2i + edit (r{LORA_RANK} on to_q/to_out, "
          f"{n_lora} adapters, {n_train / 1e6:.1f} M trainable with "
          f"down_blocks.0 and the resampler): one training step at batch 1 "
          f"in {secs[0]:.3f} s, loss {losses[0]:.5f}, launches {counts[0]},"
          f" peak {peak:.2f} GiB; a {VARIANT_STEPS}-step edit generate in "
          f"{wall:.2f} s ({ad.last_timings['denoise_s'] * 1e3 / VARIANT_STEPS:.2f} ms a step), "
          f"launches {got}, peak {gpeak:.2f} GiB", flush=True)
    return {"lora_modules": n_lora, "trainable": n_train,
            "train_step_s": secs[0], "loss": losses[0],
            "train_launches": counts[0], "train_peak_gib": peak,
            "generate_s": wall, "timings": dict(ad.last_timings),
            "launches": got, "peak_gib": gpeak}


def np_std(img) -> float:
    import numpy as np
    return float(np.asarray(img).std())


def sd_phase(vis, feats):
    """15e: SD21Text2ImageAndEditAdapter at 768² (the 8-channel SD-2.1
    UNet, a plain Resampler of 64 queries to its 1024 context width, the
    SD VAE) and IPAdapterSDPipe over SD-1.5 with 16 image tokens at 512²,
    a 4-step generate each, seed 0 weights; then one IP UNet forward with
    K1 against plain attention (D = 40, 80, 160)."""
    import torch

    from mllm_npu_tpu_torch.configs import load_config
    from mllm_npu_tpu_torch.models.factory import materialize
    from mllm_npu_tpu_torch.models.generation.adapter_modules import (
        IPAdapterSD, IPAdapterSDPipe, SD21Text2ImageAndEditAdapter)
    from mllm_npu_tpu_torch.models.generation.resampler import Resampler
    from mllm_npu_tpu_torch.models.generation.unet import (
        UNet2DConditionModel, UNetConfig)
    from mllm_npu_tpu_torch.models.generation.vae import (AutoencoderKL,
                                                          VAEConfig)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    rcfg = load_config(ROOT / GEN_CONFIG)["resampler"]
    width = vis.config.output_dim
    build = lambda make, seed: materialize(make, device="cuda",
                                           seed=seed).eval()
    vae = build(lambda: AutoencoderKL(VAEConfig.sdxl(
        scaling_factor=SD_SCALING), dtype=bf16), 2)
    out = {}

    cfg21 = UNetConfig.sd21(in_channels=8)
    unet = build(lambda: UNet2DConditionModel(cfg21, dtype=bf16), 0)
    res = build(lambda: Resampler(
        dim=rcfg["dim"], depth=rcfg["depth"], dim_head=rcfg["dim_head"],
        heads=rcfg["heads"], num_queries=rcfg["num_queries"],
        embedding_dim=width, output_dim=cfg21.cross_attention_dim,
        dtype=bf16), 1)
    ad = SD21Text2ImageAndEditAdapter(unet=unet, resampler=res,
                                      vit_down=True)
    ad.init_pipe(vae, visual_encoder=vis)
    with torch.inference_mode():
        ad.get_image_embeds(image_embeds=feats, image_size=VISION_SIZE)
    n21 = attention_count(unet)
    imgs, got, wall, peak = timed(lambda: ad.generate(
        image_embeds=feats, seed=GEN_SEED, height=SD21_SIZE,
        width=SD21_SIZE, num_inference_steps=VARIANT_STEPS,
        input_image_size=VISION_SIZE))
    expect_counts(got, "15e SD-2.1 generate", flash_fwd=n21 * VARIANT_STEPS)
    check(imgs[0].size == (SD21_SIZE, SD21_SIZE) and np_std(imgs[0]) > 0,
          "15e SD-2.1: image")
    t = dict(ad.last_timings)
    out["sd21"] = {"generate_s": wall, "timings": t, "launches": got,
                   "peak_gib": peak, "k1_per_forward": n21,
                   "unet_params": sum(p.numel() for p in unet.parameters())}
    print(f"[phase 15e] SD-2.1 t2i + edit ({out['sd21']['unet_params'] / 1e9:.3f} B UNet, "
          f"plain Resampler → prompt embeds only): a {VARIANT_STEPS}-step "
          f"{SD21_SIZE}² generate in {wall:.2f} s "
          f"({t['denoise_s'] * 1e3 / VARIANT_STEPS:.2f} ms a step at batch "
          f"3), launches {got} ({n21} a forward), peak {peak:.2f} GiB",
          flush=True)
    del ad, unet, res
    gc.collect()
    torch.cuda.empty_cache()

    cfg15 = UNetConfig.sd15(ip_num_image_tokens=IP_TOKENS)
    unet = build(lambda: UNet2DConditionModel(cfg15, dtype=bf16), 0)
    res = build(lambda: Resampler(
        dim=cfg15.cross_attention_dim, depth=4, dim_head=64, heads=12,
        num_queries=IP_TOKENS, embedding_dim=width,
        output_dim=cfg15.cross_attention_dim, dtype=bf16), 1)
    ip = IPAdapterSD.from_pretrained(unet, res)
    pipe = IPAdapterSDPipe(ip_adapter=ip, vae=vae, visual_encoder=vis,
                           text_context_len=TEXT_TOKENS)
    image = seeded((1, VISION_SIZE, VISION_SIZE, 3), GEN_SEED + 2, dev,
                   uniform=True)
    n15, n_vis = attention_count(unet), vision_attention_count(vis)
    imgs, got, wall, peak = timed(lambda: pipe.generate(
        image_tensor=image, scale=1.0, seed=GEN_SEED, height=SD15_SIZE,
        width=SD15_SIZE, num_inference_steps=VARIANT_STEPS))
    expect_counts(got, "15e IP-Adapter generate",
                  flash_fwd=n_vis + n15 * VARIANT_STEPS)
    check(imgs[0].size == (SD15_SIZE, SD15_SIZE) and np_std(imgs[0]) > 0,
          "15e IP-Adapter: image")
    t = dict(pipe.last_timings)
    with torch.inference_mode():
        pos, neg = pipe.get_image_embeds(image_tensor=image)
        text = torch.zeros((2, TEXT_TOKENS, cfg15.cross_attention_dim),
                           device=dev, dtype=bf16)
        context = torch.cat([text, torch.cat([neg, pos]).to(bf16)], dim=1)
        f = vae.config.spatial_scale_factor
        lat = seeded((2, 4, SD15_SIZE // f, SD15_SIZE // f), GEN_SEED, dev)
        eps = route_outputs(lambda: unet(lat, torch.full((2,), 500.0,
                                                         device=dev),
                                         context, ip_scale=1.0), n15,
                            "15e SD-1.5 IP UNet ε (D = 40, 80, 160)")
    out["sd15_ip"] = {"generate_s": wall, "timings": t, "launches": got,
                      "peak_gib": peak, "k1_per_forward": n15,
                      "vision_k1": n_vis, "eps": eps,
                      "unet_params": sum(p.numel() for p in unet.parameters())}
    print(f"[phase 15e] IP-Adapter SD-1.5 ({out['sd15_ip']['unet_params'] / 1e9:.3f} B "
          f"UNet, {IP_TOKENS} image tokens after {TEXT_TOKENS} zero text "
          f"tokens): a {VARIANT_STEPS}-step {SD15_SIZE}² generate in "
          f"{wall:.2f} s ({t['denoise_s'] * 1e3 / VARIANT_STEPS:.2f} ms a "
          f"step at batch 2), launches {got} ({n_vis} for the image and the "
          f"zero image, {n15} a forward), peak {peak:.2f} GiB", flush=True)
    del pipe, ip, unet, res, vae
    gc.collect()
    torch.cuda.empty_cache()
    return out


def detokenizer_variants_phase(t_start):
    """Phase 15 (see the module's docstring). → summary, its launches
    among them."""
    import torch

    from mllm_npu_tpu_torch.configs import instantiate, load_config
    from mllm_npu_tpu_torch.models.factory import (build_component,
                                                   build_sdxl_adapter)
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict.fromkeys(kernel_counters(), 0)

    def add(got):
        for k in launches:
            launches[k] += got[k]

    def stamp(label):
        print(f"[time] {time.perf_counter() - t_start:.1f} s: phase {label}",
              flush=True)
    gen = load_config(ROOT / GEN_CONFIG)
    node = load_config(ROOT / SEEDX_YAML)["mllm"]["mllm_model"][
        "vision_encoder"]
    t0 = time.perf_counter()
    vis = build_component(instantiate(node), device="cuda", seed=0).eval()
    ad = build_sdxl_adapter(**gen, visual_encoder=vis, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.inference_mode():
        neg = ad._negative_embeds(1, VISION_SIZE)
    # features of the output projector's shape (the resampler's input),
    # seeded at the zero-image negative's RMS
    shape = (1, ad.resampler.latents.shape[1],
             ad.resampler.proj_in.in_features)
    feats = seeded(shape, 15, torch.device("cuda"),
                   float(neg.float().std())).to(torch.bfloat16)
    n_k1 = attention_count(ad.unet)
    print(f"[phase 15] SEED-X's vision encoder and the SDXL adapter from "
          f"{Path(GEN_CONFIG).name} (seed 0, bf16) built in {build_s:.1f} s;"
          f" the features {list(shape)} seeded at the zero-image negative's "
          f"RMS; {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident",
          flush=True)
    out = {"build_s": build_s, "unet_k1_per_forward": n_k1}

    stamp("15b")
    out["quantized"] = q = quantized_unet_phase(ad, feats, n_k1)
    for label in ("bf16", "int8", "int4"):
        add(q[label]["launches"])
        add(q[label]["forward_launches"])

    stamp("15c")
    out["training"] = tr = detok_training_phase(ad, neg.shape, n_k1)
    out["train_kernel_shapes"] = train_kernel_cases(tr["batch"])
    del ad
    gc.collect()
    torch.cuda.empty_cache()

    stamp("15a")
    ad_e = build_sdxl_adapter(**gen, with_latent_image=True,
                              visual_encoder=vis, device="cuda", seed=0)
    with torch.inference_mode():
        ad_e.get_image_embeds(image_embeds=feats, image_size=VISION_SIZE)
    check(ad_e.unet.conv_in.in_channels == 8, "15a: not the 8-channel UNet")
    out["edit"] = e = edit_phase(ad_e, feats, n_k1)
    add(e["launches"])

    stamp("15d")
    out["lora"] = lo = lora_phase(ad_e, vis, feats, n_k1)
    add(lo["train_launches"])
    add(lo["launches"])
    del ad_e
    gc.collect()
    torch.cuda.empty_cache()

    stamp("15e")
    out["sd"] = sd = sd_phase(vis, feats)
    add(sd["sd21"]["launches"])
    add(sd["sd15_ip"]["launches"])
    for step_counts in tr["step_counts"]:
        add(step_counts)
    out["launches"] = launches
    del vis
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_kernel_cases(B):
    """15c's K1-with-LSE, K2 and K3 shapes at the run's batch: the SDXL
    UNet's self-attention at 64² and 32² latents and its cross-attention
    over the resampler's 64 tokens (D = 64) → (rows, {shape: launches a
    step})."""
    cfg, _, ctx = variant_configs()["edit"]
    mix, rows = {}, []
    for (S, H, D, Sk), n in unet_attention_mix(cfg, ctx).items():
        name = f"unet_train_s{S}_k{Sk}_b{B}"
        rows.append(bwd_case(name, B, S, Sk, H, H, D, False))
        mix[name] = n
    return rows, mix


def variant_fields(vrows, vmixes, uq_rows, uq_mix, variants):
    """Phase 15's fields of each kernel's row in the JSON line: K1 at the
    edit, SD-2.1 and SD-1.5 IP UNets per forward and its launches per
    de-tokenizer training step; K2's and K3's per training step at the
    run's batch; K4's and K5's per int8 / int4 UNet forward and 15b's
    generates."""
    from mllm_npu_tpu_torch.configs import load_config
    n_ctx = load_config(ROOT / GEN_CONFIG)["resampler"]["num_queries"]
    train = variants["training"]
    train_rows, tmix = variants["train_kernel_shapes"]
    basis = {"edit": "one SEED-X-Edit UNet forward (3-way CFG batch 3, "
                     "1024x1024)",
             "sd21": f"one SD-2.1 edit UNet forward (batch 3, "
                     f"{SD21_SIZE}x{SD21_SIZE})",
             "sd15_ip": f"one SD-1.5 IP-Adapter UNet forward (CFG batch 2, "
                        f"{SD15_SIZE}x{SD15_SIZE}, {TEXT_TOKENS} text + "
                        f"{IP_TOKENS} image tokens)"}
    out = {"flash_fwd": {
        **{f"{label}_forward": row_mix(vrows, mix, basis[label])
           for label, mix in vmixes.items()},
        "detok_variant_shapes": vrows,
        "detok_variant_launches": variants["launches"]["flash_fwd"],
        "unet_train_launches_per_step": train["launches_per_step"][
            "flash_fwd"],
        "unet_train_lse_shapes": [r["lse"] for r in train_rows]}}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        out[name] = {
            "unet_train_step": {
                **row_mix([r[name] for r in train_rows], tmix,
                          f"one de-tokenizer training step at batch "
                          f"{train['batch']} (1024x1024)"),
                "launches_per_step": train["launches_per_step"][name]},
            "unet_train_shapes": [r[name] for r in train_rows],
            "max_abs_err": max(r[name]["max_abs_err"] for r in train_rows)}
    for bits in (8, 4):
        q = variants["quantized"][f"int{bits}"]
        out[f"int{bits}_matmul"] = {
            "unet_forward": row_mix(
                uq_rows[bits], uq_mix, f"one int{bits} SDXL UNet forward "
                f"(CFG batch 2, 1024x1024, {n_ctx} context tokens)",
                key=lambda r: (r["M"], r["K"], r["N"]),
                name=lambda s: "M{} K{} N{}".format(*s)),
            "unet_shapes": uq_rows[bits],
            "unet_generate": {k: q[k] for k in (
                "ms_per_step", "unet_gib", "unet_forward_ms",
                "eps_vs_plain_products", "eps_vs_bf16", "forward_launches")},
            "max_abs_err": max(r["max_abs_err"] for r in uq_rows[bits])}
    out["flash_fwd"]["max_abs_err"] = max(r["max_abs_err"] for r in vrows)
    return out


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
    if sys.argv[1:2] == ["--first-token"]:
        first_token(sys.argv[2])
        return
    use_seeded_configs()
    if sys.argv[1:2] == ["--traced-replays"]:
        traced_replays()
        return

    t_start = time.perf_counter()
    # -- 1. header and kernel builds, all started together --------------
    smi = nvidia_smi()
    print(f"[card] {smi}")
    print(f"[card] torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}"
          f"  torch {torch.__version__}  cuda {torch.version.cuda}")
    # the nvcc processes run while phase 2 builds the model (which
    # launches no kernel); phase 3 starts once every build has ended
    t_build = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(build_all,
                               ["flash_fwd", "flash_bwd", "quant_matmul"])

        print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 2",
              flush=True)
        # -- 2. full-width model ------------------------------------------
        t0 = time.perf_counter()
        engine = build_engine(LLAMA3_YAML, device="cuda", seed=0,
                              fake_tokenizer=True,
                              max_new_tokens=MAX_NEW_TOKENS)
        torch.cuda.synchronize()
        model_s = time.perf_counter() - t0
        builds = building.result()
    print(f"[build] all kernels: {time.perf_counter() - t_build:.1f} s "
          f"(the model built alongside in {model_s:.1f} s)")
    for name, (secs, log) in builds.items():
        print(f"[build] nvcc {name}.cu: {secs:.1f} s")
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "C7513")):
                print(f"[build] {name}: {line.strip()}")
    model = engine.generator.model
    lm_cfg = model.language_model.config
    vis_cfg = model.vision_encoder.config
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] built in {model_s:.1f} s: "
          f"{n_params / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; llama "
          f"{lm_cfg.num_hidden_layers} layers, LoRA r{lm_cfg.lora_rank}, "
          f"vocab {lm_cfg.vocab_size}; siglip {vis_cfg.num_hidden_layers} "
          f"layers; resampler {model.projector.num_queries} queries")

    requests = phase4_requests()
    preps = [engine._prepare_comprehension(q, b) for q, b in requests]
    s_img, n_tiles = len(preps[0][0]), preps[0][1].shape[0]
    bucket = -(-s_img // WORKER["batch_prompt_bucket"]) \
        * WORKER["batch_prompt_bucket"]
    print(f"[model] request 1: prompt {s_img} tokens, {n_tiles} tiles; the "
          f"batched worker's bucket {bucket}")

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 3",
          flush=True)

    def sub_stamp(label):
        print(f"[time] {time.perf_counter() - t_start:.1f} s: phase {label}",
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
    sub_stamp("3, after SEED-X's K1 cases")
    edges = k1_edge_sweep()
    sub_stamp("3, after K1's edge sweep")
    # the SDXL UNet's attentions at 1024² (phase 11's request)
    unet_cases, unet_mix = unet_kernel_cases()
    # phase 15's UNets: SEED-X-Edit's at batch 3, SD-2.1's at 768², the
    # IP-Adapter's SD-1.5 (D = 40, 80, 160; 77 text keys); K4 / K5 at the
    # int8 / int4 SDXL UNet's projections
    variant_cases, variant_mixes = variant_kernel_cases()
    sub_stamp("3, after the UNets' K1 cases")
    unet_qrows, unet_qmix = unet_quant_cases()
    sub_stamp("3, after the UNet's K4/K5 cases")
    qrows = quant_rows(lm_cfg, s_img, bucket, WORKER["num_slots"])
    seedx_lm = seedx_specs()[3]
    qrows13 = quant_rows(seedx_lm, s_img, bucket, WORKER["num_slots"],
                         regimes=("decode", "slots", "prefill"))

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 4",
          flush=True)
    # -- 4. the bf16 path, counts set to 0 before each request ---------
    launches, quant_prefill, phase4_ids = serve(engine, requests, preps,
                                                "bf16", lm_cfg)
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

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 12b (bf16)",
          flush=True)
    # -- 12b: the evaluator's speed probes on the resident bf16 model, counts
    #        set to 0 before and read after
    evaluator = {"speed_bf16": eval_speed_phase(engine, "bf16")}
    for k, n in evaluator["speed_bf16"]["launches"].items():
        launches[k] += n

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
    phase7_ids = {}
    for bits in (8, 4):
        label = f"int{bits}"
        t0 = time.perf_counter()
        engine = build_engine(LLAMA3_YAML, device="cuda", seed=0,
                              fake_tokenizer=True,
                              max_new_tokens=MAX_NEW_TOKENS,
                              **{f"quantize_int{bits}": True})
        torch.cuda.synchronize()
        model = engine.generator.model
        print(f"[{label}] engine built and quantized in "
              f"{time.perf_counter() - t0:.1f} s: "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
        got, got_prefill, phase7_ids[bits] = serve(
            engine, [requests[0], requests[2]], [preps[0], preps[2]], label,
            lm_cfg)
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
            # 12b on the int8 model (before check e fuses it)
            print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 12b "
                  "(int8)", flush=True)
            e8 = evaluator["speed_int8"] = eval_speed_phase(engine, "int8")
            for k, n in e8["launches"].items():
                launches[k] += n
            quant_prefill[8] += e8["prefill_launches"]

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
    # -- 7b. the replayed ticks' K4 kernel nodes and traced events, in a
    #       process of their own
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

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 12a",
          flush=True)
    # -- 12a. the evaluator on SEED-X: run.py's build, the seven benchmarks
    #         on the fixtures, lm_loss against plain attention, prefix cache
    evaluator["seedx"] = ev = evaluator_phase()
    for k in launches:
        launches[k] += ev["launches"][k]

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 13",
          flush=True)
    # -- 13. SEED-X pretraining at full width: the launcher's recipe
    #        through the trainer, the gradients against plain attention,
    #        int4 QLoRA and an int8 step, then the kernels at its shapes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seedx_") as tmp:
        seedtrain = seedx_train_phase(Path(tmp))
    for k in launches:
        launches[k] += seedtrain["launches"][k]

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 14",
          flush=True)
    # -- 14. the reference's checkpoints: phase 4's 8B assembly and phase
    #        11's de-tokenizer written in the reference's layouts and loaded
    #        back (bit for bit, phase 4's ids, K1's counts)
    ckpt = checkpoint_phase(requests, preps, lm_cfg, phase4_ids,
                            phase7_ids[8])
    for k in launches:
        launches[k] += ckpt["launches"][k]

    print(f"[time] {time.perf_counter() - t_start:.1f} s: phase 15",
          flush=True)
    # -- 15. the de-tokenizer's variants: the int8 / int4 UNet, its
    #        training, SEED-X-Edit, UNet LoRA, SD-2.1 and the IP-Adapter
    variants = detokenizer_variants_phase(t_start)
    for k in launches:
        launches[k] += variants["launches"][k]
    unet_forward = row_mix(unet_cases, unet_mix, "one SDXL UNet forward "
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
    seedx_image = row_mix(seedx_cases, {
        "seedx_llama2_prefill": L13, "seedx_qwen_vit": seedx_specs()[0].layers,
        "seedx_attn_pool": 1, "seedx_input_projector": 1},
        "one SEED-X 896x896 request")
    seedx_caption = row_mix(seedx_cases, {
        "seedx_llama2_caption": L13, "seedx_output_projector": 1},
        "one SEED-X caption -> features request")
    rows = [{
        "name": "flash_fwd", "route": "cuda", "design": "wgmma+tma",
        "source": "mllm_npu_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mllm_npu_tpu/ops/flash_attention.py:100",
        "launches": launches["flash_fwd"],
        "max_abs_err": max(c["max_abs_err"]
                           for c in cases + seedx_cases + unet_cases),
        **row_mix(cases, {"llama_prefill": lm_cfg.num_hidden_layers,
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
        "evaluator_lm_loss_launches": {
            "seedx": ev["lm_loss"]["k1_each"],
            "llama3_8b": evaluator["speed_bf16"]["lm_loss"]["k1"]},
        "checkpoint_launches": {
            "loaded_8b_requests": ckpt["llama3_8b"]["served_launches"][
                "flash_fwd"],
            "params_checkpoint_requests": ckpt["llama3_8b"][
                "params_checkpoint_launches"]["flash_fwd"],
            "loaded_unet_forward": ckpt["detokenizer"]["unet_launches"]},
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
            "wgmma_launches": (train["launches"][f"{name}_wgmma"]
                               + seedtrain["launches"][f"{name}_wgmma"]),
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
            # qmm_decode's kernel nodes in one captured block (each
            # replay launches them all), and the replays
            "graph_replay_launches": (traced["block"]["graph"]["qmm_decode"]
                                      if bits == 8 else None),
            "graph_replays": (worker["int8"]["replays"] if bits == 8
                              else None),
            "graph_replay_basis": "qmm_decode kernel nodes of the captured "
                                  "block's CUDA graph, one replay of it seen "
                                  "under torch.profiler (int8 worker; no int4 "
                                  "worker runs)",
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
                    traced["verify"]["graph"]["qmm_prefill"]
                    if bits == 8 else None),
                "graph_replay_split_sums": (
                    traced["verify"]["graph"]["qmm_split_sum"] if bits == 8
                    else None),
            },
            "fused_decode": {
                **{k: fused_dec[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "library_ms", "bound_by",
                                             "bound_share")},
                "ms_basis": "one decode token (M=1) with fused projections: "
                            "the launch mix " + fused_dec["launch_mix"],
                "graph_replay_launches": (
                    traced["fused_block"]["graph"]["qmm_decode"]
                    if bits == 8 else None),
            },
            "library": "F.linear on the weight dequantized to bf16",
            "shapes": qrows[bits],
            "seedx": seedx_quant(qrows13[bits], seedx_lm, s_img),
        })
    extra = seedx_train_fields(seedtrain, seedx_lm)
    vfields = variant_fields(variant_cases, variant_mixes, unet_qrows,
                             unet_qmix, variants)
    for row in rows:
        row.update(extra[row["name"]])
        more = dict(vfields[row["name"]])
        row["max_abs_err"] = max(row["max_abs_err"], more.pop("max_abs_err"))
        row.update(more)
    print("[train] summary " + json.dumps(
        {k: v for k, v in train.items() if k != "profile"}))
    print("[worker] summary " + json.dumps(worker, default=str))
    print("[single] summary " + json.dumps(single_graph))
    print("[seedx] summary " + json.dumps(seedx, default=str))
    print("[detok] summary " + json.dumps(detok, default=str))
    print("[detok-variants] summary " + json.dumps(
        {k: v for k, v in variants.items() if k != "train_kernel_shapes"},
        default=str))
    print("[ckpt] summary " + json.dumps(
        {k: v for k, v in ckpt.items() if k != "launches"}, default=str))
    print("[eval] summary " + json.dumps(evaluator, default=str))
    print("[seedx-train] summary " + json.dumps(
        {k: ({kk: vv for kk, vv in v.items() if kk != "profile"}
             if isinstance(v, dict) else v)
         for k, v in seedtrain.items() if k not in ("bwd", "quant")},
        default=str))
    print(f"[time] {time.perf_counter() - t_start:.1f} s: all phases done",
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
