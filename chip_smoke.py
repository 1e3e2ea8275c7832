#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It imports only the port
(``mllm_npu_tpu_torch``), never JAX or the JAX package, and any failure
exits non-zero. Phases, in order:

1. header: the card (``nvidia-smi`` name and power limit) and the build of
   every kernel of the path from ``mllm_npu_tpu_torch/csrc`` with ``nvcc``;
2. the full-width model: the port's ``mllm_llama3_8b_siglip_vit.yaml``
   (Llama-3-8B with r32 LoRA, SigLIP-so400m, attention resampler), bf16,
   weights drawn from a seed, ``FakeTokenizer`` at vocab 128587;
3. K1 (flash forward) against its plain PyTorch version on the card at
   the path's own shapes, with times of the kernel, the plain version,
   ``scaled_dot_product_attention`` as a yardstick, and the bound;
4. the main path: ``InferenceEngine.comprehension`` on an 896×896 image
   (2×2 grid + thumbnail), a 384×1152 image and a text-only question,
   with K1's launch count set to 0 before and asserted after each request;
5. the first image request's prefill logits with K1 against the same
   forward with K1's plain version in every attention;
6. the text-only request once more under ``torch.profiler``: the share
   of its wall time the device is busy, and the kernels that take most.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

import base64
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# K1 vs its fp32 plain version on the same bf16 inputs: the kernel rounds P
# (before PV) and O to bf16, 2^-9 relative each, so |err| <= ATOL + RTOL·|O|
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
MAX_NEW_TOKENS = 32


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
        SegmentIds, flash_attention, flash_attention_reference)
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
    if seg is not None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask[:, None])
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal)
    row = {
        "shape": name, "B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hkv": Hkv,
        "D": D, "causal": causal, "segments": seg is not None,
        "max_abs_err": err,
        "ms": time_ms(lambda: flash_attention(q, k, v, **kw)),
        "plain_ms": time_ms(lambda: flash_attention_reference(q, k, v, **kw),
                            iters=5),
        "library_ms": time_ms(lib),
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_c >= t_m else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    print(f"[K1] {name}: err {err:.3e}  kernel {row['ms']:.4f} ms  "
          f"plain {row['plain_ms']:.4f} ms  sdpa {row['library_ms']:.4f} ms"
          f"  bound {bound_ms:.4f} ms ({row['bound_by']})", flush=True)
    return row


def prefill_logits(model, prep):
    """Last-position logits of one image request's prefill (vision tower,
    resampler, scatter, causal Llama prefill with segment ids)."""
    import torch

    from mllm_npu_tpu_torch.ops import SegmentIds
    ids, patches, pos, cmp = prep
    dev = torch.device("cuda")
    input_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)[None]
    lm = model.language_model
    with torch.inference_mode():
        emb, _ = model.embed_and_scatter(
            input_ids, torch.as_tensor(patches, device=dev),
            torch.ones((patches.shape[0],), dtype=torch.bool, device=dev),
            torch.as_tensor(cmp, device=dev)[None],
            torch.as_tensor(pos, device=dev))
        ones = torch.ones_like(input_ids, dtype=torch.int32)
        h, _ = lm(inputs_embeds=emb, segment_ids=SegmentIds(q=ones, kv=ones))
        return lm.logits(h[:, -1]).float()


def profile_request(engine, request):
    """One request under ``torch.profiler``: wall ms, device busy ms (the
    union of the device activity intervals) and the five kernels with the
    most device time. The profiler's own host cost slows the host, so the
    busy share it gives is a lower bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.comprehension(*request)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in device):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return wall_ms, busy_us / 1e3, top


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "GPU")
    if not (ROOT / "mllm_npu_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    os.environ.pop("DEBUG_FLAG", None)       # full width, never tiny

    import mllm_npu_tpu_torch.ops as port_ops
    from mllm_npu_tpu_torch.demo_img2txt import build_engine
    from mllm_npu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)
    from mllm_npu_tpu_torch.utils.cuda_build import build

    # fp32 reference products in full fp32 (the plain K1 is an fp32
    # einsum; cuDNN would run an fp32 conv in TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. header and kernel build ------------------------------------
    smi = nvidia_smi()
    print(f"[card] {smi}")
    print(f"[card] torch.cuda.get_device_name: {torch.cuda.get_device_name(0)}"
          f"  torch {torch.__version__}  cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    log = build("flash_fwd")
    print(f"[build] nvcc flash_fwd.cu: {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] flash_fwd: {line.strip()}")

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
    print(f"[model] request 1: prompt {s_img} tokens, {n_tiles} tiles")

    # -- 3. K1 against its plain version at the path's shapes ---------
    H, Hkv, D = (lm_cfg.num_attention_heads, lm_cfg.num_key_value_heads,
                 lm_cfg.head_dim)
    vh = vis_cfg.num_attention_heads
    n_vis = vis_cfg.num_patches
    cases = [
        kernel_case("llama_prefill", 1, s_img, s_img, H, Hkv, D, True,
                    pad_rows={}),
        kernel_case("llama_prefill_padded_b2", 2, s_img, s_img, H, Hkv, D,
                    True, pad_rows={1: s_img - 57}),
        kernel_case("siglip", n_tiles, n_vis, n_vis, vh, vh,
                    vis_cfg.hidden_size // vh, False),
        kernel_case("resampler", n_tiles, model.projector.num_queries, n_vis,
                    model.projector.attn.num_heads,
                    model.projector.attn.num_heads,
                    model.projector.embed_dim
                    // model.projector.attn.num_heads, False),
        kernel_case("tiny_llama_d32", 1, 77, 77, 4, 2, 32, True,
                    pad_rows={}),
    ]

    # -- 4. the main path, counts set to 0 before each request ---------
    total_launches = 0
    for i, ((q, b64), prep) in enumerate(zip(requests, preps), 1):
        expect = lm_cfg.num_hidden_layers + (
            vis_cfg.num_hidden_layers + 1 if b64 else 0)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        t0 = time.perf_counter()
        text = engine.comprehension(q, b64)
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        total_launches += launches
        tm = engine.generator.last_timings
        steps = tm["decode_steps"]
        print(f"[path] request {i} ({'image' if b64 else 'text'}, prompt "
              f"{len(prep[0])} tokens): K1 launches {launches} (expected "
              f"{expect}); vision+projector {tm['embed_s'] * 1e3:.1f} ms; "
              f"prefill {tm['prefill_s'] * 1e3:.1f} ms; ttft "
              f"{tm['ttft_s'] * 1e3:.1f} ms; decode {steps} steps, "
              f"{tm['decode_s'] * 1e3 / max(steps, 1):.2f} ms/token; wall "
              f"{wall:.2f} s; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; text {text[:60]!r}", flush=True)
        check(isinstance(text, str), "comprehension returned no text")
        check(launches == expect,
              f"request {i}: K1 launched {launches} times, expected {expect}")

    # -- 5. the image request's prefill with K1 against the same forward
    #       with K1's plain version in every attention (SigLIP, resampler,
    #       Llama): random weights give flat logits, so hold the direction
    #       (cosine) and report the argmax
    logits = {}
    for label, fn in (("K1", flash_attention),
                      ("plain", flash_attention_reference)):
        port_ops.flash_attention = fn
        flash_attention.launches = 0
        try:
            logits[label] = prefill_logits(model, preps[0])
        finally:
            port_ops.flash_attention = flash_attention
        expect = (lm_cfg.num_hidden_layers + vis_cfg.num_hidden_layers + 1
                  if label == "K1" else 0)
        check(flash_attention.launches == expect,
              f"{label} prefill launched K1 {flash_attention.launches} times, "
              f"expected {expect}")
    k1, plain = logits["K1"], logits["plain"]
    cos = torch.nn.functional.cosine_similarity(k1, plain).item()
    diff = (k1 - plain).abs().max().item()
    print(f"[check] full-width image prefill logits, K1 vs plain attention: "
          f"cos {cos:.6f}, max abs diff {diff:.4f}, |logits| max "
          f"{plain.abs().max().item():.3f}, argmax "
          f"{k1.argmax().item()} vs {plain.argmax().item()}")
    check(bool(torch.isfinite(k1).all()), "non-finite logits")
    check(tuple(k1.shape) == (1, lm_cfg.vocab_size), "logits shape")
    check(cos >= 0.99, f"K1 and plain-attention logits disagree (cos {cos})")

    # -- 6. how busy the device is during a text-only request ----------
    wall_ms, busy_ms, top = profile_request(engine, requests[2])
    if busy_ms > 0:
        print(f"[profile] text request under torch.profiler: wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({100 * busy_ms / wall_ms:.1f}%); most device time: "
              + "; ".join(f"{n[:70]} {t / 1e3:.2f} ms" for n, t in top))
    else:
        print("[profile] torch.profiler recorded no device activity: the "
              "busy share is not measured")

    by = {c["shape"]: c for c in cases}
    mix = {"llama_prefill": lm_cfg.num_hidden_layers,
           "siglip": vis_cfg.num_hidden_layers, "resampler": 1}
    agg = {key: sum(by[s][key] * n for s, n in mix.items())
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    kernels = {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "mllm_npu_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mllm_npu_tpu/ops/flash_attention.py:100",
        "launches": total_launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **agg,
        "bound_by": ("operations" if sum(by[s]["flops"] * n for s, n in
                                          mix.items()) / H100_BF16_FLOPS
                     >= sum(by[s]["bytes"] * n for s, n in mix.items())
                     / H100_BYTES_PER_S else "bytes"),
        "ms_basis": "one 896x896 request: the launch mix "
                    + ", ".join(f"{n} x {s}" for s, n in mix.items()),
        "shapes": cases,
    }]}
    print(json.dumps(kernels))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
