"""Times K2 and K3 (the flash-attention backward) on the GPU at the training
shapes, beside the backward of ``scaled_dot_product_attention``, δ, the
bound and the first design of the kernels, and, given ``--baseline``,
beside an earlier ``flash_bwd.cu`` built from that source (its C entries
take the arguments of PR 4's, without the regime argument).

    python -m mllm_npu_tpu_torch.bench_flash_bwd [--shapes NAME ...]
        [--batch 8] [--images 56] [--baseline path/to/flash_bwd.cu]
        [--out results.json]

Per shape: K2, K3 and the pair in the regime ``k23_regime`` picks, each
checked against its plain version (2e-2·|plain| + 1e-2·max|plain|) and for
a bit-identical repeat; the mma.sync regime (the first design of these
kernels, whose code the regime keeps unchanged) forced at the same shape
where it takes the head dim (up to 160; null above);
δ = rowsum(dO∘O) as the wrapper computes it; the plain versions; SDPA's
backward (autograd of
``scaled_dot_product_attention`` with K/V repeated for GQA: dq, dk and dv
together, δ included); the bounds, TFLOP/s and shares. Then per training
step: 32 Llama layers and the resampler. Needs a CUDA card; prints the
card's name and power limit first. ``chip_smoke.py`` phase 9 calls
:func:`bench_shape`.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess

import torch
import torch.nn.functional as F

from mllm_npu_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, _nvcc

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
# K2/K3 vs their fp32 plain versions on the same bf16 inputs: dS and P are
# rounded to bf16 before their products and the output to bf16, so
# |err| <= BWD_RTOL·|plain| + BWD_ATOL_FRAC·max|plain|
BWD_RTOL, BWD_ATOL_FRAC = 2e-2, 1e-2
LLAMA_LAYERS = 32


def shapes(batch: int, images: int, tiles: int = 5):
    """name → (B, Sq, Sk, Hq, Hkv, D, causal, segments): the Llama training
    layer (two packed segments a row, the last row's tail padded), the
    resampler over the batch's image slots, SigLIP's D = 72, a tiny
    D = 32 with segments, and the reference's bench shape (``bench.py``:
    B32 H8 S256 D256, non-causal)."""
    return {
        "llama_train": (batch, 600, 600, 32, 8, 128, True, True),
        "resampler_train": (images, 64, 729, 32, 32, 128, False, False),
        "siglip_d72": (tiles, 729, 729, 16, 16, 72, False, False),
        "tiny_d32": (1, 77, 77, 4, 2, 32, True, True),
        "bench_d256": (32, 256, 256, 8, 8, 256, False, False),
    }


def time_ms(fn, iters: int = 20) -> float:
    """Device ms per call of ``fn``, queued behind a spin kernel so the
    events time the device and not the host."""
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


def inputs(B, Sq, Sk, Hq, Hkv, D, segments, seed=0):
    """Seeded bf16 q, k, v, dO and segment ids (two segments a row, the
    last row's tail padded with id 0) or None."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, do = (torch.randn(B, Sq, Hq, D, device=dev, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Sk, Hkv, D, device=dev, generator=g).bfloat16()
            for _ in range(2))
    seg = None
    if segments:
        pm = torch.ones(B, Sq, dtype=torch.int32, device=dev)
        pm[:, Sq // 2:] = 2
        pm[-1, Sq - Sq // 6:] = 0
        seg = fa.SegmentIds(q=pm, kv=pm.clone())
    return q, k, v, do, seg


def work(B, Sq, Sk, Hq, Hkv, D, causal, seg):
    """{kernel: (flops, bytes)}: the products over the visible pairs, each
    input read once and each output written once."""
    dev = torch.device("cuda")
    mask = torch.ones(B, Sq, Sk, dtype=torch.bool, device=dev)
    if causal:
        mask &= torch.ones(Sq, Sk, dtype=torch.bool, device=dev).tril()
    if seg is not None:
        mask &= seg.q[:, :, None] == seg.kv[:, None, :]
    pairs = int(mask.sum().item()) * Hq
    in_bytes = 2 * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D) \
        + 4 * 2 * B * Hq * Sq + (4 * B * (Sq + Sk) if seg is not None else 0)
    return {"flash_bwd_dq": (3 * 2 * pairs * D,
                             in_bytes + 2 * B * Sq * Hq * D),
            "flash_bwd_dkv": (4 * 2 * pairs * D,
                              in_bytes + 2 * 2 * B * Sk * Hkv * D)}


def bound_ms(flops, nbytes):
    t_c, t_m = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_c, t_m) * 1e3, "operations" if t_c >= t_m else "bytes"


class forced_regime:
    """Within the block, every K2/K3 call takes ``regime``."""

    def __init__(self, regime):
        self.regime = regime

    def __enter__(self):
        self.chosen = fa.k23_regime
        fa.k23_regime = lambda D: self.regime

    def __exit__(self, *exc):
        fa.k23_regime = self.chosen


def baseline_fns(src):
    """K2 and K3 of an earlier ``flash_bwd.cu`` (PR 4's C entries), built
    from ``src`` into build/: (dq(q, k, v, do, lse, delta, kw),
    dkv(...))."""
    out = BUILD_DIR / "libflash_bwd_baseline.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_nvcc(), *flags, "-o", str(out), src], check=True)
    lib = ctypes.CDLL(str(out))
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
    lib.flash_bwd_dq_bf16.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int] * 6 + tail)
    lib.flash_bwd_dkv_bf16.argtypes = ([ctypes.c_void_p] * 10
                                       + [ctypes.c_int] * 6 + tail)

    def call(dkv, q, k, v, do, lse, delta, kw):
        B, Sq, Hq, D = q.shape
        outs = ((torch.empty_like(k), torch.empty_like(v)) if dkv
                else (torch.empty_like(q),))
        dq = None if dkv else outs[0]
        dk, dv = outs if dkv else (None, None)
        strides = []
        for t in (q, k, v, do, dq, dk, dv):
            strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
        qseg, kseg = fa._segments(kw["segment_ids"], q.device)
        fn = lib.flash_bwd_dkv_bf16 if dkv else lib.flash_bwd_dq_bf16
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), fa._ptr(qseg),
                 fa._ptr(kseg), *[t.data_ptr() for t in outs],
                 B, Sq, k.shape[1], Hq, k.shape[2], D,
                 (ctypes.c_longlong * 21)(*strides), float(D ** -0.5),
                 int(kw["causal"]), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: CUDA error {err}")
        return outs
    return (lambda *a: call(False, *a)), (lambda *a: call(True, *a))


def _ms(t) -> str:
    return "-" if t is None else f"{t:.4f}"


def _close(got, ref):
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    ok = bool(torch.isfinite(got).all()) and bool(
        (diff <= BWD_RTOL * ref.abs() + BWD_ATOL_FRAC * ref.abs().max()).all())
    return diff.max().item(), ok


def bench_shape(name, B, Sq, Sk, Hq, Hkv, D, causal, segments, baseline=None,
                seed=0):
    """One shape's row: errors, repeat, times, bounds (see the module
    docstring). Launches made here are counted by the wrappers: the caller
    resets the counts before the path it checks."""
    q, k, v, do, seg = inputs(B, Sq, Sk, Hq, Hkv, D, segments, seed)
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    delta = fa.attention_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    rdq = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    errs = {lab: _close(got, ref) for lab, got, ref in (
        ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
    same = (torch.equal(dq, fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw))
            and all(torch.equal(a, b) for a, b in zip(
                (dk, dv), fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))))
    del rdq, rdk, rdv
    regime = fa.k23_regime(D)

    def k2():
        fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)

    def k3():
        fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)

    def pair():
        k2()
        k3()

    def pair_delta():       # as FlashAttention.backward: δ once, K2, K3
        d = fa.attention_delta(o, do)
        fa.flash_bwd_dq(q, k, v, do, lse, d, **kw)
        fa.flash_bwd_dkv(q, k, v, do, lse, d, **kw)

    row = {"shape": name, "B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hkv": Hkv,
           "D": D, "causal": causal, "segments": seg is not None,
           "regime": regime,
           "max_abs_err": {lab: e for lab, (e, _) in errs.items()},
           "within_tolerance": all(ok for _, ok in errs.values()),
           "repeat_bit_identical": same,
           "k2_ms": time_ms(k2), "k3_ms": time_ms(k3),
           "pair_ms": time_ms(pair),
           "delta_ms": time_ms(lambda: fa.attention_delta(o, do)),
           "pair_delta_ms": time_ms(pair_delta)}
    # the first design (mma.sync), forced at this shape where it takes D
    row["mma_sync_k2_ms"] = row["mma_sync_k3_ms"] = None
    row["mma_sync_pair_ms"] = None
    if D <= fa.MMA_SYNC_MAX_HEAD_DIM:
        with forced_regime("mma_sync"):
            row["mma_sync_k2_ms"] = time_ms(k2)
            row["mma_sync_k3_ms"] = time_ms(k3)
        row["mma_sync_pair_ms"] = (row["mma_sync_k2_ms"]
                                   + row["mma_sync_k3_ms"])
    row["plain_k2_ms"] = time_ms(lambda: fa.flash_bwd_dq_reference(
        q, k, v, do, lse, delta, **kw), iters=3)
    row["plain_k3_ms"] = time_ms(lambda: fa.flash_bwd_dkv_reference(
        q, k, v, do, lse, delta, **kw), iters=3)
    if baseline is not None:
        bdq, bdkv = baseline
        row["baseline_k2_ms"] = time_ms(
            lambda: bdq(q, k, v, do, lse, delta, kw))
        row["baseline_k3_ms"] = time_ms(
            lambda: bdkv(q, k, v, do, lse, delta, kw))
    # SDPA's backward on the same function (δ is its own work)
    G = Hq // Hkv
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(G, 1).detach().requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(G, 1).detach().requires_grad_()
    w = work(B, Sq, Sk, Hq, Hkv, D, causal, seg)
    if seg is not None:
        mask = torch.ones(B, Sq, Sk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= torch.ones(Sq, Sk, dtype=torch.bool,
                               device=q.device).tril()
        mask &= seg.q[:, :, None] == seg.kv[:, None, :]
        out = F.scaled_dot_product_attention(qt, kt, vt,
                                             attn_mask=mask[:, None])
    else:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out, qt, kt, vt
    for kern, key in (("flash_bwd_dq", "k2"), ("flash_bwd_dkv", "k3")):
        flops, nbytes = w[kern]
        b_ms, by = bound_ms(flops, nbytes)
        row[f"{key}_flops"], row[f"{key}_bytes"] = flops, nbytes
        row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = b_ms, by
        row[f"{key}_bound_share"] = b_ms / row[f"{key}_ms"]
        row[f"{key}_tflops"] = flops / row[f"{key}_ms"] / 1e9
    row["pair_vs_sdpa"] = row["pair_ms"] / row["sdpa_bwd_ms"]
    row["pair_delta_vs_sdpa"] = row["pair_delta_ms"] / row["sdpa_bwd_ms"]
    print(f"[K2/K3] {name} ({regime}): K2 {row['k2_ms']:.4f} ms "
          f"({row['k2_tflops']:.0f} TFLOP/s, "
          f"{100 * row['k2_bound_share']:.1f}% of {row['k2_bound_ms']:.4f} "
          f"{row['k2_bound_by']}), K3 {row['k3_ms']:.4f} ms "
          f"({row['k3_tflops']:.0f} TFLOP/s, "
          f"{100 * row['k3_bound_share']:.1f}% of {row['k3_bound_ms']:.4f} "
          f"{row['k3_bound_by']}); pair {row['pair_ms']:.4f}, + delta "
          f"{row['pair_delta_ms']:.4f} (delta {row['delta_ms']:.4f}); SDPA "
          f"backward {row['sdpa_bwd_ms']:.4f} (pair/SDPA "
          f"{row['pair_vs_sdpa']:.3f}); mma.sync K2 "
          f"{_ms(row['mma_sync_k2_ms'])} K3 {_ms(row['mma_sync_k3_ms'])}"
          + (f"; baseline K2 {row['baseline_k2_ms']:.4f} K3 "
             f"{row['baseline_k3_ms']:.4f}" if baseline else "")
          + f"; err "
          f"{row['max_abs_err']} within tolerance "
          f"{row['within_tolerance']}, repeat identical {same}", flush=True)
    return row


def per_step(rows, layers=LLAMA_LAYERS):
    """Times summed over one training step's launch mix: ``layers`` Llama
    layers and one resampler."""
    mix = {"llama_train": layers, "resampler_train": 1}
    keys = [k for k in rows["llama_train"] if k.endswith("_ms")
            and isinstance(rows["llama_train"][k], float)
            and k in rows["resampler_train"]]
    step = {k: sum(rows[s][k] * n for s, n in mix.items()) for k in keys}
    step["pair_vs_sdpa"] = step["pair_ms"] / step["sdpa_bwd_ms"]
    step["pair_delta_vs_sdpa"] = step["pair_delta_ms"] / step["sdpa_bwd_ms"]
    step["mix"] = mix
    return step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", nargs="+", default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--images", type=int, default=56)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    base = baseline_fns(args.baseline) if args.baseline else None
    table = shapes(args.batch, args.images)
    rows = {name: bench_shape(name, *table[name], baseline=base)
            for name in (args.shapes or table)}
    result = {"device": torch.cuda.get_device_name(0), "shapes": rows}
    if "llama_train" in rows and "resampler_train" in rows:
        result["per_step"] = per_step(rows)
        print("[K2/K3] per training step: " + json.dumps(
            result["per_step"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
