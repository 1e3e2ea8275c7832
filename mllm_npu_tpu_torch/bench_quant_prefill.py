"""Times K4 and K5's prefill regime on the GPU at the Llama-3-8B projection
shapes, beside ``F.linear`` on the weight dequantized to x's dtype and the
bound, and, given ``--baseline``, beside an earlier ``quant_matmul.cu``
built from that source (its C entries take the arguments without a plan
or workspace, as before the prefill redesign).

    python -m mllm_npu_tpu_torch.bench_quant_prefill [--m 339 128 512]
        [--f32] [--baseline path/to/quant_matmul.cu] [--sweep]
        [--out results.json]

Each call finds its weights outside the 50 MB L2 (copies cycled, as every
projection of a forward does). Per shape and, at each M, summed over one
prefill's launch mix (32 layers of q, k, v, o, gate, up, down). ``--f32``
times K4 f32 / K5 f32 on fp32 x instead (the pre-split and the prefill
kernel; bound at the dense TF32 rate). With ``--sweep`` it also times,
per shape, the plans beside the one ``prefill_plan`` picks (each tile
width with 1, 2, 4 and 8 splits of K), which is how the plan's cost model
is checked, and fits the model's stage time (fixed + per X row) to those
times by least squares (``_STAGE_S`` in ``ops/quant.py``). Needs a CUDA
card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess

import torch
import torch.nn.functional as F

from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, _nvcc

H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 494.7e12
QUANT_F32_TOL = 2e-5
COLD_BYTES = 150e6
GROUP = 256     # Llama-3-8B's int4 group (quant_group_size)
# (K, N) and launches per prefill of Llama-3-8B: q/o, k/v, gate/up, down
SHAPES = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
          ((14336, 4096), 32)]


def time_ms(fns, iters=20):
    """Device ms per call, cycling through ``fns``, queued behind a spin
    kernel so the events time the device and not the host."""
    for f in fns[:3]:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def baseline_fns(src):
    """The earlier kernel's entries, built from ``src`` into build/."""
    out = BUILD_DIR / "libquant_matmul_baseline.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_nvcc(), *flags, "-o", str(out), src], check=True)
    lib = ctypes.CDLL(str(out))
    f8, f4 = lib.int8_matmul_bf16, lib.int4_matmul_bf16
    f8.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong, ctypes.c_void_p])
    f4.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])

    def call(bits, x, qt):
        M, K = x.shape
        N = qt.values.shape[0]
        y = torch.empty(M, N, dtype=torch.bfloat16, device=x.device)
        st = torch.cuda.current_stream().cuda_stream
        args = [x.data_ptr(), qt.values.data_ptr(), qt.scale.data_ptr(),
                y.data_ptr(), M, N, K]
        if bits == 4:
            args.append(K // qt.scale.shape[0])
        err = (f8 if bits == 8 else f4)(*args, K, st)
        if err:
            raise RuntimeError(f"baseline launch failed: CUDA error {err}")
        return y
    return call


def sweep_plans(bits, M, N, K, G, dtype=torch.bfloat16):
    """The plans beside the chosen one: each tile width, 1/2/4/8 splits."""
    stages = -(-K // 64) if bits == 8 else K // 128
    step = 1 if bits == 8 else G // 128
    out = []
    for bx in tq.PREFILL_BX[dtype][bits]:
        for s in (1, 2, 4, 8):
            per = -(-(-(-stages // s)) // step) * step
            if -(-stages // per) == s:
                out.append(tq.PrefillPlan(bits, bx, -(-M // bx),
                                          -(-N // tq.PREFILL_BN), stages, s,
                                          per, dtype))
    return out


def fit_stage_s(points, sms):
    """Least-squares (fixed, per X row) seconds of one ring stage, weighted
    by 1/t, from sweep points (plan, M, N, seconds): t = the busiest
    block's units × (stages a unit + the fill) × (fixed + per_row · bx) +
    the split sums' cost, ``prefill_plan``'s model. With one tile width the
    stage time is all ``fixed``."""
    import numpy as np
    rows, rhs = [], []
    for plan, M, N, t in points:
        waves = -(-plan.units // sms)
        a = waves * (plan.split_stages + tq._FILL_STAGES)
        extra = 0.0
        if plan.splits > 1:
            extra = ((8 * plan.splits + 2) * M * N / tq._BYTES_PER_S
                     + tq._REDUCE_LAUNCH_S)
        rows.append([a / t, a * plan.bx / t])
        rhs.append((t - extra) / t)
    A, b = np.array(rows), np.array(rhs)
    if len({p.bx for p, *_ in points}) == 1:
        return float(np.linalg.lstsq(A[:, :1], b, rcond=None)[0][0]), 0.0
    fixed, per_row = np.linalg.lstsq(A, b, rcond=None)[0]
    return float(fixed), float(per_row)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[339])
    ap.add_argument("--f32", action="store_true",
                    help="K4 f32 / K5 f32 on fp32 x")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    base = baseline_fns(args.baseline) if args.baseline else None
    dev = torch.device("cuda")
    dt = torch.float32 if args.f32 else torch.bfloat16
    rate = H100_TF32_FLOPS if args.f32 else H100_BF16_FLOPS
    sms = tq._sms(dev)
    rows, totals, points = [], {}, {8: [], 4: []}
    for M in args.m:
        for bits in (8, 4):
            tot = totals.setdefault(f"int{bits} M{M}", dict.fromkeys(
                ("ms", "baseline_ms", "library_ms", "bound_ms"), 0.0))
            for (K, N), n in SHAPES:
                g = torch.Generator(device=dev)
                g.manual_seed(0)
                w = (torch.randn(N, K, device=dev, generator=g)
                     * 0.02).bfloat16()
                x = torch.randn(M, K, device=dev, generator=g).to(dt)
                if bits == 8:
                    qt, kernel = tq.quantize_int8(w), tq.int8_matmul
                    wd, plain = tq.dequantize_int8(qt, dt), \
                        tq.int8_matmul_reference
                else:
                    qt, kernel = tq.quantize_int4(w, GROUP), \
                        tq.int4_matmul
                    wd, plain = tq.dequantize_int4(qt, dt), \
                        tq.int4_matmul_reference
                del w
                ref = plain(x, *qt).float()
                out = kernel(x, *qt).float()
                err = (out - ref).abs().max().item()
                if args.f32:
                    ok = err <= QUANT_F32_TOL * ref.abs().max().item()
                else:
                    ok = bool(((out - ref).abs() <= 1e-2 * ref.abs()
                               + 1e-3 * ref.abs().max()).all())
                same = bool(torch.equal(kernel(x, *qt), kernel(x, *qt)))
                w_bytes = qt.values.numel() + 4 * qt.scale.numel()
                copies = [qt] + [type(qt)(qt.values.clone(), qt.scale.clone())
                                 for _ in range(math.ceil(COLD_BYTES
                                                          / w_bytes) - 1)]
                lib = [wd] + [wd.clone() for _ in range(
                    math.ceil(COLD_BYTES / (wd.element_size() * N * K)) - 1)]
                plan = tq.prefill_plan(bits, M, N, K, GROUP, sms, dtype=dt)
                row = {"bits": bits, "M": M, "K": K, "N": N,
                       "plan": {**plan._asdict(), "dtype": str(dt)},
                       "max_abs_err": err, "within_tolerance": ok,
                       "repeat_bit_identical": same,
                       "ms": time_ms([lambda c=c: kernel(x, *c)
                                      for c in copies]),
                       "library_ms": time_ms([lambda c=c: F.linear(x, c)
                                              for c in lib]),
                       "bound_ms": 2 * M * N * K / rate * 1e3}
                row["baseline_ms"] = (time_ms([lambda c=c: base(bits, x, c)
                                               for c in copies])
                                      if base else None)
                row["tflops"] = 2 * M * N * K / row["ms"] / 1e9
                if args.sweep:
                    chosen, row["sweep"] = tq.prefill_plan, []
                    try:
                        for p in sweep_plans(bits, M, N, K, GROUP, dt):
                            tq.prefill_plan = lambda *a, _p=p, **k: _p
                            ms = time_ms([lambda c=c: kernel(x, *c)
                                          for c in copies])
                            row["sweep"].append(
                                {"bx": p.bx, "splits": p.splits, "ms": ms})
                            points[bits].append((p, M, N, ms * 1e-3))
                    finally:
                        tq.prefill_plan = chosen
                    print(f"  sweep int{bits} M{M} K{K} N{N}: " + "  ".join(
                        f"bx{r['bx']}/s{r['splits']} {r['ms']:.4f}"
                        for r in row["sweep"]), flush=True)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                for k in tot:
                    tot[k] += n * (row[k] or 0.0)
                print(f"int{bits} M{M} K{K} N{N}: kernel {row['ms']:.4f} ms "
                      f"({row['tflops']:.0f} TFLOP/s, "
                      f"{100 * row['bound_share']:.1f}% of the bound)  "
                      + (f"baseline {row['baseline_ms']:.4f} ms  "
                         if base else "")
                      + f"F.linear {row['library_ms']:.4f} ms  bound "
                      f"{row['bound_ms']:.4f} ms  err {err:.3e} "
                      f"(within tolerance: {ok}; repeat identical: {same})  "
                      f"plan bx {row['plan']['bx']} x_tiles "
                      f"{row['plan']['x_tiles']} splits "
                      f"{row['plan']['splits']}", flush=True)
                del copies, lib, wd
                torch.cuda.empty_cache()
            tot["bound_share"] = tot["bound_ms"] / tot["ms"]
            print(f"per prefill, int{bits} M{M} (224 products): kernel "
                  f"{tot['ms']:.3f} ms  "
                  + (f"baseline {tot['baseline_ms']:.3f} ms  " if base else "")
                  + f"F.linear {tot['library_ms']:.3f} ms  bound "
                  f"{tot['bound_ms']:.3f} ms  "
                  f"({100 * tot['bound_share']:.1f}% of the bound)",
                  flush=True)
    fits = {}
    if args.sweep:
        for bits, pts in points.items():
            fixed, per_row = fit_stage_s(pts, sms)
            fits[bits] = {"fixed_s": fixed, "per_row_s": per_row,
                          "model": list(tq._STAGE_S[dt][bits])}
            print(f"stage time fitted over {len(pts)} plans, int{bits} "
                  f"{'f32' if args.f32 else 'bf16'} x: fixed {fixed:.4g} s "
                  f"+ {per_row:.4g} s a row (the model's "
                  f"{tq._STAGE_S[dt][bits]})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "shapes": rows, "per_prefill": totals,
                       "stage_fit": fits}, f, indent=1)


if __name__ == "__main__":
    main()
