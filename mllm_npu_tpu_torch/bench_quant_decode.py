"""Times K4 f32 and K5 f32's decode route on the GPU (the pre-split of x
and ``qmm_decode_parts``) at the Llama-3-8B's products, M rows of fp32 x,
summed over one decode step's launch mix (32 layers of q, k, v, o, gate,
up, down and the lm_head), beside bf16 K4 / K5 on the same rows and the
byte bound.

    python -m mllm_npu_tpu_torch.bench_quant_decode [--m 1 8]
        [--variants 8,2,1,2,2,1 8,2,1,2,2,0 ...] [--out results.json]

``--variants W,U8,U4,B,T,O`` also builds copies of
``csrc/quant_matmul_f32.cu`` whose decode constants are set to each
choice (DP_WARPS W warps a block, DP_UNROLL_INT8 / DP_UNROLL_INT4 U8 / U4
weight loads in flight a lane and row, DP_MIN_BLOCKS B blocks an SM in
the launch bounds, DP_BLOCKS T blocks an SM the n-tiling aims for,
DP_OVERLAP O 1 to launch it overlapping the pre-split, 0 not), one nvcc
each, all started together, and times them in the same run, each
checked against the plain product. Each call finds its weights
outside the 50 MB L2 (copies cycled). Needs a CUDA card; prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess

import torch

from mllm_npu_tpu_torch.bench_quant_prefill import COLD_BYTES, time_ms
from mllm_npu_tpu_torch.ops import quant as tq
from mllm_npu_tpu_torch.utils.cuda_build import (BUILD_DIR, CSRC, NVCC_FLAGS,
                                                 _nvcc)

H100_BYTES_PER_S = 3.35e12
QUANT_F32_TOL = 2e-5
GROUP = 256
# (K, N) and launches per decode step of Llama-3-8B (vocab 128587)
SHAPES = [((4096, 4096), 64), ((4096, 1024), 64), ((4096, 14336), 64),
          ((14336, 4096), 32), ((4096, 128587), 1)]
CONSTANTS = ("DP_WARPS", "DP_UNROLL_INT8", "DP_UNROLL_INT4",
             "DP_MIN_BLOCKS", "DP_BLOCKS", "DP_OVERLAP")


def build_variants(variants):
    """{tag: (C entries {bits: fn}, ptxas lines)}: a copy of the fp32
    source per variant with its decode constants set, one nvcc each."""
    procs = {}
    for v in variants:
        tag = "v" + "_".join(map(str, v))
        d = BUILD_DIR / "decode_variants" / tag
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(CSRC / "quant_matmul.cuh", d)
        src = (CSRC / "quant_matmul_f32.cu").read_text()
        for name, val in zip(CONSTANTS, v):
            src, n = re.subn(rf"constexpr int {name} = \d+;",
                             f"constexpr int {name} = {val};", src)
            if n != 1:
                raise RuntimeError(f"{name} not found once in the source")
        (d / "quant_matmul_f32.cu").write_text(src)
        out = d / "lib.so"
        procs[tag] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(out),
             str(d / "quant_matmul_f32.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for tag, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {tag}:\n{log}")
        lib = ctypes.CDLL(str(out))
        fns = {}
        for bits in (8, 4):
            fn = getattr(lib, f"int{bits}_matmul_f32")
            fn.argtypes = ([ctypes.c_void_p] * 6
                           + [ctypes.c_int] * (3 if bits == 8 else 4)
                           + [ctypes.c_longlong] + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[bits] = fn
        lines = log.splitlines()
        # the decode kernels' ptxas report: the two lines after each entry
        libs[tag] = (fns, [ln.strip() for i, entry in enumerate(lines)
                           if "decode_parts" in entry
                           for ln in lines[i:i + 3]])
    return libs


def variant_call(fn, bits, x, qt):
    """One decode-route call of a variant's C entry (what ``_launch_f32``
    does at M <= F32_DECODE_MAX_M)."""
    M, K = x.shape
    N = qt.values.shape[0]
    y = torch.empty(M, N, device=x.device)
    xs = torch.empty(3 * M * K, dtype=torch.bfloat16, device=x.device)
    shape = [M, N, K] + ([K // qt.scale.shape[0]] if bits == 4 else [])
    err = fn(x.data_ptr(), qt.values.data_ptr(), qt.scale.data_ptr(),
             y.data_ptr(), xs.data_ptr(), None, *shape, x.stride(0), 0, 0,
             0, 0, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return y


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[1, 8])
    ap.add_argument("--variants", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    variants = [tuple(int(v) for v in s.split(",")) for s in args.variants]
    libs = build_variants(variants) if variants else {}
    for tag, (_, lines) in libs.items():
        for ln in lines:
            print(f"[{tag}] {ln}", flush=True)
    dev = torch.device("cuda")
    totals = {}
    for bits in (8, 4):
        for (K, N), n in SHAPES:
            g = torch.Generator(device=dev)
            g.manual_seed(K + N)
            w = (torch.randn(N, K, device=dev, generator=g) * 0.02).bfloat16()
            if bits == 8:
                qt, kernel = tq.quantize_int8(w), tq.int8_matmul
                plain = tq.int8_matmul_reference
            else:
                qt, kernel = tq.quantize_int4(w, GROUP), tq.int4_matmul
                plain = tq.int4_matmul_reference
            del w
            w_bytes = qt.values.numel() + 4 * qt.scale.numel()
            copies = [qt] + [type(qt)(qt.values.clone(), qt.scale.clone())
                             for _ in range(math.ceil(COLD_BYTES / w_bytes)
                                            - 1)]
            for M in args.m:
                x = torch.randn(M, K, device=dev, generator=g)
                ref = plain(x, *qt)
                tol = QUANT_F32_TOL * ref.abs().max().item()
                calls = {"f32": lambda c, x=x: kernel(x, *c),
                         "bf16": lambda c, xb=x.bfloat16(): kernel(xb, *c)}
                for tag, (fns, _) in libs.items():
                    calls[tag] = (lambda c, f=fns[bits], x=x:
                                  variant_call(f, bits, x, c))
                for name, call in calls.items():
                    if name != "bf16":
                        err = (call(qt) - ref).abs().max().item()
                        if err > tol:
                            raise SystemExit(f"{name} int{bits} M{M} K{K} "
                                             f"N{N}: err {err} > {tol}")
                    ms = time_ms([lambda c=c: call(c) for c in copies])
                    key = f"int{bits} M{M} {name}"
                    tot = totals.setdefault(key, {"ms": 0.0, "bound_ms": 0.0})
                    tot["ms"] += n * ms
                    xe = 2 if name == "bf16" else 4
                    tot["bound_ms"] += n * (w_bytes + xe * M * (K + N)) \
                        / H100_BYTES_PER_S * 1e3
                    print(f"int{bits} M{M} K{K} N{N} {name}: {ms:.4f} ms",
                          flush=True)
            del copies
            torch.cuda.empty_cache()
    for key, tot in totals.items():
        tot["bound_share"] = tot["bound_ms"] / tot["ms"]
        print(f"per decode step, {key}: {tot['ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms ({100 * tot['bound_share']:.1f}%)",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "variants": {t: v for t, (_, v) in libs.items()},
                       "per_step": totals}, f, indent=1)


if __name__ == "__main__":
    main()
