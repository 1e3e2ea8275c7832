"""Times K2 f32 and K3 f32 (the fp32 flash-attention backward) on the GPU at
the fp32 de-tokenizer's training shapes, beside the fp32 backward of
``scaled_dot_product_attention`` (TF32 off), the bound and, given
``--baseline``, an earlier pair of sources built beside them.

    python -m mllm_npu_tpu_torch.bench_flash_bwd_f32 [--batch 4]
        [--wide] [--baseline DIR] [--repeats 1] [--out results.json]

The shapes are those of one training step of the SDXL de-tokenizer at
1024² (``build_sdxl_adapter(param_dtype=torch.float32)``): self-attention
at 4096 positions (10 heads) and 1024 (20 heads), and cross-attention over
the resampler's 64 tokens, all at D = 64, with the launches a step makes of
each (``DETOK_MIX``); ``--wide`` adds the reference's bench shape (B32 H8
S256 D256, the mma.sync route). Per shape: each kernel checked against its
plain version (``K1_F32_TOL``·max|plain|) and for a bit-identical repeat,
then K2 f32, K3 f32 and SDPA's backward (dq, dk and dv together) timed in
turns, ``--repeats`` times, with the bound at the dense TF32 rate (one TF32
product counted a product). ``--baseline DIR``: the C entries of an earlier
``flash_bwd_f32.cu`` and ``flash_bwd_dkv_f32.cu`` (with its
``flash_bwd_f32.cuh``) in DIR, built into ``build/`` and called with the
mma.sync design's plan (``mma_sync_smem``), timed in the same turns. Then
the per-step sums over ``DETOK_MIX``. Prints the card's name and power
limit first and one JSON line last. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from mllm_npu_tpu_torch.bench_flash_bwd import time_ms
from mllm_npu_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, _nvcc

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

H100_TF32_FLOPS = 494.7e12
H100_BYTES_PER_S = 3.35e12
K1_F32_TOL = 1e-4
# (Sq, Sk, heads, D) → launches of each kernel in one de-tokenizer
# training step (the SDXL UNet at 1024²: its self-attention blocks at 64²
# and 32² latents, each with cross-attention over 64 resampler tokens)
DETOK_MIX = {(4096, 4096, 10, 64): 10, (1024, 1024, 20, 64): 60,
             (4096, 64, 10, 64): 10, (1024, 64, 20, 64): 60}
WIDE_SHAPE = (32, 256, 8, 256)           # B, S, heads, D


def mma_sync_smem(D: int):
    """(K2, K3) shared-memory bytes of the mma.sync design (the plan every
    head dim had before the wgmma route) at head dim D: K2 keeps Q and dO
    and two stages of T-row K and V tiles, K3 K and V and two stages of Q
    and dO, rows D + 4 floats, a 16 × (T + 4) patch a warp (K2 four, K3
    four up to a padded 128, eight above), T key ids (K2) or LSEs, δs and
    ids (K3) twice."""
    dp = fa.padded_head_dim(D)
    T = 16 if dp > 192 else 32
    rows = (2 * 64 + 4 * T) * (dp + 4)
    patch = 16 * (T + 4)
    return (4 * (rows + 4 * patch + 2 * T),
            4 * (rows + (8 if dp > 128 else 4) * patch + 6 * T))


def baseline_fns(src: Path):
    """K2 f32 and K3 f32 of the sources in ``src`` built into build/:
    (dq(q, k, v, do, lse, delta), dkv(...))."""
    out_dir = BUILD_DIR / "baseline_f32"
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    shutil.copy(src / "flash_bwd_f32.cuh", out_dir / "flash_bwd_f32.cuh")
    libs = {}
    procs = []
    for name in ("flash_bwd_f32", "flash_bwd_dkv_f32"):
        shutil.copy(src / f"{name}.cu", out_dir / f"{name}.cu")
        procs.append((name, subprocess.Popen(
            [_nvcc(), *flags, "-o", str(out_dir / f"lib{name}.so"),
             str(out_dir / f"{name}.cu")])))
    for name, proc in procs:
        if proc.wait():
            raise RuntimeError(f"the baseline's {name}.cu did not build")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
    tail = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    dq_fn = libs["flash_bwd_f32"].flash_bwd_dq_f32
    dq_fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + tail
    dkv_fn = libs["flash_bwd_dkv_f32"].flash_bwd_dkv_f32
    dkv_fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + tail

    def call(dkv, q, k, v, do, lse, delta):
        B, Sq, Hq, D = q.shape
        outs = ((torch.empty_like(k), torch.empty_like(v)) if dkv
                else (torch.empty_like(q),))
        dq = None if dkv else outs[0]
        dk, dv = outs if dkv else (None, None)
        strides = []
        for t in (q, k, v, do, dq, dk, dv):
            strides += list(t.stride()[:3]) if t is not None else [0, 0, 0]
        err = (dkv_fn if dkv else dq_fn)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), 0, 0,
            *[t.data_ptr() for t in outs], B, Sq, k.shape[1], Hq,
            k.shape[2], D, (ctypes.c_longlong * 21)(*strides),
            float(D ** -0.5), 0, 3, mma_sync_smem(D)[int(dkv)],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline launch failed: CUDA error {err}")
        return outs
    return (lambda *a: call(False, *a)), (lambda *a: call(True, *a))


def _err(got, ref) -> float:
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


def bench_shape(B, Sq, Sk, H, D, repeats=1, baseline=None, seed=0):
    """One shape's row (see the module docstring)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, D, device=dev, generator=g)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, H, D, device=dev, generator=g)
            for _ in range(2))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    delta = fa.attention_delta(o, do)
    got = (fa.flash_bwd_dq(q, k, v, do, lse, delta),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta))
    refs = (fa.flash_bwd_dq_reference(q, k, v, do, lse, delta),
            *fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta))
    errs = {lab: _err(a, r) for lab, a, r in zip(("dq", "dk", "dv"), got,
                                                 refs)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, refs
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    dot = do.transpose(1, 2)
    fns = {"k2": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta),
           "k3": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta),
           "sdpa_bwd": lambda: torch.autograd.grad(
               out, (qt, kt, vt), dot, retain_graph=True)}
    if baseline is not None:
        bdq, bdkv = baseline
        fns["baseline_k2"] = lambda: bdq(q, k, v, do, lse, delta)
        fns["baseline_k3"] = lambda: bdkv(q, k, v, do, lse, delta)
    times = {name: [] for name in fns}
    for _ in range(repeats):        # in turns, each kernel beside the rest
        for name, fn in fns.items():
            times[name].append(time_ms(fn))
    del out, qt, kt, vt
    pairs = B * H * Sq * Sk
    nq, nk, row = 4 * B * Sq * H * D, 4 * B * Sk * H * D, 4 * B * H * Sq
    work = {"k2": (6 * D * pairs, 3 * nq + 2 * nk + 2 * row),
            "k3": (8 * D * pairs, 2 * nq + 4 * nk + 2 * row)}
    plan = fa.k23_f32_plan(D)
    result = {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "D": D,
              "route": plan.route, "plan": plan._asdict(),
              "max_rel_err": errs, "tolerance": K1_F32_TOL,
              "within_tolerance": max(errs.values()) <= K1_F32_TOL,
              "repeat_bit_identical": same,
              **{f"{name}_ms": min(t) for name, t in times.items()},
              **{f"{name}_ms_all": t for name, t in times.items()}}
    for key, (flops, nbytes) in work.items():
        t_c, t_m = flops / H100_TF32_FLOPS, nbytes / H100_BYTES_PER_S
        result[f"{key}_bound_ms"] = max(t_c, t_m) * 1e3
        result[f"{key}_bound_by"] = "operations" if t_c >= t_m else "bytes"
        result[f"{key}_bound_share"] = (result[f"{key}_bound_ms"]
                                        / result[f"{key}_ms"])
    print(f"[K2/K3 f32] B{B} S{Sq}/{Sk} H{H} D{D} ({plan.route}): "
          + ", ".join(f"{name} {result[name + '_ms']:.4f} ms"
                      for name in fns)
          + f"; bounds {result['k2_bound_ms']:.4f} / "
          f"{result['k3_bound_ms']:.4f} ms; errors {errs}, repeat "
          f"identical {same}", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd_f32 needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    base = (baseline_fns(Path(args.baseline)) if args.baseline else None)
    rows = [dict(bench_shape(args.batch, Sq, Sk, H, D, args.repeats, base),
                 launches_per_step=n)
            for (Sq, Sk, H, D), n in DETOK_MIX.items()]
    step = {}
    for key in ("k2", "k3", "sdpa_bwd", "baseline_k2", "baseline_k3"):
        if f"{key}_ms" in rows[0]:
            step[f"{key}_ms_per_step"] = sum(r[f"{key}_ms"]
                                             * r["launches_per_step"]
                                             for r in rows)
    step["pair_vs_sdpa"] = ((step["k2_ms_per_step"] + step["k3_ms_per_step"])
                            / step["sdpa_bwd_ms_per_step"])
    if args.wide:
        B, S, H, D = WIDE_SHAPE
        rows.append(bench_shape(B, S, S, H, D, args.repeats, base))
    result = {"card": smi, "device": torch.cuda.get_device_name(0),
              "batch": args.batch, "rows": rows, "per_step": step}
    print(f"[K2/K3 f32] per de-tokenizer step at batch {args.batch}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in step.items()), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
