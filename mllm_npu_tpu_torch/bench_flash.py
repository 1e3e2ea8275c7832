"""The port's twin of the JAX package's root ``bench.py``: K1, the
flash-attention forward, at the reference's published op-level shape
(B = 32, H = 8, S = 256, D = 256, non-causal, bf16), printed as one JSON
line with ``bench.py``'s keys and more.

    python -m mllm_npu_tpu_torch.bench_flash [--device cpu] [--batch 32]
        [--heads 8] [--seq 256] [--head-dim 256] [--short 20]
        [--long 220] [--reps 15]

Timing, ``bench.py``'s method: ``q ← K1(q, k, v)`` chained n times, at
n = 20 and n = 220, 15 reps of each; one call's time (``value``) is the
slope between the two medians, ``best`` between the two minima. On the
card CUDA events time each chain, queued behind a spin kernel so that
they time the device and not the host enqueuing the calls.
``sdpa_s`` is ``scaled_dot_product_attention`` on the same tensors in the
same harness (the library call; the port never calls it) and ``plain_s``
the plain version (``flash_attention_reference``, 3 reps). The inputs are
drawn from a ``torch.Generator`` seeded with 0; one call is held against the
plain version first (``max_abs_err``, |err| ≤ 1e-2 + 1e-2·|plain|).

The bound is the card's floor for this work, the larger of Q, K, V read
and O written once over 3.35 TB/s (134.2 MB: 40.1 µs at the bench shape)
and 4·B·H·S²·D flops over 989 TFLOP/s (17.18 GFLOP: 17.4 µs), so the
shape is bound by its bytes. K and V together (67 MB) exceed the H100's
50 MB L2, so each call of the chain reads them from device memory again.

Runs on the card unless ``--device cpu``, which times the plain version
on the CPU for the tests only (``card`` is then null, and no number of
such a run is a device number); without a GPU and without ``--device
cpu`` it raises. ``chip_smoke.py`` phase 19a calls :func:`main`.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

fa = importlib.import_module("mllm_npu_tpu_torch.ops.flash_attention")

# the reference's published anchors at the bench shape (bench.py:24,
# README.md's performance table): Ascend 910B npu_fusion_attention, and
# the A100's flash-attn and xformers
BASELINE_NPU_FUSION_ATTENTION_S = 0.0022245049
A100_FLASH_ATTN_S = 778.5e-6
A100_XFORMERS_S = 460.7e-6
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
# K1 vs its fp32 plain version on the same bf16 inputs: the kernel rounds P
# (before PV) and O to bf16, 2^-9 relative each
ATOL, RTOL = 1e-2, 1e-2


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bound(B: int, H: int, S: int, D: int):
    """(seconds, "bytes" or "operations", bytes, flops): the card's floor
    for one call at this shape."""
    nbytes = 4 * B * S * H * D * 2
    flops = 4 * B * H * S * S * D
    t_m, t_c = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_m, t_c), "bytes" if t_m >= t_c else "operations", nbytes, \
        flops


def chain_seconds(step, q0, n: int, reps: int, cuda: bool):
    """Seconds of each of ``reps`` chains ``x ← step(x)`` of ``n`` calls
    from ``q0``: CUDA events queued behind a spin kernel on the card, the
    host's clock on the CPU."""
    def chain():
        x = q0
        for _ in range(n):
            x = step(x)
        return x
    chain()                                 # warm
    out = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(40_000_000)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chain()
            out.append(time.perf_counter() - t0)
    return out


def slope(step, q0, short: int, long: int, reps: int, cuda: bool):
    """(median slope, min slope): one call's seconds, ``bench.py``'s way."""
    ts = chain_seconds(step, q0, short, reps, cuda)
    tl = chain_seconds(step, q0, long, reps, cuda)
    n = long - short
    return (max((statistics.median(tl) - statistics.median(ts)) / n, 1e-12),
            max((min(tl) - min(ts)) / n, 1e-12))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--head-dim", type=int, default=256)
    ap.add_argument("--short", type=int, default=20)
    ap.add_argument("--long", type=int, default=220)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("bench_flash: no CUDA card (--device cpu times "
                           "the plain version, for the tests)")
    B, H, S, D = args.batch, args.heads, args.seq, args.head_dim
    dev = torch.device(args.device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    q, k, v = (torch.randn(B, S, H, D, device=dev, generator=g).bfloat16()
               for _ in range(3))

    launches = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v).float()
    diff = (out.float() - ref).abs()
    ok = bool(torch.isfinite(out.float()).all()) and bool(
        (diff <= ATOL + RTOL * ref.abs()).all())
    del out, ref

    value, best = slope(lambda x: fa.flash_attention(x, k, v), q,
                        args.short, args.long, args.reps, cuda)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa, sdpa_best = slope(
        lambda x: F.scaled_dot_product_attention(x, kt, vt), qt, args.short,
        args.long, args.reps, cuda)
    plain, _ = slope(lambda x: fa.flash_attention_reference(x, k, v), q,
                     args.short, args.long, min(args.reps, 3), cuda)
    b_s, b_by, nbytes, flops = bound(B, H, S, D)
    result = {
        "metric": f"flash_attention_fwd_avg_time_B{B}H{H}S{S}D{D}",
        "value": value, "unit": "s",
        "vs_baseline": BASELINE_NPU_FUSION_ATTENTION_S / value,
        "best": best, "reps": args.reps,
        "sdpa_s": sdpa, "sdpa_best": sdpa_best, "vs_sdpa": sdpa / value,
        "plain_s": plain,
        "bound_s": b_s, "bound_by": b_by, "bound_share": b_s / value,
        "bytes": nbytes, "flops": flops,
        "vs_a100_flash_attn": A100_FLASH_ATTN_S / value,
        "vs_a100_xformers": A100_XFORMERS_S / value,
        "max_abs_err": diff.max().item(), "within_tolerance": ok,
        "launches": fa.flash_attention.launches - launches,
        "device": args.device,
        "kind": torch.cuda.get_device_name(0) if cuda else None,
        "card": card() if cuda else None,
        "shape": {"B": B, "H": H, "S": S, "D": D, "causal": False,
                  "dtype": "bfloat16", "short": args.short,
                  "long": args.long},
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
