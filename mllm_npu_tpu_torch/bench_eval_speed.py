"""Throughput of the evaluator at the 8B serving stack (twin of
``benchmarks/eval_speed.py``): items/s through the port's evaluator
(``EvalModel`` → ``InferenceEngine`` → ``MLLMGenerator``, or the batched
engine with a prefix cache) with seeded weights, and the hours projected
to the full published benchmarks.

    python -m mllm_npu_tpu_torch.bench_eval_speed --preset 8b --int8
    python -m mllm_npu_tpu_torch.bench_eval_speed --preset 8b --int8 \\
        --prefix_cache 8 --slots 8
    python -m mllm_npu_tpu_torch.bench_eval_speed \\
        --preset tiny --device cpu --mmlu_items 3 --mme_images 1

Two probes, on the reference's synthetic data (``RandomState(0)``):
  mmlu  one subject of 5-shot prompts of about 700 words, 10-token greedy
        answers, the letter extracted;
  mme   768×1024 JPEGs through decode, anyres tiling, the SigLIP tower and
        a 10-token answer, two questions an image.
A warm pass (the first 2 items; on the GPU it captures the decode step's
graph) is timed apart; items/s is over a second pass of every item. The
probes take an ``EvalModel``, so an engine that is already built can be
measured (``chip_smoke.py`` phase 12). The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
import tempfile
import time
from pathlib import Path

# full-benchmark sizes for the wall-clock projection
MMLU_FULL_ITEMS = 14042       # 57 subjects, official test split
MME_FULL_ITEMS = 2374         # QA pairs over 14 tasks
# the batched engine for --prefix_cache (the reference's values, with
# --slots slots): 512-token buckets, as the cache aligns prefixes to the
# bucket
PREFIX_ENGINE = dict(max_len=2048, max_prompt=1536, batch_prompt_bucket=512)
NEW_TOKENS = 10


def mk_mmlu(root: Path, n_items: int, words_q: int = 60) -> None:
    """Synthetic subject at realistic item sizes: ~60-word questions + 4
    choices, so the 5-shot prompt lands around 700 words (the reference's
    draws, written as ``DataFrame.to_csv(header=False, index=False)``
    writes them)."""
    import numpy as np
    rs = np.random.RandomState(0)

    def item(i):
        q = " ".join(f"word{rs.randint(0, 5000)}"
                     for _ in range(words_q)) + f" question {i}?"
        choices = [" ".join(f"c{rs.randint(0, 5000)}"
                            for _ in range(12)) for _ in range(4)]
        return [q, *choices, "ABCD"[i % 4]]

    (root / "dev").mkdir(parents=True)
    (root / "test").mkdir()
    for path, rows in (
            (root / "dev" / "synthetic_dev.csv", [item(i) for i in range(5)]),
            (root / "test" / "synthetic_test.csv",
             [item(100 + i) for i in range(n_items)])):
        with open(path, "w", newline="") as f:
            csv.writer(f, lineterminator="\n").writerows(rows)


def mk_mme(root: Path, n_images: int) -> None:
    import numpy as np
    from PIL import Image
    rs = np.random.RandomState(0)
    task = root / "color"
    task.mkdir(parents=True)
    for i in range(n_images):
        arr = (rs.rand(768, 1024, 3) * 255).astype("uint8")
        Image.fromarray(arr).save(task / f"img{i:03d}.jpg")
        (task / f"img{i:03d}.txt").write_text(
            "Is the dominant color of this image red? Please answer "
            "yes or no.\tYes\n"
            "Is the dominant color of this image blue? Please answer "
            "yes or no.\tNo\n")


def _sync(em) -> None:
    import torch
    if em.engine.device.type == "cuda":
        torch.cuda.synchronize(em.engine.device)


def probe_mmlu(em, n_items: int = 10) -> dict:
    """The mmlu probe on ``em``: the warm pass (2 items), then all
    ``n_items`` timed."""
    from mllm_npu_tpu_torch.evaluate import text_benchmarks as tb
    with tempfile.TemporaryDirectory() as td:
        root = Path(td) / "mmlu"
        mk_mmlu(root, n_items)
        out = str(Path(td) / "result_mmlu.json")
        t0 = time.perf_counter()
        tb.mmlu_eval(em, str(root), max_items_per_subject=2, out_path=out)
        _sync(em)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tb.mmlu_eval(em, str(root), max_items_per_subject=n_items,
                     out_path=out)
        _sync(em)
        all_s = time.perf_counter() - t0
    steady = all_s / n_items
    return {"items": n_items, "first2_with_compile_s": warm_s,
            "steady_items_per_sec": 1.0 / steady,
            "steady_sec_per_item": steady,
            "projected_full_mmlu_hours": MMLU_FULL_ITEMS * steady / 3600}


def probe_mme(em, n_images: int = 5) -> dict:
    """The mme probe on ``em``: the warm pass (1 QA pair), then both
    questions of every image timed; the rate is over the QA pairs run."""
    from mllm_npu_tpu_torch.evaluate import mm_benchmarks as mm
    with tempfile.TemporaryDirectory() as td:
        root = Path(td) / "mme"
        mk_mme(root, n_images)
        out = str(Path(td) / "res_mme")
        t0 = time.perf_counter()
        mm.mme_eval(em, str(root), out_dir=out, max_items=1)
        _sync(em)
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = mm.mme_eval(em, str(root), out_dir=out,
                          max_items=2 * n_images)
        _sync(em)
        all_s = time.perf_counter() - t0
    pairs = sum(res.values())
    steady = all_s / pairs
    return {"images": n_images, "qa_pairs": pairs,
            "first_with_compile_s": warm_s,
            "steady_qa_per_sec": 1.0 / steady,
            "steady_sec_per_qa": steady,
            "projected_full_mme_hours": MME_FULL_ITEMS * steady / 3600}


def build_model(preset: str, *, device=None, seed: int = 0):
    """The reference harness's assembly, bf16, weights from ``seed``: the
    tiny configs, or Llama-3-8B (no LoRA) + SigLIP-so400m-384 + a 64-query
    resampler."""
    import torch

    from mllm_npu_tpu_torch.models.factory import materialize
    from mllm_npu_tpu_torch.models.language_models.llama import (
        LlamaConfig, LlamaForCausalLM)
    from mllm_npu_tpu_torch.models.mllm import GeneralizedMultimodalModel
    from mllm_npu_tpu_torch.models.multimodal_encoder.siglip_vit import (
        SigLIPConfig, SigLIPVisionEncoder)
    from mllm_npu_tpu_torch.models.multimodal_projector.attention_resampler \
        import AttentionResampler
    if preset == "tiny":
        lm_cfg, vis_cfg, nq, heads = (LlamaConfig.tiny(), SigLIPConfig.tiny(),
                                      4, 4)
    else:
        lm_cfg, vis_cfg, nq, heads = (LlamaConfig.llama3_8b(),
                                      SigLIPConfig.so400m_384(), 64, 32)
    dt = torch.bfloat16

    def make():
        return GeneralizedMultimodalModel(
            LlamaForCausalLM(lm_cfg, dtype=dt),
            SigLIPVisionEncoder(vis_cfg, dtype=dt),
            AttentionResampler(grid_size=int(nq ** 0.5),
                               embed_dim=lm_cfg.hidden_size, num_heads=heads,
                               kv_dim=vis_cfg.hidden_size, dtype=dt),
            freeze_vision_encoder=True, add_patch_pos=True,
            patch_pos_dim=lm_cfg.hidden_size)
    return materialize(make, device=device, param_dtype=dt, seed=seed)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", choices=["tiny", "8b"], default="8b")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int4", action="store_true")
    p.add_argument("--fused", action="store_true")
    p.add_argument("--unroll", action="store_true",
                   help="accepted and ignored: the reference's scan setting "
                        "has no PyTorch meaning (the port's layers are a "
                        "Python loop)")
    p.add_argument("--mmlu_items", type=int, default=10)
    p.add_argument("--mme_images", type=int, default=5)
    p.add_argument("--probe", choices=["both", "mmlu", "mme"],
                   default="both")
    p.add_argument("--slots", type=int, default=4,
                   help="batched-engine slots for --prefix_cache runs")
    p.add_argument("--prefix_cache", type=int, default=0, metavar="N",
                   help="route text benchmarks through the batched "
                        "engine with an N-entry prompt-prefix KV "
                        "cache: the few-shot preamble every item "
                        "repeats prefills once, items after the first "
                        "prefill only their question suffix")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if args.preset == "8b" and not (args.int8 or args.int4):
        p.error("8B needs --int8 or --int4")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from mllm_npu_tpu_torch.data.processor import ImageProcessor
    from mllm_npu_tpu_torch.evaluate.run import eval_model_for
    from mllm_npu_tpu_torch.utils.device import resolve_device
    from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer

    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model = build_model(args.preset, device=device, seed=args.seed)
    size = model.vision_encoder.config.image_size
    em = eval_model_for(
        model, FakeTokenizer(vocab_size=min(
            4096, model.language_model.config.vocab_size)),
        ImageProcessor(height=size, width=size), max_new_tokens=NEW_TOKENS,
        prefix_cache=args.prefix_cache,
        prefix_engine=dict(num_slots=args.slots, **PREFIX_ENGINE),
        device=device, base_resolution=size, quantize_int8=args.int8,
        quantize_int4=args.int4, fuse_projections=args.fused)
    print(f"build {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    out = {"preset": args.preset, "int8": args.int8, "int4": args.int4,
           "fused": args.fused, "unroll": args.unroll,
           "device": str(device)}
    try:
        if args.probe in ("both", "mmlu"):
            out["mmlu"] = probe_mmlu(em, args.mmlu_items)
            print(json.dumps(out["mmlu"]), file=sys.stderr)
        if args.probe in ("both", "mme"):
            out["mme"] = probe_mme(em, args.mme_images)
            print(json.dumps(out["mme"]), file=sys.stderr)
        if args.prefix_cache:
            out["prefix_cache"] = \
                em.engine.batch_engine.stats()["prefix_cache"]
    finally:
        if hasattr(em.engine, "close"):
            em.engine.close()
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
