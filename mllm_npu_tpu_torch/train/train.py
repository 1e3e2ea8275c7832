"""Training CLI: LoRA fine-tuning of the comprehension assembly on one
device (twin of ``mllm_npu_tpu/train/train.py``).

    python -m mllm_npu_tpu_torch.train.train \
        --model mllm_npu_tpu_torch/configs/models/mllm_llama3_8b_siglip_vit.yaml \
        --train_dataset mllm_npu_tpu_torch/configs/dataset/caption_data.yaml \
        --output_dir out --max_steps 100000 --save_steps 1000 \
        --learning_rate 1e-4 --lr_scheduler_type cosine --warmup_steps 500

The flags and the log line (``sec/step``, ``tokens/s``, ``images/s``,
``loss``, ``lr``, ``grad_norm``) are the reference's. The model is built for
training (``build_mllm(train=True)``: fp32 trainable parameters, frozen
ones in bf16 at full width) with weights drawn from ``--seed``; every
attention that needs a gradient runs K1 with its LSE forward and K2/K3
backward. The run writes ``checkpoint_{step}`` directories and the JSONL
metrics under ``--output_dir`` and resumes from the latest checkpoint
there (or under ``--resume_from_checkpoint``) at the exact data position.

It runs on ``--device`` (default ``cuda``) and raises without a GPU unless
given ``--device cpu``. Not ported yet, and raising when asked for:
meshes other than one device (``--mesh_*``), ``--quantize_base`` (QLoRA),
``--params_checkpoint`` and ``--dataloader_workers > 0``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
import types
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

log = logging.getLogger("mllm_npu_tpu_torch.train")


@dataclasses.dataclass
class TrainArgs:
    # config paths
    model: str = ""
    train_dataset: str = ""
    tokenizer: str = ""
    # optimization
    output_dir: str = "output"
    resume_from_checkpoint: str = ""
    resume_steps: int = 0
    params_checkpoint: str = ""
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    max_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "bf16"
    dataloader_workers: int = 0
    num_train_epochs: int = 10
    max_steps: int = 100_000
    save_steps: int = 1000
    log_steps: int = 10
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 500
    min_lr_ratio: float = 0.05
    mu_dtype: str = "bfloat16"
    quantize_base: str = ""
    quant_group_size: int = 256
    # > 0: chunked (fused-linear) CE over this many positions
    ce_loss_chunk: int = 0
    # mesh: one device only in this port so far (-1 = all = the one)
    mesh_data: int = -1
    mesh_fsdp: int = 1
    mesh_tensor: int = 1
    mesh_dcn_data: int = 1
    mesh_seq: int = 1
    mesh_stage: int = 1
    pipeline_microbatches: int = 4
    # observability
    project_name: str = "mllm_tpu"
    run_name: str = ""
    profile_steps: int = 0     # torch.profiler trace of this step
    # testing hooks
    fake_tokenizer: bool = False
    # the port's own: where to run, and the seed of the model's weights
    device: str = "cuda"
    seed: int = 42


def parse_args(argv=None) -> TrainArgs:
    p = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainArgs):
        if isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", action="store_true")
        else:
            p.add_argument(f"--{f.name}", type=type(f.default),
                           default=f.default)
    return TrainArgs(**vars(p.parse_args(argv)))


def _refuse_unported(args: TrainArgs) -> None:
    mesh = {"mesh_fsdp": args.mesh_fsdp, "mesh_tensor": args.mesh_tensor,
            "mesh_dcn_data": args.mesh_dcn_data, "mesh_seq": args.mesh_seq,
            "mesh_stage": args.mesh_stage}
    bad = {k: v for k, v in mesh.items() if v != 1}
    if args.mesh_data not in (-1, 1):
        bad["mesh_data"] = args.mesh_data
    if bad:
        raise NotImplementedError(
            f"{bad}: meshes over several devices are the parallel slice "
            "(ROADMAP queue 1 item 12), not ported yet")
    if args.quantize_base:
        raise NotImplementedError(
            "--quantize_base (LoRA over an int8/int4 base and the quantized "
            "product's backward) is not ported yet (ROADMAP queue 1)")
    if args.params_checkpoint:
        raise NotImplementedError(
            "--params_checkpoint (orbax params from the JAX package) is not "
            "ported yet (ROADMAP queue 1, slice 8)")
    if args.dataloader_workers > 0:
        raise NotImplementedError(
            "--dataloader_workers > 0 (the multi-process loader) is not "
            "ported yet (ROADMAP queue 1); use 0")


def build_tokenizer(args: TrainArgs, cfg: dict, vocab_size: int):
    if args.fake_tokenizer:
        from mllm_npu_tpu_torch.utils.fake_tokenizer import FakeTokenizer
        return FakeTokenizer(vocab_size=vocab_size)
    from mllm_npu_tpu_torch.configs import instantiate
    node = cfg["mllm"]["tokenizer"]
    if args.tokenizer:
        node = dict(node)
        node["pretrained_model_name_or_path"] = args.tokenizer
    return instantiate(node)


class PipeFactory:
    """seed → the dataset mixture of ``ds_cfg`` (``build_multi_datapipes``)."""

    def __init__(self, ds_cfg: dict, tokenizer, processor):
        self.ds_cfg = ds_cfg
        self.tokenizer = tokenizer
        self.processor = processor

    def __call__(self, seed):
        from mllm_npu_tpu_torch.data.datapipes import build_multi_datapipes
        return build_multi_datapipes(
            self.ds_cfg["datapipes"], tokenizer=self.tokenizer,
            image_transform=self.processor,
            sample_weights=self.ds_cfg.get("sample_weights"), seed=seed)


_LONG_KEYS = ("input_ids", "labels")


def batch_to_device(batch: dict, device) -> dict:
    """The data layer's numpy batch → the model's keyword arguments on
    ``device`` (ids and labels as int64)."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        if k == "patch_position":
            k = "patch_positions"
        if k in ("images_patch_length", "image_size"):
            continue
        t = torch.from_numpy(v if v.flags.writeable else v.copy())
        if k in _LONG_KEYS:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def mllm_loss(model, batch):
    """The trainer's loss: the assembly's total loss, with ``lm_loss`` as a
    metric."""
    out = model(**batch)
    return out["total_loss"], {"lm_loss": out["lm_loss"]}


def main(argv=None, on_step: Optional[Callable[[dict], None]] = None):
    """Run the trainer; returns a namespace with the model, the optimizer,
    the last step's micro-batches and the records of the logged steps
    (unrounded). ``on_step(record)`` is called after every
    optimizer step, which then also records every step."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    _refuse_unported(args)

    from mllm_npu_tpu_torch.configs import instantiate, load_config
    from mllm_npu_tpu_torch.data.dataloader import make_dataloader
    from mllm_npu_tpu_torch.train.checkpoint import (
        CheckpointManager, install_sigterm_checkpoint)
    from mllm_npu_tpu_torch.train.train_state import (
        AdamW, OptimizerConfig, make_train_step, trainable_parameters)
    from mllm_npu_tpu_torch.train.trackers import build_trackers
    from mllm_npu_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    # ---- model ------------------------------------------------------------
    model_cfg = load_config(args.model)
    llm_spec = instantiate(model_cfg["mllm"]["language_model"])
    tokenizer = build_tokenizer(args, model_cfg, llm_spec.config.vocab_size)
    model = instantiate(model_cfg["mllm"]["mllm_model"],
                        language_model=llm_spec, device=device, train=True,
                        seed=args.seed, ce_loss_chunk=args.ce_loss_chunk)
    model.train()
    params = trainable_parameters(model)
    n_all = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for _, p in params)
    log.info("total params: %.2fM, trainable: %.2fM", n_all / 1e6,
             n_train / 1e6)

    # ---- data -------------------------------------------------------------
    processor = instantiate(model_cfg["mllm"]["processor"]) \
        if "processor" in model_cfg["mllm"] else None
    ds_cfg = load_config(args.train_dataset)
    loader = make_dataloader(PipeFactory(ds_cfg, tokenizer, processor),
                             prefetch=4, num_workers=args.dataloader_workers)

    # ---- optimizer and step -----------------------------------------------
    opt_cfg = OptimizerConfig(
        lr=args.learning_rate, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm, scheduler=args.lr_scheduler_type,
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        min_lr_ratio=args.min_lr_ratio, mu_dtype=args.mu_dtype)
    optimizer = AdamW(params, opt_cfg)
    step_fn = make_train_step(model, mllm_loss, optimizer)
    ga = args.gradient_accumulation_steps

    # ---- resume -----------------------------------------------------------
    mgr = CheckpointManager(args.resume_from_checkpoint or args.output_dir)
    data_state, resumed_step = mgr.restore(model, optimizer)
    start_step = int(resumed_step or args.resume_steps or 0)
    if data_state:
        loader.load_state_dict(data_state)
    data_iter = iter(loader)
    if resumed_step:
        log.info("resumed from checkpoint_%d", resumed_step)
    # the data position only at optimizer-step boundaries: with gradient
    # accumulation the loader may be micro-batches ahead of the last update
    applied_data_state = loader.state_dict()
    state = {"step": start_step}

    def save(step):
        mgr.save(step, model, optimizer, data_state=applied_data_state)

    install_sigterm_checkpoint(lambda: save(state["step"]))
    writer = build_trackers(args.output_dir, vars(args))

    # ---- loop -------------------------------------------------------------
    micro, records = [], []
    t0 = time.time()
    step = start_step
    epoch_mark = loader.state_dict()["steps"]
    while step < args.max_steps:
        try:
            batch = next(data_iter)
        except StopIteration:
            # epoch boundary: reseed (the reference's semantics) and restart
            consumed = loader.state_dict()["steps"]
            if consumed == epoch_mark:
                raise RuntimeError("data stream yielded no batches — "
                                   "check the dataset config paths")
            epoch_mark = consumed
            loader.next_epoch(resume_steps=start_step)
            data_iter = iter(loader)
            continue
        micro.append(batch_to_device(batch, device))
        if len(micro) < ga:
            continue
        batches, micro = micro, []

        prof = None
        if args.profile_steps and step == args.profile_steps:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if device.type == "cuda" else [])])
            prof.__enter__()
        loss, metrics = step_fn(batches)
        if prof is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(Path(args.output_dir)
                                         / f"profile_step{step}.json"))

        applied_data_state = loader.state_dict()
        step += 1
        state["step"] = step
        if step % args.log_steps == 0 or on_step is not None:
            loss_v = float(loss)
            dt = (time.time() - t0) / (args.log_steps if on_step is None
                                       else 1)
            t0 = time.time()
            tokens = sum(int(b["input_ids"].numel()) for b in batches)
            n_imgs = int(batches[-1]["images"].shape[0]) \
                if "images" in batches[-1] else 0
            rec = {"step": step, "loss": loss_v,
                   "lr": float(optimizer.schedule(step)), "sec/step": dt,
                   "tokens/s": tokens / max(dt, 1e-9),
                   "images/s": n_imgs / max(dt, 1e-9)}
            rec.update({k: float(v) for k, v in metrics.items()})
            records.append(rec)
            if step % args.log_steps == 0:
                digits = {"sec/step": 3, "tokens/s": 0, "images/s": 2,
                          "lr": None}
                log.info(json.dumps({
                    k: v if digits.get(k, 4) is None
                    else round(v, digits.get(k, 4)) for k, v in rec.items()}))
                if writer is not None:
                    writer.log({k: v for k, v in rec.items()
                                if k not in ("step", "sec/step", "tokens/s",
                                             "images/s")}, step)
            if on_step is not None:
                on_step(rec)
        if step % args.save_steps == 0:
            save(step)

    save(step)
    if writer is not None:
        writer.close()
    log.info("training done at step %d", step)
    return types.SimpleNamespace(model=model, optimizer=optimizer,
                                 last_batches=batches if step > start_step
                                 else None, records=records)


if __name__ == "__main__":
    main()
