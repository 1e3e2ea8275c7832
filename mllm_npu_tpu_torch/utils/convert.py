"""Offline checkpoint conversion and ``--params_checkpoint`` (twin of
``mllm_npu_tpu/utils/convert.py``: ``convert_model_checkpoint`` :50,
``restore_params`` :76, ``restore_any_params`` :111).

The reference's layouts (HF directories, ``qwen_vit_G.pt``, the peft
``pytorch_model.bin``) are read, renamed, resized and seeded on every
start. The converter does that once and writes the port's whole
state_dict as safetensors shards:

    python -m mllm_npu_tpu_torch.tools.convert_checkpoint \\
        --model-config mllm_npu_tpu_torch/configs/models/seedx_llama2_13b_qwenvl_vitg.yaml \\
        --out ckpt/seedx

writes ``ckpt/seedx/checkpoint-0/model-0000i-of-0000n.safetensors`` and
``ckpt/seedx/convert_info.json`` (``n_params``, ``bytes``,
``convert_seconds``). The worker's ``--params-checkpoint``, the
evaluator's and the trainer's ``--params_checkpoint`` then build the model
on ``meta`` and fill it from those files straight onto the device
(``factory.build_mllm(params_checkpoint=...)``). The evaluator also takes
the port trainer's output directory (``checkpoint_{step}/state.pt``: the
trainable parameters over the model its YAML builds), as the reference's
``restore_any_params`` takes both of its flavours. An orbax directory (the
JAX package's) raises: that is ROADMAP queue 1 item 16.
"""

from __future__ import annotations

import json
import re
import time
from pathlib import Path
from typing import Optional

import torch

from mllm_npu_tpu_torch.models.factory import (frozen_parameter_names,
                                               load_state_)
from mllm_npu_tpu_torch.utils.checkpoint_files import (converted_dir,
                                                       is_orbax,
                                                       save_sharded)

__all__ = ["convert_model_checkpoint", "checkpoint_flavour",
           "restore_trainer_params_"]

_TRAINER_STEP = re.compile(r"^checkpoint_(\d+)$")


def convert_model_checkpoint(model_config_path: str, out_dir: str,
                             step: int = 0, *, device=None, seed: int = 0
                             ) -> dict:
    """Build the assembly a model YAML names from its checkpoints (on
    ``device``, ``cuda`` unless named) and write its whole state_dict
    under ``out_dir/checkpoint-{step}/`` as safetensors shards, with
    ``out_dir/convert_info.json``. Returns that info. The model is the
    training build, so the parameters a run trains are written in fp32
    (as the reference's converter writes its params) and the frozen ones
    in bf16: the trainer starts from the values its YAML's files give,
    and a bf16 build rounds them when it loads."""
    from mllm_npu_tpu_torch.configs import instantiate, load_config
    t0 = time.perf_counter()
    cfg = load_config(model_config_path)["mllm"]
    model = instantiate(cfg["mllm_model"],
                        language_model=instantiate(cfg["language_model"]),
                        device=device, seed=seed, train=True)
    sd = model.state_dict()
    n_params = sum(t.numel() for t in sd.values())
    index = save_sharded(sd, Path(out_dir) / f"checkpoint-{step}")
    info = {"model_config": str(model_config_path), "step": step,
            "n_params": n_params, "bytes": index["metadata"]["total_size"],
            "shards": len(set(index["weight_map"].values())),
            "skipped": model.checkpoint_report["skipped"],
            "convert_seconds": round(time.perf_counter() - t0, 1)}
    with open(Path(out_dir) / "convert_info.json", "w") as f:
        json.dump(info, f, indent=1)
    return info


def checkpoint_flavour(path) -> str:
    """``"trainer"`` for the port trainer's output directory
    (``checkpoint_{step}/state.pt``), ``"converted"`` otherwise (the
    converter's, which ``converted_dir`` checks when it reads it); an
    orbax directory raises (queue 1 item 16)."""
    p = Path(path)
    if p.is_dir() and not is_orbax(p) and any(
            _TRAINER_STEP.match(c.name) and (c / "state.pt").exists()
            for c in p.iterdir()):
        return "trainer"
    converted_dir(p)
    return "converted"


def restore_trainer_params_(model: torch.nn.Module, path,
                            step: Optional[int] = None) -> int:
    """Copy the trainable parameters of the port trainer's
    ``checkpoint_{step}`` (the latest unless given) into ``model`` in place
    (``factory.load_state_``: cast to each parameter's dtype, a name the
    model does not hold or a shape that differs raises); the frozen ones
    (``factory.frozen_parameter_names``) are the model's own, from its
    checkpoints, and every other parameter must be in the checkpoint.
    → the step."""
    steps = {int(m.group(1)): c for c in Path(path).iterdir()
             if (m := _TRAINER_STEP.match(c.name))
             and (c / "state.pt").exists()}
    if not steps:
        raise FileNotFoundError(f"no trainer checkpoint under {path}")
    step = max(steps) if step is None else step
    state = torch.load(steps[step] / "state.pt", map_location="cpu",
                       weights_only=True)["params"]
    frozen = frozen_parameter_names(
        model, getattr(model, "freeze_vision_encoder", True))
    missing = sorted(n for n, _ in model.named_parameters()
                     if n not in frozen and n not in state)
    if missing:
        raise KeyError(f"{steps[step]}: {len(missing)} trainable parameters "
                       f"missing, e.g. {missing[:3]}")
    load_state_(model, state)
    return step
