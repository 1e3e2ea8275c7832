"""Checkpoint save and resume in the ``checkpoint_{step}`` layout (twin of
``mllm_npu_tpu/train/checkpoint.py``, which saves through orbax).

Each checkpoint is a directory ``checkpoint_{step}`` holding ``state.pt``
(``torch.save`` of the step, the trainable parameters and the optimizer
state) and ``data.json`` (the data loader's position). It is written under
a temporary name and renamed into place, so a directory with the final
name is complete. The frozen parameters (the LoRA bases and the frozen
vision tower) are not written: the model build reproduces them from its
seed or its pretrained weights. At most ``max_to_keep`` checkpoints are
kept. :func:`install_sigterm_checkpoint` writes one on SIGTERM.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import signal
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch import nn

from mllm_npu_tpu_torch.train.train_state import (AdamW,
                                                  trainable_parameters)

log = logging.getLogger(__name__)

_NAME = re.compile(r"^checkpoint_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list:
        return sorted(int(m.group(1)) for m in
                      (_NAME.match(p.name) for p in self.directory.iterdir())
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: nn.Module, optimizer: AdamW,
             data_state: Optional[dict] = None) -> Path:
        final = self.directory / f"checkpoint_{step}"
        tmp = self.directory / f".checkpoint_{step}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save({"step": step,
                    "params": {n: p.detach()
                               for n, p in trainable_parameters(model)},
                    "optimizer": optimizer.state_dict()},
                   tmp / "state.pt")
        if data_state is not None:
            (tmp / "data.json").write_text(json.dumps(data_state))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / f"checkpoint_{old}",
                          ignore_errors=True)
        return final

    @torch.no_grad()
    def restore(self, model: nn.Module, optimizer: AdamW
                ) -> Tuple[Optional[dict], Optional[int]]:
        """Load the latest checkpoint into ``model`` and ``optimizer`` in
        place; returns (data state, step), or (None, None) when there is
        none. Saves are synchronous, so the latest is complete."""
        step = self.latest_step()
        if step is None:
            return None, None
        path = self.directory / f"checkpoint_{step}"
        params = dict(trainable_parameters(model))
        device = next(iter(params.values())).device
        state = torch.load(path / "state.pt", map_location=device,
                           weights_only=True)
        missing = set(params) ^ set(state["params"])
        if missing:
            raise ValueError(f"checkpoint {path} does not match the model's "
                             f"trainable parameters: {sorted(missing)[:5]}")
        for name, p in params.items():
            p.copy_(state["params"][name])
        optimizer.load_state_dict(state["optimizer"])
        data = path / "data.json"
        data_state = json.loads(data.read_text()) if data.exists() else None
        return data_state, int(state["step"])


def install_sigterm_checkpoint(save_fn) -> None:
    """Save a final checkpoint when the job is preempted (SIGTERM), then
    exit with 143."""

    def handler(signum, frame):
        log.warning("SIGTERM received — writing preemption checkpoint")
        try:
            save_fn()
        finally:
            raise SystemExit(143)

    signal.signal(signal.SIGTERM, handler)
