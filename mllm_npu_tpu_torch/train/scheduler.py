"""Learning-rate schedules as plain functions of the step (twin of
``mllm_npu_tpu/train/scheduler.py``, which builds them from optax): linear
warmup from 0, then constant, linear decay to 0, or cosine decay to the
``min_lr_ratio`` floor."""

from __future__ import annotations

import math
from typing import Callable


def _warmup(step: int, base_lr: float, warmup_steps: int) -> float:
    # optax.linear_schedule(0, base_lr, warmup_steps)
    return base_lr * min(max(step, 0), warmup_steps) / warmup_steps


def get_scheduler(name: str, *, base_lr: float, warmup_steps: int = 0,
                  total_steps: int = 0, min_lr_ratio: float = 0.0
                  ) -> Callable[[int], float]:
    """step → learning rate, with the semantics of the reference's optax
    schedules (``join_schedules`` at ``warmup_steps``)."""
    name = name.lower()
    if name == "constant":
        return lambda step: base_lr
    decay_steps = max(total_steps - warmup_steps, 1)
    if name == "constant_with_warmup":
        def after(s):
            return base_lr
    elif name == "linear":
        def after(s):
            return base_lr * (1.0 - min(max(s, 0), decay_steps)
                              / decay_steps)
    elif name in ("cosine", "cosine_with_min_lr"):
        def after(s):
            frac = min(max(s / decay_steps, 0.0), 1.0)
            cos = 0.5 * (1.0 + math.cos(math.pi * frac))
            return base_lr * (min_lr_ratio + (1 - min_lr_ratio) * cos)
    else:
        raise ValueError(f"unknown scheduler: {name}")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return _warmup(step, base_lr, warmup_steps)
        return after(step - warmup_steps)
    return schedule
