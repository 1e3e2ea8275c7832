"""Train step and optimizer (twin of ``mllm_npu_tpu/train/train_state.py``
for one device).

The trainable set is the model's parameters that require a gradient
(``models.factory.build_mllm(train=True)`` marks them, or
:func:`apply_frozen_patterns` by the reference's regexes); the frozen ones
never get a gradient or optimizer state, where the reference runs them
through ``optax.set_to_zero``. :class:`AdamW` is the reference's
``clip_by_global_norm → adamw`` chain written as plain tensor functions
with optax's semantics:

- the global norm is taken over the trainable gradients, and they are
  scaled by ``min(1, max_norm / norm)`` (no epsilon);
- Adam with bias correction, ``eps`` outside the square root; the first
  moment is stored in ``mu_dtype`` but the step uses its fp32 value before
  the cast (``optax.scale_by_adam``), the second moment is fp32;
- decoupled weight decay on every trainable parameter, then the step
  ``p ← p − lr·(m̂/(√v̂ + eps) + wd·p)``, with ``lr`` the schedule at the
  number of updates done so far.

:func:`make_train_step` averages gradients over micro-batches (the
reference's ``lax.scan`` accumulation, ``:131-198``) and sets one LoRA
dropout seed per step, the twin of ``fold_in(PRNGKey(17), step)``. The
reference's sharded ``compile_train_step`` belongs to the parallel slice.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from mllm_npu_tpu_torch.models.language_models.llama import (
    set_lora_dropout_seed)
from mllm_npu_tpu_torch.train.scheduler import get_scheduler

_MU_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class OptimizerConfig:
    lr: float = 1e-4
    weight_decay: float = 0.05
    betas: tuple = (0.9, 0.98)
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    scheduler: str = "cosine"
    warmup_steps: int = 500
    total_steps: int = 100_000
    min_lr_ratio: float = 0.05
    mu_dtype: str = "float32"  # float32 | bfloat16
    optimizer: str = "adamw"   # adafactor is not ported yet


def apply_frozen_patterns(model: nn.Module, frozen_patterns) -> None:
    """Mark the trainable set by name (twin of ``trainable_mask``): a
    floating-point parameter trains unless one of the regexes
    ``frozen_patterns`` is found in its dotted name (``re.search``); an
    integer one (quantized storage) never trains. The de-tokenizers'
    patterns (``adapter_modules.*_trainable_patterns``) are over their
    ``parts``' names."""
    pats = [re.compile(p) for p in frozen_patterns]
    for name, p in model.named_parameters():
        p.requires_grad_(p.is_floating_point()
                         and not any(pat.search(name) for pat in pats))


def trainable_parameters(model: nn.Module) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) of every parameter that requires a gradient."""
    return [(n, p) for n, p in model.named_parameters() if p.requires_grad]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) in fp32, a 0-d tensor on the tensors' device."""
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


class AdamW:
    """AdamW with global-norm clipping over ``params`` (see the module
    docstring for the exact semantics). ``count`` is the number of updates
    applied."""

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 config: OptimizerConfig):
        if config.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {config.optimizer!r} is not ported yet (ported: "
                "adamw)")
        self.params = list(params)
        self.config = config
        self.schedule = get_scheduler(
            config.scheduler, base_lr=config.lr,
            warmup_steps=config.warmup_steps, total_steps=config.total_steps,
            min_lr_ratio=config.min_lr_ratio)
        mu_dtype = _MU_DTYPES[config.mu_dtype]
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype)
                   for n, p in self.params}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params}
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the gradient
        norm the clip used (before clipping). The ``.grad`` tensors are not
        changed."""
        cfg = self.config
        b1, b2 = cfg.betas
        grads = [p.grad for _, p in self.params]
        norm = global_norm(grads)
        clip = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm),
                           cfg.max_grad_norm / norm)
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for (name, p), g in zip(self.params, grads):
            g = g.float() * clip
            mu = self.mu[name].float().mul_(b1).add_(g, alpha=1.0 - b1)
            nu = self.nu[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            upd.add_(p, alpha=cfg.weight_decay)
            p.add_(upd, alpha=-lr)
            if self.mu[name] is not mu:
                self.mu[name].copy_(mu)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(self.mu),
                "nu": dict(self.nu)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name in self.mu:
            self.mu[name].copy_(state["mu"][name])
            self.nu[name].copy_(state["nu"][name])


def dropout_seed(step: int) -> int:
    """The step's LoRA dropout seed (the reference folds the step into
    ``PRNGKey(17)``)."""
    return (17 << 32) + int(step)


def compute_grads(model: nn.Module, loss_fn: Callable, micro_batches
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Fill each trainable parameter's ``.grad`` with the gradient of the
    mean loss over ``micro_batches``; ``loss_fn(model, batch) → (loss,
    metrics)``. Returns the mean loss and metrics (detached)."""
    params = [p for _, p in trainable_parameters(model)]
    for p in params:
        p.grad = None
    loss_sum, metrics_sum = None, {}
    for batch in micro_batches:
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        loss_sum = loss.detach() if loss_sum is None \
            else loss_sum + loss.detach()
        for k, v in metrics.items():
            metrics_sum[k] = metrics_sum.get(k, 0) + v.detach()
    n = len(micro_batches)
    if n > 1:
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.mul_(1.0 / n)
        loss_sum = loss_sum * (1.0 / n)
        metrics_sum = {k: v * (1.0 / n) for k, v in metrics_sum.items()}
    for p in params:
        if p.grad is None:      # unused on this batch: a zero gradient
            p.grad = torch.zeros_like(p)
    return loss_sum, metrics_sum


def make_train_step(model: nn.Module, loss_fn: Callable, optimizer: AdamW):
    """step(micro_batches) → (loss, metrics): gradients averaged over the
    micro-batches (one for no accumulation), then one optimizer update.
    ``metrics["grad_norm"]`` is the norm over the trainable gradients that
    the clip uses (the reference logs the norm over every float gradient,
    frozen ones included)."""
    def step(micro_batches):
        set_lora_dropout_seed(model, dropout_seed(optimizer.count))
        loss, metrics = compute_grads(model, loss_fn, micro_batches)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.step()
        return loss, metrics
    return step
