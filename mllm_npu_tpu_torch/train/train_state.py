"""Train step and optimizer (twin of ``mllm_npu_tpu/train/train_state.py``
for one device).

The trainable set is the model's parameters that require a gradient
(``models.factory.build_mllm(train=True)`` marks them, or
:func:`apply_frozen_patterns` by the reference's regexes); the frozen ones
never get a gradient or optimizer state, where the reference runs them
through ``optax.set_to_zero``. :class:`AdamW` is the reference's
``clip_by_global_norm → adamw`` chain written as plain tensor functions
with optax's semantics (:class:`Adafactor`, its ``adafactor`` chain, is
described in its class; :func:`build_optimizer` picks one by
``OptimizerConfig.optimizer``):

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    optimizer: str = "adamw"   # adamw | adafactor (build_optimizer)


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


class _ClippedOptimizer:
    """What AdamW and Adafactor share: the trainable ``params``, the
    schedule, ``count`` (the number of updates applied), the global-norm
    clip and the state as the per-parameter tensor dicts named in
    ``_STATE``."""
    _STATE: Tuple[str, ...] = ()

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 config: OptimizerConfig):
        self.params = list(params)
        self.config = config
        self.schedule = get_scheduler(
            config.scheduler, base_lr=config.lr,
            warmup_steps=config.warmup_steps, total_steps=config.total_steps,
            min_lr_ratio=config.min_lr_ratio)
        self.count = 0

    def _clip(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the norm of the trainable gradients, the factor that clips them
        to ``max_grad_norm``: ``min(1, max_norm / norm)``)."""
        norm = global_norm([p.grad for _, p in self.params])
        max_norm = self.config.max_grad_norm
        return norm, torch.where(norm < max_norm, torch.ones_like(norm),
                                 max_norm / norm)

    def state_dict(self) -> dict:
        return {"count": self.count,
                **{k: dict(getattr(self, k)) for k in self._STATE}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for k in self._STATE:
            for name, t in getattr(self, k).items():
                t.copy_(state[k][name])


class AdamW(_ClippedOptimizer):
    """AdamW with global-norm clipping over ``params`` (see the module
    docstring for the exact semantics)."""
    _STATE = ("mu", "nu")

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 config: OptimizerConfig):
        super().__init__(params, config)
        mu_dtype = _MU_DTYPES[config.mu_dtype]
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype)
                   for n, p in self.params}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in self.params}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the gradient
        norm the clip used (before clipping). The ``.grad`` tensors are not
        changed."""
        cfg = self.config
        b1, b2 = cfg.betas
        norm, clip = self._clip()
        lr = self.schedule(self.count)
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for name, p in self.params:
            g = p.grad.float() * clip
            mu = self.mu[name].float().mul_(b1).add_(g, alpha=1.0 - b1)
            nu = self.nu[name].mul_(b2).addcmul_(g, g, value=1.0 - b2)
            upd = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
            upd.add_(p, alpha=cfg.weight_decay)
            p.add_(upd, alpha=-lr)
            if self.mu[name] is not mu:
                self.mu[name].copy_(mu)
        return norm


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """The two largest dims (second largest, largest) of ``shape`` when
    the second is at least ``min_dim_size_to_factor``, else None (optax's
    ``_factored_dims``; ties keep the earlier dim first, as its argsort)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class Adafactor(_ClippedOptimizer):
    """The reference's ``clip_by_global_norm → optax.adafactor`` chain as
    ``build_optimizer`` configures it (``min_dim_size_to_factor=128``,
    ``multiply_by_parameter_scale=False``, ``clipping_threshold=None``,
    ``momentum=betas[0]``, ``weight_decay_rate=weight_decay``):

    - the clipped gradient's second moment, with β₂ = 1 − (t+1)^−0.8 at the
      t-th update and ε = 1e-30 added to g²: factored over the two largest
      dims (:func:`factored_dims`) into a row and a column mean, otherwise
      full; the update is g / √v̂, with v̂ = row · col / mean(row);
    - times the schedule's rate, then an EMA of that (``momentum``, no
      bias correction) stored in ``mu_dtype``, whose fp32 value is used;
    - then ``weight_decay · p`` is added AFTER the rate: each step takes
      ``weight_decay`` of every trainable weight away, whatever the rate
      (the reference's semantics; ROADMAP, known issues of the reference).

    The port's Linear weights are the transposes of the reference's
    kernels; the factored estimate is symmetric in its two dims, so the
    update is the same, element for element, up to rounding. A port
    parameter that stacks several of the reference's along dim 0 (the
    attention's fused ``in_proj`` weight, q, k and v: ``splits[name] =
    3``) keeps one second moment per stacked block, as the reference
    does for each of its kernels."""
    _STATE = ("mu", "v_row", "v_col", "v")

    def __init__(self, params: Sequence[Tuple[str, nn.Parameter]],
                 config: OptimizerConfig,
                 splits: Optional[Dict[str, int]] = None):
        super().__init__(params, config)
        mu_dtype = _MU_DTYPES[config.mu_dtype]
        self.mu = {n: torch.zeros_like(p, dtype=mu_dtype)
                   for n, p in self.params}
        # the second moment per block: the parameter itself, or its
        # splits[name] chunks along dim 0 (keys name[i])
        self.splits = dict(splits or {})
        self.dims, self.v_row, self.v_col, self.v = {}, {}, {}, {}
        for n, p in self.params:
            for key, block in self._blocks(n, p):
                dims = self.dims[key] = factored_dims(block.shape)
                if dims is None:
                    self.v[key] = torch.zeros_like(block)
                else:
                    d1, d0 = dims
                    self.v_row[key] = torch.zeros_like(block.select(d0, 0))
                    self.v_col[key] = torch.zeros_like(block.select(d1, 0))

    def _blocks(self, name: str, t: torch.Tensor):
        n = self.splits.get(name, 1)
        if n == 1:
            return [(name, t)]
        return [(f"{name}[{i}]", b) for i, b in enumerate(t.chunk(n))]

    def _scaled(self, key: str, g: torch.Tensor, beta2: float
                ) -> torch.Tensor:
        """g / √v̂ for one block, its second moment updated in place."""
        g2 = g * g + 1e-30
        dims = self.dims[key]
        if dims is None:
            v = self.v[key].mul_(beta2).add_(g2, alpha=1.0 - beta2)
            return g * v.rsqrt()
        d1, d0 = dims
        row = self.v_row[key].mul_(beta2).add_(g2.mean(d0),
                                               alpha=1.0 - beta2)
        col = self.v_col[key].mul_(beta2).add_(g2.mean(d1),
                                               alpha=1.0 - beta2)
        row_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (row / row.mean(row_d1, keepdim=True)).rsqrt()
        return g * row_factor.unsqueeze(d0) * col.rsqrt().unsqueeze(d1)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the gradient
        norm the clip used (before clipping)."""
        cfg = self.config
        b1 = cfg.betas[0]
        norm, clip = self._clip()
        lr = self.schedule(self.count)
        # the decay schedule in fp32, as optax computes it
        beta2 = float(1.0 - torch.tensor(self.count + 1.0) ** -0.8)
        self.count += 1
        for name, p in self.params:
            g = p.grad.float() * clip
            upd = torch.cat([self._scaled(key, b, beta2)
                             for key, b in self._blocks(name, g)])
            # EMA of the rate-scaled update; decay·mu is a product in mu's
            # dtype, the decay rounded to it first (JAX's weak-typed scalar)
            m = self.mu[name]
            decay = float(torch.tensor(b1, dtype=m.dtype))
            mu = (m * decay).float().add_(upd.mul_(lr), alpha=1.0 - b1)
            if m is not mu:
                m.copy_(mu)
            p.sub_(torch.add(mu, p, alpha=cfg.weight_decay))
        return norm


def fused_qkv_splits(params: Sequence[Tuple[str, nn.Parameter]]
                     ) -> Dict[str, int]:
    """{name: 3} for each fused q/k/v projection weight among ``params``
    (``…in_proj_weight``, ``…in_proj.weight``), which the reference holds as
    three kernels."""
    return {n: 3 for n, p in params
            if n.endswith(("in_proj_weight", "in_proj.weight"))
            and p.dim() == 2}


def build_optimizer(params: Sequence[Tuple[str, nn.Parameter]],
                    config: OptimizerConfig) -> _ClippedOptimizer:
    """``config.optimizer``'s optimizer over ``params`` (the reference's
    ``build_optimizer``): ``adamw``, or ``adafactor`` with the fused q/k/v
    weights' blocks (:func:`fused_qkv_splits`)."""
    if config.optimizer == "adamw":
        return AdamW(params, config)
    if config.optimizer == "adafactor":
        params = list(params)
        return Adafactor(params, config, splits=fused_qkv_splits(params))
    raise ValueError(f"optimizer {config.optimizer!r}: the reference has "
                     "adamw and adafactor")


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


def make_train_step(model: nn.Module, loss_fn: Callable,
                    optimizer: _ClippedOptimizer):
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
