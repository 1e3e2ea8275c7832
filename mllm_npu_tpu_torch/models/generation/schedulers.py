"""Diffusion schedulers (twin of
``mllm_npu_tpu/models/generation/schedulers.py``: ``EulerDiscreteScheduler``
:22, ``DPMSolverPP2MScheduler`` :82, ``DDPMScheduler`` :123).

The schedule tables are built in float64 numpy at construction, as the
reference; ``make_schedule`` hands them out as fp32 tensors and every step
is fp32 tensor math. The denoise loop that drives them is a Python loop
over the steps (``adapter_modules.SDXLAdapter``), where the reference
compiles a ``lax.fori_loop``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _betas(start: float, end: float, n: int, schedule: str) -> np.ndarray:
    if schedule == "scaled_linear":
        return np.linspace(start ** 0.5, end ** 0.5, n) ** 2
    return np.linspace(start, end, n)


@dataclasses.dataclass
class EulerDiscreteScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    timestep_spacing: str = "leading"
    steps_offset: int = 1

    def __post_init__(self):
        betas = _betas(self.beta_start, self.beta_end,
                       self.num_train_timesteps, self.beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)
        self.alphas_cumprod = alphas_cumprod
        self.sigmas_all = np.sqrt((1 - alphas_cumprod) / alphas_cumprod)

    @property
    def init_noise_sigma(self) -> float:
        return float(np.sqrt(self.sigmas_all.max() ** 2 + 1))

    def make_schedule(self, num_inference_steps: int, device=None):
        """→ (timesteps [T], sigmas [T+1]) as fp32 tensors on ``device``
        (the CPU unless named)."""
        if self.timestep_spacing == "leading":
            step = self.num_train_timesteps // num_inference_steps
            ts = (np.arange(num_inference_steps) * step
                  + self.steps_offset).round()[::-1].astype(np.float64)
        else:  # linspace
            ts = np.linspace(0, self.num_train_timesteps - 1,
                             num_inference_steps)[::-1].astype(np.float64)
        sig = np.interp(ts, np.arange(self.num_train_timesteps),
                        self.sigmas_all)
        sig = np.concatenate([sig, [0.0]])
        as_t = lambda x: torch.as_tensor(x.astype(np.float32), device=device)
        return as_t(ts), as_t(sig)

    @staticmethod
    def scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
        return sample / torch.sqrt(sigma ** 2 + 1)

    @staticmethod
    def init_state(latents: torch.Tensor):
        """Per-trajectory solver state carried through the denoise loop
        (None: Euler is single-step)."""
        return None

    @staticmethod
    def step(model_output: torch.Tensor, sample: torch.Tensor, i: int, ts,
             sigmas, state=None):
        """Euler step, epsilon prediction. Returns (sample, state)."""
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        pred_original = sample - sigma * model_output
        derivative = (sample - pred_original) / sigma
        return sample + derivative * (sigma_next - sigma), state


@dataclasses.dataclass
class DPMSolverPP2MScheduler(EulerDiscreteScheduler):
    """DPM-Solver++(2M) in Euler's sigma space (k-diffusion
    ``sample_dpmpp_2m``, data prediction); the carried state is the
    previous step's x0 prediction. The first and the final step are first
    order, as the reference's."""
    timestep_spacing: str = "linspace"

    @staticmethod
    def init_state(latents: torch.Tensor):
        return torch.zeros_like(latents)

    @staticmethod
    def step(model_output: torch.Tensor, sample: torch.Tensor, i: int, ts,
             sigmas, state=None):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        x0 = sample - sigma * model_output              # data prediction
        t = -torch.log(sigma)
        t_next = -torch.log(torch.clamp(sigma_next, min=1e-10))
        h = t_next - t
        sigma_prev = sigmas[max(i - 1, 0)]
        h_last = t - (-torch.log(sigma_prev))
        r = h_last / torch.clamp(h, min=1e-12)
        # the unselected branch's NaNs (first step: r = 0) are discarded
        x0_d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * state
        first = (i == 0) or bool(sigma_next == 0.0)
        d = x0 if first else x0_d
        new = (sigma_next / sigma) * sample - torch.expm1(-h) * d
        return new, x0


@dataclasses.dataclass
class DDPMScheduler:
    """Training-side q(x_t | x_0) sampling and the epsilon target."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"

    def __post_init__(self):
        ac = np.cumprod(1.0 - _betas(self.beta_start, self.beta_end,
                                     self.num_train_timesteps,
                                     self.beta_schedule))
        self.sqrt_alphas_cumprod = torch.as_tensor(
            np.sqrt(ac).astype(np.float32))
        self.sqrt_one_minus = torch.as_tensor(
            np.sqrt(1 - ac).astype(np.float32))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  timesteps: torch.Tensor) -> torch.Tensor:
        idx = timesteps.long().cpu()
        a = self.sqrt_alphas_cumprod[idx].to(x0.device)
        b = self.sqrt_one_minus[idx].to(x0.device)
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return a.reshape(shape) * x0 + b.reshape(shape) * noise
