"""Normalization ops (twin of ``mllm_npu_tpu/ops/norms.py``).

RMSNorm: fp32 variance, cast back to the input dtype, weight applied
after the cast (Llama semantics)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (weight * xf.to(dtype)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf.to(dtype) * weight + bias).to(dtype)
