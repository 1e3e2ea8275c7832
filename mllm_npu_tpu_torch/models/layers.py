"""Linear and LayerNorm that compute in a set dtype.

The reference's flax layers cast their parameters to the module's compute
dtype at use, so weights may be stored in bf16 (``cast_params_bf16``)
under an fp32 compute, or in bf16 under a bf16 compute at full width.
These two keep torch's parameter names (``weight``, ``bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


class LayerNorm(nn.LayerNorm):
    """Statistics in fp32, output in the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)
