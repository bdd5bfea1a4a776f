"""Building blocks: plain functions on tensors, and the small modules that
hold their parameters under the reference's state_dict key names.

Counterpart of ``editor_tpu/models/layers.py``. Parameters keep torch's
layout (Linear weight [out, in]) so a reference or exported checkpoint loads
with ``load_state_dict(strict=True)``; they stay in their own dtype (fp32 by
default) and are cast to the activation's dtype at each use, as the JAX
package does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.ops._checks import compute_dtype


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W^T with W cast to x's dtype; the bias is added in that dtype
    (a separate add, not a fused epilogue, like ``layers.linear``)."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float) -> torch.Tensor:
    """LayerNorm in at least fp32 (bf16 upcast, fp64 stays fp64), cast back."""
    cd = compute_dtype(x.dtype)
    y = F.layer_norm(x.to(cd), x.shape[-1:], weight.to(cd), bias.to(cd), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (torch nn.GELU default)."""
    return F.gelu(x)


def new_param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = True, device=None):
        super().__init__()
        self.weight = new_param(d_out, d_in, device=device)
        self.bias = new_param(d_out, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = new_param(dim, device=device)
        self.bias = new_param(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.weight, self.bias, self.eps)


class BatchNorm1d(nn.Module):
    """Parameters and running stats of a BN-neck head, kept so that a
    checkpoint loads strictly. The eval output (``cls4t``) never uses it:
    the heads it feeds score training losses only."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = new_param(dim, device=device)
        self.bias = new_param(dim, device=device)
        self.register_buffer("running_mean", torch.empty(dim, device=device))
        self.register_buffer("running_var", torch.empty(dim, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))
