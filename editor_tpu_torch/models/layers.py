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


def drop_path(x: torch.Tensor, rate: float, u: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample stochastic depth (``_drop_path_scan``): ``u`` holds one
    uniform [0, 1) draw per sample, shaped to broadcast over ``x`` (None in
    eval: identity). A sample survives when ``keep + u >= 1`` and is scaled
    by 1/keep. Like the JAX function, the branch is rounded through fp32
    even at rate 0 (so an fp64 run keeps fp32 precision there)."""
    if u is None:
        return x
    keep = 1.0 - rate
    y = x.to(torch.float32) / keep
    if rate > 0:
        y = y * torch.floor(keep + u)
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            width: Optional[int] = None, offset: int = 0) -> torch.Tensor:
    """Inverted dropout with an explicit generator (identity at rate 0 or
    without a generator, as ``layers.dropout`` without a key). ``width``:
    ``x`` is the columns ``offset:offset + x.shape[-1]`` of a tensor that
    many wide (a tensor-parallel shard): the draws are the full tensor's,
    so every shard of it drops what the whole would."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = x.shape if width is None else x.shape[:-1] + (width,)
    u = torch.rand(shape, generator=generator, device=x.device, dtype=torch.float32)
    if width is not None:
        u = u[..., offset:offset + x.shape[-1]]
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class BatchNorm1d(nn.Module):
    """BN-neck head over [B, C] (``layers.batchnorm1d``): in training it
    normalises with the biased batch variance and moves the running stats by
    ``momentum`` towards the batch mean and the unbiased batch variance, in
    place (``num_batches_tracked`` counts the updates, as torch's does); in
    eval it normalises with the running stats. Math in at least fp32, the
    output in x's dtype."""

    eps, momentum = 1e-5, 0.1  # torch's defaults, as batchnorm1d_init

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = new_param(dim, device=device)
        self.bias = new_param(dim, device=device)
        self.register_buffer("running_mean", torch.empty(dim, device=device))
        self.register_buffer("running_var", torch.empty(dim, device=device))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        cd = compute_dtype(x.dtype)
        xf = x.to(cd)
        if training:
            mu = xf.mean(dim=0)
            var = (xf - mu).square().mean(dim=0)
            n = x.shape[0]
            with torch.no_grad():
                m = self.momentum
                unbiased = var.detach() * (n / max(n - 1, 1))
                rm, rv = self.running_mean, self.running_var
                rm.copy_((1 - m) * rm + m * mu.detach().to(rm.dtype))
                rv.copy_((1 - m) * rv + m * unbiased.to(rv.dtype))
                self.num_batches_tracked += 1
        else:
            mu, var = self.running_mean.to(cd), self.running_var.to(cd)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight.to(cd) + self.bias.to(cd)).to(x.dtype)
