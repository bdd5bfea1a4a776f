"""Layers the CNN zoo's families share (``editor_tpu/models/zoo/common.py``),
as ``nn.Module``s.

Layout: NCHW activations, OIHW convolution weights, ``[out, in]`` linear
weights (the JAX package's NHWC / HWIO / ``[in, out]``, same numel). The zoo
is inference only: BatchNorm normalises with its running statistics in any
mode.

dtype: every weight is cast to the input's dtype at its use, as JAX's
``apply`` does, so a bf16 forward (bf16 images into fp32 weights) runs bf16
convolutions and products; BatchNorm computes in ``promote(x.dtype, fp32)``
and casts back (fp32 statistics math under bf16, exact under f64). These are
explicit casts, not autocast. InstanceNorm stays in the input's dtype with
its affine weights cast to it (JAX's ``in2d`` promotes a bf16 input to fp32
there, and its later layers run in fp32).

Pools are ``nn.MaxPool2d`` / ``nn.AvgPool2d``. torch's ceil_mode drops a
last window that would start in the right padding, where JAX's
(``common.py:152-170``) keeps it; the two agree at padding 0, the only
padding the zoo's ceil_mode pools use.

Registration order: every module registers its children in the order the
JAX DSL builds its parameters, the reference's torch order, so the ordered
importer (``utils/zoo_import.py``) zips checkpoints by position.

Seeded init (``init_weights``) follows JAX's distributions, drawn from one
CPU ``torch.Generator`` in registration order: convolutions normal with std
``sqrt(2 / fan_in)`` (``fan_in = kh * kw * cin / groups``), linear weights
uniform in ``+-1 / sqrt(cin)``, biases 0, norms weight 1 and bias 0, running
mean 0 and variance 1. The values are not JAX's for the same seed.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _fill(t: torch.Tensor, draw) -> None:
    cpu = torch.empty(t.shape, dtype=torch.float32)
    draw(cpu)
    t.copy_(cpu)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight (and bias) run in the input's dtype."""

    def __init__(self, cin: int, cout: int, k, stride=1, padding=0, groups: int = 1,
                 bias: bool = False, dilation=1):
        super().__init__(cin, cout, k, stride, padding, dilation, groups, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding,
                        self.dilation, self.groups)

    def init_(self, gen: torch.Generator) -> None:
        kh, kw = self.kernel_size
        std = (2.0 / max(kh * kw * self.in_channels // self.groups, 1)) ** 0.5
        _fill(self.weight, lambda t: t.normal_(0.0, std, generator=gen))
        if self.bias is not None:
            self.bias.zero_()


class Linear(nn.Linear):
    """``nn.Linear`` whose weight (and bias) run in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)

    def init_(self, gen: torch.Generator) -> None:
        bound = (1.0 / self.in_features) ** 0.5
        _fill(self.weight, lambda t: t.uniform_(-bound, bound, generator=gen))
        if self.bias is not None:
            self.bias.zero_()


class BatchNorm(nn.BatchNorm2d):
    """Inference BatchNorm over the channel axis of ``[B, C, H, W]`` or
    ``[B, C]`` (JAX's ``bn2d`` and ``bn1d``). ``bias=False`` is a BN whose
    bias is frozen at zero (``requires_grad`` False: out of the trainable
    count and of the importer's slots, as CAL's are). ``eps`` 1e-3 for the
    TensorFlow-derived nets."""

    def __init__(self, c: int, eps: float = 1e-5, bias: bool = True):
        super().__init__(c, eps=eps)
        self.frozen_bias = not bias
        if not bias:
            self.bias.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)
        y = F.batch_norm(x.to(ct), self.running_mean.to(ct), self.running_var.to(ct),
                         self.weight.to(ct), self.bias.to(ct), False, 0.0, self.eps)
        return y.to(x.dtype)

    def init_(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()


class InstanceNorm(nn.InstanceNorm2d):
    """Affine InstanceNorm2d (every use in the zoo is affine), eps 1e-5, in
    the input's dtype."""

    def __init__(self, c: int):
        super().__init__(c, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, weight=self.weight.to(x.dtype), bias=self.bias.to(x.dtype),
                               eps=self.eps)

    def init_(self, gen: torch.Generator) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()


class GlobalAvgPool(nn.Module):
    """``[B, C, H, W]`` -> ``[B, C]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean((2, 3))


def seq(*mods: Optional[nn.Module]) -> nn.Sequential:
    return nn.Sequential(*[m for m in mods if m is not None])


def named(**mods: nn.Module) -> nn.Sequential:
    return nn.Sequential(OrderedDict(mods))


class ParallelConcat(nn.Module):
    """Branches on the same input, outputs concatenated over channels."""

    def __init__(self, *branches: nn.Module):
        super().__init__()
        self.branches = nn.ModuleList(branches)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([b(x) for b in self.branches], 1)


class Residual(nn.Module):
    """``post(body(x) + (down or identity)(x))``; ``post`` None: no
    activation."""

    def __init__(self, body: nn.Module, down: Optional[nn.Module] = None,
                 post: Optional[Callable] = F.relu):
        super().__init__()
        self.body = body
        self.down = down
        self.post = post

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.body(x) + (x if self.down is None else self.down(x))
        return y if self.post is None else self.post(y)


class SEModule(nn.Module):
    """Squeeze-and-excitation with 1x1 convolutions (pretrainedmodels'
    SEModule)."""

    def __init__(self, channels: int, reduction: int, bias: bool = True):
        super().__init__()
        self.fc1 = Conv2d(channels, channels // reduction, 1, bias=bias)
        self.fc2 = Conv2d(channels // reduction, channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


def classifier_head(feature_dim: int, num_classes: int,
                    fc_dims: Sequence[int] = ()) -> nn.Sequential:
    """torchreid's ``_construct_fc_layer`` (Linear, BN, ReLU per width) and
    the classifier."""
    mods, d = [], feature_dim
    for dim in fc_dims:
        mods += [Linear(d, dim), BatchNorm(dim), nn.ReLU()]
        d = dim
    mods.append(Linear(d, num_classes))
    return seq(*mods)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter and buffer of a zoo model from one CPU generator
    seeded ``seed``, module by module in registration order."""
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "init_"):
            m.init_(gen)
    return model


def count_params(model: nn.Module) -> int:
    """The trainable count, ``tests/test_cnn_zoo.py``'s torch oracle: BN
    running statistics are buffers and frozen BN biases do not count."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)
