"""OSNet and OSNet-AIN (``editor_tpu/models/zoo/osnet.py``; reference:
modeling/backbones/basic_cnn_params/{osnet,osnet_ain}.py).

OSBlock: a 1x1 bottleneck, four LightConv3x3 streams of depth 1-4 each gated
by one shared ChannelGate and summed, a linear 1x1 out and the residual.
OSNet's head is Linear(c3, 768); OSNet-AIN's Linear(c3, 512), with mixed
(OSBlock | OSBlockINin) stages and an InstanceNorm stem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, InstanceNorm, classifier_head, named, seq,
)


def _conv_layer(cin, cout, k, s=1, p=0, use_in=False) -> nn.Sequential:
    return seq(Conv2d(cin, cout, k, s, p), InstanceNorm(cout) if use_in else BatchNorm(cout),
               nn.ReLU())


def _conv1x1(cin, cout) -> nn.Sequential:
    return seq(Conv2d(cin, cout, 1), BatchNorm(cout), nn.ReLU())


def _conv1x1_linear(cin, cout, bn=True) -> nn.Sequential:
    return seq(Conv2d(cin, cout, 1), BatchNorm(cout) if bn else None)


def _light_conv3x3(cin, cout) -> nn.Sequential:
    # a linear 1x1 and a depthwise 3x3, one BN + ReLU after (osnet.py:128-160)
    return seq(Conv2d(cin, cout, 1), Conv2d(cout, cout, 3, 1, 1, groups=cout), BatchNorm(cout),
               nn.ReLU())


class ChannelGate(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = Conv2d(c, c // reduction, 1, bias=True)
        self.fc2 = Conv2d(c // reduction, c, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.relu(self.fc1(x.mean((2, 3), keepdim=True)))
        return x * torch.sigmoid(self.fc2(s))


class OSBlock(nn.Module):
    """``post_in``: OSNet's OSBlock(IN=True), InstanceNorm after the residual
    sum; ``in_inside``: OSNet-AIN's OSBlockINin, conv3 without BN and the
    InstanceNorm inside the residual (osnet_ain.py:271-302)."""

    def __init__(self, cin, cout, T=4, reduction=4, post_in=False, in_inside=False):
        super().__init__()
        mid = cout // reduction
        self.post_in, self.in_inside = post_in, in_inside
        self.conv1 = _conv1x1(cin, mid)
        self.streams = nn.ModuleList(
            seq(_light_conv3x3(mid, mid), *[_light_conv3x3(mid, mid) for _ in range(t - 1)])
            for t in range(1, T + 1))
        self.gate = ChannelGate(mid)
        self.conv3 = _conv1x1_linear(mid, cout, bn=not in_inside)
        self.down = _conv1x1_linear(cin, cout) if cin != cout else None
        self.IN = InstanceNorm(cout) if (post_in or in_inside) else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = None
        for stream in self.streams:
            g = self.gate(stream(x1))
            x2 = g if x2 is None else x2 + g
        x3 = self.conv3(x2)
        if self.in_inside:
            x3 = self.IN(x3)
        out = x3 + (x if self.down is None else self.down(x))
        if self.post_in:
            out = self.IN(out)
        return F.relu(out)


def _reduce(c) -> nn.Sequential:
    return seq(_conv1x1(c, c), nn.AvgPool2d(2, 2))


def osnet(num_classes, channels, use_in=False) -> nn.Module:
    """OSNet: three stages of two OSBlocks; the IN variant norms the stem
    and the first stage's blocks (osnet.py:310-321)."""
    c0, c1, c2, c3 = channels
    return named(
        conv1=_conv_layer(3, c0, 7, 2, 3, use_in=use_in),
        pool1=nn.MaxPool2d(3, 2, 1),
        conv2=seq(OSBlock(c0, c1, post_in=use_in), OSBlock(c1, c1, post_in=use_in), _reduce(c1)),
        conv3=seq(OSBlock(c1, c2), OSBlock(c2, c2), _reduce(c2)),
        conv4=seq(OSBlock(c2, c3), OSBlock(c3, c3)),
        conv5=_conv1x1(c3, c3),
        pool=GlobalAvgPool(),
        head=classifier_head(c3, num_classes, fc_dims=(768,)),
    )


def osnet_ain(num_classes, channels) -> nn.Module:
    """OSNet-AIN: blocks [[INin, INin], [OS, INin], [INin, OS]], an IN stem,
    fc 512 (osnet_ain.py:532-550)."""
    c0, c1, c2, c3 = channels
    A = lambda cin, cout: OSBlock(cin, cout, in_inside=True)  # noqa: E731
    return named(
        conv1=_conv_layer(3, c0, 7, 2, 3, use_in=True),
        pool1=nn.MaxPool2d(3, 2, 1),
        conv2=seq(A(c0, c1), A(c1, c1)),
        pool2=_reduce(c1),
        conv3=seq(OSBlock(c1, c2), A(c2, c2)),
        pool3=_reduce(c2),
        conv4=seq(A(c2, c3), OSBlock(c3, c3)),
        conv5=_conv1x1(c3, c3),
        pool=GlobalAvgPool(),
        head=classifier_head(c3, num_classes, fc_dims=(512,)),
    )


def osnet_x1_0(nc): return osnet(nc, [64, 256, 384, 512])
def osnet_x0_75(nc): return osnet(nc, [48, 192, 288, 384])
def osnet_x0_5(nc): return osnet(nc, [32, 128, 192, 256])
def osnet_x0_25(nc): return osnet(nc, [16, 64, 96, 128])
def osnet_ibn_x1_0(nc): return osnet(nc, [64, 256, 384, 512], use_in=True)
def osnet_ain_x1_0(nc): return osnet_ain(nc, [64, 256, 384, 512])
def osnet_ain_x0_75(nc): return osnet_ain(nc, [48, 192, 288, 384])
def osnet_ain_x0_5(nc): return osnet_ain(nc, [32, 128, 192, 256])
def osnet_ain_x0_25(nc): return osnet_ain(nc, [16, 64, 96, 128])
