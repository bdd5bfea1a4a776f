"""Xception (``editor_tpu/models/zoo/xception.py``; reference: modeling/
backbones/basic_cnn_params/xception.py: entry, middle and exit flows of
depthwise-separable blocks)."""

from __future__ import annotations

import torch
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, classifier_head, named, seq,
)


def _sep_conv(cin, cout, k=3, s=1, p=0) -> nn.Sequential:
    return seq(Conv2d(cin, cin, k, s, p, groups=cin), Conv2d(cin, cout, 1))


class XceptionBlock(nn.Module):
    def __init__(self, cin, cout, reps, stride=1, start_with_relu=True, grow_first=True):
        super().__init__()
        # skip and skipbn register before rep (xception.py:74-130)
        self.skip = (seq(Conv2d(cin, cout, 1, stride), BatchNorm(cout))
                     if (cout != cin or stride != 1) else None)
        rep, filters = [], cin
        if grow_first:
            rep += [nn.ReLU(), _sep_conv(cin, cout, 3, 1, 1), BatchNorm(cout)]
            filters = cout
        for _ in range(reps - 1):
            rep += [nn.ReLU(), _sep_conv(filters, filters, 3, 1, 1), BatchNorm(filters)]
        if not grow_first:
            rep += [nn.ReLU(), _sep_conv(cin, cout, 3, 1, 1), BatchNorm(cout)]
        if not start_with_relu:
            rep = rep[1:]
        if stride != 1:
            rep.append(nn.MaxPool2d(3, stride, 1))
        self.rep = seq(*rep)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rep(x) + (x if self.skip is None else self.skip(x))


def xception(num_classes) -> nn.Module:
    return named(
        stem=seq(Conv2d(3, 32, 3, 2), BatchNorm(32), nn.ReLU(), Conv2d(32, 64, 3), BatchNorm(64),
                 nn.ReLU()),
        blocks=seq(
            XceptionBlock(64, 128, 2, 2, start_with_relu=False),
            XceptionBlock(128, 256, 2, 2),
            XceptionBlock(256, 728, 2, 2),
            *[XceptionBlock(728, 728, 3, 1) for _ in range(8)],
            XceptionBlock(728, 1024, 2, 2, grow_first=False)),
        tail=seq(_sep_conv(1024, 1536, 3, 1, 1), BatchNorm(1536), nn.ReLU(),
                 _sep_conv(1536, 2048, 3, 1, 1), BatchNorm(2048), nn.ReLU()),
        pool=GlobalAvgPool(),
        head=classifier_head(2048, num_classes),
    )
