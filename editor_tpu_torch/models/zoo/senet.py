"""SENet family: se_resnet50/101 (+fc512), se_resnext50/101_32x4d
(``editor_tpu/models/zoo/senet.py``; reference: modeling/backbones/
basic_cnn_params/senet.py, inplanes 64, no 3x3 stem, 1x1 downsample,
reduction 16). SEResNetBottleneck strides conv1 (Caffe style), SEResNeXt
conv2 with base width 4; the SE module's 1x1 convolutions carry biases."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, SEModule, classifier_head, named, seq,
)


class SEBlock(nn.Module):
    def __init__(self, cin, planes, groups, stride, variant: str, down_needed: bool):
        super().__init__()
        if variant == "resnet":
            self.body = seq(Conv2d(cin, planes, 1, stride), BatchNorm(planes), nn.ReLU(),
                            Conv2d(planes, planes, 3, 1, 1, groups=groups), BatchNorm(planes),
                            nn.ReLU(), Conv2d(planes, planes * 4, 1), BatchNorm(planes * 4))
        else:  # resnext, base width 4
            width = int(math.floor(planes * (4 / 64.0)) * groups)
            self.body = seq(Conv2d(cin, width, 1), BatchNorm(width), nn.ReLU(),
                            Conv2d(width, width, 3, stride, 1, groups=groups), BatchNorm(width),
                            nn.ReLU(), Conv2d(width, planes * 4, 1), BatchNorm(planes * 4))
        self.se = SEModule(planes * 4, reduction=16)
        self.down = (seq(Conv2d(cin, planes * 4, 1, stride), BatchNorm(planes * 4))
                     if down_needed else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.se(self.body(x))
        return F.relu(y + (x if self.down is None else self.down(x)))


def _se_stage(cin, planes, blocks, stride, groups, variant) -> nn.Sequential:
    mods, c = [], cin
    for i in range(blocks):
        s = stride if i == 0 else 1
        mods.append(SEBlock(c, planes, groups, s, variant, s != 1 or c != planes * 4))
        c = planes * 4
    return seq(*mods)


def _senet(num_classes, layers, groups, variant, fc_dims=(), last_stride=2) -> nn.Module:
    return named(
        # the ceil_mode pool keeps Caffe weight compatibility (senet.py:364-367)
        layer0=seq(Conv2d(3, 64, 7, 2, 3), BatchNorm(64), nn.ReLU(),
                   nn.MaxPool2d(3, 2, 0, ceil_mode=True)),
        layer1=_se_stage(64, 64, layers[0], 1, groups, variant),
        layer2=_se_stage(256, 128, layers[1], 2, groups, variant),
        layer3=_se_stage(512, 256, layers[2], 2, groups, variant),
        layer4=_se_stage(1024, 512, layers[3], last_stride, groups, variant),
        pool=GlobalAvgPool(),
        head=classifier_head(2048, num_classes, fc_dims),
    )


def se_resnet50(nc): return _senet(nc, [3, 4, 6, 3], 1, "resnet")
def se_resnet101(nc): return _senet(nc, [3, 4, 23, 3], 1, "resnet")
def se_resnet50_fc512(nc): return _senet(nc, [3, 4, 6, 3], 1, "resnet", fc_dims=(512,),
                                         last_stride=1)
def se_resnext50_32x4d(nc): return _senet(nc, [3, 4, 6, 3], 32, "resnext")
def se_resnext101_32x4d(nc): return _senet(nc, [3, 4, 23, 3], 32, "resnext")
