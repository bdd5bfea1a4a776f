"""ResNet family: resnet18/34/50/101/152, ResNeXt, fc512, IBN-a/b, PCB,
resnet50mid (``editor_tpu/models/zoo/resnet.py``; reference:
modeling/backbones/basic_cnn_params/{resnet,resnet_ibn_a,resnet_ibn_b,pcb,
resnetmid}.py)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, InstanceNorm, Linear, Residual, classifier_head, named, seq,
)


def _basic_block(cin, planes, stride=1) -> nn.Module:
    body = seq(Conv2d(cin, planes, 3, stride, 1), BatchNorm(planes), nn.ReLU(),
               Conv2d(planes, planes, 3, 1, 1), BatchNorm(planes))
    down = None
    if stride != 1 or cin != planes:
        down = seq(Conv2d(cin, planes, 1, stride), BatchNorm(planes))
    return Residual(body, down)


class IBNNorm(nn.Module):
    """IBN-a's split norm: InstanceNorm on the first half of the channels,
    BatchNorm on the rest (reference resnet_ibn_a.py:63-78)."""

    def __init__(self, planes: int):
        super().__init__()
        self.half = planes // 2
        self.IN = InstanceNorm(self.half)
        self.BN = BatchNorm(planes - self.half)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.IN(x[:, :self.half]), self.BN(x[:, self.half:])], 1)


class IBNBBlock(nn.Module):
    """IBN-b's last block of a stage: InstanceNorm on the pre-ReLU residual
    sum, then one ReLU (reference resnet_ibn_b.py:104-110)."""

    def __init__(self, block: Residual, planes: int):
        super().__init__()
        self.blk = block
        self.IN = InstanceNorm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.IN(self.blk(x)))


def _bottleneck(cin, planes, stride=1, groups=1, base_width=64, ibn: str = "",
                post_in: bool = False) -> nn.Module:
    """torchvision's Bottleneck (stride on conv2); ``ibn='a'`` swaps bn1 for
    the IBN split; ``post_in``: IBN-b's InstanceNorm after the sum."""
    width = int(planes * (base_width / 64.0)) * groups
    n1 = IBNNorm(width) if ibn == "a" else BatchNorm(width)
    body = seq(Conv2d(cin, width, 1), n1, nn.ReLU(),
               Conv2d(width, width, 3, stride, 1, groups=groups), BatchNorm(width), nn.ReLU(),
               Conv2d(width, planes * 4, 1), BatchNorm(planes * 4))
    down = None
    if stride != 1 or cin != planes * 4:
        down = seq(Conv2d(cin, planes * 4, 1, stride), BatchNorm(planes * 4))
    if not post_in:
        return Residual(body, down)
    return IBNBBlock(Residual(body, down, post=None), planes * 4)


def _stage(cin, planes, blocks, stride, groups=1, base_width=64, block="bottleneck",
           ibn="", last_in=False) -> nn.Sequential:
    mods, c = [], cin
    for i in range(blocks):
        s = stride if i == 0 else 1
        if block == "basic":
            mods.append(_basic_block(c, planes, s))
            c = planes
        else:
            mods.append(_bottleneck(c, planes, s, groups, base_width, ibn=ibn,
                                    post_in=last_in and i == blocks - 1))
            c = planes * 4
    return seq(*mods)


def _stem(norm: nn.Module = None) -> nn.Sequential:
    return seq(Conv2d(3, 64, 7, 2, 3), norm if norm is not None else BatchNorm(64), nn.ReLU(),
               nn.MaxPool2d(3, 2, 1))


def _resnet(num_classes, layers: Sequence[int], block="bottleneck", groups=1, base_width=64,
            fc_dims=(), last_stride=2, ibn: str = "", stem_in: bool = False) -> nn.Module:
    exp = 1 if block == "basic" else 4
    # IBN-a in the stages with planes != 512 (resnet_ibn_a.py:198-200); IBN-b
    # an InstanceNorm stem and one after layer1 and layer2 (resnet_ibn_b.py:142-153)
    return named(
        stem=_stem(InstanceNorm(64) if stem_in else None),
        layer1=_stage(64, 64, layers[0], 1, groups, base_width, block, ibn=ibn,
                      last_in=stem_in),
        layer2=_stage(64 * exp, 128, layers[1], 2, groups, base_width, block, ibn=ibn,
                      last_in=stem_in),
        layer3=_stage(128 * exp, 256, layers[2], 2, groups, base_width, block, ibn=ibn),
        layer4=_stage(256 * exp, 512, layers[3], last_stride, groups, base_width, block),
        pool=GlobalAvgPool(),
        head=classifier_head(512 * exp, num_classes, fc_dims),
    )


def resnet18(nc): return _resnet(nc, [2, 2, 2, 2], "basic")
def resnet34(nc): return _resnet(nc, [3, 4, 6, 3], "basic")
def resnet50(nc): return _resnet(nc, [3, 4, 6, 3])
def resnet101(nc): return _resnet(nc, [3, 4, 23, 3])
def resnet152(nc): return _resnet(nc, [3, 8, 36, 3])
def resnext50_32x4d(nc): return _resnet(nc, [3, 4, 6, 3], groups=32, base_width=4)
def resnext101_32x8d(nc): return _resnet(nc, [3, 4, 23, 3], groups=32, base_width=8)
def resnet50_fc512(nc): return _resnet(nc, [3, 4, 6, 3], fc_dims=(512,), last_stride=1)
def resnet50_ibn_a(nc): return _resnet(nc, [3, 4, 6, 3], ibn="a")
def resnet50_ibn_b(nc): return _resnet(nc, [3, 4, 6, 3], stem_in=True)


class PCB(nn.Module):
    """Part-based Convolutional Baseline (reference pcb.py:16-56): resnet50
    with last stride 1, ``parts`` horizontal stripes, a shared 1x1 reduction
    and one classifier a part; ``forward`` returns ``[B, parts, nc]``.

    The stripes are ``AdaptiveAvgPool2d((parts, 1))``, the reference's. JAX's
    ``pcb`` averages ``H // parts`` rows a stripe and drops the rest: the
    same where ``parts`` divides the trunk's height, not elsewhere (pcb_p6
    at 256x128, height 16)."""

    def __init__(self, num_classes: int, parts: int, reduced_dim: int = 256):
        super().__init__()
        self.parts = parts
        self.trunk = named(stem=_stem(), layer1=_stage(64, 64, 3, 1),
                           layer2=_stage(256, 128, 4, 2), layer3=_stage(512, 256, 6, 2),
                           layer4=_stage(1024, 512, 3, 1))
        self.reduce = seq(Conv2d(2048, reduced_dim, 1), BatchNorm(reduced_dim), nn.ReLU())
        self.heads = nn.ModuleList(Linear(reduced_dim, num_classes) for _ in range(parts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.adaptive_avg_pool2d(self.trunk(x), (self.parts, 1))   # [B, 2048, parts, 1]
        g = self.reduce(y)[..., 0]                                   # [B, reduced, parts]
        return torch.stack([h(g[:, :, i]) for i, h in enumerate(self.heads)], 1)


def pcb_p6(nc): return PCB(nc, parts=6)
def pcb_p4(nc): return PCB(nc, parts=4)


class ResNet50Mid(nn.Module):
    """resnet50 with mid-level fusion (reference resnetmid.py:108-290):
    layer4's three block outputs pooled, the first two concatenated through
    ``fusion`` (1024-d), the feature ``[fused, v4c]`` (3072-d)."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.trunk = named(stem=_stem(), layer1=_stage(64, 64, 3, 1),
                           layer2=_stage(256, 128, 4, 2), layer3=_stage(512, 256, 6, 2))
        self.l4a = _bottleneck(1024, 512, 2)
        self.l4b = _bottleneck(2048, 512, 1)
        self.l4c = _bottleneck(2048, 512, 1)
        self.fusion = seq(Linear(4096, 1024), BatchNorm(1024), nn.ReLU())
        self.head = Linear(3072, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.l4a(self.trunk(x))
        b = self.l4b(a)
        c = self.l4c(b)
        fused = self.fusion(torch.cat([a.mean((2, 3)), b.mean((2, 3))], 1))
        return self.head(torch.cat([fused, c.mean((2, 3))], 1))


def resnet50mid(nc): return ResNet50Mid(nc)
