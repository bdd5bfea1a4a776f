"""Lightweight families: MobileNetV2 (torchreid's), ShuffleNet v1,
ShuffleNetV2, SqueezeNet (``editor_tpu/models/zoo/light.py``; reference:
modeling/backbones/basic_cnn_params/{mobilenetv2,shufflenet,shufflenetv2,
squeezenet}.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, classifier_head, named, seq,
)


# MobileNetV2 (torchreid keeps the expansion conv even at t = 1, mobilenetv2.py:40-67)

def _conv_block(cin, cout, k, s=1, p=0, g=1) -> nn.Sequential:
    return seq(Conv2d(cin, cout, k, s, p, groups=g), BatchNorm(cout), nn.ReLU6())


class MBV2Bottleneck(nn.Sequential):
    def __init__(self, cin, cout, t, stride):
        mid = cin * t
        super().__init__(_conv_block(cin, mid, 1), _conv_block(mid, mid, 3, stride, 1, g=mid),
                         Conv2d(mid, cout, 1), BatchNorm(cout))
        self.use_res = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return x + y if self.use_res else y


def mobilenetv2(num_classes, width_mult=1) -> nn.Module:
    w = lambda c: int(c * width_mult)  # noqa: E731
    feature = int(1280 * width_mult) if width_mult > 1 else 1280
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    mods, cin = [_conv_block(3, w(32), 3, 2, 1)], w(32)
    for t, c, n, s in cfg:
        for i in range(n):
            mods.append(MBV2Bottleneck(cin, w(c), t, s if i == 0 else 1))
            cin = w(c)
    mods.append(_conv_block(cin, feature, 1))
    return named(features=seq(*mods), pool=GlobalAvgPool(),
                 head=classifier_head(feature, num_classes))


def mobilenetv2_x1_0(nc): return mobilenetv2(nc, 1)
def mobilenetv2_x1_4(nc): return mobilenetv2(nc, 1.4)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel ``g * (C / groups) + i`` goes to ``i * groups + g`` (JAX's NHWC
    reshape-swap)."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(B, C, H, W)


# ShuffleNet v1 (groups 3; reference shufflenet.py:36-153)

class ShuffleV1Block(nn.Module):
    def __init__(self, cin, cout, stride, groups, group_conv1x1=True):
        super().__init__()
        mid = cout // 4
        if stride == 2:
            cout = cout - cin
        self.groups, self.stride = groups, stride
        self.c1 = seq(Conv2d(cin, mid, 1, groups=groups if group_conv1x1 else 1),
                      BatchNorm(mid), nn.ReLU())
        self.c2 = seq(Conv2d(mid, mid, 3, stride, 1, groups=mid), BatchNorm(mid))
        self.c3 = seq(Conv2d(mid, cout, 1, groups=groups), BatchNorm(cout))
        self.short = nn.AvgPool2d(3, 2, 1) if stride == 2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c3(self.c2(channel_shuffle(self.c1(x), self.groups)))
        if self.stride == 2:
            return F.relu(torch.cat([self.short(x), y], 1))
        return F.relu(x + y)


def shufflenet(num_classes, groups=3) -> nn.Module:
    c1, c2, c3 = {1: (144, 288, 576), 2: (200, 400, 800), 3: (240, 480, 960),
                  4: (272, 544, 1088), 8: (384, 768, 1536)}[groups]
    return named(
        conv1=seq(Conv2d(3, 24, 3, 2, 1), BatchNorm(24), nn.ReLU(), nn.MaxPool2d(3, 2, 1)),
        stage2=seq(ShuffleV1Block(24, c1, 2, groups, group_conv1x1=False),
                   *[ShuffleV1Block(c1, c1, 1, groups) for _ in range(3)]),
        stage3=seq(ShuffleV1Block(c1, c2, 2, groups),
                   *[ShuffleV1Block(c2, c2, 1, groups) for _ in range(7)]),
        stage4=seq(ShuffleV1Block(c2, c3, 2, groups),
                   *[ShuffleV1Block(c3, c3, 1, groups) for _ in range(3)]),
        pool=GlobalAvgPool(),
        head=classifier_head(c3, num_classes),
    )


# ShuffleNetV2 (reference shufflenetv2.py:29-200)

class ShuffleV2Unit(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        branch = cout // 2
        self.stride = stride
        # branch1 (left) registers before branch2 (right), shufflenetv2.py:51-86
        self.left = (seq(Conv2d(cin, cin, 3, stride, 1, groups=cin), BatchNorm(cin),
                         Conv2d(cin, branch, 1), BatchNorm(branch), nn.ReLU())
                     if stride > 1 else None)
        self.right = seq(Conv2d(cin if stride > 1 else cin // 2, branch, 1), BatchNorm(branch),
                         nn.ReLU(), Conv2d(branch, branch, 3, stride, 1, groups=branch),
                         BatchNorm(branch), Conv2d(branch, branch, 1), BatchNorm(branch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            left, right = self.left(x), self.right(x)
        else:
            half = x.shape[1] // 2
            left, right = x[:, :half], self.right(x[:, half:])
        return channel_shuffle(torch.cat([left, right], 1), 2)


def shufflenet_v2(num_classes, repeats, out_channels) -> nn.Module:
    stages, cin = {}, out_channels[0]
    for si, (reps, cout) in enumerate(zip(repeats, out_channels[1:4])):
        stages[f"stage{si + 2}"] = seq(ShuffleV2Unit(cin, cout, 2),
                                       *[ShuffleV2Unit(cout, cout, 1) for _ in range(reps - 1)])
        cin = cout
    return named(
        conv1=seq(Conv2d(3, out_channels[0], 3, 2, 1), BatchNorm(out_channels[0]), nn.ReLU(),
                  nn.MaxPool2d(3, 2, 1)),
        **stages,
        conv5=seq(Conv2d(cin, out_channels[4], 1), BatchNorm(out_channels[4]), nn.ReLU()),
        pool=GlobalAvgPool(),
        head=classifier_head(out_channels[4], num_classes),
    )


def shufflenet_v2_x0_5(nc): return shufflenet_v2(nc, [4, 8, 4], [24, 48, 96, 192, 1024])
def shufflenet_v2_x1_0(nc): return shufflenet_v2(nc, [4, 8, 4], [24, 116, 232, 464, 1024])
def shufflenet_v2_x1_5(nc): return shufflenet_v2(nc, [4, 8, 4], [24, 176, 352, 704, 1024])
def shufflenet_v2_x2_0(nc): return shufflenet_v2(nc, [4, 8, 4], [24, 244, 488, 976, 2048])


# SqueezeNet (reference squeezenet.py:19-117; the convolutions carry biases)

class Fire(nn.Module):
    def __init__(self, cin, s, e1, e3):
        super().__init__()
        self.s = Conv2d(cin, s, 1, bias=True)
        self.e1 = Conv2d(s, e1, 1, bias=True)
        self.e3 = Conv2d(s, e3, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.s(x))
        return torch.cat([F.relu(self.e1(y)), F.relu(self.e3(y))], 1)


def squeezenet(num_classes, version=1.0, fc_dims=()) -> nn.Module:
    pool = lambda: nn.MaxPool2d(3, 2, 0, ceil_mode=True)  # noqa: E731
    if version == 1.0:
        feats = seq(Conv2d(3, 96, 7, 2, 0, bias=True), nn.ReLU(), pool(),
                    Fire(96, 16, 64, 64), Fire(128, 16, 64, 64), Fire(128, 32, 128, 128), pool(),
                    Fire(256, 32, 128, 128), Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                    Fire(384, 64, 256, 256), pool(), Fire(512, 64, 256, 256))
    else:
        feats = seq(Conv2d(3, 64, 3, 2, 0, bias=True), nn.ReLU(), pool(),
                    Fire(64, 16, 64, 64), Fire(128, 16, 64, 64), pool(),
                    Fire(128, 32, 128, 128), Fire(256, 32, 128, 128), pool(),
                    Fire(256, 48, 192, 192), Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                    Fire(512, 64, 256, 256))
    return named(features=feats, pool=GlobalAvgPool(),
                 head=classifier_head(512, num_classes, fc_dims))


def squeezenet1_0(nc): return squeezenet(nc, 1.0)
def squeezenet1_1(nc): return squeezenet(nc, 1.1)
def squeezenet1_0_fc512(nc): return squeezenet(nc, 1.0, fc_dims=(512,))
