"""InceptionV4 and Inception-ResNet-V2 (``editor_tpu/models/zoo/
inception.py``; reference: modeling/backbones/basic_cnn_params/{inceptionv4,
inceptionresnetv2}.py: BasicConv2d = bias-free conv + BN (eps 1e-3) + ReLU,
"VALID" strides at padding 0, average pools that leave the padding out)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, ParallelConcat, classifier_head, named, seq,
)


def _bc(cin, cout, k, s=1, p=0) -> nn.Sequential:
    """BasicConv2d (BN eps 0.001, reference inceptionv4.py:51)."""
    return seq(Conv2d(cin, cout, k, s, p), BatchNorm(cout, eps=1e-3), nn.ReLU())


def _avg31() -> nn.Module:
    return nn.AvgPool2d(3, 1, 1, count_include_pad=False)


class ResidualScaled(nn.Module):
    """Inception-ResNet block: the branches' concat, a 1x1 conv with bias,
    ``out * scale + x`` (Block35/17/8)."""

    def __init__(self, branches: nn.Module, proj: nn.Module, scale: float,
                 final_relu: bool = True):
        super().__init__()
        self.branches, self.proj = branches, proj
        self.scale, self.final_relu = scale, final_relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.proj(self.branches(x)) * self.scale + x
        return F.relu(out) if self.final_relu else out


# InceptionV4 (inceptionv4.py:37-260)

def _mixed_3a():
    return ParallelConcat(nn.MaxPool2d(3, 2), _bc(64, 96, 3, 2))


def _mixed_4a():
    return ParallelConcat(
        seq(_bc(160, 64, 1), _bc(64, 96, 3)),
        seq(_bc(160, 64, 1), _bc(64, 64, (1, 7), 1, (0, 3)), _bc(64, 64, (7, 1), 1, (3, 0)),
            _bc(64, 96, 3)))


def _mixed_5a():
    return ParallelConcat(_bc(192, 192, 3, 2), nn.MaxPool2d(3, 2))


def _inception_a():
    return ParallelConcat(
        _bc(384, 96, 1),
        seq(_bc(384, 64, 1), _bc(64, 96, 3, 1, 1)),
        seq(_bc(384, 64, 1), _bc(64, 96, 3, 1, 1), _bc(96, 96, 3, 1, 1)),
        seq(_avg31(), _bc(384, 96, 1)))


def _reduction_a():
    return ParallelConcat(
        _bc(384, 384, 3, 2),
        seq(_bc(384, 192, 1), _bc(192, 224, 3, 1, 1), _bc(224, 256, 3, 2)),
        nn.MaxPool2d(3, 2))


def _inception_b():
    return ParallelConcat(
        _bc(1024, 384, 1),
        seq(_bc(1024, 192, 1), _bc(192, 224, (1, 7), 1, (0, 3)),
            _bc(224, 256, (7, 1), 1, (3, 0))),
        seq(_bc(1024, 192, 1), _bc(192, 192, (7, 1), 1, (3, 0)),
            _bc(192, 224, (1, 7), 1, (0, 3)), _bc(224, 224, (7, 1), 1, (3, 0)),
            _bc(224, 256, (1, 7), 1, (0, 3))),
        seq(_avg31(), _bc(1024, 128, 1)))


def _reduction_b():
    return ParallelConcat(
        seq(_bc(1024, 192, 1), _bc(192, 192, 3, 2)),
        seq(_bc(1024, 256, 1), _bc(256, 256, (1, 7), 1, (0, 3)),
            _bc(256, 320, (7, 1), 1, (3, 0)), _bc(320, 320, 3, 2)),
        nn.MaxPool2d(3, 2))


class InceptionC(nn.Module):
    def __init__(self):
        super().__init__()
        self.b0 = _bc(1536, 256, 1)
        self.b1_0 = _bc(1536, 384, 1)
        self.b1_1a = _bc(384, 256, (1, 3), 1, (0, 1))
        self.b1_1b = _bc(384, 256, (3, 1), 1, (1, 0))
        self.b2_0 = _bc(1536, 384, 1)
        self.b2_1 = _bc(384, 448, (3, 1), 1, (1, 0))
        self.b2_2 = _bc(448, 512, (1, 3), 1, (0, 1))
        self.b2_3a = _bc(512, 256, (1, 3), 1, (0, 1))
        self.b2_3b = _bc(512, 256, (3, 1), 1, (1, 0))
        self.b3 = seq(_avg31(), _bc(1536, 256, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.b1_0(x)
        x2 = self.b2_2(self.b2_1(self.b2_0(x)))
        return torch.cat([self.b0(x), self.b1_1a(x1), self.b1_1b(x1), self.b2_3a(x2),
                          self.b2_3b(x2), self.b3(x)], 1)


def inceptionv4(num_classes) -> nn.Module:
    return named(
        features=seq(
            _bc(3, 32, 3, 2), _bc(32, 32, 3), _bc(32, 64, 3, 1, 1),
            _mixed_3a(), _mixed_4a(), _mixed_5a(),
            *[_inception_a() for _ in range(4)], _reduction_a(),
            *[_inception_b() for _ in range(7)], _reduction_b(),
            *[InceptionC() for _ in range(3)]),
        pool=GlobalAvgPool(),
        head=classifier_head(1536, num_classes),
    )


# Inception-ResNet-V2 (inceptionresnetv2.py:37-270)

def _mixed_5b():
    return ParallelConcat(
        _bc(192, 96, 1),
        seq(_bc(192, 48, 1), _bc(48, 64, 5, 1, 2)),
        seq(_bc(192, 64, 1), _bc(64, 96, 3, 1, 1), _bc(96, 96, 3, 1, 1)),
        seq(_avg31(), _bc(192, 64, 1)))


def _block35(scale):
    branches = ParallelConcat(
        _bc(320, 32, 1),
        seq(_bc(320, 32, 1), _bc(32, 32, 3, 1, 1)),
        seq(_bc(320, 32, 1), _bc(32, 48, 3, 1, 1), _bc(48, 64, 3, 1, 1)))
    return ResidualScaled(branches, Conv2d(128, 320, 1, bias=True), scale)


def _mixed_6a():
    return ParallelConcat(
        _bc(320, 384, 3, 2),
        seq(_bc(320, 256, 1), _bc(256, 256, 3, 1, 1), _bc(256, 384, 3, 2)),
        nn.MaxPool2d(3, 2))


def _block17(scale):
    branches = ParallelConcat(
        _bc(1088, 192, 1),
        seq(_bc(1088, 128, 1), _bc(128, 160, (1, 7), 1, (0, 3)),
            _bc(160, 192, (7, 1), 1, (3, 0))))
    return ResidualScaled(branches, Conv2d(384, 1088, 1, bias=True), scale)


def _mixed_7a():
    return ParallelConcat(
        seq(_bc(1088, 256, 1), _bc(256, 384, 3, 2)),
        seq(_bc(1088, 256, 1), _bc(256, 288, 3, 2)),
        seq(_bc(1088, 256, 1), _bc(256, 288, 3, 1, 1), _bc(288, 320, 3, 2)),
        nn.MaxPool2d(3, 2))


def _block8(scale=1.0, final_relu=True):
    branches = ParallelConcat(
        _bc(2080, 192, 1),
        seq(_bc(2080, 192, 1), _bc(192, 224, (1, 3), 1, (0, 1)),
            _bc(224, 256, (3, 1), 1, (1, 0))))
    return ResidualScaled(branches, Conv2d(448, 2080, 1, bias=True), scale, final_relu)


def inceptionresnetv2(num_classes) -> nn.Module:
    return named(
        features=seq(
            _bc(3, 32, 3, 2), _bc(32, 32, 3), _bc(32, 64, 3, 1, 1), nn.MaxPool2d(3, 2),
            _bc(64, 80, 1), _bc(80, 192, 3), nn.MaxPool2d(3, 2), _mixed_5b(),
            *[_block35(0.17) for _ in range(10)], _mixed_6a(),
            *[_block17(0.10) for _ in range(20)], _mixed_7a(),
            *[_block8(0.20) for _ in range(9)], _block8(1.0, final_relu=False),
            _bc(2080, 1536, 1)),
        pool=GlobalAvgPool(),
        head=classifier_head(1536, num_classes),
    )
