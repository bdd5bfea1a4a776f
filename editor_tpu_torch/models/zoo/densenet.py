"""DenseNet 121/169/201/161 (+121_fc512) (``editor_tpu/models/zoo/
densenet.py``; reference: modeling/backbones/basic_cnn_params/densenet.py,
torchvision's BN-ReLU-Conv1x1 -> BN-ReLU-Conv3x3 dense layers, half-channel
transitions, a final BN)."""

from __future__ import annotations

import torch
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, GlobalAvgPool, classifier_head, named, seq,
)


def _dense_layer(cin, growth, bn_size=4) -> nn.Sequential:
    return seq(BatchNorm(cin), nn.ReLU(), Conv2d(cin, bn_size * growth, 1),
               BatchNorm(bn_size * growth), nn.ReLU(), Conv2d(bn_size * growth, growth, 3, 1, 1))


class DenseBlock(nn.ModuleList):
    """Each layer's output concatenated to its input."""

    def __init__(self, cin, layers, growth):
        super().__init__(_dense_layer(cin + i * growth, growth) for i in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = torch.cat([x, layer(x)], 1)
        return x


def _transition(cin, cout) -> nn.Sequential:
    return seq(BatchNorm(cin), nn.ReLU(), Conv2d(cin, cout, 1), nn.AvgPool2d(2, 2))


def densenet(num_classes, init_features, growth, block_config, fc_dims=()) -> nn.Module:
    mods = [seq(Conv2d(3, init_features, 7, 2, 3), BatchNorm(init_features), nn.ReLU(),
                nn.MaxPool2d(3, 2, 1))]
    c = init_features
    for i, n in enumerate(block_config):
        mods.append(DenseBlock(c, n, growth))
        c += n * growth
        if i != len(block_config) - 1:
            mods.append(_transition(c, c // 2))
            c //= 2
    mods.append(seq(BatchNorm(c), nn.ReLU()))
    return named(features=seq(*mods), pool=GlobalAvgPool(),
                 head=classifier_head(c, num_classes, fc_dims))


def densenet121(nc): return densenet(nc, 64, 32, (6, 12, 24, 16))
def densenet169(nc): return densenet(nc, 64, 32, (6, 12, 32, 32))
def densenet201(nc): return densenet(nc, 64, 32, (6, 12, 48, 32))
def densenet161(nc): return densenet(nc, 96, 48, (6, 12, 36, 24))
def densenet121_fc512(nc): return densenet(nc, 64, 32, (6, 12, 24, 16), fc_dims=(512,))
