"""NASNet-A Mobile (``editor_tpu/models/zoo/nasnet.py``; reference:
modeling/backbones/basic_cnn_params/nasnet.py).

The cell topology as the reference's: stem cells, First and Normal cells
(6-way concat), Reduction cells (4-way concat), the pad-then-crop
'specific' / 'reduction' separable branches and the pad/crop pools
(MaxPoolPad / AvgPoolPad), in NCHW. BN eps 1e-3 (nasnet.py:131).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, Linear, seq,
)


def _pad_tl(x: torch.Tensor) -> torch.Tensor:
    """ZeroPad2d((1, 0, 1, 0)): one column on the left, one row on top."""
    return F.pad(x, (1, 0, 1, 0))


def _crop_tl(x: torch.Tensor) -> torch.Tensor:
    return x[:, :, 1:, 1:]


def _bn(c) -> BatchNorm:
    return BatchNorm(c, eps=1e-3)


def _sep_conv(cin, cout, k, s, p) -> nn.Sequential:
    return seq(Conv2d(cin, cin, k, s, p, groups=cin), Conv2d(cin, cout, 1))


class BranchSeparables(nn.Module):
    """relu -> sep(k, s) -> bn -> relu -> sep(k, 1) -> bn. ``mode='stem'``:
    the first separable maps cin -> cout; 'specific' / 'reduction': pad top
    and left before the strided separable and crop after
    (nasnet.py:113-222)."""

    def __init__(self, cin, cout, k, s, p, mode="normal"):
        super().__init__()
        mid = cout if mode == "stem" else cin
        self.padded = mode in ("specific", "reduction")
        self.sep1 = _sep_conv(cin, mid, k, s, p)
        self.bn1 = _bn(mid)
        self.sep2 = _sep_conv(mid, cout, k, 1, p)
        self.bn2 = _bn(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        if self.padded:
            x = _crop_tl(self.sep1(_pad_tl(x)))
        else:
            x = self.sep1(x)
        return self.bn2(self.sep2(F.relu(self.bn1(x))))


class PadPool(nn.Module):
    """MaxPoolPad / AvgPoolPad: pad top and left, pool 3 / 2 / 1, crop."""

    def __init__(self, pool: nn.Module):
        super().__init__()
        self.pool = pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _crop_tl(self.pool(_pad_tl(x)))


def _maxpool_pad() -> PadPool:
    return PadPool(nn.MaxPool2d(3, 2, 1))


def _avgpool_pad() -> PadPool:
    return PadPool(nn.AvgPool2d(3, 2, 1, count_include_pad=False))


def _relu_conv_bn(cin, cout) -> nn.Sequential:
    return seq(nn.ReLU(), Conv2d(cin, cout, 1), _bn(cout))


class ShrinkPaths(nn.Module):
    """The stride-2 skip pair: path 1 AvgPool2d(1, 2) + conv; path 2 shifted
    (pad bottom and right, crop top and left) + the same; concat + BN
    (CellStem1 / FirstCell path_1 / path_2)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.c1 = Conv2d(cin, cout // 2, 1)
        self.c2 = Conv2d(cin, cout // 2, 1)
        self.bn = _bn(2 * (cout // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        p1 = self.c1(x[:, :, ::2, ::2])
        p2 = self.c2(F.pad(x, (0, 1, 0, 1))[:, :, 1:, 1:][:, :, ::2, ::2])
        return self.bn(torch.cat([p1, p2], 1))


_AVG31 = nn.AvgPool2d(3, 1, 1, count_include_pad=False)
_MP = nn.MaxPool2d(3, 2, 1)
_AVG32 = nn.AvgPool2d(3, 2, 1, count_include_pad=False)


class Cell(nn.ModuleDict):
    """A two-input cell: its branches registered in the reference's order,
    ``forward(x, x_prev)`` the kind's wiring."""

    def __init__(self, kind: str, subs: Dict[str, nn.Module]):
        super().__init__(subs)
        self.kind = kind

    def forward(self, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
        s = self
        if self.kind == "stem0":
            x1 = s["conv_1x1"](x)
            i0 = s["c0l"](x1) + s["c0r"](x)
            i1 = _MP(x1) + s["c1r"](x)
            i2 = _AVG32(x1) + s["c2r"](x)
            i3 = _AVG31(i0) + i1
            i4 = s["c4l"](i0) + _MP(x1)
            return torch.cat([i1, i2, i3, i4], 1)
        if self.kind == "stem1":  # x = conv0's output, x_prev = stem 0's
            left, right = s["conv_1x1"](x_prev), s["paths"](x)
            i0 = s["c0l"](left) + s["c0r"](right)
            i1 = s["c1l"](left) + s["c1r"](right)
            i2 = s["c2l"](left) + s["c2r"](right)
            i3 = _AVG31(i0) + i1
            i4 = s["c4l"](i0) + s["c4r"](left)
            return torch.cat([i1, i2, i3, i4], 1)
        if self.kind in ("first", "normal"):
            left = s["paths"](x_prev) if self.kind == "first" else s["conv_prev"](x_prev)
            right = s["conv_1x1"](x)
            i0 = s["c0l"](right) + s["c0r"](left)
            i1 = s["c1l"](left) + s["c1r"](left)
            i2 = _AVG31(right) + left
            i3 = _AVG31(left) + _AVG31(left)
            i4 = s["c4l"](right) + right
            return torch.cat([left, i0, i1, i2, i3, i4], 1)
        # reduction: the strided branches take conv_1x1(x) as their left
        # input and conv_prev(x_prev) as their right (nasnet.py:735-760)
        left, right = s["conv_prev"](x_prev), s["conv_1x1"](x)
        i0 = s["c0l"](right) + s["c0r"](left)
        i1 = s["c1l"](right) + s["c1r"](left)
        i2 = s["c2l"](right) + s["c2r"](left)
        i3 = _AVG31(i0) + i1
        i4 = s["c4l"](i0) + s["c4r"](right)
        return torch.cat([i1, i2, i3, i4], 1)


def _cell_stem_0(stem_filters, nf) -> Cell:
    B = BranchSeparables
    return Cell("stem0", {
        "conv_1x1": _relu_conv_bn(stem_filters, nf),
        "c0l": B(nf, nf, 5, 2, 2),
        "c0r": B(stem_filters, nf, 7, 2, 3, "stem"),
        "c1r": B(stem_filters, nf, 7, 2, 3, "stem"),
        "c2r": B(stem_filters, nf, 5, 2, 2, "stem"),
        "c4l": B(nf, nf, 3, 1, 1),
    })


def _cell_stem_1(stem_filters, nf) -> Cell:
    B = BranchSeparables
    return Cell("stem1", {
        "conv_1x1": _relu_conv_bn(2 * nf, nf),
        "paths": ShrinkPaths(stem_filters, nf),
        "c0l": B(nf, nf, 5, 2, 2, "specific"),
        "c0r": B(nf, nf, 7, 2, 3, "specific"),
        "c1l": _maxpool_pad(),
        "c1r": B(nf, nf, 7, 2, 3, "specific"),
        "c2l": _avgpool_pad(),
        "c2r": B(nf, nf, 5, 2, 2, "specific"),
        "c4l": B(nf, nf, 3, 1, 1, "specific"),
        "c4r": _maxpool_pad(),
    })


def _first_cell(inl, outl, inr, outr) -> Cell:
    B = BranchSeparables
    return Cell("first", {
        "conv_1x1": _relu_conv_bn(inr, outr),
        "paths": ShrinkPaths(inl, 2 * outl),
        "c0l": B(outr, outr, 5, 1, 2),
        "c0r": B(outr, outr, 3, 1, 1),
        "c1l": B(outr, outr, 5, 1, 2),
        "c1r": B(outr, outr, 3, 1, 1),
        "c4l": B(outr, outr, 3, 1, 1),
    })


def _normal_cell(inl, outl, inr, outr) -> Cell:
    B = BranchSeparables
    return Cell("normal", {
        "conv_prev": _relu_conv_bn(inl, outl),
        "conv_1x1": _relu_conv_bn(inr, outr),
        "c0l": B(outr, outr, 5, 1, 2),
        "c0r": B(outl, outl, 3, 1, 1),
        "c1l": B(outl, outl, 5, 1, 2),
        "c1r": B(outl, outl, 3, 1, 1),
        "c4l": B(outr, outr, 3, 1, 1),
    })


def _reduction_cell(inl, outl, inr, outr, mode) -> Cell:
    """mode 'reduction' (ReductionCell0) or 'specific' (ReductionCell1)."""
    B = BranchSeparables
    return Cell("reduction", {
        "conv_prev": _relu_conv_bn(inl, outl),
        "conv_1x1": _relu_conv_bn(inr, outr),
        "c0l": B(outr, outr, 5, 2, 2, mode),
        "c0r": B(outr, outr, 7, 2, 3, mode),
        "c1l": _maxpool_pad(),
        "c1r": B(outr, outr, 7, 2, 3, mode),
        "c2l": _avgpool_pad(),
        "c2r": B(outr, outr, 5, 2, 2, mode),
        "c4l": B(outr, outr, 3, 1, 1, mode),
        "c4r": _maxpool_pad(),
    })


class NASNetAMobile(nn.Module):
    def __init__(self, num_classes, stem_filters=32, penultimate_filters=1056, mult=2):
        super().__init__()
        f = penultimate_filters // 24
        self.conv0 = seq(Conv2d(3, stem_filters, 3, 2, 0), _bn(stem_filters))
        self.stem0 = _cell_stem_0(stem_filters, f // (mult ** 2))
        self.stem1 = _cell_stem_1(stem_filters, f // mult)
        self.cell_0 = _first_cell(f, f // 2, 2 * f, f)
        self.cell_1 = _normal_cell(2 * f, f, 6 * f, f)
        self.cell_2 = _normal_cell(6 * f, f, 6 * f, f)
        self.cell_3 = _normal_cell(6 * f, f, 6 * f, f)
        self.red_0 = _reduction_cell(6 * f, 2 * f, 6 * f, 2 * f, "reduction")
        self.cell_6 = _first_cell(6 * f, f, 8 * f, 2 * f)
        self.cell_7 = _normal_cell(8 * f, 2 * f, 12 * f, 2 * f)
        self.cell_8 = _normal_cell(12 * f, 2 * f, 12 * f, 2 * f)
        self.cell_9 = _normal_cell(12 * f, 2 * f, 12 * f, 2 * f)
        self.red_1 = _reduction_cell(12 * f, 4 * f, 12 * f, 4 * f, "specific")
        self.cell_12 = _first_cell(12 * f, 2 * f, 16 * f, 4 * f)
        self.cell_13 = _normal_cell(16 * f, 4 * f, 24 * f, 4 * f)
        self.cell_14 = _normal_cell(24 * f, 4 * f, 24 * f, 4 * f)
        self.cell_15 = _normal_cell(24 * f, 4 * f, 24 * f, 4 * f)
        # last_linear registers after the cells (nasnet.py __init__)
        self.head = Linear(24 * f, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = self.conv0(x)
        s0 = self.stem0(x0, None)
        s1 = self.stem1(x0, s0)
        y0 = self.cell_0(s1, s0)
        y1 = self.cell_1(y0, s1)
        y2 = self.cell_2(y1, y0)
        y3 = self.cell_3(y2, y1)
        r0 = self.red_0(y3, y2)
        y6 = self.cell_6(r0, y3)
        y7 = self.cell_7(y6, r0)
        y8 = self.cell_8(y7, y6)
        y9 = self.cell_9(y8, y7)
        r1 = self.red_1(y9, y8)
        y12 = self.cell_12(r1, y9)
        y13 = self.cell_13(y12, r1)
        y14 = self.cell_14(y13, y12)
        y15 = self.cell_15(y14, y13)
        return self.head(F.relu(y15).mean((2, 3)))


def nasnetamobile(nc): return NASNetAMobile(nc)
