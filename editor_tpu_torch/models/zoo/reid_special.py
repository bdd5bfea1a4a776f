"""ReID-specific zoo models: MuDeep, HACNN, MLFN, CAL
(``editor_tpu/models/zoo/reid_special.py``; reference: modeling/backbones/
basic_cnn_params/{mudeep,hacnn,mlfn,cal}.py). HACNN takes 160x64 inputs and
crops its stripes with ``affine_grid`` + ``grid_sample``; MuDeep takes
256x128.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from editor_tpu_torch.models.zoo.common import (
    BatchNorm, Conv2d, Linear, ParallelConcat, seq,
)
from editor_tpu_torch.models.zoo.resnet import _stage, _stem


def _cb(cin, cout, k, s=1, p=0) -> nn.Sequential:
    """ConvBlock: conv with bias + BN + ReLU (mudeep.py, hacnn.py)."""
    return seq(Conv2d(cin, cout, k, s, p, bias=True), BatchNorm(cout), nn.ReLU())


def _resize_ac(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the reference's F.upsample)."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


# MuDeep (mudeep.py)

def _multi_scale_a():
    return ParallelConcat(
        seq(_cb(96, 96, 1), _cb(96, 24, 3, 1, 1)),
        seq(nn.AvgPool2d(3, 1, 1), _cb(96, 24, 1)),
        _cb(96, 24, 1),
        seq(_cb(96, 16, 1), _cb(16, 24, 3, 1, 1), _cb(24, 24, 3, 1, 1)))


def _reduction():
    return ParallelConcat(
        nn.MaxPool2d(3, 2, 1),
        _cb(96, 96, 3, 2, 1),
        seq(_cb(96, 48, 1), _cb(48, 56, 3, 1, 1), _cb(56, 64, 3, 2, 1)))


def _multi_scale_b() -> nn.ModuleList:
    return nn.ModuleList([
        seq(nn.AvgPool2d(3, 1, 1), _cb(256, 256, 1)),
        seq(_cb(256, 64, 1), _cb(64, 128, (1, 3), 1, (0, 1)), _cb(128, 256, (3, 1), 1, (1, 0))),
        _cb(256, 256, 1),
        seq(_cb(256, 64, 1), _cb(64, 64, (1, 3), 1, (0, 1)), _cb(64, 128, (3, 1), 1, (1, 0)),
            _cb(128, 128, (1, 3), 1, (0, 1)), _cb(128, 256, (3, 1), 1, (1, 0)))])


class Fusion(nn.Module):
    """The four streams' saliency weights a1..a4, ``[1, 256, 1, 1]`` each
    (Fusion, mudeep.py:133-136); init uniform in [0, 1) as JAX's."""

    def __init__(self, c: int = 256):
        super().__init__()
        for i in range(1, 5):
            setattr(self, f"a{i}", nn.Parameter(torch.empty(1, c, 1, 1)))

    def weights(self) -> List[torch.Tensor]:
        return [self.a1, self.a2, self.a3, self.a4]

    def init_(self, gen: torch.Generator) -> None:
        for a in self.weights():
            cpu = torch.empty(a.shape, dtype=torch.float32)
            cpu.uniform_(0.0, 1.0, generator=gen)
            a.copy_(cpu)


class MuDeep(nn.Module):
    """Multi-scale deep net (mudeep.py); the input must be 256x128."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.b1 = seq(_cb(3, 48, 3, 1, 1), _cb(48, 96, 3, 1, 1), nn.MaxPool2d(3, 2, 1))
        self.b2 = _multi_scale_a()
        self.b3 = _reduction()
        self.streams = _multi_scale_b()
        self.fusion = Fusion()
        self.head = seq(Linear(256 * 16 * 8, 768), BatchNorm(768), nn.ReLU(),
                        Linear(768, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.b3(self.b2(self.b1(x)))
        acc = None
        for s, a in zip(self.streams, self.fusion.weights()):
            t = s(y) * a.to(y.dtype)
            acc = t if acc is None else acc + t
        v = F.avg_pool2d(acc, 4, 4)
        return self.head(v.flatten(1))  # NCHW order, as torch's x.view(B, -1)


def mudeep(nc): return MuDeep(nc)


# HACNN (hacnn.py)

def _inception_a_h(cin, cout):
    mid = cout // 4
    return ParallelConcat(
        seq(_cb(cin, mid, 1), _cb(mid, mid, 3, 1, 1)),
        seq(_cb(cin, mid, 1), _cb(mid, mid, 3, 1, 1)),
        seq(_cb(cin, mid, 1), _cb(mid, mid, 3, 1, 1)),
        seq(nn.AvgPool2d(3, 1, 1), _cb(cin, mid, 1)))


def _inception_b_h(cin, cout):
    mid = cout // 4
    return ParallelConcat(
        seq(_cb(cin, mid, 1), _cb(mid, mid, 3, 2, 1)),
        seq(_cb(cin, mid, 1), _cb(mid, mid, 3, 1, 1), _cb(mid, mid, 3, 2, 1)),
        seq(nn.MaxPool2d(3, 2, 1), _cb(cin, 2 * mid, 1)))


class SoftAttn(nn.Module):
    """Spatial (channel mean, strided 3x3, resized back, 1x1) times channel
    (global mean, squeeze, excite) attention, a 1x1 conv, sigmoid."""

    def __init__(self, c: int):
        super().__init__()
        self.sp1 = _cb(1, 1, 3, 2, 1)
        self.sp2 = _cb(1, 1, 1)
        self.ch1 = _cb(c, c // 16, 1)
        self.ch2 = _cb(c // 16, c, 1)
        self.conv = _cb(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.sp2(_resize_ac(self.sp1(x.mean(1, keepdim=True)), x.shape[2:]))
        ch = self.ch2(self.ch1(x.mean((2, 3), keepdim=True)))
        return torch.sigmoid(self.conv(s * ch))


def stripe_crop(x: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor,
                sy: float = 0.25) -> torch.Tensor:
    """The reference's STN crop: ``grid_sample(x, affine_grid(theta))`` with
    theta ``[[1, 0, tx], [0, sy, ty]]``, align_corners=False, zero padding,
    in ``x``'s dtype (the reference fixes float32 here)."""
    B = x.shape[0]
    theta = torch.zeros(B, 2, 3, dtype=x.dtype, device=x.device)
    theta[:, 0, 0] = 1.0
    theta[:, 1, 1] = sy
    theta[:, 0, 2] = tx
    theta[:, 1, 2] = ty
    grid = F.affine_grid(theta, list(x.shape), align_corners=False)
    return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros", align_corners=False)


class HACNN(nn.Module):
    """Harmonious Attention CNN (hacnn.py; feat_dim 768). A global stream of
    three InceptionA + InceptionB stages with soft attention, and a local
    stream of four STN-cropped horizontal stripes through InceptionB
    columns; ``forward`` returns ``[global | local]`` logits, ``[B, 2 nc]``.
    Registration as the reference's (hacnn.py:225-266)."""

    SIZES = [(24, 28), (12, 14), (6, 7)]

    def __init__(self, num_classes: int, nchannels=(128, 256, 384), feat_dim: int = 768):
        super().__init__()
        n1, n2, n3 = nchannels
        self.conv = _cb(3, 32, 3, 2, 1)
        ins = (32, n1, n2)
        for b, n in enumerate(nchannels):
            setattr(self, f"inc{b}", seq(_inception_a_h(ins[b], n), _inception_b_h(n, n)))
            setattr(self, f"soft{b}", SoftAttn(n))
            setattr(self, f"hard{b}", Linear(n, 8))
        self.fc_global = seq(Linear(n3, feat_dim), BatchNorm(feat_dim), nn.ReLU())
        self.cls_global = Linear(feat_dim, num_classes)
        for b, n in enumerate(nchannels):
            setattr(self, f"local{b}", _inception_b_h(ins[b], n))
        self.fc_local = seq(Linear(n3 * 4, feat_dim), BatchNorm(feat_dim), nn.ReLU())
        self.cls_local = Linear(feat_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[2:]) != (160, 64):
            raise ValueError(f"HACNN expects 160x64 inputs (reference hacnn.py forward), "
                             f"got {tuple(x.shape[2:])}")
        src = self.conv(x)
        locals_: List[torch.Tensor] = [None] * 4
        for b in range(3):
            g = getattr(self, f"inc{b}")(src)
            attn = getattr(self, f"soft{b}")(g)
            theta = torch.tanh(getattr(self, f"hard{b}")(g.mean((2, 3)))).reshape(-1, 4, 2)
            local = getattr(self, f"local{b}")
            for r in range(4):
                crop = _resize_ac(stripe_crop(src, theta[:, r, 0], theta[:, r, 1]),
                                  self.SIZES[b])
                if b > 0:
                    crop = crop + locals_[r]
                locals_[r] = local(crop)
            src = g * attn
        y_g = self.cls_global(self.fc_global(src.mean((2, 3))))
        v_l = self.fc_local(torch.cat([t.mean((2, 3)) for t in locals_], 1))
        return torch.cat([y_g, self.cls_local(v_l)], 1)


def hacnn(nc): return HACNN(nc)


# MLFN (mlfn.py)

class MLFNBlock(nn.Module):
    def __init__(self, cin, cout, stride, fsm_channels, groups=32):
        super().__init__()
        mid = cout // 2
        self.fm1 = seq(Conv2d(cin, mid, 1), BatchNorm(mid), nn.ReLU())
        self.fm2 = seq(Conv2d(mid, mid, 3, stride, 1, groups=groups), BatchNorm(mid), nn.ReLU())
        self.fm3 = seq(Conv2d(mid, cout, 1), BatchNorm(cout))
        f0, f1 = fsm_channels
        self.fsm = seq(Conv2d(cin, f0, 1, bias=True), BatchNorm(f0), nn.ReLU(),
                       Conv2d(f0, f1, 1, bias=True), BatchNorm(f1), nn.ReLU(),
                       Conv2d(f1, groups, 1, bias=True), BatchNorm(groups))
        self.down = (seq(Conv2d(cin, cout, 1, stride), BatchNorm(cout))
                     if (cin != cout or stride > 1) else None)

    def forward(self, x: torch.Tensor):
        s = torch.sigmoid(self.fsm(x.mean((2, 3), keepdim=True)))     # [B, G, 1, 1]
        y = self.fm2(self.fm1(x))
        # gate each of the G groups (channels group-major: c = g * n + i)
        y = self.fm3(y * s.repeat_interleave(y.shape[1] // s.shape[1], dim=1))
        sc = x if self.down is None else self.down(x)
        # relu(bn3) first, then relu of the residual sum (mlfn.py:88-96)
        return F.relu(sc + F.relu(y)), s.flatten(1)


class MLFN(nn.Module):
    def __init__(self, num_classes, groups=32, channels=(64, 256, 512, 1024, 2048),
                 embed_dim=768):
        super().__init__()
        c = channels
        specs = ([(c[0], c[1], 1, (128, 64))] + [(c[1], c[1], 1, (128, 64))] * 2
                 + [(c[1], c[2], 2, (256, 128))] + [(c[2], c[2], 1, (256, 128))] * 3
                 + [(c[2], c[3], 2, (512, 128))] + [(c[3], c[3], 1, (512, 128))] * 5
                 + [(c[3], c[4], 2, (512, 128))] + [(c[4], c[4], 1, (512, 128))] * 2)
        self.stem = seq(Conv2d(3, c[0], 7, 2, 3, bias=True), BatchNorm(c[0]), nn.ReLU(),
                        nn.MaxPool2d(3, 2, 1))
        self.blocks = nn.ModuleList(MLFNBlock(a, b, s, f, groups) for a, b, s, f in specs)
        self.fc_x = seq(Conv2d(c[4], embed_dim, 1), BatchNorm(embed_dim), nn.ReLU())
        self.fc_s = seq(Conv2d(groups * len(specs), embed_dim, 1), BatchNorm(embed_dim), nn.ReLU())
        self.head = Linear(embed_dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, gates = self.stem(x), []
        for block in self.blocks:
            y, s = block(y)
            gates.append(s)
        vx = self.fc_x(y.mean((2, 3), keepdim=True))
        vs = self.fc_s(torch.cat(gates, 1)[:, :, None, None])
        return self.head(((vx + vs) * 0.5).flatten(1))


def mlfn(nc): return MLFN(nc)


# CAL (cal.py): counterfactual attention learning over a resnet50 trunk

class CalSE(nn.Module):
    def __init__(self, c, reduction):
        super().__init__()
        self.fc1 = Linear(c, c // reduction, bias=False)
        self.fc2 = Linear(c // reduction, c, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean((2, 3))))))
        return s[:, :, None, None]


class MultiHeadAtt(nn.Module):
    """ResNeSt-style split attention over ``radix`` channel splits
    (cal.py MultiHeadAtt)."""

    def __init__(self, cin, channels, radix=2):
        super().__init__()
        inter = max(cin * radix // 4, 32)
        self.radix, self.channels = radix, channels
        self.fc1 = Conv2d(channels, inter, 1, bias=True)
        self.bn1 = BatchNorm(inter)
        self.fc2 = Conv2d(inter, channels * radix, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = torch.chunk(x, self.radix, 1)
        gap = sum(parts).mean((2, 3), keepdim=True)
        gap = F.relu(self.bn1(self.fc1(gap)))
        att = torch.softmax(self.fc2(gap).reshape(x.shape[0], self.radix, self.channels), 1)
        return torch.cat([att[:, i, :, None, None] * p for i, p in enumerate(parts)], 1)


class CAL(nn.Module):
    """CAL (cal.py:376). The reference's forward cannot run as shipped: BAP
    gives M x 2048 features where ``classifier_bap`` takes M x in_planes.
    This forward carries JAX's repair: the trunk's features are cut to their
    first ``in_planes`` channels before BAP. The BN biases of ``bn0``-``bn4``
    and ``bottleneck`` are frozen zeros (``requires_grad_(False)`` in the
    reference). Registration follows the reference's after its base /
    base_i alias drop (cal.py:276-301)."""

    CHANS = (64, 256, 512, 1024, 2048)

    def __init__(self, num_classes, in_planes=768, M=8):
        super().__init__()
        self.in_planes = in_planes
        stages = [_stage(64, 64, 3, 1), _stage(256, 128, 4, 2), _stage(512, 256, 6, 2),
                  _stage(1024, 512, 3, 1)]  # last stride 1
        self.stem = _stem()
        for i, (ch, r) in enumerate(zip(self.CHANS, (8, 32, 64, 128, 256))):
            setattr(self, f"bn{i}", BatchNorm(ch, bias=False))
            setattr(self, f"se{i}", CalSE(ch, r))
            setattr(self, f"matt{i}", MultiHeadAtt(ch, ch // 2))
            if i < 4:
                setattr(self, f"stage{i}", stages[i])
        # BasicConv2d: BN eps 0.001 (cal.py:140-151)
        self.attn = seq(Conv2d(2048, M, 1), BatchNorm(M, eps=1e-3), nn.ReLU())
        self.bottleneck = BatchNorm(in_planes, bias=False)
        self.head = Linear(in_planes, num_classes, bias=False)
        self.cls_bap = Linear(in_planes * M, in_planes, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.stem(x)
        for i in range(5):
            if i > 0:
                y = getattr(self, f"stage{i - 1}")(y)
            y = getattr(self, f"bn{i}")(getattr(self, f"matt{i}")(y))
            y = y * getattr(self, f"se{i}")(y)
        att = self.attn(y)                                           # [B, M, H, W]
        feats = y[:, :self.in_planes]
        mat = torch.einsum("bmhw,bchw->bmc", att, feats) / (att.shape[2] * att.shape[3])
        mat = mat.reshape(x.shape[0], -1)
        # BAP sign-sqrt and L2 normalisation (cal.py:197-201)
        mat = torch.sign(mat) * torch.sqrt(mat.abs() + 1e-12)
        mat = mat / mat.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        return self.head(self.bottleneck(self.cls_bap(mat)))


def cal(nc): return CAL(nc)
