"""Image transforms: the eval normalisation and the on-device train
augmentation.

Counterpart of ``editor_tpu/data/transforms.py`` (reference:
data/datasets/make_dataloader.py): eval is uint8 NHWC -> float32 / 255 ->
(x - mean) / std; train adds a per-sample horizontal flip, zero-pad and random
crop back to size, and, after normalising, pixel-mode random erasing (timm
semantics: up to 10 box proposals, the first that fits wins, filled with
standard-normal noise). Every draw is fp32 from an explicit
``torch.Generator`` on the images' device; the train step calls the augment
once per modality, so each modality gets its own part of the stream. The
draws are not the JAX package's numbers (the generators differ), so the
tests hold the augmentation by its statistics.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch

PIXEL_MEAN = (0.5, 0.5, 0.5)
PIXEL_STD = (0.5, 0.5, 0.5)


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)
    s = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - m) / s


def make_eval_transform(pixel_mean: Sequence[float] = PIXEL_MEAN,
                        pixel_std: Sequence[float] = PIXEL_STD
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns transform(imgs [B, H, W, 3] uint8) -> float32 normalised images,
    on the images' device."""

    def transform(imgs: torch.Tensor) -> torch.Tensor:
        return normalize(imgs.to(torch.float32) / 255.0, pixel_mean, pixel_std)

    return transform


def _rand(gen: torch.Generator, *shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def random_hflip(x: torch.Tensor, prob: float, gen: torch.Generator) -> torch.Tensor:
    """Per-sample horizontal flip of [B, H, W, C]."""
    flip = _rand(gen, x.shape[0], 1, 1, 1, device=x.device) < prob
    return torch.where(flip, x.flip(2), x)


def pad_random_crop(x: torch.Tensor, padding: int, gen: torch.Generator) -> torch.Tensor:
    """Zero-pad by ``padding`` on each side, then crop a random window of the
    original size per sample (offsets uniform in [0, 2 padding])."""
    B, H, W, C = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    off = torch.randint(0, 2 * padding + 1, (2, B), generator=gen, device=x.device)
    rows = off[0][:, None, None] + torch.arange(H, device=x.device)[None, :, None]
    cols = off[1][:, None, None] + torch.arange(W, device=x.device)[None, None, :]
    return xp[torch.arange(B, device=x.device)[:, None, None], rows, cols]


def random_erasing(x: torch.Tensor, prob: float, gen: torch.Generator,
                   min_area: float = 0.02, max_area: float = 1 / 3,
                   min_aspect: float = 0.3, attempts: int = 10) -> torch.Tensor:
    """Pixel-mode random erasing of [B, H, W, C] (``random_erasing``)."""
    B, H, W, C = x.shape
    dev = x.device
    apply = _rand(gen, B, device=dev) < prob
    area = (min_area + (max_area - min_area) * _rand(gen, B, attempts, device=dev)) * (H * W)
    lo, hi = math.log(min_aspect), math.log(1.0 / min_aspect)
    ar = torch.exp(lo + (hi - lo) * _rand(gen, B, attempts, device=dev))
    hs = torch.round(torch.sqrt(area * ar)).to(torch.int64)
    ws = torch.round(torch.sqrt(area / ar)).to(torch.int64)
    valid = (hs < H) & (ws < W)
    first = valid.to(torch.uint8).argmax(dim=1, keepdim=True)  # the first that fits
    h = hs.gather(1, first)[:, 0]
    w = ws.gather(1, first)[:, 0]
    do = apply & valid.any(dim=1)
    top = torch.floor(_rand(gen, B, device=dev) * (H - h + 1)).to(torch.int64)
    left = torch.floor(_rand(gen, B, device=dev) * (W - w + 1)).to(torch.int64)
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    box = ((rows >= top[:, None, None]) & (rows < (top + h)[:, None, None])
           & (cols >= left[:, None, None]) & (cols < (left + w)[:, None, None]))
    mask = (box & do[:, None, None])[..., None]
    noise = torch.randn(x.shape, generator=gen, device=dev, dtype=x.dtype)
    return torch.where(mask, noise, x)


def make_train_augment(input_cfg: Any) -> Callable[[torch.Tensor, torch.Generator],
                                                   torch.Tensor]:
    """Returns augment(imgs [B, H, W, 3] uint8, generator) -> float32
    normalised, augmented images (``make_train_augment``), from the INPUT
    section: PROB (flip), PADDING (crop), RE_PROB (erasing), PIXEL_MEAN/STD."""
    prob, padding, re_prob = input_cfg.PROB, input_cfg.PADDING, input_cfg.RE_PROB
    mean, std = tuple(input_cfg.PIXEL_MEAN), tuple(input_cfg.PIXEL_STD)

    def augment(imgs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        x = imgs.to(torch.float32) / 255.0
        x = random_hflip(x, prob, gen)
        x = pad_random_crop(x, padding, gen)
        return random_erasing(normalize(x, mean, std), re_prob, gen)

    return augment
