"""Eval-time image transform.

Counterpart of ``make_eval_transform`` in ``editor_tpu/data/transforms.py``:
uint8 NHWC -> float32 / 255 -> (x - mean) / std, with the JAX config's
PIXEL_MEAN / PIXEL_STD defaults. The training augmentations are not ported
yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

PIXEL_MEAN = (0.5, 0.5, 0.5)
PIXEL_STD = (0.5, 0.5, 0.5)


def make_eval_transform(pixel_mean: Sequence[float] = PIXEL_MEAN,
                        pixel_std: Sequence[float] = PIXEL_STD
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Returns transform(imgs [B, H, W, 3] uint8) -> float32 normalised images,
    on the images' device."""

    def transform(imgs: torch.Tensor) -> torch.Tensor:
        x = imgs.to(torch.float32) / 255.0
        mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
        return (x - mean) / std

    return transform
