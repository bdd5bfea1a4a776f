"""Frequency-domain token selection (eval path).

Counterpart of ``editor_tpu/models/frequency.py``. For Haar on images whose
sides divide by 2^J, DWT -> band average across modalities -> IDWT is the
identity applied to the modality average, so no wavelet transform runs: the
mask counts positive pixels of the averaged grey image per patch window and
keeps the top ``keep`` windows. The general ``wavedec2`` branch is not
ported yet.
"""

from __future__ import annotations

from typing import List

import torch


def topk_bool_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[R, G] scores -> [R, G] bool mask with exactly k True per row; ties go
    to the lowest index, like ``jax.lax.top_k`` (a stable descending sort:
    ``torch.topk`` promises no order among ties)."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    mask = torch.zeros_like(scores, dtype=torch.bool)
    return mask.scatter_(1, idx, True)


def window_positive_counts(img: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """[B, H, W] -> [B, H//window, W//window] count of > 0 pixels per window
    (non-overlapping windows only)."""
    B, H, W = img.shape
    if stride != window or H % window or W % window:
        raise NotImplementedError(
            "window counts are ported for non-overlapping windows that tile the "
            f"image (got window {window}, stride {stride}, image {H}x{W})")
    pos = (img > 0).to(torch.int32)
    return pos.reshape(B, H // window, window, W // window, window).sum(dim=(2, 4))


def frequency_token_select(modalities: List[torch.Tensor], keep: int,
                           stride: int = 16, window: int = 16, J: int = 4,
                           wave: str = "haar") -> torch.Tensor:
    """2-3 [B, H, W, C] images -> [B, P] bool token mask, row-major over the
    patch grid."""
    mods = [m for m in modalities if m is not None]
    H, W = mods[0].shape[1], mods[0].shape[2]
    if wave not in ("haar", "db1") or H % (1 << J) or W % (1 << J):
        raise NotImplementedError(
            "only the Haar shortcut (image sides divisible by 2^J) is ported; "
            f"got wave={wave!r}, J={J}, image {H}x{W}")
    inv = mods[0].to(torch.float32)
    for m in mods[1:]:
        inv = inv + m.to(torch.float32)
    inv = inv / float(len(mods))
    counts = window_positive_counts(inv.mean(dim=-1), window, stride)
    flat = counts.reshape(counts.shape[0], -1).to(torch.float32)
    return topk_bool_mask(flat, min(keep, flat.shape[-1]))
