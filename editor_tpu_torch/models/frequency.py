"""Frequency-domain token selection (eval path).

Counterpart of ``editor_tpu/models/frequency.py``: a J-level DWT of each
modality (zero padding), every band averaged across the modalities, the
inverse DWT, then per patch window the count of positive pixels of the grey
(channel-mean) reconstruction; the top ``keep`` windows are the mask.

For Haar on images whose sides divide by 2^J, DWT -> band average -> IDWT is
the identity applied to the modality average, so no transform runs (the JAX
shortcut). Otherwise the transforms of :mod:`editor_tpu_torch.ops.wavelets`
run in fp32 with TF32 off, averaged in the JAX order (modality by modality,
then divided by their number), and the reconstruction keeps the extent JAX's
``waverec2`` gives. The windows are VALID (``lax.reduce_window``'s grid:
``(H - window) // stride + 1`` by ``(W - window) // stride + 1``), so
overlapping patches (stride below the window) get one count per patch token;
the counts are integer sums, never float pooling. The averages are left-to-
right sums and rounded divisions (:func:`_div`), so the Haar shortcut gives
the same mask on the card as on the CPU, bit for bit.
"""

from __future__ import annotations

from typing import List

import torch

from editor_tpu_torch.ops.wavelets import wavedec2, waverec2


def _div(x: torch.Tensor, d: int) -> torch.Tensor:
    """x / d as a rounded division on every device: a CUDA tensor divided by
    a Python number is multiplied by the number's reciprocal, which rounds
    differently, and sums in another order round differently too; bf16
    images sum to exact zeros often enough that such rounding decides the
    sign of some grey pixels, so the order and the division are fixed. The
    divisor is a 0-dim tensor filled on x's device, not copied from the host:
    a copy would make the host wait for the stream at every forward."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def topk_bool_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[R, G] scores -> [R, G] bool mask with exactly k True per row; ties go
    to the lowest index, like ``jax.lax.top_k`` (a stable descending sort:
    ``torch.topk`` promises no order among ties)."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k]
    mask = torch.zeros_like(scores, dtype=torch.bool)
    return mask.scatter_(1, idx, True)


def window_positive_counts(img: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """[B, H, W] -> int32 [B, (H - window) // stride + 1, (W - window) //
    stride + 1]: the count of > 0 pixels in each VALID window."""
    B, H, W = img.shape
    pos = (img > 0).to(torch.int32)
    # [B, gh, gw, window, window] views of the pixels, one per window
    counts = pos.unfold(1, window, stride).unfold(2, window, stride).sum(dim=(3, 4))
    return counts.to(torch.int32)


def frequency_token_select(modalities: List[torch.Tensor], keep: int,
                           stride: int = 16, window: int = 16, J: int = 4,
                           wave: str = "haar") -> torch.Tensor:
    """2-3 [B, H, W, C] images -> [B, P] bool token mask, row-major over the
    patch grid."""
    mods = [m for m in modalities if m is not None]
    n = len(mods)
    H, W = mods[0].shape[1], mods[0].shape[2]
    if wave in ("haar", "db1") and H % (1 << J) == 0 and W % (1 << J) == 0:
        inv = _div(sum(m.to(torch.float32) for m in mods), n)
    else:
        lows, highs_all = [], []
        for m in mods:
            low, highs = wavedec2(m.to(torch.float32), wave=wave, J=J, mode="zero")
            lows.append(low)
            highs_all.append(highs)
        low = _div(sum(lows), n)
        highs = [_div(sum(level), n) for level in zip(*highs_all)]
        inv = waverec2(low, highs, wave=wave, mode="zero")  # [B, H', W', C]
    gray = _div(sum(inv.unbind(-1)), inv.shape[-1])  # the channel mean
    counts = window_positive_counts(gray, window, stride)
    flat = counts.reshape(counts.shape[0], -1).to(torch.float32)
    return topk_bool_mask(flat, min(keep, flat.shape[-1]))
