"""Torch checkpoint import: ImageNet ViT ``.pth`` files into the port's backbone.

Counterpart of ``load_torch_state_dict``, ``resize_pos_embed`` and
``load_imagenet_vit`` in ``editor_tpu/utils/torch_convert.py`` (reference:
the backbone's ``load_param``, vit_pytorch.py:646-690), acting on the port's
``state_dict`` keys: the file's keys are those of ``BACKBONE.base``, so no
layout conversion is needed. The position-embedding grid is resized with the
JAX package's numpy bilinear resize (torch ``F.interpolate`` bilinear,
``align_corners=False``), so both packages load the same numbers.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` file, unwrapped from ``model`` or
    ``state_dict`` and with ``module.`` prefixes stripped (read with
    ``weights_only=True``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if isinstance(sd.get("state_dict"), dict):
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _bilinear_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """Bilinear interpolation along one axis, half-pixel centers, no
    antialiasing."""
    in_size = x.shape[axis]
    src = np.clip((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5, 0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).reshape([-1 if i == axis else 1 for i in range(x.ndim)])
    return np.take(x, lo, axis=axis) * (1 - frac) + np.take(x, hi, axis=axis) * frac


def resize_pos_embed(posemb: np.ndarray, grid_hw: Tuple[int, int],
                     has_cls: bool = True) -> np.ndarray:
    """Bilinear-resize the square grid part of a [1, (1+)G, C] position
    embedding to ``grid_hw`` (reference resize_pos_embed, vit_pytorch.py:674-690)."""
    tok, grid = (posemb[:, :1], posemb[0, 1:]) if has_cls else (None, posemb[0])
    gs_old = int(round(np.sqrt(grid.shape[0])))
    C = grid.shape[-1]
    h, w = grid_hw
    resized = _bilinear_axis(_bilinear_axis(grid.reshape(gs_old, gs_old, C), h, 0), w, 1)
    resized = resized.astype(posemb.dtype).reshape(1, h * w, C)
    return np.concatenate([tok, resized], axis=1) if tok is not None else resized


@torch.no_grad()
def load_imagenet_vit(path: str, model: torch.nn.Module) -> List[str]:
    """Copy an ImageNet/timm ViT ``.pth`` into ``model.BACKBONE.base`` and
    return the keys copied. Classifier (``head``) and distillation keys are
    dropped; a distilled checkpoint's second token is cut from its position
    embedding; a position grid of another size is resized to the model's.
    Keys the file lacks (SIE embedding, ``fc``) keep their values, the
    reference's partial copy (vit_pytorch.py:652-671)."""
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if not ("head" in k or "dist" in k)}
    vit = model.BACKBONE.base
    own = vit.state_dict()
    if "pos_embed" in sd:
        pe = sd["pos_embed"].numpy()
        if "distilled" in path:
            pe = np.concatenate([pe[:, :1], pe[:, 2:]], axis=1)
        if pe.shape[1] != own["pos_embed"].shape[1]:
            pe = resize_pos_embed(pe, (vit.cfg.num_y, vit.cfg.num_x))
        sd["pos_embed"] = torch.from_numpy(np.ascontiguousarray(pe))
    loaded = []
    for k, v in sd.items():
        if k not in own:
            continue
        if own[k].shape != v.shape:
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the model "
                             f"{tuple(own[k].shape)}")
        own[k].copy_(v)
        loaded.append(k)
    return loaded
