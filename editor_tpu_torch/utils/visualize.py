"""Qualitative visualisation dumps: token masks, attention rollout, the
frequency reconstruction.

Counterpart of ``editor_tpu/utils/visualize.py`` (reference: the optional
figure paths of the reference: mask overlays, modeling/fusion_part/
SFTS.py:65-137; per-head attention maps, modeling/backbones/
vit_pytorch.py:575-617; the frequency reconstruction, modeling/fusion_part/
Frequency.py:20-39). The overlays are numpy uint8 arrays, written as PNGs by
``_save``, the one place PIL is imported.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _to_uint8(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] float (any range) -> uint8 by min-max normalisation."""
    img = np.asarray(img, np.float32)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def _heat_rgb(h: np.ndarray) -> np.ndarray:
    """[H, W] in [0, 1] -> red-yellow heat RGB."""
    h = np.clip(np.asarray(h, np.float32), 0, 1)
    r = np.clip(h * 2, 0, 1)
    g = np.clip(h * 2 - 1, 0, 1)
    return np.stack([r, g, np.zeros_like(h)], -1)


def _overlay(img: np.ndarray, heat: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    base = _to_uint8(img).astype(np.float32) / 255.0
    return _to_uint8((1 - alpha) * base + alpha * _heat_rgb(heat))


def _upsample_grid(grid: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """[gy, gx] token grid -> [H, W] nearest-neighbour heat map."""
    gy, gx = grid.shape
    H, W = hw
    return grid[np.minimum(np.arange(H) * gy // H, gy - 1)][
        :, np.minimum(np.arange(W) * gx // W, gx - 1)]


def _save(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)


def dump_token_mask(out_dir: str, images: Dict[str, np.ndarray], index: np.ndarray,
                    grid_hw: Tuple[int, int], prefix: str = "mask") -> None:
    """Selected-token mask overlays (reference SFTS.py:65-137): one PNG per
    modality per sample. images: {'RGB'/'NI'/'TI': [B, H, W, 3]}; index:
    [B, P] bool/float union mask over the patch grid ``grid_hw``."""
    index = np.asarray(index, np.float32)
    for mod, imgs in images.items():
        imgs = np.asarray(imgs)
        for b in range(imgs.shape[0]):
            heat = _upsample_grid(index[b].reshape(grid_hw), imgs.shape[1:3])
            _save(os.path.join(out_dir, f"{prefix}_{mod}_{b}.png"), _overlay(imgs[b], heat))


def dump_rollout(out_dir: str, images: Dict[str, np.ndarray], rollouts: Dict[str, np.ndarray],
                 grid_hw: Tuple[int, int], prefix: str = "rollout") -> None:
    """Attention-rollout heat overlays (reference vit_pytorch.py:575-617),
    head-averaged. rollouts: {mod: [B, heads, P]}."""
    for mod, roll in rollouts.items():
        imgs = np.asarray(images[mod])
        roll = np.asarray(roll, np.float32).mean(axis=1)  # [B, P]
        roll = roll / np.maximum(roll.max(axis=1, keepdims=True), 1e-12)
        for b in range(imgs.shape[0]):
            heat = _upsample_grid(roll[b].reshape(grid_hw), imgs.shape[1:3])
            _save(os.path.join(out_dir, f"{prefix}_{mod}_{b}.png"), _overlay(imgs[b], heat))


def dump_frequency(out_dir: str, recon: np.ndarray, prefix: str = "frequency") -> None:
    """Band-averaged DWT reconstruction images (reference Frequency.py:20-39).
    recon: [B, H, W, C]."""
    recon = np.asarray(recon)
    for b in range(recon.shape[0]):
        _save(os.path.join(out_dir, f"{prefix}_{b}.png"), _to_uint8(recon[b]))


def eval_visualization_maps(model, images: Dict[str, torch.Tensor],
                            cam_ids: Optional[torch.Tensor] = None,
                            compute_dtype: Optional[torch.dtype] = None):
    """The maps the visualisations draw: the backbone per modality (its
    rollout; K1 and K2 on the kernel path), then the frequency mask and the
    SFTS union. images: {mod: [B, H, W, 3]} normalised, on the model's
    device; ``compute_dtype`` (default: the images') the images are cast to.
    Returns ({mod: rollout [B, heads, P] fp32}, union [B, P] bool), on the
    model's device."""
    from editor_tpu_torch.models.frequency import frequency_token_select
    from editor_tpu_torch.models.sfts import sfts_select

    cfg = model.cfg
    mods = [m for m in ("RGB", "NI", "TI") if m in images]
    arrs = [images[m] if compute_dtype is None else images[m].to(compute_dtype) for m in mods]
    with torch.inference_mode():
        toks, rolls = [], []
        for x in arrs:
            t, r = model.BACKBONE.base(x, cam_ids, None, use_kernels=cfg.use_pallas)
            toks.append(t)
            rolls.append(r)
        mask_fre = frequency_token_select(arrs, keep=cfg.frequency_keep,
                                          stride=cfg.vit.stride_size[0], window=cfg.vit.patch_size)
        _, index = sfts_select(toks, rolls, mask_fre, cfg.head_keep)
    return ({m: r.to(torch.float32) for m, r in zip(mods, rolls)}, index[..., 0] > 0)


def dump_eval_visualizations(out_dir: str, model, images: Dict[str, np.ndarray],
                             cam_ids: Optional[np.ndarray] = None,
                             compute_dtype: Optional[torch.dtype] = None) -> list:
    """Run the EDITOR eval machinery on a small batch and write every
    qualitative artifact: per-modality rollout heat maps, the SFTS union
    token mask and the frequency reconstruction. ``images``: {mod: [B, H, W,
    3]} normalised images and ``cam_ids`` [B] (numpy or tensors, on any
    device); the model runs on its own device, the images cast to
    ``compute_dtype`` (default: theirs). Returns the paths in ``out_dir``,
    sorted."""
    device = next(model.parameters()).device

    def tensor(x) -> torch.Tensor:
        return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(device)

    mods = [m for m in ("RGB", "NI", "TI") if m in images]
    arrs = {m: tensor(images[m]) for m in mods}
    cams = None if cam_ids is None else tensor(cam_ids)
    rolls, union = eval_visualization_maps(model, arrs, cams, compute_dtype)
    os.makedirs(out_dir, exist_ok=True)
    grid_hw = (model.cfg.vit.num_y, model.cfg.vit.num_x)

    np_images = {m: arrs[m].detach().cpu().numpy().astype(np.float32) for m in mods}
    dump_rollout(out_dir, np_images, {m: rolls[m].cpu().numpy() for m in mods}, grid_hw)
    dump_token_mask(out_dir, np_images, union.cpu().numpy(), grid_hw)
    dump_frequency(out_dir, sum(np_images[m] for m in mods) / len(mods))
    return sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir))
