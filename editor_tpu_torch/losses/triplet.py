"""Batch-hard triplet loss: counterpart of ``editor_tpu/losses/triplet.py``
(reference: layers/triplet_loss.py). Hard-example mining is a masked max/min
over the pairwise distances, valid for any batch layout. Computed in at least
fp32."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from editor_tpu_torch.ops._checks import compute_dtype


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distance with the reference's clamp(1e-12).sqrt()."""
    cd = compute_dtype(x.dtype)
    xf, yf = x.to(cd), y.to(cd)
    xx = (xf * xf).sum(dim=1, keepdim=True)
    yy = (yf * yf).sum(dim=1, keepdim=True).t()
    return (xx + yy - 2.0 * (xf @ yf.t())).clamp_min(1e-12).sqrt()


def hard_example_mining(dist: torch.Tensor, labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per anchor: the farthest positive and the closest negative."""
    pos = labels[:, None] == labels[None, :]
    big = torch.finfo(dist.dtype).max
    dist_ap = torch.where(pos, dist, torch.full_like(dist, -big)).amax(dim=1)
    dist_an = torch.where(pos, torch.full_like(dist, big), dist).amin(dim=1)
    return dist_ap, dist_an


def batch_hard_triplet(feat: torch.Tensor, labels: torch.Tensor,
                       margin: Optional[float] = None) -> torch.Tensor:
    """margin None: soft margin, mean softplus(d_ap - d_an); else mean
    max(0, d_ap - d_an + margin)."""
    dist_ap, dist_an = hard_example_mining(euclidean_dist(feat, feat), labels)
    if margin is not None:
        return (dist_ap - dist_an + margin).clamp_min(0.0).mean()
    d = dist_ap - dist_an  # softplus(d) without torch's linear cut-off at d > 20
    return torch.logaddexp(d, torch.zeros_like(d)).mean()
