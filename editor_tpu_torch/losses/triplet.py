"""Batch-hard triplet loss and its weighted-regularized variant: counterpart
of ``editor_tpu/losses/triplet.py`` (reference: layers/triplet_loss.py).
Hard-example mining is a masked max/min over the pairwise distances, valid
for any batch layout. Computed in at least fp32."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from editor_tpu_torch.ops._checks import compute_dtype


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x over its L2 norm along ``dim`` (+ 1e-12 in the denominator)."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-12)


def euclidean_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distance with the reference's clamp(1e-12).sqrt()."""
    cd = compute_dtype(x.dtype)
    xf, yf = x.to(cd), y.to(cd)
    xx = (xf * xf).sum(dim=1, keepdim=True)
    yy = (yf * yf).sum(dim=1, keepdim=True).t()
    return (xx + yy - 2.0 * (xf @ yf.t())).clamp_min(1e-12).sqrt()


def cosine_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise (1 - cosine similarity) / 2."""
    return (1.0 - normalize(x) @ normalize(y).t()) / 2.0


def hard_example_mining(dist: torch.Tensor, labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per anchor: the farthest positive and the closest negative."""
    pos = labels[:, None] == labels[None, :]
    big = torch.finfo(dist.dtype).max
    dist_ap = torch.where(pos, dist, torch.full_like(dist, -big)).amax(dim=1)
    dist_an = torch.where(pos, torch.full_like(dist, big), dist).amin(dim=1)
    return dist_ap, dist_an


def _softplus(d: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(d)) without torch's linear cut-off at d > 20."""
    return torch.logaddexp(d, torch.zeros_like(d))


def batch_hard_triplet(feat: torch.Tensor, labels: torch.Tensor,
                       margin: Optional[float] = None) -> torch.Tensor:
    """margin None: soft margin, mean softplus(d_ap - d_an); else mean
    max(0, d_ap - d_an + margin)."""
    dist_ap, dist_an = hard_example_mining(euclidean_dist(feat, feat), labels)
    if margin is not None:
        return (dist_ap - dist_an + margin).clamp_min(0.0).mean()
    return _softplus(dist_ap - dist_an).mean()


def _softmax_weights(dist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    max_v = (dist * mask).amax(dim=1, keepdim=True)
    diff = dist - max_v
    z = (torch.exp(diff) * mask).sum(dim=1, keepdim=True) + 1e-6
    return torch.exp(diff) * mask / z


def weighted_regularized_triplet(feat: torch.Tensor, labels: torch.Tensor,
                                 normalize_feature: bool = False) -> torch.Tensor:
    """TripletLoss_WRT: softmax-weighted positive and negative distances
    per anchor, mean softplus(d_pos - d_neg)."""
    if normalize_feature:
        feat = normalize(feat)
    dist = euclidean_dist(feat, feat)
    is_pos = (labels[:, None] == labels[None, :]).to(dist.dtype)
    is_neg = 1.0 - is_pos
    w_ap = _softmax_weights(dist * is_pos, is_pos)
    w_an = _softmax_weights(-dist * is_neg, is_neg)
    furthest_pos = (dist * is_pos * w_ap).sum(dim=1)
    closest_neg = (dist * is_neg * w_an).sum(dim=1)
    return _softplus(furthest_pos - closest_neg).mean()
