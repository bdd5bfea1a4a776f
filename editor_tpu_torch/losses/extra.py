"""Auxiliary metric losses off the main path: counterpart of
``editor_tpu/losses/extra.py`` (reference: layers/cluster_loss.py
(ClusterLoss), layers/range_loss.py (RangeLoss), layers/hcloss.py
(hetero_loss), layers/mutilmargin.py (multiModalMarginLossNew)), vectorised
over P x K batches (rows ordered class by class, K a class). Computed in at
least fp32 (``_ct``), exactly at f64."""

from __future__ import annotations

from typing import Tuple

import torch

from editor_tpu_torch.ops._checks import compute_dtype as _ct


def _pk_centers(features: torch.Tensor, P: int, K: int) -> torch.Tensor:
    """Class centers of a P x K-ordered batch -> [P, dim], in the features'
    dtype."""
    return features.reshape(P, K, -1).mean(1)


def _dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise euclidean distances over the last two dims, clamp(1e-12)
    before the root."""
    xf, yf = x.to(_ct(x.dtype)), y.to(_ct(y.dtype))
    d = ((xf * xf).sum(-1, keepdim=True) + (yf * yf).sum(-1).unsqueeze(-2)
         - 2 * xf @ yf.transpose(-1, -2))
    return d.clamp_min(1e-12).sqrt()


def _off_diagonal(d: torch.Tensor) -> torch.Tensor:
    """``d`` with the dtype's largest value added on the diagonal (a min over
    it skips the diagonal)."""
    P = d.shape[-1]
    return d + torch.finfo(d.dtype).max * torch.eye(P, dtype=d.dtype, device=d.device)


def cluster_loss(features: torch.Tensor, targets: torch.Tensor, P: int, K: int,
                 margin: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ClusterLoss: per class, relu(the largest center-to-member distance -
    the smallest center-to-center distance + margin), averaged; returns
    (loss, intra_max [P], inter_min [P])."""
    del targets  # the P x K layout gives the classes
    centers = _pk_centers(features, P, K)
    feats = features.reshape(P, K, -1).to(_ct(features.dtype))
    intra_max = torch.linalg.vector_norm(feats - centers[:, None, :], dim=-1).amax(1)
    inter_min = _off_diagonal(_dist(centers, centers)).amin(1)
    loss = torch.relu(intra_max - inter_min + margin).mean()
    return loss, intra_max, inter_min


def range_loss(features: torch.Tensor, targets: torch.Tensor, P: int, K: int, k: int = 2,
               margin: float = 0.1, alpha: float = 0.5, beta: float = 0.5
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RangeLoss: intra = per class the harmonic mean of its k largest
    pairwise distances, summed over classes; inter = relu(margin - the
    smallest center distance); returns (alpha intra + beta inter, intra,
    inter)."""
    del targets
    feats = features.reshape(P, K, -1).to(_ct(features.dtype))
    d = _dist(feats, feats)  # [P, K, K]
    upper = torch.ones(K, K, dtype=torch.bool, device=d.device).triu(1)
    vals = torch.where(upper, d, torch.full_like(d, -float("inf"))).reshape(P, K * K)
    top = vals.topk(k, dim=1).values
    intra_loss = (k / (1.0 / top.clamp_min(1e-12)).sum(1)).sum()
    centers = _pk_centers(features, P, K)
    min_center = _off_diagonal(_dist(centers, centers)).amin()
    inter_loss = torch.relu(margin - min_center)
    return alpha * intra_loss + beta * inter_loss, intra_loss, inter_loss


def hetero_center_loss(feat1: torch.Tensor, feat2: torch.Tensor, P: int, K: int,
                       margin: float = 0.1, dist_type: str = "l2") -> torch.Tensor:
    """hetero_loss: per class the distance between the two modalities'
    centers ('l2': summed squares, 'l1': mean absolute, 'cos': relu(1 -
    cosine)), summed over classes."""
    del margin  # unused, as in the JAX function
    c1 = _pk_centers(feat1, P, K).to(_ct(feat1.dtype))
    c2 = _pk_centers(feat2, P, K).to(_ct(feat2.dtype))
    if dist_type == "l2":
        d = (c1 - c2).square().sum(1)
    elif dist_type == "l1":
        d = (c1 - c2).abs().mean(1)
    elif dist_type == "cos":
        cs = (c1 * c2).sum(1) / (torch.linalg.vector_norm(c1, dim=1)
                                 * torch.linalg.vector_norm(c2, dim=1) + 1e-12)
        d = torch.relu(1.0 - cs)
    else:
        raise ValueError(dist_type)
    return torch.relu(d.abs()).sum()


def multi_modal_margin_loss(feat1: torch.Tensor, feat2: torch.Tensor, feat3: torch.Tensor,
                            targets: torch.Tensor, P: int, K: int,
                            margin: float = 3.0) -> torch.Tensor:
    """multiModalMarginLossNew: per class the largest over the modality
    pairs of |margin - the summed squared center distance|, summed."""
    del targets
    c1, c2, c3 = (_pk_centers(f, P, K).to(_ct(f.dtype)) for f in (feat1, feat2, feat3))
    d12 = (c1 - c2).square().sum(1)
    d23 = (c2 - c3).square().sum(1)
    d13 = (c1 - c3).square().sum(1)
    per_class = torch.maximum(torch.maximum((margin - d12).abs(), (margin - d23).abs()),
                              (margin - d13).abs())
    return per_class.sum()
