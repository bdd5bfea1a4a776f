"""OCFR: object-centric feature refinement loss with an EMA class-center memory.

Counterpart of ``editor_tpu/models/ocfr.py``. The centers are the
``FUSE_block.memory_cls.{RGB,NIR,TIR}_centers`` buffers of
:class:`~editor_tpu_torch.models.fusion.BlockMask`; they are updated in place,
outside the autograd graph, before the loss reads them (the reference's
order: update first, then the intra loss against the updated, detached
centers).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # torch F.normalize semantics: x / max(||x||, eps)
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(eps)


def ocfr_update_and_loss(centers: Sequence[torch.Tensor],
                         cls_feats: Sequence[Optional[torch.Tensor]],
                         labels: torch.Tensor, momentum: float = 0.8) -> torch.Tensor:
    """EMA-update each modality's centers [K, dim] in place with the batch
    class means of its L2-normalised cls features [B, dim], then return
    the summed MSE of the features against the updated
    centers of their classes. Classes absent from the batch keep their
    centers. The features are normalised and compared in fp32, as in the JAX
    function (an fp64 run rounds here too); the centers keep their dtype."""
    num_classes = centers[0].shape[0]
    onehot = F.one_hot(labels.long(), num_classes).to(torch.float32)  # [B, K]
    counts = onehot.sum(dim=0)
    present = (counts > 0)[:, None]
    denom = counts.clamp_min(1.0)[:, None]
    loss = torch.zeros((), dtype=torch.float32, device=labels.device)
    for center, feat in zip(centers, cls_feats):
        if feat is None:
            continue
        f = _l2_normalize(feat.to(torch.float32))
        with torch.no_grad():
            batch_mean = (onehot.t() @ f) / denom
            center.copy_(torch.where(present, momentum * batch_mean
                                     + (1.0 - momentum) * center, center))
        loss = loss + (center[labels.long()] - f).square().mean()
    return loss
