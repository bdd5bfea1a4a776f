"""Center loss (Wen et al., ECCV 2016): counterpart of
``editor_tpu/losses/center.py`` (reference: layers/center_loss.py). The
centers are trainable parameters with their own SGD (reference:
solver/make_optimizer.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def center_loss_init(gen: torch.Generator, num_classes: int, feat_dim: int = 2048) -> dict:
    """{'centers': [num_classes, feat_dim]} standard-normal draws from
    ``gen``, on the generator's device."""
    return {"centers": torch.randn(num_classes, feat_dim, generator=gen, device=gen.device)}


def center_loss(params: dict, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The sum of squared distances to the own class's center over the batch
    size, with the reference's clamp(1e-12, 1e12) over the whole masked
    matrix (its zeros included), in fp32 whatever the inputs' dtype, as the
    JAX function computes."""
    centers = params["centers"].to(torch.float32)
    xf = x.to(torch.float32)
    d = ((xf * xf).sum(1, keepdim=True) + (centers * centers).sum(1)[None, :]
         - 2.0 * xf @ centers.t())
    mask = F.one_hot(labels.long(), centers.shape[0]).to(torch.float32)
    return (d * mask).clamp(1e-12, 1e12).sum() / x.shape[0]
