"""ID (classification) losses: counterpart of ``editor_tpu/losses/softmax.py``
(reference: layers/softmax_loss.py). Computed in at least fp32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from editor_tpu_torch.ops._checks import compute_dtype


def cross_entropy_label_smooth(logits: torch.Tensor, targets: torch.Tensor,
                               num_classes: int, epsilon: float = 0.1) -> torch.Tensor:
    """CrossEntropyLabelSmooth: ``(-t * log_softmax(x)).mean(0).sum()`` with
    ``t = (1 - eps) * onehot + eps / K``."""
    cd = compute_dtype(logits.dtype)
    logp = torch.log_softmax(logits.to(cd), dim=1)
    t = (1.0 - epsilon) * F.one_hot(targets.long(), num_classes).to(cd) + epsilon / num_classes
    return (-t * logp).mean(dim=0).sum()


def label_smoothing_ce(logits: torch.Tensor, targets: torch.Tensor,
                       smoothing: float = 0.1) -> torch.Tensor:
    """LabelSmoothingCrossEntropy: (1 - smoothing) NLL + smoothing x the mean
    negative log-probability over the classes, averaged over the batch."""
    logp = torch.log_softmax(logits.to(compute_dtype(logits.dtype)), dim=-1)
    nll = -logp.gather(1, targets.long()[:, None])[:, 0]
    return ((1.0 - smoothing) * nll - smoothing * logp.mean(dim=-1)).mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Plain CE, mean reduction."""
    logp = torch.log_softmax(logits.to(compute_dtype(logits.dtype)), dim=-1)
    return -logp.gather(1, targets.long()[:, None]).mean()
