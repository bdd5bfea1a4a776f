"""Loss factory: counterpart of ``editor_tpu/losses/make_loss.py`` (reference:
layers/make_loss.py). ``ID_LOSS_WEIGHT * CE + TRIPLET_LOSS_WEIGHT * triplet``
per (score, feat) pair, with the reference's list handling (0.5 * first +
0.5 * mean of the rest) and the targets tiled when the features stack
several batches."""

from __future__ import annotations

from typing import Any, Callable

from editor_tpu_torch.losses.softmax import cross_entropy, cross_entropy_label_smooth
from editor_tpu_torch.losses.triplet import batch_hard_triplet


def make_loss(cfg: Any, num_classes: int) -> Callable:
    """Returns loss_func(score, feat, target) -> scalar; score and feat may each
    be a tensor or a list of tensors."""
    sampler = cfg.DATALOADER.SAMPLER
    use_smooth = cfg.MODEL.IF_LABELSMOOTH == "on"
    margin = None if cfg.MODEL.NO_MARGIN else cfg.SOLVER.MARGIN
    id_w = cfg.MODEL.ID_LOSS_WEIGHT
    tri_w = cfg.MODEL.TRIPLET_LOSS_WEIGHT

    def xent(score, target):
        if use_smooth:
            return cross_entropy_label_smooth(score, target, num_classes)
        return cross_entropy(score, target)

    if sampler == "softmax":
        return lambda score, feat, target: cross_entropy(score, target)
    if sampler != "softmax_triplet":
        raise ValueError(f"unsupported sampler '{sampler}'")

    def half_first_half_rest(fn, xs, t):
        if isinstance(xs, (list, tuple)):
            rest = [fn(x, t) for x in xs[1:]]
            return 0.5 * (sum(rest) / len(rest)) + 0.5 * fn(xs[0], t)
        return fn(xs, t)

    def loss_func(score, feat, target):
        f0 = feat[0] if isinstance(feat, (list, tuple)) else feat
        t = target
        if f0.shape[0] != t.shape[0]:
            t = t.repeat(f0.shape[0] // t.shape[0])
        id_loss = half_first_half_rest(xent, score, t)
        tri_loss = half_first_half_rest(
            lambda f, tt: batch_hard_triplet(f, tt, margin=margin), feat, t)
        return id_w * id_loss + tri_w * tri_loss

    return loss_func
