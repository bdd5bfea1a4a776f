"""Epoch-stepped cosine LR schedule with warmup (timm CosineLRScheduler
semantics): counterpart of ``editor_tpu/solver/schedule.py``, as plain
Python on floats (reference: solver/scheduler_factory.py, solver/cosine_lr.py).
The JAX function computes in fp32 and this one in Python floats, so the two
agree to fp32 precision."""

from __future__ import annotations

import math
from typing import Any, Callable


def cosine_lr_schedule(t, base_lr: float, t_initial: int, lr_min: float, warmup_t: int,
                       warmup_lr_init: float) -> float:
    """lr at epoch ``t`` for one param-group base lr: a linear warmup from
    ``warmup_lr_init`` over ``warmup_t`` epochs, then one cosine cycle of
    ``t_initial`` epochs from ``base_lr`` down to ``lr_min``, then ``lr_min``
    (``CosineLRScheduler._get_lr`` with the factory's one cycle: no restarts,
    so its cycle decay and length growth never act)."""
    t = float(t)
    if t < warmup_t:
        return warmup_lr_init + t * (base_lr - warmup_lr_init) / max(warmup_t, 1)
    if t >= t_initial:
        return lr_min
    return lr_min + 0.5 * (base_lr - lr_min) * (1.0 + math.cos(math.pi * t / t_initial))


def make_scheduler(cfg: Any) -> Callable[[Any, float], float]:
    """Returns ``lr_fn(epoch, base_lr) -> lr`` (``create_scheduler``:
    MAX_EPOCHS cosine, WARMUP_ITERS warmup epochs from 0.01 x BASE_LR, floor
    0.001 x BASE_LR, one cycle)."""
    base = cfg.SOLVER.BASE_LR

    def lr_fn(epoch, group_base_lr: float) -> float:
        return cosine_lr_schedule(epoch, base_lr=group_base_lr,
                                  t_initial=cfg.SOLVER.MAX_EPOCHS, lr_min=0.001 * base,
                                  warmup_t=cfg.SOLVER.WARMUP_ITERS,
                                  warmup_lr_init=0.01 * base)

    return lr_fn
