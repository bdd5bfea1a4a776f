"""Epoch-stepped cosine LR schedule with warmup (timm CosineLRScheduler
semantics): counterpart of ``editor_tpu/solver/schedule.py``, as plain
Python on floats (reference: solver/scheduler_factory.py, solver/cosine_lr.py,
solver/scheduler.py). The JAX function computes in fp32 and this one in
Python floats, so the two agree to fp32 precision. The whole option surface
is here: ``t_mul`` (geometric cycle growth), ``decay_rate`` restarts,
``cycle_limit`` (0 = unlimited), ``warmup_prefix``, and the epoch-scalar LR
noise (:func:`add_lr_noise`); the factory (:func:`make_scheduler`) uses one
cycle and no noise."""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence, Union

import torch


def cosine_lr_schedule(t, base_lr: float, t_initial: int, lr_min: float, warmup_t: int,
                       warmup_lr_init: float, decay_rate: float = 0.1, cycle_limit: int = 1,
                       t_mul: float = 1.0, warmup_prefix: bool = False) -> float:
    """lr at epoch ``t`` for one param-group base lr (``CosineLRScheduler.
    _get_lr``): a linear warmup from ``warmup_lr_init`` over ``warmup_t``
    epochs, then cosine cycles from ``base_lr`` down to ``lr_min``, cycle i
    scaled by ``decay_rate ** i`` and lasting ``t_mul ** i * t_initial``
    epochs (starting at ``(1 - t_mul ** i) / (1 - t_mul) * t_initial``), and
    ``lr_min`` from cycle ``cycle_limit`` on (0: never). ``warmup_prefix``
    starts the cycles after the warmup."""
    t = float(t)
    if t < warmup_t:
        return warmup_lr_init + t * (base_lr - warmup_lr_init) / max(warmup_t, 1)
    tm = t - warmup_t if warmup_prefix else t
    if t_mul != 1.0:
        # +1e-6: the log of an exact cycle boundary may round just below its
        # integer (integer epochs inside a cycle sit far below the next one)
        i = math.floor(math.log1p(-tm / t_initial * (1.0 - t_mul)) / math.log(t_mul) + 1e-6)
        t_i = t_mul ** i * t_initial
        t_curr = tm - (1.0 - t_mul ** i) / (1.0 - t_mul) * t_initial
    else:
        i = math.floor(tm / t_initial)
        t_i = float(t_initial)
        t_curr = tm - t_initial * i
    if cycle_limit > 0 and i >= cycle_limit:
        return lr_min
    gamma = decay_rate ** i
    lr_min_i, lr_max_i = lr_min * gamma, base_lr * gamma
    return lr_min_i + 0.5 * (lr_max_i - lr_min_i) * (1.0 + math.cos(math.pi * t_curr / t_i))


def add_lr_noise(lr: float, t: int, noise_range_t: Optional[Union[int, Sequence[int]]],
                 noise_pct: float = 0.67, noise_std: float = 1.0, noise_seed: int = 42,
                 noise_type: str = "normal") -> float:
    """``Scheduler._add_noise``: a per-epoch scalar perturbation lr (1 +
    noise), active for ``t`` in [noise_range_t[0], noise_range_t[1]) or from
    an int ``noise_range_t`` on, drawn from a CPU ``torch.Generator`` seeded
    ``noise_seed + t``: 'normal' redraws until |noise| < noise_pct,
    'uniform' is uniform in (-noise_pct, noise_pct). ``noise_std`` is
    unused, as in the JAX function."""
    del noise_std
    if noise_range_t is None:
        return lr
    if isinstance(noise_range_t, (list, tuple)):
        apply_noise = noise_range_t[0] <= t < noise_range_t[1]
    else:
        apply_noise = t >= noise_range_t
    if not apply_noise:
        return lr
    g = torch.Generator()
    g.manual_seed(noise_seed + t)
    if noise_type == "normal":
        while True:
            noise = torch.randn(1, generator=g).item()
            if abs(noise) < noise_pct:
                break
    else:
        noise = 2 * (torch.rand(1, generator=g).item() - 0.5) * noise_pct
    return lr + lr * noise


def make_scheduler(cfg: Any) -> Callable[[Any, float], float]:
    """Returns ``lr_fn(epoch, base_lr) -> lr`` (``create_scheduler``:
    MAX_EPOCHS cosine, WARMUP_ITERS warmup epochs from 0.01 x BASE_LR, floor
    0.001 x BASE_LR, one cycle)."""
    base = cfg.SOLVER.BASE_LR

    def lr_fn(epoch, group_base_lr: float) -> float:
        return cosine_lr_schedule(epoch, base_lr=group_base_lr,
                                  t_initial=cfg.SOLVER.MAX_EPOCHS, lr_min=0.001 * base,
                                  warmup_t=cfg.SOLVER.WARMUP_ITERS,
                                  warmup_lr_init=0.01 * base, decay_rate=0.1, cycle_limit=1)

    return lr_fn
