"""The kernel wrappers' share of ``utils.profiling.cost_analysis``.

``torch.utils.flop_counter.FlopCounterMode`` counts the aten products an
operation dispatches. A wrapper that launches its CUDA kernel through ctypes
dispatches none, and on the CPU the same wrapper runs its plain version,
whose products the counter would see. So while a count is open
(:func:`counting`), each wrapper counts its work once from its shapes, the
operations the plain version's products take (the counts of the bound in
``chip_smoke.py``, over every query-key pair, masked or not), and runs with
the dispatch modes switched off, so nothing inside it is counted again.
Outside a count a wrapper runs as it is, with one list lookup more.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, List

from torch.utils._python_dispatch import _disable_current_modes

_OPEN: List[Dict[str, float]] = []  # the open counts, innermost last


@contextlib.contextmanager
def counting(into: Dict[str, float]):
    """Inside the block the wrappers add their operations to ``into`` (by
    wrapper name) instead of dispatching countable ops."""
    _OPEN.append(into)
    try:
        yield into
    finally:
        _OPEN.remove(into)


def counted(formula: Callable[..., float]):
    """Decorate a kernel wrapper whose work is ``formula(*args, **kwargs)``
    operations."""

    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _OPEN:
                return fn(*args, **kwargs)
            into = _OPEN[-1]
            into[fn.__name__] = into.get(fn.__name__, 0.0) + float(formula(*args, **kwargs))
            with _disable_current_modes():
                return fn(*args, **kwargs)

        return wrapper

    return wrap


def attention(qkv, *_args, **_kwargs) -> float:
    """q k^T and p v over every query-key pair of qkv [B, N, 3C]: 4 B N^2 C."""
    B, N, C3 = qkv.shape
    return 4.0 * B * N * N * (C3 // 3)


def attention_bwd(qkv, *_args, **_kwargs) -> float:
    """The logits again and the four products of the backward: 10 B N^2 C."""
    B, N, C3 = qkv.shape
    return 10.0 * B * N * N * (C3 // 3)


def rollout(probs, *_args, **_kwargs) -> float:
    """The vector chain v <- v A_l over L - 1 maps [L, B, H, N, N]."""
    L, B, H, N, _ = probs.shape
    return 2.0 * (L - 1) * B * H * N * N


def ln_matmul(x, weight, *_args, **_kwargs) -> float:
    """The product of the normalised rows [T, C] with the weight [O, C]."""
    O, C = weight.shape
    return 2.0 * (x.numel() // C) * C * O
