"""Numerical and collective debugging aids: counterpart of
``editor_tpu/utils/debug.py`` (reference: c10d's debug levels and
``monitored_barrier``, distributed_c10d.py).

A tree here is what the JAX package's pytrees are to it: nested dicts, lists
and tuples (None holds no leaf) with tensors or numpy arrays as leaves; an
``nn.Module`` or an optimizer stands for its ``state_dict()``. Leaves are
visited in JAX's order (a dict's keys sorted, an ``OrderedDict``'s in
insertion order) and named by JAX's ``keystr`` form (``['a']['b'][0]``, a
namedtuple's field as ``.name``), so the same tree gives the same strings.
"""

from __future__ import annotations

import datetime
import time
from collections import OrderedDict
from typing import Any, Iterator, List, Tuple

import numpy as np
import torch
import torch.distributed as dist


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd's anomaly mode: a backward that produces a NaN raises at the
    op, naming the forward op it came from (JAX's ``jax_debug_nans`` traps
    forward NaNs too; here the forward is checked by :func:`assert_tree_finite`)."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, (torch.nn.Module, torch.optim.Optimizer)):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        keys = list(tree) if isinstance(tree, OrderedDict) else sorted(tree)
        for k in keys:
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _leaves_with_path(getattr(tree, name), f"{path}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def _float_array(leaf: Any):
    """A float leaf as a numpy array (bf16 / fp16 tensors as fp32), else None."""
    if isinstance(leaf, torch.Tensor):
        if not leaf.is_floating_point():
            return None
        t = leaf.detach()
        return (t if t.dtype in (torch.float32, torch.float64) else t.float()).cpu().numpy()
    if isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
        return leaf
    return None


def nonfinite_leaves(tree: Any) -> List[str]:
    """Paths of the float leaves that hold a NaN or an Inf."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(path)
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
            if not np.isfinite(leaf).all():
                bad.append(path)
    return bad


def assert_tree_finite(tree: Any, name: str = "tree") -> None:
    bad = nonfinite_leaves(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:10]}"
                                 + (" ..." if len(bad) > 10 else ""))


def checked_update(step_fn, check_every: int = 100):
    """Wrap a train step ``step_fn(state, ...)``: every ``check_every``-th
    call sweeps the new state (the output, or its first element when it is
    a tuple) for NaN/Inf and raises ``FloatingPointError``."""
    counter = {"n": 0}

    def wrapped(state, *args, **kwargs):
        out = step_fn(state, *args, **kwargs)
        counter["n"] += 1
        if counter["n"] % check_every == 0:
            assert_tree_finite(out[0] if isinstance(out, tuple) else out, "train state")
        return out

    return wrapped


def monitored_barrier(timeout_s: float = 60.0, name: str = "barrier") -> float:
    """A barrier over the default process group with a deadline; returns its
    seconds (0.0 without a group, as JAX with one process). Under gloo it is
    ``torch.distributed.monitored_barrier``, which names the ranks that did
    not arrive; under NCCL a barrier timed on the host. Past ``timeout_s``
    it raises ``TimeoutError``."""
    if not dist.is_available() or not dist.is_initialized():
        return 0.0
    t0 = time.time()
    if dist.get_backend() == "gloo":
        try:
            dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError as e:
            raise TimeoutError(f"{name}: {e}") from e
    else:
        dist.barrier()
    dt = time.time() - t0
    if dt > timeout_s:
        raise TimeoutError(f"{name}: barrier took {dt:.1f}s (> {timeout_s}s): check worker "
                           "heartbeats in the elastic supervisor logs")
    return dt


def summarize_tree(tree: Any, max_leaves: int = 20) -> str:
    """One line of stats per float leaf among the first ``max_leaves``
    leaves: path, shape, mean, std and the largest magnitude."""
    lines = []
    for path, leaf in list(_leaves_with_path(tree))[:max_leaves]:
        arr = _float_array(leaf)
        if arr is not None:
            lines.append(f"{path}: shape={arr.shape} mean={arr.mean():.4g} "
                         f"std={arr.std():.4g} absmax={np.abs(arr).max():.4g}")
    return "\n".join(lines)
