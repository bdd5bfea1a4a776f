"""Profiling and tracing harness: counterpart of
``editor_tpu/utils/profiling.py`` (reference: the autograd profiler of the
RPC layer and the pipeline's auto-balance profiling).

* :func:`trace` - a ``torch.profiler`` trace (host and, with a card, CUDA
  activity), written as a Chrome trace into ``logdir``;
* :func:`annotate` - a named range in that trace (``record_function``) and,
  with CUDA, an NVTX range;
* :func:`sync`, :func:`benchmark`, :func:`flops_per_second` - timing with
  completion semantics, the JAX functions' keys;
* :func:`cost_analysis` - the operations a call takes, counted by
  ``torch.utils.flop_counter.FlopCounterMode``. The port's kernel wrappers
  count their own work from their shapes (:mod:`editor_tpu_torch.ops._flops`),
  so a forward counts the same with the kernels (``use_pallas=True``) as with
  the plain versions, on the card and on the CPU. Its ``flops`` are what
  ``parallel.pipeline.balance_stages`` takes as per-layer costs, as in JAX.

``cost_analysis`` runs the call once (JAX's only lowers it), so its side
effects happen; counts are taken one at a time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Trace the block: host ops and, with CUDA, every kernel on the card
    (the port's ctypes launches included), written to
    ``logdir/trace.json`` (Chrome trace format, which Perfetto opens; JAX's
    ``create_perfetto_link`` has no counterpart here)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in traces: ``record_function`` and, with CUDA, NVTX."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree: Any) -> None:
    """Wait until the work that made the tree's tensors is done: synchronise
    each CUDA device they lie on (CPU tensors are done when made)."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1,
              **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)`` on the host clock, each call synchronised
    through its outputs. Returns {'mean_s', 'p50_s', 'min_s', 'iters'}."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(out)
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {"mean_s": float(times.mean()), "p50_s": float(np.median(times)),
            "min_s": float(times.min()), "iters": iters}


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{'flops': the operations of one call of ``fn(*args, **kwargs)``}:
    ``FlopCounterMode``'s count of the products it dispatches (2 M N K a
    matrix product, convolutions likewise) plus each kernel wrapper's count
    from its shapes; a backward run inside ``fn`` is counted too."""
    from torch.utils.flop_counter import FlopCounterMode

    from editor_tpu_torch.ops import _flops

    wrappers: Dict[str, float] = {}
    with FlopCounterMode(display=False) as counter, _flops.counting(wrappers):
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()) + sum(wrappers.values())}


def flops_per_second(fn: Callable, *args, iters: int = 10, **kwargs) -> Dict[str, float]:
    """:func:`benchmark`'s timing with the achieved rate against
    :func:`cost_analysis`'s count: adds 'flops' and 'tflops_per_s'."""
    flops = cost_analysis(fn, *args, **kwargs).get("flops", 0.0)
    timing = benchmark(fn, *args, iters=iters, **kwargs)
    return {**timing, "flops": flops,
            "tflops_per_s": flops / timing["p50_s"] / 1e12 if flops else 0.0}
