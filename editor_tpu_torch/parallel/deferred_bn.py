"""Deferred BatchNorm: mini-batch BN statistics under GPipe microbatching,
counterpart of ``editor_tpu/parallel/deferred_bn.py`` (reference:
distributed/pipeline/sync/batchnorm.py:23 ``DeferredBatchNorm``).

A BN layer inside a pipeline stage sees microbatches. Each microbatch is
normalised with its own (biased) moments, as in training, while its sums
are accumulated outside the autograd graph into an accumulator that the
stage carries as :func:`~editor_tpu_torch.parallel.pipeline.pipeline_apply`'s
``stage_state``; once the mini-batch has passed, :func:`deferred_bn_commit`
folds the mini-batch moments into the running statistics (the reference's
``_track`` and ``_commit``). Tensors are channel-last ([mb, ..., C]), as the
JAX module's. The EDITOR does not need it: its BN-necks sit after the
pipelined backbone and see the whole batch.

One difference from the JAX function: a commit of an accumulator that
counted no element leaves the running statistics and
``num_batches_tracked`` as they were, where JAX divides by the zero count
and writes NaN.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def bn_params_init(num_features: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    """gamma and beta with the running statistics (reference _BatchNorm's
    parameters and buffers)."""
    kw = dict(dtype=dtype, device=device)
    return {"gamma": torch.ones(num_features, **kw), "beta": torch.zeros(num_features, **kw),
            "running_mean": torch.zeros(num_features, **kw),
            "running_var": torch.ones(num_features, **kw),
            "num_batches_tracked": torch.zeros((), dtype=torch.int32, device=device)}


def bn_acc_init(num_features: int, dtype: torch.dtype = torch.float32,
                device=None) -> Dict[str, torch.Tensor]:
    """A zeroed mini-batch accumulator (reference sum / sum_squares /
    counter, batchnorm.py:43-47)."""
    kw = dict(dtype=dtype, device=device)
    return {"sum": torch.zeros(num_features, **kw), "sum_squares": torch.zeros(num_features, **kw),
            "count": torch.zeros((), **kw)}


def deferred_bn_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                      acc: Dict[str, torch.Tensor], valid=True, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One microbatch through deferred BN (reference forward,
    batchnorm.py:98-132, training): x normalised by its own biased moments,
    scaled and shifted; its sums added to the accumulator where ``valid``
    (a bool or a 0-d tensor), outside the graph. Returns ``(y, acc)``."""
    red = tuple(range(x.dim() - 1))
    mean = x.mean(dim=red)
    var = x.var(dim=red, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * params["gamma"] + params["beta"]
    with torch.no_grad():
        v = torch.as_tensor(valid, dtype=x.dtype, device=x.device)
        n = x.numel() // x.shape[-1]
        acc = {"sum": acc["sum"] + v * x.sum(dim=red),
               "sum_squares": acc["sum_squares"] + v * (x * x).sum(dim=red),
               "count": acc["count"] + v * n}
    return y, acc


def deferred_bn_commit(params: Dict[str, torch.Tensor], acc: Dict[str, torch.Tensor],
                       momentum: Optional[float] = 0.1) -> Dict[str, torch.Tensor]:
    """Fold a mini-batch accumulator into the running statistics (reference
    _commit, batchnorm.py:72-96): an EMA with ``momentum``, or with None the
    cumulative average; mean and biased variance from the sums. Returns new
    params; an accumulator with a zero count returns them unchanged."""
    if float(acc["count"]) == 0:
        return dict(params)
    tracked = params["num_batches_tracked"] + 1
    m = 1.0 / float(tracked) if momentum is None else momentum
    mean = acc["sum"] / acc["count"]
    var = acc["sum_squares"] / acc["count"] - mean * mean
    out = dict(params)
    out["running_mean"] = (1 - m) * params["running_mean"] + m * mean
    out["running_var"] = (1 - m) * params["running_var"] + m * var
    out["num_batches_tracked"] = tracked
    return out
