"""LocalSGD / periodic model averaging: counterpart of
``editor_tpu/parallel/localsgd.py``.

reference: distributed/algorithms/model_averaging/averagers.py:29
(PeriodicModelAverager) and optim/post_localSGD_optimizer.py:7
(PostLocalSGDOptimizer): every rank runs its own update for ``start_step``
steps with the parameters averaged after each (as DDP), then averages them
only every ``period`` steps.

In torch the replica axis is the process: each rank's model is its replica,
so the JAX module's ``stack_replicas`` and ``unstack_replica`` (a stacked
leading axis sharded over 'data') have no counterpart here. As in JAX, only
the trainable parameters are averaged: not the BN running stats, not the
OCFR centers, not the optimizer slots. Like JAX, no training loop runs
LocalSGD; a caller wraps its own per-rank update.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Union

import torch

from editor_tpu_torch.parallel import collectives as C


def _params(model: Union[torch.nn.Module, Iterable[torch.Tensor]]):
    if isinstance(model, torch.nn.Module):
        return [p for p in model.parameters() if p.requires_grad]
    return list(model)


@torch.no_grad()
def average_params(model: Union[torch.nn.Module, Iterable[torch.Tensor]], group=None) -> None:
    """``PeriodicModelAverager.average_parameters``: every trainable
    parameter of ``model`` (or every tensor of an iterable) replaced by its
    mean over ``group``, through one flat all-reduce a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in _params(model):
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = C.all_reduce(torch.cat([p.reshape(-1) for p in ps]), group, "mean")
        off = 0
        for p in ps:
            p.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()


def build_localsgd_train_step(local_update: Callable[[Any, Any], Dict[str, Any]], mesh,
                              period: int = 4, start_step: int = 0, *,
                              model: Union[torch.nn.Module, Iterable[torch.Tensor]]
                              ) -> Callable[[Any, Any, int], Dict[str, Any]]:
    """Wrap this rank's update ``local_update(batch, epoch) -> metrics``
    (the single-device ``engine.train.build_train_step``, say, which changes
    ``model`` in place) into ``step(batch, epoch, step_idx) -> metrics``:
    the update on this rank's ``batch``, then the parameters of ``model``
    averaged over ``mesh``'s data axis when ``step_idx < start_step`` or
    ``(step_idx + 1) % period == 0``. The metrics come back mean-reduced
    over the ranks as float32 tensors, with ``averaged`` (1 or 0), as
    JAX's."""
    params = _params(model)

    def step(batch, epoch, step_idx: int) -> Dict[str, Any]:
        metrics = local_update(batch, epoch)
        averaged = int(step_idx) < start_step or (int(step_idx) + 1) % period == 0
        if averaged:
            average_params(params, mesh)
        metrics = dict(metrics, averaged=int(averaged))
        names = sorted(metrics)
        device = params[0].device
        vals = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device)
                            .detach().reshape(()) for k in names])
        vals = C.all_reduce(vals, mesh, "mean")
        return dict(zip(names, vals.unbind(0)))

    return step
