"""The ('data', 'model') device mesh and the batch layout over it:
counterpart of ``editor_tpu/parallel/mesh.py``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group (one process per device, see :mod:`.multihost`). Only data
parallelism is ported: ``model`` must be 1. The JAX module's
``batch_sharding`` (a ``NamedSharding`` that lets the compiler split a
global array) has no torch counterpart and is left out: here each rank holds
its own rows, either cut from a global batch (:func:`shard_batch`) or loaded
as its host shard (:func:`shard_host_batch`).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from editor_tpu_torch.data.sampler import host_rows

AXES = ("data", "model")


def make_mesh(data: int = -1, model: int = 1) -> DeviceMesh:
    """A ('data', 'model') mesh over every rank of the default group;
    ``data=-1`` takes all ranks. Needs an initialised group (NCCL: a CUDA
    mesh, gloo: a CPU mesh). ``model > 1`` (tensor parallelism) is not
    ported and raises."""
    if model != 1:
        raise NotImplementedError("a 'model' mesh axis above 1 (tensor parallelism) "
                                  "is not ported")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize)")
    n = dist.get_world_size()
    data = n // model if data == -1 else data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def data_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("data")


def replicated(mesh: DeviceMesh) -> tuple:
    """The placement of a replicated tensor on ``mesh`` (JAX's ``P()``)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in range(mesh.ndim))


def shard_batch(mesh: DeviceMesh, batch: Dict[str, Any], grad_accum: int = 1
                ) -> Dict[str, Any]:
    """This rank's rows of a global batch (every rank holds the same
    ``batch``; tensors or numpy arrays, rows first): the r-th of W
    contiguous blocks. With ``grad_accum`` A > 1 the global batch is A
    microbatches of B/A rows, and the rank takes the r-th block of each, so
    that its local microbatch i is its part of global microbatch i (the
    global-batch step accumulates over them in that order): the rows
    ``host_shard(..., grad_accum)`` loads (``data.sampler.host_rows``)."""
    W, r = data_size(mesh), data_rank(mesh)
    n = len(next(iter(batch.values())))
    idx = torch.from_numpy(host_rows(n, r, W, grad_accum))
    out = {}
    for k, v in batch.items():
        out[k] = v[idx.to(v.device)] if isinstance(v, torch.Tensor) else v[idx.numpy()]
    return out


def shard_host_batch(mesh: DeviceMesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's local rows as they are: each rank loads its own
    ``host_shard`` rows of every global batch (``ReIDDataModule.train_epoch(
    epoch, host_id, num_hosts, grad_accum)``), the rows :func:`shard_batch`
    would cut. Every rank must hold the same number of rows."""
    del mesh
    return batch
