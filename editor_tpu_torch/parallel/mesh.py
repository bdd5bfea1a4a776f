"""The ('data', 'model') device mesh and the batch layout over it:
counterpart of ``editor_tpu/parallel/mesh.py``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group (one process per device, see :mod:`.multihost`), laid out as
JAX's ``mesh_utils.create_device_mesh((data, model))``: rank ``d * model +
m`` sits at data index d and model index m, so the ranks of one model group
(tensor parallelism, :mod:`.tp`) are adjacent. With a pipeline (``stage=``)
the mesh is ('data', 'stage', 'model'), JAX's 3D layout of
``__graft_entry__.dryrun_multichip``'s flavor 5: rank ``(d * stage + s) *
model + m``. The batch is cut by the data rank only: every rank of a model
group, and every stage of a data row, holds the same rows. The JAX module's
``batch_sharding`` (a ``NamedSharding`` that lets the compiler split a
global array) has no torch counterpart and is left out: here each rank holds
its own rows, either cut from a global batch (:func:`shard_batch`) or loaded
as its host shard (:func:`shard_host_batch`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from editor_tpu_torch.data.sampler import host_rows

AXES = ("data", "model")
AXES_PP = ("data", "stage", "model")


def make_mesh(data: int = -1, model: int = 1, stage: Optional[int] = None) -> DeviceMesh:
    """A ('data', 'model') mesh over every rank of the default group, or with
    ``stage`` (pipeline stages, 1 or more) a ('data', 'stage', 'model')
    mesh; ``data=-1`` takes all ranks over the other axes. Needs an
    initialised group (NCCL: a CUDA mesh, gloo: a CPU mesh)."""
    if model < 1 or (stage is not None and stage < 1):
        raise ValueError(f"model axis {model} or stage axis {stage} < 1")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize)")
    n = dist.get_world_size()
    inner = model * (stage or 1)
    data = n // inner if data == -1 else data
    if data * inner != n:
        raise ValueError(f"mesh {data}x{stage or 1}x{model} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if stage is None:
        return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)
    return init_device_mesh(device_type, (data, stage, model), mesh_dim_names=AXES_PP)


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def data_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("data")


def model_size(mesh: Optional[DeviceMesh]) -> int:
    """The 'model' axis's size (tensor-parallel degree); 1 without a mesh
    or without the axis."""
    if mesh is None:
        return 1
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a DeviceMesh (parallel.mesh.make_mesh), not {mesh!r}")
    if "model" not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index("model"))


def model_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("model")


def stage_size(mesh: Optional[DeviceMesh]) -> int:
    """The 'stage' axis's size (pipeline stages); 1 without a mesh or
    without the axis."""
    if mesh is None or "stage" not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index("stage"))


def stage_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's stage; 0 without a 'stage' axis."""
    if mesh is None or "stage" not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank("stage")


def model_group(mesh: DeviceMesh):
    """The process group of this rank's model group (the ranks that hold
    the same rows and one shard each of the backbone)."""
    return mesh.get_group("model")


def axis_group(mesh, axis: str):
    """(process group, size) of ``mesh``'s dimension ``axis``: a
    ``DeviceMesh`` with that dimension name, or a process group taken as
    the axis itself."""
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        if axis not in names:
            raise ValueError(f"the mesh has no '{axis}' dimension (dimensions {names})")
        pg = mesh.get_group(axis)
    elif isinstance(mesh, dist.ProcessGroup):
        pg = mesh
    else:
        raise TypeError(f"a '{axis}' mesh is a DeviceMesh or a process group, not {mesh!r}")
    return pg, dist.get_world_size(pg)


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
    ``host_shard(..., grad_accum)`` loads (``data.sampler.host_rows``).
    The 'stage' and 'model' axes replicate the batch (JAX's step on a
    mesh with only a stage axis replicates it)."""
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
