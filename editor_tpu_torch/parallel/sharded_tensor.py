"""Sharded tensors: chunk and enumerable sharding specs over the mesh, as
``torch.distributed.tensor.DTensor``s: counterpart of
``editor_tpu/parallel/sharded_tensor.py`` (reference:
distributed/_sharded_tensor/api.py (ShardedTensor), _sharding_spec/api.py
(ChunkShardingSpec, EnumerableShardingSpec)).

A spec names one dimension of the tensor and one dimension (axis) of a
``DeviceMesh`` (:func:`editor_tpu_torch.parallel.mesh.make_mesh`): the tensor
is cut into even chunks along it, one per coordinate of that axis (DTensor's
``Shard`` rule: chunks of ceil(n / size) rows, the last ones shorter or
empty), and replicated over the mesh's other axes. Every rank calls the
factories collectively, as with JAX's global arrays.

``sharded_rand`` draws the whole tensor from a CPU ``torch.Generator``
seeded with ``seed`` on every rank, and each rank keeps its chunk, so the
values do not depend on the world size or the device; they are not the JAX
package's (its PRNG is another).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard


@dataclasses.dataclass(frozen=True)
class ChunkShardingSpec:
    """Even chunks of tensor dimension ``dim`` over mesh dimension ``axis``."""
    dim: int
    axis: str = "data"

    def placements(self, mesh: DeviceMesh) -> tuple:
        """The DTensor placements: ``Shard(dim)`` on ``axis``, ``Replicate``
        on the mesh's other dimensions (JAX's ``named_sharding``)."""
        names = mesh.mesh_dim_names or ()
        if self.axis not in names:
            raise ValueError(f"the mesh has no '{self.axis}' dimension (dimensions {names})")
        return tuple(Shard(self.dim) if n == self.axis else Replicate() for n in names)


@dataclasses.dataclass(frozen=True)
class ShardMetadata:
    shard_offsets: Tuple[int, ...]
    shard_sizes: Tuple[int, ...]
    device_index: int


@dataclasses.dataclass(frozen=True)
class EnumerableShardingSpec:
    """Explicit per-shard placement; the shards must tile the tensor."""
    shards: Tuple[ShardMetadata, ...]

    def validate(self, shape: Sequence[int]) -> None:
        total = int(np.prod(shape))
        covered = 0
        for s in self.shards:
            if len(s.shard_offsets) != len(shape):
                raise ValueError("shard rank mismatch")
            for o, sz, dim in zip(s.shard_offsets, s.shard_sizes, shape):
                if o < 0 or o + sz > dim:
                    raise ValueError(f"shard [{o}:{o+sz}] exceeds dim {dim}")
            covered += int(np.prod(s.shard_sizes))
        if covered != total:
            raise ValueError("shards do not tile the tensor")


def _distribute(spec: ChunkShardingSpec, full: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """Each rank keeps its chunk of ``full`` (the same on every rank)."""
    return DTensor.from_local(_chunk(full, spec, mesh), mesh, spec.placements(mesh),
                              run_check=False, shape=full.shape, stride=full.stride())


def _chunk(full: torch.Tensor, spec: ChunkShardingSpec, mesh: DeviceMesh) -> torch.Tensor:
    n = mesh.size(mesh.mesh_dim_names.index(spec.axis))
    off, size = _chunk_span(full.shape[spec.dim], n, mesh.get_local_rank(spec.axis))
    return full.narrow(spec.dim, off, size).contiguous().to(mesh.device_type)


def _chunk_span(length: int, n: int, index: int) -> Tuple[int, int]:
    """(offset, size) of chunk ``index`` of ``n`` along an extent of
    ``length`` (``torch.chunk`` sizes; chunks past the end are empty)."""
    step = -(-length // n)
    off = min(index * step, length)
    return off, min(step, length - off)


def sharded_zeros(spec: ChunkShardingSpec, shape, mesh: DeviceMesh,
                  dtype=torch.float32) -> DTensor:
    from torch.distributed import tensor as dt
    return dt.zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                    placements=spec.placements(mesh))


def sharded_ones(spec: ChunkShardingSpec, shape, mesh: DeviceMesh,
                 dtype=torch.float32) -> DTensor:
    from torch.distributed import tensor as dt
    return dt.ones(tuple(shape), dtype=dtype, device_mesh=mesh,
                   placements=spec.placements(mesh))


def sharded_full(spec: ChunkShardingSpec, shape, value, mesh: DeviceMesh,
                 dtype=torch.float32) -> DTensor:
    from torch.distributed import tensor as dt
    return dt.full(tuple(shape), value, dtype=dtype, device_mesh=mesh,
                   placements=spec.placements(mesh))


def sharded_rand(spec: ChunkShardingSpec, shape, mesh: DeviceMesh, seed: int = 0,
                 dtype=torch.float32) -> DTensor:
    """Uniform [0, 1) values of the whole tensor from a CPU generator seeded
    ``seed`` (the same on every rank and at every world size), each rank
    keeping its chunk."""
    gen = torch.Generator().manual_seed(seed)
    return _distribute(spec, torch.rand(tuple(shape), generator=gen, dtype=dtype), mesh)


def from_enumerable(spec: EnumerableShardingSpec, shape,
                    host_fill: Callable[[ShardMetadata], np.ndarray], mesh: DeviceMesh,
                    dtype=torch.float32) -> DTensor:
    """A sharded tensor from explicitly placed per-shard host data,
    ``host_fill(meta) -> np.ndarray`` giving each shard's contents. Only a
    regular tiling of one dimension maps onto the mesh: it is laid out as
    the chunk spec of that dimension over the mesh's first axis."""
    spec.validate(shape)
    dims = [i for i in range(len(shape)) if any(s.shard_offsets[i] != 0 for s in spec.shards)]
    if len(dims) != 1:
        raise ValueError("only single-dim enumerable layouts supported")
    dim = dims[0]
    order = sorted(spec.shards, key=lambda s: s.shard_offsets[dim])
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    data = np.concatenate([np.asarray(host_fill(s), np_dtype) for s in order], axis=dim)
    return _distribute(ChunkShardingSpec(dim=dim, axis=mesh.mesh_dim_names[0]),
                       torch.from_numpy(data), mesh)


def shard_metadata_of(arr: DTensor) -> List[ShardMetadata]:
    """Every rank's shard of ``arr``, in rank order, ``device_index`` the
    global rank (``ShardedTensor.metadata``)."""
    mesh, shape = arr.device_mesh, tuple(arr.shape)
    ranks = mesh.mesh
    out = []
    for r in sorted(int(x) for x in ranks.flatten()):
        coord = [int(c[0]) for c in torch.nonzero(ranks == r, as_tuple=True)]
        offsets, sizes = [0] * len(shape), list(shape)
        for mdim, p in enumerate(arr.placements):
            if isinstance(p, Shard):
                if offsets[p.dim] or sizes[p.dim] != shape[p.dim]:
                    raise ValueError(f"dimension {p.dim} is sharded over two mesh dimensions")
                offsets[p.dim], sizes[p.dim] = _chunk_span(shape[p.dim], ranks.shape[mdim],
                                                           coord[mdim])
        out.append(ShardMetadata(tuple(offsets), tuple(sizes), r))
    return out
