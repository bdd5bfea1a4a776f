"""Collectives over a mesh dimension's process group: counterpart of
``editor_tpu/parallel/collectives.py`` (reference: distributed_c10d.py).

The twelve functions of the JAX module, with its semantics: every rank
calls each of them, and the rooted ones (``reduce``, ``gather``,
``scatter``) give every rank a result, the root's being the meaningful one.
They are differentiable where the JAX ones are, as autograd Functions whose
backward is the collective JAX transposes to (``all_reduce`` sum: sum,
``all_gather``: reduce-scatter, ``reduce_scatter``: all-gather,
``all_to_all``: the reverse all-to-all, a permutation: its inverse), so a
rank's gradient is that of the sum of every rank's loss. A backward runs a
collective too, so every rank must run the same backward. The max and min
reductions, as ``lax.pmax``/``pmin``, have no gradient.

``group`` is a ``DeviceMesh`` (its 'data' dimension), a process group, or
None (the default group). Written on ``torch.distributed``'s tensor
collectives (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all``, ``batch_isend_irecv``), which NCCL and gloo both run, and
not on ``torch.distributed.nn.functional``, which newer torch deprecates.
Each call of a torch collective adds one to its count
(:func:`collective_counts`), forward and backward alike. Beside them, the
two conjugate operations of tensor parallelism (:func:`copy_to_group`,
:func:`reduce_from_group`), whose gradient is that of one replicated loss.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_COUNTS: Counter = Counter()


def collective_counts() -> dict:
    """Calls of each torch collective since the last reset."""
    return dict(_COUNTS)


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _pg(group):
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(group, DeviceMesh):
        return group.get_group("data")
    return group


# ---------------------------------------------------------------------------
# primitives (each one torch collective, counted)
# ---------------------------------------------------------------------------

def _all_reduce_(x: torch.Tensor, pg, op=dist.ReduceOp.SUM) -> torch.Tensor:
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(x, op=op, group=pg)
    return x


def _all_gather0(x: torch.Tensor, pg) -> torch.Tensor:
    """[W, *x.shape]: every rank's x, in rank order."""
    _COUNTS["all_gather"] += 1
    W = dist.get_world_size(pg)
    out = torch.empty(W * x.numel(), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous().reshape(-1), group=pg)
    return out.view((W,) + tuple(x.shape))


def _reduce_scatter0(x: torch.Tensor, pg) -> torch.Tensor:
    """x [W, *s] summed over ranks; rank r gets slice r [*s]."""
    _COUNTS["reduce_scatter"] += 1
    out = torch.empty(x[0].numel(), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.contiguous().reshape(-1), op=dist.ReduceOp.SUM,
                               group=pg)
    return out.view(tuple(x.shape[1:]))


def _all_to_all(x: torch.Tensor, pg, split_axis: int, concat_axis: int) -> torch.Tensor:
    _COUNTS["all_to_all"] += 1
    W = dist.get_world_size(pg)
    if x.shape[split_axis] % W:
        raise ValueError(f"all_to_all: dim {x.shape[split_axis]} not divisible by {W}")
    ins = [c.contiguous() for c in x.chunk(W, dim=split_axis)]
    outs = [torch.empty_like(c) for c in ins]
    dist.all_to_all(outs, ins, group=pg)
    return torch.cat(outs, dim=concat_axis)


def _permute(x: torch.Tensor, pg, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Rank dst receives rank src's x for each (src, dst); the others zeros."""
    _COUNTS["permute"] += 1
    r = dist.get_rank(pg)
    glob = (lambda q: q) if pg is None else (lambda q: dist.get_global_rank(pg, q))
    x = x.contiguous()  # a non-contiguous receive buffer is refused
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == r and dst == r:
            out.copy_(x)
        elif src == r:
            ops.append(dist.P2POp(dist.isend, x, glob(dst), pg))
        elif dst == r:
            ops.append(dist.P2POp(dist.irecv, out, glob(src), pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _exchange(sends: Sequence[torch.Tensor], dst: Optional[int],
              recvs: Sequence[torch.Tensor], src: Optional[int], pg) -> None:
    """One batch of point-to-point ops: each of ``sends`` to group rank
    ``dst``, each of ``recvs`` filled in place from group rank ``src``."""
    _COUNTS["p2p"] += 1
    glob = (lambda q: q) if pg is None else (lambda q: dist.get_global_rank(pg, q))
    sends = [t.contiguous() for t in sends]
    ops = ([dist.P2POp(dist.isend, t, glob(dst), pg) for t in sends]
           + [dist.P2POp(dist.irecv, t, glob(src), pg) for t in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _broadcast_(x: torch.Tensor, root: int, pg) -> torch.Tensor:
    """Group rank ``root``'s x into x on every rank, in place."""
    _COUNTS["broadcast"] += 1
    dist.broadcast(x, src=root if pg is None else dist.get_global_rank(pg, root), group=pg)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_reduce_(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.pg), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _all_gather0(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter0(g, ctx.pg), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return _reduce_scatter0(x, pg)

    @staticmethod
    def backward(ctx, g):
        return _all_gather0(g, ctx.pg), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, split_axis, concat_axis):
        ctx.args = (pg, split_axis, concat_axis)
        return _all_to_all(x, pg, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        pg, split_axis, concat_axis = ctx.args
        return _all_to_all(g, pg, concat_axis, split_axis), None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, pairs):
        ctx.pg, ctx.pairs = pg, pairs
        return _permute(x, pg, pairs)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.pg, [(d, s) for s, d in ctx.pairs]), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.pg), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce_(x.clone(), pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, sum all-reduce over ``group`` backward: the input of
    a column-parallel layer (Megatron's f), so that a replicated input gets
    the gradient of every rank's shard."""
    return _CopyToGroup.apply(x, _pg(group))


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum all-reduce over ``group`` forward, identity backward: the output
    of a row-parallel layer (Megatron's g), each rank's partial product
    summed into the replicated result."""
    return _ReduceFromGroup.apply(x, _pg(group))


def _is_root(pg, root: int, device) -> torch.Tensor:
    return torch.tensor(dist.get_rank(pg) == root, device=device)


# ---------------------------------------------------------------------------
# the JAX module's surface
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """c10d all_reduce: 'sum', 'mean' (the sum over the group size, as
    ``lax.pmean``), 'max' or 'min' (no gradient)."""
    pg = _pg(group)
    if op == "sum":
        return _AllReduceSum.apply(x, pg)
    if op in ("mean", "avg"):
        return _AllReduceSum.apply(x, pg) / dist.get_world_size(pg)
    if op in ("max", "min"):
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN
        return _all_reduce_(x.detach().clone(), pg, red)
    raise ValueError(f"unsupported reduce op '{op}'")


def all_gather(x: torch.Tensor, group=None, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """Every rank's x along ``axis``: concatenated (``tiled``) or stacked
    on a new axis ``axis``."""
    g = _AllGather.apply(x, _pg(group))  # [W, *x.shape]
    if not tiled:
        return g.movedim(0, axis)
    axis = axis % x.dim()
    g = g.movedim(0, axis)
    return g.reshape(x.shape[:axis] + (-1,) + x.shape[axis + 1:])


def reduce_scatter(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """x summed over the group and cut along ``axis`` into W blocks; rank r
    gets block r (``lax.psum_scatter(tiled=True)``)."""
    pg = _pg(group)
    W = dist.get_world_size(pg)
    axis = axis % x.dim()
    if x.shape[axis] % W:
        raise ValueError(f"reduce_scatter: dim {x.shape[axis]} not divisible by {W}")
    xs = x.movedim(axis, 0)
    xs = xs.reshape((W, xs.shape[0] // W) + xs.shape[1:])
    return _ReduceScatter.apply(xs, pg).movedim(0, axis)


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """x cut along ``split_axis`` into W blocks, block j sent to rank j;
    the received blocks concatenated along ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, _pg(group), split_axis % x.dim(), concat_axis % x.dim())


def broadcast(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """Root's x on every rank, as JAX writes it: the sum of x on the root
    and zeros elsewhere (so the root's gradient is the group's sum)."""
    pg = _pg(group)
    return _AllReduceSum.apply(torch.where(_is_root(pg, root, x.device), x,
                                           torch.zeros_like(x)), pg)


def ppermute_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Ring shift: rank i's x goes to rank (i + shift) mod W."""
    pg = _pg(group)
    n = dist.get_world_size(pg)
    return _Permute.apply(x, pg, [(i, (i + shift) % n) for i in range(n)])


def barrier(group=None, device=None) -> torch.Tensor:
    """The group size, computed as the sum of a one on every rank (JAX's
    barrier); on ``device`` (by default the current CUDA device for an NCCL
    group, else the CPU)."""
    pg = _pg(group)
    if device is None:
        nccl = dist.get_backend(pg) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu"
    return _all_reduce_(torch.ones((), dtype=torch.int32, device=device), pg)


def reduce(x: torch.Tensor, group=None, root: int = 0, op: str = "sum") -> torch.Tensor:
    """The group's reduction on the root; every other rank gets its own x."""
    pg = _pg(group)
    return torch.where(_is_root(pg, root, x.device), all_reduce(x, pg, op), x)


def gather(x: torch.Tensor, group=None, root: int = 0, axis: int = 0) -> torch.Tensor:
    """The root gets every rank's x concatenated along ``axis``; the other
    ranks zeros of that shape."""
    pg = _pg(group)
    g = all_gather(x, pg, axis=axis, tiled=True)
    return torch.where(_is_root(pg, root, x.device), g, torch.zeros_like(g))


def scatter(x: torch.Tensor, group=None, root: int = 0, axis: int = 0) -> torch.Tensor:
    """Rank i gets block i along ``axis`` of the root's x (every rank passes
    an x of that shape; only the root's values count)."""
    pg = _pg(group)
    src = broadcast(x, pg, root)
    n = dist.get_world_size(pg)
    if src.shape[axis] % n:
        raise ValueError(f"scatter dim {src.shape[axis]} not divisible by group {n}")
    d = src.shape[axis] // n
    return src.narrow(axis, dist.get_rank(pg) * d, d)


def send_recv(x: torch.Tensor, group=None, pairs: Optional[Sequence[tuple]] = None,
              shift: int = 1) -> torch.Tensor:
    """Point-to-point exchange: for each (src, dst) pair rank dst gets rank
    src's x, and a rank named as no dst gets zeros; ``pairs=None`` is the
    ring shift by ``shift``."""
    if pairs is None:
        return ppermute_shift(x, group, shift)
    return _Permute.apply(x, _pg(group), [tuple(p) for p in pairs])
