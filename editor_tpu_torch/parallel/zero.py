"""ZeRO-1: the optimizer's slots partitioned over the data axis.
Counterpart of ``editor_tpu/parallel/zero.py`` (reference:
zero_redundancy_optimizer.py).

The JAX module shards each slot leaf over 'data' and lets the compiler
derive the communication. Here, as in torch's ``ZeroRedundancyOptimizer``,
each parameter has one owner rank (a greedy partition by size, largest
first, onto the least-loaded rank), and each rank keeps the
:class:`~editor_tpu_torch.solver.optimizer.Optimizer` slots (SGD ``buf``,
AdamW ``mu``/``nu``) of its own parameters only. A step updates those
parameters with the (already averaged) gradients, then every rank's updated
parameters are all-gathered in one flat buffer. The update is elementwise,
so the parameters equal the replicated optimizer's bit for bit: ZeRO-1
changes the layout, not the math.

``state_dict`` gathers the slots into the single-device optimizer's format
(a collective: every rank calls it; the full dict comes back on rank 0, None
elsewhere), and ``load_state_dict`` takes a rank's part of such a dict, so a
checkpoint resumes at any world size, one process included.

On a mesh (``zero1_state_shardings(optimizer, mesh)``) the group is the
mesh's data group only, as JAX shards ``opt_state`` over 'data'. Under
tensor parallelism each model rank's optimizer holds its own shards, and
the rank partitions those over its data group (the shards of a model group
have the same sizes, so every model rank draws the same partition); the
update is elementwise, so the step equals the plain tensor-parallel step
bit for bit. Under the pipeline every stage holds the same canonical model
and the same partition. ``state_dict`` then gives data rank 0 of each model
group the single-device format of its shards, which
``utils.checkpoint.train_state`` un-shards over the model group
(``parallel.tp.gather_train_state``) into the canonical one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from editor_tpu_torch.parallel import collectives as C
from editor_tpu_torch.solver.optimizer import Optimizer


def partition(sizes: List[int], world: int) -> List[int]:
    """Owner rank of each parameter: largest first onto the least-loaded
    rank (ties to the lower rank)."""
    load = [0] * world
    owner = [0] * len(sizes)
    for i in sorted(range(len(sizes)), key=lambda i: (-sizes[i], i)):
        r = min(range(world), key=lambda r: (load[r], r))
        owner[i] = r
        load[r] += sizes[i]
    return owner


class Zero1Optimizer:
    """An :class:`Optimizer` whose slots live on their parameter's owner.
    Drop-in for the optimizer in the train step, the loop and the
    checkpoints (``step``, ``zero_grad``, ``params``, ``count``,
    ``state_dict``, ``load_state_dict``)."""

    def __init__(self, optimizer: Optimizer, group):
        self.full = optimizer
        self.pg = C._pg(group)
        self.world = dist.get_world_size(self.pg)
        self.rank = dist.get_rank(self.pg)
        self.name, self.groups = optimizer.name, optimizer.groups
        flat = [(gi, pi) for gi, g in enumerate(optimizer.groups)
                for pi in range(len(g["params"]))]
        sizes = [optimizer.groups[gi]["params"][pi].numel() for gi, pi in flat]
        owners = partition(sizes, self.world)
        self.owner = {key: o for key, o in zip(flat, owners)}
        # this rank's Optimizer over its own parameters, with their slots; the
        # full optimizer's slots are dropped
        mine = [{"params": [p for pi, p in enumerate(g["params"])
                            if self.owner[(gi, pi)] == self.rank],
                 "lr_factor": g["lr_factor"], "weight_decay": g["weight_decay"]}
                for gi, g in enumerate(optimizer.groups)]
        self.local = Optimizer(mine, name=optimizer.name, momentum=optimizer.momentum)
        self.local.count = optimizer.count
        optimizer.state = None
        # the all-gather layout: each rank's parameters, flat, in group order
        self._by_rank = [[(gi, pi) for gi, pi in flat if self.owner[(gi, pi)] == r]
                         for r in range(self.world)]
        self._mine = self._by_rank[self.rank]
        self._numel = [sum(optimizer.groups[gi]["params"][pi].numel() for gi, pi in keys)
                       for keys in self._by_rank]

    @property
    def count(self) -> int:
        return self.local.count

    def params(self) -> List[torch.Tensor]:
        return self.full.params()

    def zero_grad(self) -> None:
        self.full.zero_grad()

    def _param(self, key) -> torch.Tensor:
        gi, pi = key
        return self.groups[gi]["params"][pi]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """Update the own parameters, then all-gather everyone's."""
        self.local.step(lr)
        ref = self._param((0, 0))
        n = max(self._numel)
        buf = torch.zeros(n, dtype=ref.dtype, device=ref.device)
        off = 0
        for key in self._mine:
            p = self._param(key)
            buf[off:off + p.numel()].copy_(p.reshape(-1))
            off += p.numel()
        allp = C.all_gather(buf, self.pg, tiled=False)  # [W, n]
        for r, keys in enumerate(self._by_rank):
            if r == self.rank:
                continue
            off = 0
            for key in keys:
                p = self._param(key)
                p.copy_(allp[r, off:off + p.numel()].view_as(p))
                off += p.numel()

    @torch.no_grad()
    def state_dict(self) -> Optional[Dict[str, Any]]:
        """The single-device ``Optimizer.state_dict`` on rank 0 (None on the
        other ranks): each slot broadcast from its owner, copied to the host
        on rank 0."""
        slots = ("buf",) if self.name == "SGD" else ("mu", "nu")
        # an own parameter's slot index in the local optimizer's group
        local_pos = {}
        for gi, g in enumerate(self.groups):
            own = [pi for pi in range(len(g["params"])) if self.owner[(gi, pi)] == self.rank]
            local_pos.update({(gi, pi): j for j, pi in enumerate(own)})
        state = [{k: [] for k in slots} for _ in self.groups]
        for gi, g in enumerate(self.groups):
            for pi, p in enumerate(g["params"]):
                src = self.owner[(gi, pi)]
                for k in slots:
                    if src == self.rank:
                        t = self.local.state[gi][k][local_pos[(gi, pi)]].clone()
                    else:
                        t = torch.empty_like(p)
                    _broadcast(t, src, self.pg)
                    if self.rank == 0:
                        state[gi][k].append(t.cpu())
        if self.rank != 0:
            return None
        return {"name": self.name, "count": self.count, "state": state}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """This rank's slots of a single-device ``state_dict``."""
        if sd["name"] != self.name or len(sd["state"]) != len(self.groups):
            raise ValueError(f"optimizer state of {sd['name']} with {len(sd['state'])} "
                             f"groups into {self.name} with {len(self.groups)}")
        mine = [{k: [v[pi] for pi in range(len(g["params"]))
                     if self.owner[(gi, pi)] == self.rank] for k, v in sd["state"][gi].items()}
                for gi, g in enumerate(self.groups)]
        self.local.load_state_dict({"name": sd["name"], "count": sd["count"], "state": mine})


def _broadcast(t: torch.Tensor, src: int, pg) -> None:
    C._COUNTS["broadcast"] += 1
    dist.broadcast(t, src=src if pg is None else dist.get_global_rank(pg, src), group=pg)


def zero1_state_shardings(optimizer: Optimizer, mesh) -> Zero1Optimizer:
    """The ZeRO-1 layout of ``optimizer`` over ``mesh``'s data axis (the
    JAX ``zero1_state_shardings``), whatever its model and stage axes; pass
    it to ``build_train_step`` as ``state_shardings`` and use it as the
    run's optimizer."""
    return Zero1Optimizer(optimizer, mesh)


def state_memory_bytes(optimizer, per_device: bool = True) -> int:
    """Bytes of optimizer slots on this rank (``per_device``) or in all (the
    replicated optimizer's); for a plain :class:`Optimizer` both are the
    whole. Takes the FSDP optimizer too (``parallel.fsdp``)."""
    from editor_tpu_torch.parallel.fsdp import FsdpOptimizer
    if isinstance(optimizer, (Zero1Optimizer, FsdpOptimizer)):
        if not per_device:
            nslots = 1 if optimizer.name == "SGD" else 2
            return nslots * sum(p.numel() * p.element_size() for p in optimizer.full.params())
        optimizer = optimizer.local
    return sum(t.numel() * t.element_size()
               for st in optimizer.state for ts in st.values() for t in ts)
