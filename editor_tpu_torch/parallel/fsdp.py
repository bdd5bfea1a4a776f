"""FSDP / ZeRO-3: parameters, gradients and optimizer slots sharded over the
data axis. Counterpart of ``editor_tpu/parallel/fsdp.py`` (reference: torch
FSDP; the reference code itself stops at ZeRO-1).

The JAX module states a layout and lets XLA derive the communication. Here
the layout is the same and the communication is written out, as torch's
FSDP does, one collective a kind per step (``engine.train.build_train_step(
gather_params_compute=True)``):

* which leaves are sharded, and on which axis, is JAX's rule
  (:func:`fsdp_leaf_spec`) applied to each parameter leaf in the JAX layout
  (``parallel.ddp.LeafLayout``: Linear weights [in, out], the patch conv
  HWIO, the backbone blocks stacked [depth, ...]): the largest dimension
  divisible by the world size and strictly larger than every other
  non-leading one, for leaves of at least 4096 elements. The port shards
  the leaves JAX shards, on the same axis;
* rank r holds block r of that axis (the slice JAX's device r holds), as a
  contiguous tensor in the JAX layout, and the optimizer slots of it. A
  torch weight is the transpose of its leaf, so the block is not a slice of
  the torch tensor: the gather and the scatter go through the JAX layout;
* between steps the model's sharded parameters keep their shape but no
  storage (``untyped_storage().resize_(0)``, as torch's FSDP frees them);
  replicated leaves keep their full tensor and slots, as JAX gives both the
  same spec;
* a step all-gathers every shard in one flat buffer and rebuilds the full
  parameters, runs the forward and backward, reduce-scatters (mean) the
  sharded leaves' gradients into their shards in one flat buffer, mean
  all-reduces the replicated leaves' gradients, frees the full parameters
  and gradients, and updates the shards. The update is elementwise, so the
  layout changes no value.

``state_dict`` and ``load_state_dict`` use the single-device optimizer's
format, so a checkpoint resumes at any world size, one process included;
:meth:`FsdpOptimizer.gathered` is the context in which the model holds its
full parameters (evaluation, checkpoints).

On a mesh with a 'model' axis above 1 (tensor parallelism, the model cut by
``parallel.tp.shard_editor``) the group is the data group and the leaves
are the rank's tensor-parallel shards: JAX's rule applied to each shard's
leaf in the JAX layout (a qkv leaf [depth, C, 3C/t], a proj leaf [depth,
C/t, C]), and data rank r holds block r of it. JAX stores each whole
(shard-major) leaf sharded over 'data' and replicated over 'model'; the port
stores the smaller part the math needs, the rank's shard split over its data
group. A rank holds ``param_memory_bytes(model, True, d)`` of parameter
storage (the cut model, d the data axis's size; :meth:`FsdpOptimizer.
param_bytes` measures it): at the flagship in fp32 on a (2, 2) mesh 159.0 MB
against JAX's 258.2 MB per device, 305.7 MB for the shard alone and 475.7
MB unsharded (``tests/test_torch_tp_zero.py``). ``gathered()`` yields the
rank's whole shard, and ``utils.checkpoint.train_state`` un-shards the
gathered state over the model group into the canonical one. Under the
pipeline every stage holds the same canonical model and the same layout,
and the step gathers the whole model at its top.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from editor_tpu_torch.parallel import collectives as C
from editor_tpu_torch.parallel.ddp import LeafLayout
from editor_tpu_torch.solver.optimizer import Optimizer

# Leaves below this many elements stay replicated (JAX's _MIN_SHARD_ELEMS,
# editor_tpu/parallel/zero.py): no memory to win, a collective to pay.
MIN_SHARD_ELEMS = 4096


def fsdp_leaf_spec(shape: Sequence[int], size: int) -> Tuple[Optional[str], ...]:
    """JAX's ``_fsdp_leaf_spec`` for a leaf of ``shape`` (the JAX layout) over
    ``size`` ranks, as the tuple of its ``PartitionSpec``: ``()`` for a
    replicated leaf, else ``'data'`` at the sharded axis and None elsewhere.

    Only an expansion dimension is sharded: one strictly larger than every
    other non-leading dimension (the 3C and 4C widths, class counts). Rank-4
    conv kernels and broadcast tables ([1, N, C], [K, 1, C]) stay
    replicated, and so does a square [C, C] matrix."""
    shape = tuple(int(s) for s in shape)
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel < max(2 * size, MIN_SHARD_ELEMS):
        return ()
    if len(shape) >= 4:
        return ()
    if len(shape) == 3 and (shape[0] == 1 or shape[1] == 1):
        return ()
    for ax in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[ax] % size or shape[ax] < size:
            continue
        # a stacked leaf's leading dim is depth, not a competing width
        others = [shape[i] for i in range(len(shape))
                  if i != ax and not (i == 0 and len(shape) >= 3)]
        if all(shape[ax] > o for o in others):
            return tuple("data" if i == ax else None for i in range(len(shape)))
    return ()


def _axis(spec: Tuple[Optional[str], ...]) -> Optional[int]:
    return spec.index("data") if "data" in spec else None


def leaf_shapes(model: torch.nn.Module, layout: Optional[LeafLayout] = None
                ) -> Dict[str, Tuple[int, ...]]:
    """Every parameter leaf's shape in the JAX layout, by keystr (the shapes
    only: the model may be on the ``meta`` device, or sharded)."""
    layout = layout or LeafLayout(model, trainable_only=False)
    named = dict(model.named_parameters())
    out = {}
    for key, names in layout.specs.items():
        shape = tuple(layout.jax_shape(names[0], named[names[0]].shape))
        out[key] = ((len(names),) + shape) if key in layout.stacked else shape
    return out


def fsdp_shardings(model: torch.nn.Module, world: int) -> Dict[str, Tuple[Optional[str], ...]]:
    """Each parameter leaf's spec over ``world`` ranks (JAX's
    ``fsdp_shardings``, by keystr, as :func:`fsdp_leaf_spec` tuples). The
    same holds for the gradients and the optimizer slots."""
    return {k: fsdp_leaf_spec(s, world) for k, s in leaf_shapes(model).items()}


def _block(leaf: torch.Tensor, ax: int, rank: int, world: int) -> torch.Tensor:
    n = leaf.shape[ax] // world
    return leaf.narrow(ax, rank * n, n)


def shard_params(model: torch.nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """This rank's part of each parameter leaf in the JAX layout (JAX's
    ``shard_params``): block ``data_rank`` of a sharded leaf's axis, the whole
    of a replicated one, as new contiguous tensors."""
    from editor_tpu_torch.parallel.mesh import data_rank, data_size
    layout = LeafLayout(model, trainable_only=False)
    world, rank = data_size(mesh), data_rank(mesh)
    out = {}
    with torch.no_grad():
        leaves = layout.leaves({n: p for n, p in model.named_parameters()})
    for key, leaf in leaves.items():
        ax = _axis(fsdp_leaf_spec(leaf.shape, world))
        out[key] = (leaf if ax is None else _block(leaf, ax, rank, world)).contiguous()
    return out


def param_memory_bytes(model: torch.nn.Module, per_device: bool, world: int) -> int:
    """Parameter bytes in all (``per_device`` False) or on each rank under
    FSDP over ``world`` ranks (JAX's ``param_memory_bytes``, with the world
    size for the mesh). Reads shapes only."""
    itemsize = {k: p.element_size() for k, p in model.named_parameters()}
    layout = LeafLayout(model, trainable_only=False)
    total = per = 0
    for key, shape in leaf_shapes(model, layout).items():
        n = itemsize[layout.specs[key][0]]
        for s in shape:
            n *= s
        total += n
        per += n // world if fsdp_leaf_spec(shape, world) else n
    return per if per_device else total


class _Leaf:
    """A sharded leaf: its parameters (in depth order), axis, full and block
    shapes in the JAX layout, and this rank's block."""

    def __init__(self, key, names, params, ax, full_shape, shard):
        self.key, self.names, self.params, self.ax = key, names, params, ax
        self.full_shape, self.shard = full_shape, shard
        self.trainable = params[0].requires_grad


def _free(p: torch.Tensor) -> None:
    p.untyped_storage().resize_(0)


def _alloc(p: torch.Tensor) -> None:
    nbytes = p.numel() * p.element_size()
    if p.untyped_storage().nbytes() != nbytes:
        p.untyped_storage().resize_(nbytes)


class FsdpOptimizer:
    """The FSDP layout of a model and its :class:`Optimizer` over a group:
    drop-in for the optimizer in the train step, the loop and the
    checkpoints (``step``, ``zero_grad``, ``params``, ``count``,
    ``state_dict``, ``load_state_dict``), plus the collectives of the step
    (:meth:`gather`, :meth:`reduce_grads`, :meth:`free`) and
    :meth:`gathered`. Built by ``engine.train.fsdp_state_shardings``.

    The optimizer's own slots are dropped; a local :class:`Optimizer` over
    each group's replicated parameters and its sharded leaves' blocks (a
    stacked leaf's parameters share a group) holds the slots."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, group):
        self.model, self.full = model, optimizer
        self.pg = C._pg(group)
        self.world = dist.get_world_size(self.pg)
        self.rank = dist.get_rank(self.pg)
        self.name, self.groups = optimizer.name, optimizer.groups
        self.layout = LeafLayout(model, trainable_only=False)
        named = dict(model.named_parameters())
        self.named = named
        where = {id(p): (gi, pi) for gi, g in enumerate(optimizer.groups)
                 for pi, p in enumerate(g["params"])}
        self.leaves: List[_Leaf] = []
        self.replicated: List[torch.Tensor] = []
        sharded_names = set()
        with torch.no_grad():
            for key, shape in leaf_shapes(model, self.layout).items():
                names = self.layout.specs[key]
                ax = _axis(fsdp_leaf_spec(shape, self.world))
                params = [named[n] for n in names]
                if ax is None:
                    self.replicated += [p for p in params if p.requires_grad]
                    continue
                groups = {where.get(id(p), (None, None))[0] for p in params}
                if len(groups) != 1:
                    raise ValueError(f"leaf {key} spans optimizer groups {groups}")
                full = self.layout.leaves({n: named[n] for n in names}, keys=[key])[key]
                shard = _block(full, ax, self.rank, self.world).clone().contiguous()
                self.leaves.append(_Leaf(key, names, params, ax, tuple(full.shape), shard))
                sharded_names.update(names)
        # the local optimizer: per group, its replicated parameters in group
        # order, then its sharded leaves' blocks
        sharded = {id(named[n]) for n in sharded_names}
        self._slot_of: Dict[Tuple[int, int], Any] = {}
        local = []
        for gi, g in enumerate(optimizer.groups):
            ps = []
            for pi, p in enumerate(g["params"]):
                if id(p) not in sharded:
                    self._slot_of[(gi, pi)] = len(ps)
                    ps.append(p)
            for leaf in self.leaves:
                if leaf.trainable and where[id(leaf.params[0])][0] == gi:
                    leaf.gi, leaf.pos = gi, len(ps)
                    for d, p in enumerate(leaf.params):
                        self._slot_of[where[id(p)]] = (leaf, d)
                    ps.append(leaf.shard)
            local.append({"params": ps, "lr_factor": g["lr_factor"],
                          "weight_decay": g["weight_decay"]})
        self.local = Optimizer(local, name=optimizer.name, momentum=optimizer.momentum)
        self.local.count = optimizer.count
        optimizer.state = None
        self._full_params = True
        self.free()

    # -- the step's collectives -------------------------------------------

    @property
    def count(self) -> int:
        return self.local.count

    def params(self) -> List[torch.Tensor]:
        """The tensors the update reads gradients of: the replicated
        parameters and the sharded leaves' blocks."""
        return self.local.params()

    def zero_grad(self) -> None:
        self.full.zero_grad()
        self.local.zero_grad()

    @torch.no_grad()
    def gather(self) -> None:
        """Every sharded parameter at full size: one all-gather of all
        blocks (per dtype), each leaf rebuilt in the JAX layout and copied
        into its parameters' storage."""
        for dtype, leaves in self._by_dtype().items():
            flat = torch.cat([leaf.shard.reshape(-1) for leaf in leaves])
            allp = C._all_gather0(flat, self.pg)  # [W, n]
            off = 0
            for leaf in leaves:
                n = leaf.shard.numel()
                blocks = allp[:, off:off + n].view((self.world,) + tuple(leaf.shard.shape))
                full = blocks.movedim(0, leaf.ax).reshape(leaf.full_shape)
                parts = full.unbind(0) if leaf.key in self.layout.stacked else [full]
                for name, p, t in zip(leaf.names, leaf.params, parts):
                    _alloc(p)
                    p.copy_(self.layout.from_jax(name, t))
                off += n
        self._full_params = True

    @torch.no_grad()
    def reduce_grads(self) -> None:
        """The gradients' mean over the group: the sharded leaves' by one
        reduce-scatter into their blocks' ``.grad`` (the full gradients
        dropped), the replicated parameters' by one all-reduce."""
        from editor_tpu_torch.engine.train import mean_all_reduce_grads
        for dtype, leaves in self._by_dtype(trainable=True).items():
            rows = []
            for leaf in leaves:
                g = self.layout.leaves(
                    {n: p.grad if p.grad is not None else torch.zeros(p.shape, dtype=p.dtype,
                                                                      device=p.device)
                     for n, p in zip(leaf.names, leaf.params)}, keys=[leaf.key])[leaf.key]
                g = g.unflatten(leaf.ax, (self.world, g.shape[leaf.ax] // self.world))
                rows.append(g.movedim(leaf.ax, 0).reshape(self.world, -1))
                for p in leaf.params:
                    p.grad = None
            out = C._reduce_scatter0(torch.cat(rows, dim=1), self.pg)
            out.div_(self.world)
            off = 0
            for leaf in leaves:
                n = leaf.shard.numel()
                leaf.shard.grad = out[off:off + n].view_as(leaf.shard)
                off += n
        if self.replicated:
            mean_all_reduce_grads(self.replicated, self.pg)

    def free(self) -> None:
        """Drops the sharded parameters' full storage (their shapes stay)."""
        for leaf in self.leaves:
            for p in leaf.params:
                _free(p)
        self._full_params = False

    @torch.no_grad()
    def reshard(self) -> None:
        """Each block taken anew from the full parameters (after they were
        changed in place, as a ``load_state_dict`` does), then the full
        storage freed."""
        for leaf in self.leaves:
            full = self.layout.leaves(dict(zip(leaf.names, leaf.params)), keys=[leaf.key])
            leaf.shard.copy_(_block(full[leaf.key], leaf.ax, self.rank, self.world))
        self.free()

    @contextlib.contextmanager
    def gathered(self):
        """The model with its full parameters inside the block (a
        collective: every rank enters it); on leaving, the blocks are taken
        from the full parameters and the full storage is freed. Nested or
        already gathered: the parameters stay as they are."""
        if self._full_params:
            yield self.model
            return
        self.gather()
        try:
            yield self.model
        finally:
            self.reshard()

    def _by_dtype(self, trainable: bool = False) -> Dict[torch.dtype, List[_Leaf]]:
        out: Dict[torch.dtype, List[_Leaf]] = {}
        for leaf in self.leaves:
            if leaf.trainable or not trainable:
                out.setdefault(leaf.shard.dtype, []).append(leaf)
        return out

    # -- the update and its state ------------------------------------------

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.local.step(lr)

    def param_bytes(self) -> int:
        """Bytes of parameter storage on this rank: every parameter's
        storage (none for a sharded one between steps) and the blocks."""
        return (sum(p.untyped_storage().nbytes() for p in self.named.values())
                + sum(leaf.shard.numel() * leaf.shard.element_size() for leaf in self.leaves))

    @torch.no_grad()
    def state_dict(self) -> Optional[Dict[str, Any]]:
        """The single-device ``Optimizer.state_dict`` on rank 0 (None on the
        other ranks), a collective: each sharded leaf's slots all-gathered
        and cut back into its parameters' slots, on the host on rank 0."""
        slots = ("buf",) if self.name == "SGD" else ("mu", "nu")
        gathered = {}
        for k in slots:
            for leaf in self.leaves:
                if not leaf.trainable:
                    continue
                blk = self.local.state[leaf.gi][k][leaf.pos]
                blocks = C._all_gather0(blk, self.pg)
                full = blocks.movedim(0, leaf.ax).reshape(leaf.full_shape)
                parts = full.unbind(0) if leaf.key in self.layout.stacked else [full]
                for name, t in zip(leaf.names, parts):
                    gathered[(k, name)] = self.layout.from_jax(name, t)
        if self.rank != 0:
            return None
        name_of = {id(p): n for n, p in self.named.items()}
        state = []
        for gi, g in enumerate(self.groups):
            st = {k: [] for k in slots}
            for pi, p in enumerate(g["params"]):
                kind = self._slot_of[(gi, pi)]
                for k in slots:
                    if isinstance(kind, int):
                        t = self.local.state[gi][k][kind]
                    else:
                        t = gathered[(k, name_of[id(p)])]
                    st[k].append(t.detach().cpu().clone())
            state.append(st)
        return {"name": self.name, "count": self.count, "state": state}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """This rank's slots of a single-device ``state_dict``: the
        replicated parameters' whole, each sharded leaf's block."""
        if sd["name"] != self.name or len(sd["state"]) != len(self.groups):
            raise ValueError(f"optimizer state of {sd['name']} with {len(sd['state'])} "
                             f"groups into {self.name} with {len(self.groups)}")
        local = [{k: [None] * len(g["params"]) for k in sd["state"][gi]}
                 for gi, g in enumerate(self.local.groups)]
        name_of = {id(p): n for n, p in self.named.items()}
        for gi, g in enumerate(self.groups):
            for k, saved in sd["state"][gi].items():
                if len(saved) != len(g["params"]):
                    raise ValueError(f"optimizer slot '{k}' does not match this model")
                per_leaf: Dict[str, Dict[str, torch.Tensor]] = {}
                for pi, p in enumerate(g["params"]):
                    kind = self._slot_of[(gi, pi)]
                    if isinstance(kind, int):
                        local[gi][k][kind] = saved[pi]
                    else:
                        per_leaf.setdefault(kind[0].key, {})[name_of[id(p)]] = saved[pi]
                for leaf in self.leaves:
                    if leaf.key in per_leaf:
                        full = self.layout.leaves(per_leaf[leaf.key], keys=[leaf.key])[leaf.key]
                        local[gi][k][leaf.pos] = _block(full, leaf.ax, self.rank, self.world)
        self.local.load_state_dict({"name": sd["name"], "count": sd["count"], "state": local})
