"""The explicit data-parallel step with a pluggable gradient reducer:
counterpart of ``editor_tpu/parallel/ddp.py`` (reference: DDP with comm
hooks, engine/processor.py).

As in the JAX step (and the reference's multi-GPU math), each rank computes
the loss on its own shard, with the batch-hard mining inside its own P x K
block; then the reducer (:mod:`.compression`) averages the gradients, the
BN running stats and OCFR centers are averaged over the ranks, and so are
``loss`` and ``acc``. The reduction runs after the backward, leaf by leaf,
on the JAX package's leaves (:class:`LeafLayout`): a reducer whose result
depends on a leaf's layout (the int8 scale, PowerSGD's matrix) then gives
the JAX reducer's result. Randomness is per rank: rank r's generator is
seeded with ``engine.train.rank_seed(seed, r)`` (JAX folds the rank into
the step's key).

On a mesh whose 'model' axis is above 1 (the model cut by
``parallel.tp.shard_editor``) the forward is tensor-parallel, every rank of
a model group holding the same rows and drawing from its data rank's
generator, and every reduction runs over the data group. The elementwise
reducers (mean, fp16, bf16) reduce each rank's shards in place; int8 and
PowerSGD, whose result depends on the whole leaf (one scale a leaf, a
low-rank factor of the leaf's matrix), reduce the canonical leaves: each
sharded gradient is all-gathered over the model group and un-permuted,
the whole leaf reduced, and the rank's block kept. Their state (PowerSGD's
Q and error feedback) lives on the canonical leaves, the same on every rank
of a model group, so a checkpoint holds it canonical. This is the JAX
reducer on canonical weights: JAX's ``do_train`` instead runs its DDP step
on the shard-major qkv columns without a ``tp_mesh``, which mixes heads.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from editor_tpu_torch.parallel import collectives as C
from editor_tpu_torch.parallel.compression import Reducer, allreduce_reducer

_BLOCK = re.compile(r"^BACKBONE\.base\.blocks\.(\d+)\.(.+)$")


def _path(parts: List[str]) -> Tuple[str, ...]:
    return tuple({"weight": "w", "bias": "b"}.get(p, p) for p in parts)


def _keystr(path: Tuple[str, ...]) -> str:
    return "".join(f"[{k!r}]" for k in path)


class LeafLayout:
    """The JAX package's parameter leaves over a model's trainable
    parameters: keyed by ``jax.tree_util.keystr`` of the JAX tree, in its
    (sorted) leaf order, each in the JAX layout: Linear weights [in, out],
    the patch conv HWIO, the backbone blocks stacked over depth [depth, ...].
    ``leaves`` maps ``{param name: tensor}`` (gradients) to ``{leaf:
    tensor}``, ``params`` maps back. ``trainable_only`` False keeps the
    frozen parameters too (the JAX parameter tree has every leaf)."""

    def __init__(self, model: torch.nn.Module, trainable_only: bool = True):
        specs: Dict[Tuple[str, ...], List[Tuple[int, str]]] = {}
        self.kind: Dict[str, str] = {}
        for name, p in model.named_parameters():
            if trainable_only and not p.requires_grad:
                continue
            m = _BLOCK.match(name)
            if m:
                path, depth = ("BACKBONE", "blocks") + _path(m.group(2).split(".")), int(m.group(1))
            else:
                parts = name.split(".")
                if parts[:2] == ["BACKBONE", "base"]:
                    parts = ["BACKBONE"] + parts[2:]
                path, depth = _path(parts), -1
            specs.setdefault(path, []).append((depth, name))
            self.kind[name] = ("conv" if p.dim() == 4 else
                               "linear" if p.dim() == 2 and name.endswith(".weight") else "plain")
        self.specs = {_keystr(path): [n for _, n in sorted(v)] for path, v in sorted(specs.items())}
        self.stacked = {_keystr(path) for path, v in specs.items() if v[0][0] >= 0}

    def jax_shape(self, name: str, shape) -> Tuple[int, ...]:
        """The JAX layout's shape of parameter ``name`` of torch ``shape``."""
        shape = tuple(shape)
        kind = self.kind[name]
        if kind == "linear":
            return shape[::-1]
        if kind == "conv":
            return (shape[2], shape[3], shape[1], shape[0])
        return shape

    def _to_jax(self, name: str, t: torch.Tensor) -> torch.Tensor:
        kind = self.kind[name]
        if kind == "linear":
            return t.t()
        if kind == "conv":
            return t.permute(2, 3, 1, 0)
        return t

    def from_jax(self, name: str, t: torch.Tensor) -> torch.Tensor:
        kind = self.kind[name]
        if kind == "linear":
            return t.t()
        if kind == "conv":
            return t.permute(3, 2, 0, 1)
        return t

    def leaves(self, tensors: Dict[str, torch.Tensor], keys=None) -> Dict[str, torch.Tensor]:
        """``{leaf: tensor}`` of the leaves ``keys`` (default: all)."""
        out = {}
        for key in self.specs if keys is None else keys:
            names = self.specs[key]
            parts = [self._to_jax(n, tensors[n]) for n in names]
            out[key] = (torch.stack(parts) if key in self.stacked else parts[0]).contiguous()
        return out

    def params(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for key, names in self.specs.items():
            leaf = leaves[key]
            parts = leaf.unbind(0) if key in self.stacked else [leaf]
            for n, t in zip(names, parts):
                out[n] = self.from_jax(n, t)
        return out


def model_state_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    """The buffers a train step moves: BN running stats and OCFR centers."""
    return [b for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var", "_centers"))]


def build_ddp_train_step(model, optimizer, loss_func: Callable, lr_fn: Callable,
                         base_lr: float, mesh, reducer: Optional[Reducer] = None,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         augment: Optional[Callable] = None, seed: int = 0
                         ) -> Callable[[Dict[str, torch.Tensor], Any], Dict[str, Any]]:
    """Returns ``step(batch, epoch) -> {"loss", "acc", "lr"}`` on this
    rank's local ``batch`` (its own P x K block; under tensor parallelism
    its data rank's). The reducer's state (PowerSGD's Q and error feedback;
    ``reducer.init`` of the canonical parameters in the JAX layout) is
    ``step.comm``, the generator ``step.generator``, the leaf layout
    ``step.layout``."""
    from editor_tpu_torch.engine.train import make_loss_of, rank_seed, step_images
    from editor_tpu_torch.parallel.mesh import data_rank, model_group, model_rank, model_size

    reducer = reducer or allreduce_reducer()
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(rank_seed(seed, data_rank(mesh)))
    tp = model_size(mesh)
    loss_of = make_loss_of(model, loss_func, gen, tp_mesh=mesh if tp > 1 else None)
    layout = LeafLayout(model)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    buffers = model_state_buffers(model)
    canonical = rank_block = lambda ts: ts
    if tp > 1 and not reducer.elementwise:  # the whole leaves, the rank's blocks
        from editor_tpu_torch.parallel import tp as tpm
        heads, group, t_rank = model.cfg.vit.num_heads, model_group(mesh), model_rank(mesh)
        canonical = lambda ts: tpm.gather_state_dict(ts, heads, group)
        rank_block = lambda ts: tpm.shard_state_dict(ts, heads, tp, t_rank)

    def step(batch: Dict[str, torch.Tensor], epoch) -> Dict[str, Any]:
        images = step_images(batch, augment, gen, compute_dtype)
        optimizer.zero_grad()
        total, acc = loss_of(images, batch["pid"], batch.get("camid"))
        total.backward()
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in named.items()}
            reduced, step.comm = reducer.reduce(layout.leaves(canonical(grads)), step.comm,
                                                mesh)
            for n, g in rank_block(layout.params(reduced)).items():
                named[n].grad = g.contiguous()
            for b in buffers:
                b.copy_(C.all_reduce(b, mesh, "mean"))
            loss = C.all_reduce(total.detach(), mesh, "mean")
            acc = C.all_reduce(acc, mesh, "mean")
        lr = lr_fn(epoch, base_lr)
        optimizer.step(lr)
        return {"loss": loss, "acc": acc, "lr": lr}

    with torch.no_grad():
        step.comm = reducer.init(layout.leaves(canonical({n: p.detach()
                                                          for n, p in named.items()})))
    step.generator = gen
    step.layout = layout
    step.reducer = reducer
    return step
