"""The train step: counterpart of ``build_train_step`` in
``editor_tpu/engine/train.py`` (reference: engine/processor.py ``do_train``).

One call runs the forward, the output-tuple loss, the backward and the
optimizer update on the model's device. The JAX ``TrainState`` has no
separate object here: the parameters, BN running stats and OCFR centers live
in the model, the momentum (or Adam moments) and the step count in the
:class:`Optimizer` (``count``, JAX's ``TrainState.step``), and the random
stream in the step's ``torch.Generator``, exposed as ``step.generator``
(JAX's ``TrainState.rng``) so that a run can be saved and resumed exactly.
Mixed precision as in JAX: fp32 master weights, images and activations in
``compute_dtype`` (weights are cast at each use), losses in fp32, fp32
gradients into the optimizer. No loss scaling: bf16 has fp32's exponent
range.

On a mesh (``mesh=``, one process per device) the step is the JAX step on
a mesh: the single-device step over the global batch, each rank holding its
rows (see ``parallel.mesh.shard_batch``). The model gathers the rows where
the batch couples them (``Editor.forward(batch_group=)``), so the BN stats,
OCFR centers, losses and accuracy are the global batch's and the same on
every rank; the gradients are mean-all-reduced in one flat buffer. The
explicit local-batch step with gradient compression is
``parallel.ddp.build_ddp_train_step``.

On a mesh whose 'model' axis is above 1 (tensor parallelism; the model cut
by ``parallel.tp.shard_editor``) the forward runs the backbone Megatron-split
over the model group (``Editor.forward(tp_mesh=)``), every rank of a model
group holding the same rows; the batch, the gathers and the gradients' mean
all-reduce run over the data group only, and the generator is keyed by the
data rank, so the ranks of a model group draw the same masks.

With ``backbone=`` (``parallel.pipeline_vit.make_pipeline_backbone``; its
mesh is the step's) the forward's backbone runs through the pipeline over
the mesh's 'stage' group, every stage of a data row holding the same rows
and the whole model; a rank computes its stage's blocks only, the gradient
is made whole over the stage group (one flat sum all-reduce, the blocks and
the embedding exact zeros off their stage, the replicated tail's taken from
the last stage) and then averaged over the data group, so every rank takes
the same step and the ranks' parameters stay equal.

ZeRO-1 and FSDP (``state_shardings=``) compose with both: their slots (and
FSDP's parameter blocks) are partitioned over the data group only, each
model rank partitioning its own tensor-parallel shards, each stage the
same canonical model. The reductions run in this order: the pipeline's
stage sum first, then ZeRO-1's data mean (or FSDP's data reduce-scatter);
under tensor parallelism the replicated leaves' gradients are already the
same on every rank of a model group and stay so.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from editor_tpu_torch.models.editor import MODALITIES, Editor
from editor_tpu_torch.parallel import collectives as C
from editor_tpu_torch.solver.optimizer import Optimizer


def rank_seed(seed: int, rank: int) -> int:
    """The seed of data rank ``rank``'s generator: ``seed + rank * 2**32``,
    so rank 0 draws what the single-device step draws and no two ranks of
    runs with seeds below 2**32 share a stream."""
    return int(seed) + (int(rank) << 32)


def step_images(batch: Dict[str, torch.Tensor], augment: Optional[Callable],
                gen: torch.Generator, compute_dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    mods = [k for k in MODALITIES if k in batch]
    if augment is not None:
        return {k: augment(batch[k], gen).to(compute_dtype) for k in mods}
    return {k: batch[k].to(compute_dtype) for k in mods}


def make_loss_of(model: Editor, loss_func: Callable, gen: torch.Generator,
                 batch_group=None, tp_mesh=None, backbone=None) -> Callable:
    """loss_of(images, labels, cams) -> (total, acc): the forward and the
    output-tuple loss (every (score, feat) pair, plus the aux loss). With
    ``batch_group`` the labels are gathered and the model sees the global
    batch; ``tp_mesh`` and ``backbone`` are passed to the forward."""
    device = next(model.parameters()).device

    def loss_of(images, labels, cams):
        if batch_group is not None:
            labels = C.all_gather(labels, batch_group)
        out = model(images, cam_ids=cams, training=True, labels=labels, generator=gen,
                    batch_group=batch_group, tp_mesh=tp_mesh, backbone=backbone)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for score, feat in out.pairs:
            total = total + loss_func(score, feat, labels)
        total = total + out.aux_loss
        acc = (out.pairs[0][0].argmax(dim=1) == labels).to(torch.float32).mean()
        return total, acc

    return loss_of


def trainable(model: torch.nn.Module) -> List[torch.Tensor]:
    return [p for p in model.parameters() if p.requires_grad]


@torch.no_grad()
def mean_all_reduce_grads(params: List[torch.Tensor], group) -> None:
    """Every parameter's gradient replaced by its mean over the group (a
    missing one counts as zero), through one flat buffer a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = C.all_reduce(flat, group, "mean")
        off = 0
        for p in ps:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p.grad))
            off += p.numel()


def build_train_step(model: Editor, optimizer: Optimizer, loss_func: Callable,
                     lr_fn: Callable, base_lr: float,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     augment: Optional[Callable] = None, grad_accum: int = 1,
                     seed: int = 0, mesh=None, state_shardings=None, backbone=None,
                     gather_params_compute: bool = False
                     ) -> Callable[[Dict[str, torch.Tensor], Any], Dict[str, Any]]:
    """Returns ``step(batch, epoch) -> {"loss", "acc", "lr"}``.

    ``batch``: {'RGB', 'NI', 'TI'?: [B, H, W, 3] float (or uint8 with
    ``augment``, see ``data.transforms.make_train_augment``), 'pid': [B],
    'camid': [B]?} on the model's device; ``epoch`` is 1-based and feeds
    ``lr_fn(epoch, base_lr)`` (each group scales it by its factor). ``loss``
    and ``acc`` come back as 0-dim tensors on the device (no host sync), ``lr``
    as a float. ``seed`` seeds the step's generator (augmentation, drop path,
    dropout), which the returned function carries as ``step.generator``.

    ``grad_accum > 1`` splits the batch into that many microbatches, sums
    their gradients, averages them and steps the optimizer once; the BN stats
    and OCFR centers advance per microbatch in order and the triplet mining
    sees each microbatch, as in the JAX step.

    ``mesh`` (a ``DeviceMesh`` from ``parallel.mesh.make_mesh``): ``batch``
    is this rank's B/W rows of the global batch, and the step is the JAX
    step on a mesh over the global batch (module docstring); W and r are the
    data axis's size and rank, and with a model axis above 1 the step is
    tensor-parallel. Rank r's generator is seeded with ``rank_seed(seed,
    r)``. With ``grad_accum`` A the global microbatch i is the ranks' local
    microbatches i in rank order. ``state_shardings``: the ZeRO-1 layout of
    ``optimizer`` (``parallel.zero.zero1_state_shardings``) or the FSDP
    layout (:func:`fsdp_state_shardings`), which then steps in its place,
    on any mesh, with or without ``backbone``. FSDP: one all-gather of the
    sharded leaves at the top of the step; after the microbatch loop (and
    the pipeline's stage sum) one mean reduce-scatter of their gradients
    into this rank's blocks and the mean all-reduce of the replicated
    leaves'; the full parameters freed; the update on the blocks. The step
    is the same with ``gather_params_compute`` True or False (JAX's flag
    chooses where its compiler gathers); True asks for the FSDP layout.
    ``backbone``: the pipelined backbone
    (``parallel.pipeline_vit.make_pipeline_backbone``) on ``mesh`` (by
    default its own), with a 'data' axis dp x pp and a 'model' axis above 1
    pp x tp (module docstring)."""
    from editor_tpu_torch.parallel.fsdp import FsdpOptimizer
    from editor_tpu_torch.parallel.zero import Zero1Optimizer

    if backbone is not None:
        mesh = backbone.mesh if mesh is None else mesh
        if mesh is not backbone.mesh:
            raise ValueError("the pipelined backbone's mesh is the step's mesh")
    fsdp = isinstance(state_shardings, FsdpOptimizer)
    if (gather_params_compute and not fsdp) or (fsdp and mesh is None):
        raise ValueError("gather_params_compute=True takes the FSDP layout "
                         "(engine.train.fsdp_state_shardings) as state_shardings, on a mesh")
    if state_shardings is not None:
        if mesh is None or not isinstance(state_shardings, (Zero1Optimizer, FsdpOptimizer)):
            raise ValueError("state_shardings= takes the ZeRO-1 layout of the optimizer "
                             "(parallel.zero.zero1_state_shardings) or the FSDP layout "
                             "(fsdp_state_shardings) on a mesh")
        optimizer = state_shardings
    from editor_tpu_torch.parallel.mesh import data_rank, model_size
    tp_mesh = mesh if model_size(mesh) > 1 else None
    rank = 0 if mesh is None else data_rank(mesh)
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(rank_seed(seed, rank))
    loss_of = make_loss_of(model, loss_func, gen, batch_group=mesh, tp_mesh=tp_mesh,
                           backbone=backbone)
    params = trainable(model)

    def step(batch: Dict[str, torch.Tensor], epoch) -> Dict[str, Any]:
        images = step_images(batch, augment, gen, compute_dtype)
        labels, cams = batch["pid"], batch.get("camid")
        B = labels.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch size {B} is not divisible by grad_accum={grad_accum}")
        mb = B // grad_accum
        if fsdp:
            optimizer.gather()
        optimizer.zero_grad()
        loss = acc = 0.0
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            total, a = loss_of({k: v[sl] for k, v in images.items()}, labels[sl],
                               None if cams is None else cams[sl])
            total.backward()
            loss, acc = loss + total.detach(), acc + a
        if backbone is not None:  # whole over the stage group, then the data reduction
            backbone.reduce_grads(model)
        if fsdp:
            optimizer.reduce_grads()
            optimizer.free()
        elif mesh is not None:
            mean_all_reduce_grads(params, mesh)
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            grads = [p.grad for p in optimizer.params() if p.grad is not None]
            torch._foreach_mul_(grads, inv)
            loss, acc = loss * inv, acc * inv
        lr = lr_fn(epoch, base_lr)
        optimizer.step(lr)
        return {"loss": loss, "acc": acc, "lr": lr}

    step.generator = gen
    step.optimizer = optimizer
    return step


def fsdp_state_shardings(model: Editor, optimizer: Optimizer, mesh):
    """The FSDP / ZeRO-3 layout of ``model`` and ``optimizer`` over
    ``mesh``'s data axis (JAX's ``fsdp_state_shardings``): each large
    parameter leaf and its slots sharded, the rest, the BN stats, OCFR
    centers and generator replicated (``parallel.fsdp``). From here on the
    model holds its sharded parameters at full size only inside a step and
    inside ``gathered()``. On a mesh with a 'model' axis above 1 the
    model is cut first (``parallel.tp.shard_editor``) and each rank's
    tensor-parallel shards are sharded over its data group. Pass it to
    ``build_train_step`` as ``state_shardings`` and use it as the run's
    optimizer."""
    from editor_tpu_torch.parallel.fsdp import FsdpOptimizer
    return FsdpOptimizer(model, optimizer, mesh)
