"""The training loop (``do_train``) and its evaluation pass, on one device
or data-parallel over a process group.

Counterpart of ``editor_tpu/engine/loop.py`` (reference:
engine/processor.py ``do_train``): epochs of P x K batches from the data
module through ``build_train_step``, logging every ``SOLVER.LOG_PERIOD``
steps, full-state checkpoints every ``SOLVER.CHECKPOINT_PERIOD`` epochs and
on each new best mAP (written by a thread under ``TPU.ASYNC_CHECKPOINT``; the
loop waits for the last write at its end), evaluation every
``SOLVER.EVAL_PERIOD`` epochs, and auto-resume from the latest checkpoint in
``OUTPUT_DIR/ckpt``.

The step returns its loss and accuracy as device tensors; the loop reads
them (a host sync) only on the steps it logs. Batches arrive as uint8 numpy
from the loader's prefetch thread and go to the device through pinned host
memory without blocking.

Data parallelism (one process per device; ``parallel.multihost.initialize``
first, as ``cli.train`` does): under a process group the loop builds the
('data', 'model') mesh as the JAX loop does (``TPU.MESH_DATA`` -1 or 1: every
rank), each rank loads its host shard of every global batch, and the step is
the global-batch step (``TPU.ZERO_STAGE`` 1: with the optimizer's slots
partitioned; ``ZERO_STAGE`` 3: FSDP, with the parameters, gradients and
slots sharded, evaluation and checkpoints on the gathered parameters) or,
with ``TPU.GRAD_COMPRESSION`` (which takes precedence, as in JAX), the
local-batch step with that reducer. Rank 0 alone writes the log, the
metrics and the checkpoints; the others wait at a barrier after each save.
Without a group, one process on one device with ``TPU.MESH_DATA`` -1 (the
default) and ``MESH_MODEL`` 1 runs ``ZERO_STAGE`` 1 or 3 or a
``GRAD_COMPRESSION`` on a group of one rank that ``do_train`` makes and
destroys (the JAX loop's 1 x 1 mesh); otherwise the loop runs on one
device, and the settings that need a mesh (``TPU.MESH_DATA`` above 1,
``TPU.MESH_MODEL`` above 1, and with ``MESH_DATA`` 1 ``ZERO_STAGE`` 1 or 3
and a ``GRAD_COMPRESSION``) raise.

Tensor parallelism (``TPU.MESH_MODEL`` t above 1): the mesh is (W / t, t),
the model is cut into its Megatron shards after the init or the ImageNet
import (``parallel.tp.shard_editor``: the qkv rows permuted shard-major),
the ranks of a model group load the same host shard, and the checkpoints
are written in the canonical layout (gathered over the model group,
un-permuted, with the optimizer's slots), so they load into a one-device
run, ``cli.test`` and ``cli.export``, and resume at any t. ``ZERO_STAGE`` 1
and 3 partition each rank's shards (and their slots) over its data group;
a ``GRAD_COMPRESSION`` runs the tensor-parallel forward and reduces over the
data group, int8 and PowerSGD on the canonical leaves (``parallel.ddp``);
the checkpoints stay canonical with each of them.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from editor_tpu_torch.data.loader import ReIDDataModule
from editor_tpu_torch.data.transforms import make_eval_transform, make_train_augment
from editor_tpu_torch.engine.evaluate import do_inference
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models.editor import MODALITIES, default_device, editor_config_from
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.parallel import multihost
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.checkpoint import CheckpointManager, load_train_state, train_state
from editor_tpu_torch.utils.logger import MetricWriter, setup_logger
from editor_tpu_torch.utils.meter import AverageMeter


def _compression(cfg) -> bool:
    return cfg.TPU.GRAD_COMPRESSION not in ("none", "")


def needs_one_rank_group(cfg, mesh=None) -> bool:
    """Whether ``do_train`` makes a group of one rank for this run: no group
    and no ``mesh``, ``TPU.MESH_DATA`` -1 and ``MESH_MODEL`` 1, and
    ``ZERO_STAGE`` 1 or 3 or a ``GRAD_COMPRESSION``, the settings the JAX
    loop runs on its 1 x 1 mesh. ``MESH_DATA`` 1 keeps raising in
    :func:`resolve_mesh` (JAX builds no mesh there and drops them)."""
    t = cfg.TPU
    return (mesh is None and not dist.is_initialized() and t.MESH_DATA == -1
            and t.MESH_MODEL == 1 and (t.ZERO_STAGE in (1, 3) or _compression(cfg)))


def resolve_mesh(cfg, device: torch.device, mesh=None, train: bool = True):
    """The ('data', 'model') mesh of a run on ``device``, as the JAX loop
    builds it: ``mesh`` when given; under a process group of W ranks
    ``make_mesh(MESH_DATA, MESH_MODEL)`` (``MESH_DATA`` -1 or, with W > 1,
    1: all ranks over the model axis) unless W is 1 and both are 1; else
    None (one device). ``ZERO_STAGE`` 1 or 3 and a ``GRAD_COMPRESSION``
    take any ``MESH_MODEL``. Raises for what is not ported (a
    ``ZERO_STAGE`` other than 0, 1 and 3), for the settings that need a mesh
    without one (``ZERO_STAGE`` 1 and 3 among them; for an evaluation,
    ``train`` False, only ``MESH_DATA`` and ``MESH_MODEL``), and for a group
    whose backend does not fit ``device`` (NCCL on CUDA, gloo on the
    CPU)."""
    from torch.distributed.device_mesh import DeviceMesh

    from editor_tpu_torch.parallel.mesh import make_mesh

    t = cfg.TPU
    if train and t.ZERO_STAGE not in (0, 1, 3):
        raise NotImplementedError(f"TPU.ZERO_STAGE {t.ZERO_STAGE} is not ported "
                                  "(ZeRO-1 and FSDP are: ZERO_STAGE 1 and 3)")
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a DeviceMesh (parallel.mesh.make_mesh), not {mesh!r}")
    if mesh is None and dist.is_initialized():
        world = dist.get_world_size()
        if world > 1 or t.MESH_DATA != 1 or t.MESH_MODEL != 1:
            mesh = make_mesh(-1 if t.MESH_DATA in (-1, 1) else t.MESH_DATA, t.MESH_MODEL)
    if mesh is None:
        for name, asks in (("TPU.MESH_DATA > 1", t.MESH_DATA > 1),
                           ("TPU.MESH_MODEL > 1", t.MESH_MODEL > 1),
                           ("TPU.ZERO_STAGE 1", train and t.ZERO_STAGE == 1),
                           ("TPU.ZERO_STAGE 3", train and t.ZERO_STAGE == 3),
                           ("TPU.GRAD_COMPRESSION", train and _compression(cfg))):
            if asks:
                raise ValueError(f"{name} needs a data-parallel mesh: launch one process "
                                 "per device (torchrun, or parallel.multihost.initialize)")
        return None
    backend = dist.get_backend()
    if (backend == "nccl") != (device.type == "cuda"):
        raise RuntimeError(f"a {backend} process group cannot run on {device}: NCCL on "
                           "CUDA, gloo on the CPU")
    return mesh


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch on ``device``: through pinned memory, without blocking,
    to a CUDA device."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def eval_batches(cfg, dm: ReIDDataModule, device: torch.device):
    """The query + gallery batches on ``device``, normalised, with the
    loader's padded tail trimmed (each item once)."""
    transform = make_eval_transform(tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
    total, seen = len(dm.val_items), 0
    for batch in dm.val_batches():
        take = min(len(batch["pid"]), total - seen)
        seen += take
        feed = to_device({k: v[:take] for k, v in batch.items()}, device)
        yield {k: transform(v) if k in MODALITIES else v for k, v in feed.items()}


def evaluate(cfg, model, dm: ReIDDataModule,
             compute_dtype: torch.dtype = torch.bfloat16, mesh=None):
    """Feature extraction over the query + gallery items through
    ``do_inference`` -> (cmc, mAP). The padded tail batch is trimmed before
    the model, so the evaluator sees each item once; with the MSVR310
    protocol the rank list goes to ``OUTPUT_DIR/re.txt`` (from rank 0 only).
    With ``mesh`` every rank extracts its rows of each batch and scores all
    of them: the same metric on every rank."""
    has_scene = dm.splits.has_sceneid
    cmc, mAP, *_ = do_inference(
        model, eval_batches(cfg, dm, next(model.parameters()).device), dm.num_query,
        feat_norm=cfg.TEST.FEAT_NORM == "yes",
        reranking=cfg.TEST.RE_RANKING == "yes", msvr_protocol=has_scene,
        compute_dtype=compute_dtype, mesh=mesh,
        rank_list_path=(os.path.join(cfg.OUTPUT_DIR, "re.txt")
                        if has_scene and cfg.OUTPUT_DIR and multihost.is_primary() else None))
    return cmc, mAP


def do_train(cfg, dm: Optional[ReIDDataModule] = None, mesh=None, decode_fn=None,
             max_steps_per_epoch: Optional[int] = None, device=None) -> Dict[str, Any]:
    """Train EDITOR per ``cfg`` on ``device`` (by default the current CUDA
    device); returns {'model', 'optimizer', 'step', 'best', 'ecfg', 'mesh'}.

    ``dm``: the data module (by default ``ReIDDataModule(cfg,
    decode_fn=decode_fn)``). ``max_steps_per_epoch`` cuts each epoch short.
    With ``OUTPUT_DIR`` set, the log (``train_log.txt``), the metrics
    (``metrics.jsonl``) and the checkpoints (``ckpt/``) go there, and a run
    resumes from the latest checkpoint it finds. ``mesh``: a data-parallel
    ``DeviceMesh``; by default the one :func:`resolve_mesh` builds.

    Where :func:`needs_one_rank_group` holds, the run makes a group of one
    rank (``multihost.initialize_one_rank``) and destroys it when it ends,
    also when it raises; a group the caller made is left alone. Such a run
    returns the model with its full weights (FSDP gathers them before the
    group goes) and ``mesh`` None; its 'optimizer' and 'step' were built on
    the destroyed group: their counts, slots and generator can be read, but
    they take no further step."""
    device = default_device(device)
    owned = needs_one_rank_group(cfg, mesh)
    if owned:
        multihost.initialize_one_rank(device)
    try:
        result = _train(cfg, dm, mesh, decode_fn, max_steps_per_epoch, device)
    finally:
        if owned:
            dist.destroy_process_group()
    return dict(result, mesh=None) if owned else result


def _train(cfg, dm, mesh, decode_fn, max_steps_per_epoch, device) -> Dict[str, Any]:
    from editor_tpu_torch.parallel.mesh import data_rank, data_size, model_size

    mesh = resolve_mesh(cfg, device, mesh)
    rank = multihost.process_index()
    primary = rank == 0
    tp = model_size(mesh)
    tp_mesh = mesh if tp > 1 else None
    # the host shards and sample counts go by the data axis
    d_rank, d_size = (0, 1) if mesh is None else (data_rank(mesh), data_size(mesh))
    logger = setup_logger("editor_tpu_torch.train", cfg.OUTPUT_DIR, "train_log.txt",
                          distributed_rank=rank)
    if mesh is None and cfg.TPU.MESH_DATA == -1:
        logger.info("TPU.MESH_DATA -1 (all local devices): training on the one device %s",
                    device)
    writer = MetricWriter(cfg.OUTPUT_DIR if primary else None, tensorboard=cfg.TPU.TENSORBOARD)
    dm = dm or ReIDDataModule(cfg, decode_fn=decode_fn)
    ecfg = editor_config_from(cfg, dm.num_classes, dm.cam_num)
    compute_dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE)

    model = editor_init(ecfg, seed=cfg.SOLVER.SEED, device=device)
    if cfg.MODEL.PRETRAIN_CHOICE == "imagenet" and os.path.exists(cfg.MODEL.PRETRAIN_PATH_T):
        from editor_tpu_torch.utils.torch_convert import load_imagenet_vit
        load_imagenet_vit(cfg.MODEL.PRETRAIN_PATH_T, model)
        logger.info("Loaded ImageNet backbone from %s", cfg.MODEL.PRETRAIN_PATH_T)
    if tp_mesh is not None:
        from editor_tpu_torch.parallel.tp import shard_editor
        shard_editor(model, tp_mesh)
        logger.info("TP: backbone weights Megatron-split over the model axis (%d-way)", tp)
    opt = make_optimizer(cfg, model)
    loss_func, lr_fn = make_loss(cfg, dm.num_classes), make_scheduler(cfg)
    augment = make_train_augment(cfg.INPUT)
    if mesh is not None and _compression(cfg):
        from editor_tpu_torch.parallel.compression import make_reducer
        from editor_tpu_torch.parallel.ddp import build_ddp_train_step
        step = build_ddp_train_step(
            model, opt, loss_func, lr_fn, cfg.SOLVER.BASE_LR, mesh,
            reducer=make_reducer(cfg.TPU.GRAD_COMPRESSION, rank=cfg.TPU.POWERSGD_RANK),
            compute_dtype=compute_dtype, augment=augment, seed=cfg.SOLVER.SEED)
        logger.info("Data parallel over %d ranks: local-batch step, %s gradient reducer",
                    d_size, step.reducer.name)
    else:
        zero = None
        if mesh is not None and cfg.TPU.ZERO_STAGE == 1:
            from editor_tpu_torch.parallel.zero import zero1_state_shardings
            zero = zero1_state_shardings(opt, mesh)
            logger.info("ZeRO-1: optimizer slots partitioned over the %d data ranks", d_size)
        elif mesh is not None and cfg.TPU.ZERO_STAGE == 3:
            from editor_tpu_torch.engine.train import fsdp_state_shardings
            zero = fsdp_state_shardings(model, opt, mesh)
            logger.info("FSDP/ZeRO-3: params + optimizer state sharded over the data axis "
                        "(%d ranks)", d_size)
        step = build_train_step(model, opt, loss_func, lr_fn, cfg.SOLVER.BASE_LR,
                                compute_dtype, augment=augment, grad_accum=cfg.TPU.GRAD_ACCUM,
                                seed=cfg.SOLVER.SEED, mesh=mesh, state_shardings=zero,
                                gather_params_compute=mesh is not None
                                and cfg.TPU.ZERO_STAGE == 3)
        opt = zero or opt
        if mesh is not None:
            logger.info("Data parallel over %d ranks: global-batch step", d_size)

    def save(epoch: int) -> None:  # collective; the reducer's state is the step's latest
        payload = train_state(model, opt, step.generator, epoch,
                              comm=getattr(step, "comm", None), tp_mesh=tp_mesh)
        if primary:
            ckpt_mgr.save(opt.count, payload)
        multihost.barrier()

    def gathered():  # FSDP: the model's full parameters, else the model as it is
        return opt.gathered() if hasattr(opt, "gathered") else contextlib.nullcontext()

    ckpt_mgr = None
    start_epoch = 1
    if cfg.OUTPUT_DIR:
        ckpt_mgr = CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "ckpt"),
                                     use_async=cfg.TPU.ASYNC_CHECKPOINT)
        latest = ckpt_mgr.latest_step()
        if latest is not None:  # the full train state: an exact resume
            start_epoch = load_train_state(ckpt_mgr.restore(latest), model, opt,
                                           step.generator, comm=getattr(step, "comm", None),
                                           tp_mesh=tp_mesh) + 1
            logger.info("Resumed from checkpoint step %d (epoch %d)", latest, start_epoch - 1)

    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    best = {"mAP": 0.0, "Rank-1": 0.0, "Rank-5": 0.0, "Rank-10": 0.0}
    log_period = cfg.SOLVER.LOG_PERIOD
    shard = {}
    if mesh is not None:  # the global-batch step takes its microbatches' rows
        shard = {"host_id": d_rank, "num_hosts": d_size,
                 "grad_accum": 1 if _compression(cfg) else cfg.TPU.GRAD_ACCUM}
    for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCHS + 1):
        t0 = time.time()
        loss_meter.reset()
        acc_meter.reset()
        n_iter = 0
        for batch in dm.train_epoch(epoch, **shard):
            metrics = step(to_device(batch, device), epoch)
            n_iter += 1
            if n_iter % log_period == 0:
                loss, acc = float(metrics["loss"]), float(metrics["acc"])
                loss_meter.update(loss, batch["pid"].shape[0] * d_size)
                acc_meter.update(acc)
                logger.info("Epoch[%d] Iteration[%d] Loss: %.3f, Acc: %.3f, Base Lr: %.2e",
                            epoch, n_iter, loss_meter.avg, acc_meter.avg, metrics["lr"])
                writer.write({"epoch": epoch, "iter": n_iter, "loss": loss, "acc": acc,
                              "lr": float(metrics["lr"])})
            if max_steps_per_epoch and n_iter >= max_steps_per_epoch:
                break
        dt = time.time() - t0
        if n_iter:
            logger.info("Epoch %d done. %.1f samples/s", epoch,
                        n_iter * cfg.SOLVER.IMS_PER_BATCH / dt)

        if ckpt_mgr and epoch % cfg.SOLVER.CHECKPOINT_PERIOD == 0:
            save(epoch)

        if epoch % cfg.SOLVER.EVAL_PERIOD == 0 and dm.num_query > 0:
            with gathered():
                cmc, mAP = evaluate(cfg, model, dm, compute_dtype, mesh=mesh)
            logger.info("Validation Results - Epoch: %d", epoch)
            logger.info("mAP: %.2f%%", mAP * 100)
            for r in (1, 5, 10):
                if len(cmc) >= r:
                    logger.info("CMC curve, Rank-%d: %.2f%%", r, cmc[r - 1] * 100)
            writer.write({"epoch": epoch, "mAP": mAP, "rank1": float(cmc[0])})
            if mAP >= best["mAP"]:
                best = {"mAP": mAP, "Rank-1": float(cmc[0]),
                        "Rank-5": float(cmc[4]) if len(cmc) > 4 else 0.0,
                        "Rank-10": float(cmc[9]) if len(cmc) > 9 else 0.0}
                if ckpt_mgr:
                    save(epoch)
            logger.info("Best mAP so far: %.2f%%", best["mAP"] * 100)
    if ckpt_mgr:
        ckpt_mgr.wait()
        multihost.barrier()
    if hasattr(opt, "gather"):  # FSDP: hand back the model with its full parameters
        opt.gather()
    writer.close()
    return {"model": model, "optimizer": opt, "step": step, "best": best, "ecfg": ecfg,
            "mesh": mesh}
