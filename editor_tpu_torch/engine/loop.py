"""The training loop (``do_train``) and its evaluation pass, on one device.

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
memory without blocking. Distribution is not ported: a mesh, a
``TPU.MESH_DATA`` or ``TPU.MESH_MODEL`` above 1, ``TPU.ZERO_STAGE`` other
than 0 or gradient compression raise ``NotImplementedError``; the default
``MESH_DATA`` -1 ("all local devices") trains on the one device.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from editor_tpu_torch.data.loader import ReIDDataModule
from editor_tpu_torch.data.transforms import make_eval_transform, make_train_augment
from editor_tpu_torch.engine.evaluate import do_inference
from editor_tpu_torch.engine.train import build_train_step
from editor_tpu_torch.losses import make_loss
from editor_tpu_torch.models.editor import MODALITIES, default_device, editor_config_from
from editor_tpu_torch.models.init import editor_init
from editor_tpu_torch.solver import make_optimizer, make_scheduler
from editor_tpu_torch.utils.checkpoint import CheckpointManager, load_train_state, train_state
from editor_tpu_torch.utils.logger import MetricWriter, setup_logger
from editor_tpu_torch.utils.meter import AverageMeter


def _check_single_device(cfg, mesh=None) -> None:
    """Raise for the distribution settings that are not ported."""
    t = cfg.TPU
    for name, asks in (("mesh=", mesh is not None), ("TPU.MESH_DATA > 1", t.MESH_DATA > 1),
                       ("TPU.MESH_MODEL > 1", t.MESH_MODEL > 1),
                       ("TPU.ZERO_STAGE != 0", t.ZERO_STAGE != 0),
                       ("TPU.GRAD_COMPRESSION", t.GRAD_COMPRESSION not in ("none", ""))):
        if asks:
            raise NotImplementedError(f"{name}: distributed training is not ported; "
                                      "the loop runs on one device")


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


def evaluate(cfg, model, dm: ReIDDataModule,
             compute_dtype: torch.dtype = torch.bfloat16):
    """Feature extraction over the query + gallery items through
    ``do_inference`` -> (cmc, mAP). The padded tail batch is trimmed before
    the model, so the evaluator sees each item once; with the MSVR310
    protocol the rank list goes to ``OUTPUT_DIR/re.txt``."""
    device = next(model.parameters()).device
    transform = make_eval_transform(tuple(cfg.INPUT.PIXEL_MEAN), tuple(cfg.INPUT.PIXEL_STD))
    total = len(dm.val_items)

    def batches():
        seen = 0
        for batch in dm.val_batches():
            take = min(len(batch["pid"]), total - seen)
            seen += take
            feed = to_device({k: v[:take] for k, v in batch.items()}, device)
            yield {k: transform(v) if k in MODALITIES else v for k, v in feed.items()}

    has_scene = dm.splits.has_sceneid
    cmc, mAP, *_ = do_inference(
        model, batches(), dm.num_query, feat_norm=cfg.TEST.FEAT_NORM == "yes",
        reranking=cfg.TEST.RE_RANKING == "yes", msvr_protocol=has_scene,
        compute_dtype=compute_dtype,
        rank_list_path=(os.path.join(cfg.OUTPUT_DIR, "re.txt")
                        if has_scene and cfg.OUTPUT_DIR else None))
    return cmc, mAP


def do_train(cfg, dm: Optional[ReIDDataModule] = None, mesh=None, decode_fn=None,
             max_steps_per_epoch: Optional[int] = None, device=None) -> Dict[str, Any]:
    """Train EDITOR per ``cfg`` on ``device`` (by default the current CUDA
    device); returns {'model', 'optimizer', 'step', 'best', 'ecfg'}.

    ``dm``: the data module (by default ``ReIDDataModule(cfg,
    decode_fn=decode_fn)``). ``max_steps_per_epoch`` cuts each epoch short.
    With ``OUTPUT_DIR`` set, the log (``train_log.txt``), the metrics
    (``metrics.jsonl``) and the checkpoints (``ckpt/``) go there, and a run
    resumes from the latest checkpoint it finds."""
    _check_single_device(cfg, mesh)
    device = default_device(device)
    logger = setup_logger("editor_tpu_torch.train", cfg.OUTPUT_DIR, "train_log.txt")
    if cfg.TPU.MESH_DATA == -1:
        logger.info("TPU.MESH_DATA -1 (all local devices): training on the one device %s",
                    device)
    writer = MetricWriter(cfg.OUTPUT_DIR, tensorboard=cfg.TPU.TENSORBOARD)
    dm = dm or ReIDDataModule(cfg, decode_fn=decode_fn)
    ecfg = editor_config_from(cfg, dm.num_classes, dm.cam_num)
    compute_dtype = getattr(torch, cfg.TPU.COMPUTE_DTYPE)

    model = editor_init(ecfg, seed=cfg.SOLVER.SEED, device=device)
    if cfg.MODEL.PRETRAIN_CHOICE == "imagenet" and os.path.exists(cfg.MODEL.PRETRAIN_PATH_T):
        from editor_tpu_torch.utils.torch_convert import load_imagenet_vit
        load_imagenet_vit(cfg.MODEL.PRETRAIN_PATH_T, model)
        logger.info("Loaded ImageNet backbone from %s", cfg.MODEL.PRETRAIN_PATH_T)
    opt = make_optimizer(cfg, model)
    step = build_train_step(model, opt, make_loss(cfg, dm.num_classes), make_scheduler(cfg),
                            cfg.SOLVER.BASE_LR, compute_dtype,
                            augment=make_train_augment(cfg.INPUT),
                            grad_accum=cfg.TPU.GRAD_ACCUM, seed=cfg.SOLVER.SEED)

    ckpt_mgr = None
    start_epoch = 1
    if cfg.OUTPUT_DIR:
        ckpt_mgr = CheckpointManager(os.path.join(cfg.OUTPUT_DIR, "ckpt"),
                                     use_async=cfg.TPU.ASYNC_CHECKPOINT)
        latest = ckpt_mgr.latest_step()
        if latest is not None:  # the full train state: an exact resume
            start_epoch = load_train_state(ckpt_mgr.restore(latest), model, opt,
                                           step.generator) + 1
            logger.info("Resumed from checkpoint step %d (epoch %d)", latest, start_epoch - 1)

    loss_meter, acc_meter = AverageMeter(), AverageMeter()
    best = {"mAP": 0.0, "Rank-1": 0.0, "Rank-5": 0.0, "Rank-10": 0.0}
    log_period = cfg.SOLVER.LOG_PERIOD
    for epoch in range(start_epoch, cfg.SOLVER.MAX_EPOCHS + 1):
        t0 = time.time()
        loss_meter.reset()
        acc_meter.reset()
        n_iter = 0
        for batch in dm.train_epoch(epoch):
            metrics = step(to_device(batch, device), epoch)
            n_iter += 1
            if n_iter % log_period == 0:
                loss, acc = float(metrics["loss"]), float(metrics["acc"])
                loss_meter.update(loss, batch["pid"].shape[0])
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
            ckpt_mgr.save(opt.count, train_state(model, opt, step.generator, epoch))

        if epoch % cfg.SOLVER.EVAL_PERIOD == 0 and dm.num_query > 0:
            cmc, mAP = evaluate(cfg, model, dm, compute_dtype)
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
                    ckpt_mgr.save(opt.count, train_state(model, opt, step.generator, epoch))
            logger.info("Best mAP so far: %.2f%%", best["mAP"] * 100)
    if ckpt_mgr:
        ckpt_mgr.wait()
    writer.close()
    return {"model": model, "optimizer": opt, "step": step, "best": best, "ecfg": ecfg}
