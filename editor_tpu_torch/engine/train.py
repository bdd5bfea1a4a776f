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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from editor_tpu_torch.models.editor import MODALITIES, Editor
from editor_tpu_torch.solver.optimizer import Optimizer


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
    sees each microbatch, as in the JAX step. The distribution arguments of
    the JAX step (``mesh``, ``state_shardings``, ``backbone``,
    ``gather_params_compute``) are not ported and raise."""
    for name, value in (("mesh", mesh), ("state_shardings", state_shardings),
                        ("backbone", backbone)):
        if value is not None:
            raise NotImplementedError(f"{name}= is not ported")
    if gather_params_compute:
        raise NotImplementedError("gather_params_compute is not ported")
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)

    def loss_of(images, labels, cams):
        out = model(images, cam_ids=cams, training=True, labels=labels, generator=gen)
        # output-tuple protocol: every (score, feat) pair, plus the aux loss
        total = torch.zeros((), dtype=torch.float32, device=device)
        for score, feat in out.pairs:
            total = total + loss_func(score, feat, labels)
        total = total + out.aux_loss
        acc = (out.pairs[0][0].argmax(dim=1) == labels).to(torch.float32).mean()
        return total, acc

    def step(batch: Dict[str, torch.Tensor], epoch) -> Dict[str, Any]:
        mods = [k for k in MODALITIES if k in batch]
        if augment is not None:
            images = {k: augment(batch[k], gen).to(compute_dtype) for k in mods}
        else:
            images = {k: batch[k].to(compute_dtype) for k in mods}
        labels, cams = batch["pid"], batch.get("camid")
        B = labels.shape[0]
        if B % grad_accum:
            raise ValueError(f"batch size {B} is not divisible by grad_accum={grad_accum}")
        mb = B // grad_accum
        optimizer.zero_grad()
        loss = acc = 0.0
        for i in range(grad_accum):
            sl = slice(i * mb, (i + 1) * mb)
            total, a = loss_of({k: v[sl] for k, v in images.items()}, labels[sl],
                               None if cams is None else cams[sl])
            total.backward()
            loss, acc = loss + total.detach(), acc + a
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            grads = [p.grad for p in optimizer.params() if p.grad is not None]
            torch._foreach_mul_(grads, inv)
            loss, acc = loss * inv, acc * inv
        lr = lr_fn(epoch, base_lr)
        optimizer.step(lr)
        return {"loss": loss, "acc": acc, "lr": lr}

    step.generator = gen
    return step
