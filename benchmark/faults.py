"""Faults planted underneath the timed path, and the control in the
program's place: what the limits of ``correct`` are shown to catch.

* ``frozen_state``: the train step returns with the optimizer's state
  unchanged (the update skipped);
* ``half_batch``: the losses left out half of the batch, the mean taken
  over the rest;
* ``altered_answer``: one row's features altered where the eval step
  produces them (negated);
* the control: the reference computed with fp8 products (the step below
  the configuration's bf16) in the program's place.

Each planter is a context manager that patches the program's module
attribute that the timed path looks up at call time, and restores it.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from benchmark import inputs
from benchmark.drivers import eval as eval_driver
from benchmark.drivers import train as train_driver
from benchmark.harness import Run
from benchmark.reference import editor as ref


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def frozen_state():
    from editor_tpu_torch.solver import optimizer
    return _patched(optimizer.Optimizer, "step", lambda self, lr: None)


def half_batch():
    import editor_tpu_torch.losses as losses

    make = losses.make_loss

    def make_half(cfg, num_classes):
        fn = make(cfg, num_classes)

        def half(score, feat, target):
            n = target.shape[0] // 2
            return fn(score[:n], feat[:n], target[:n])
        return half
    return _patched(losses, "make_loss", make_half)


def altered_answer():
    from editor_tpu_torch.engine import evaluate

    build = evaluate.build_eval_step

    def build_altered(*args, **kwargs):
        step = build(*args, **kwargs)

        def altered(batch, *a, **k):
            feat = step(batch, *a, **k).clone()
            feat[0] = -feat[0]
            return feat
        return altered
    return _patched(evaluate, "build_eval_step", build_altered)


FAULTS = {"frozen_state": frozen_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


def control_numbers(run: Run) -> Dict[str, float]:
    """The compared numbers of the control: the reference with fp8 products
    in the program's place, on the run's own inputs, against the fp32
    reference."""
    cell, s, dev = run.cell, run.shape, run.device
    cfg, tf = cell.config, cell.traffic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    low = ref.Arith(fp8=True)
    if tf["driver"] == "train":
        split = inputs.train_split(tf, cfg, run.seeds["data"], dev)
        plan = inputs.pk_plan(split["pid"].cpu().numpy(), tf["ids_per_batch"], tf["instances"],
                              train_driver.CHECKED_STEPS, run.seeds["plan"])
        batches = [{k: split[k][torch.as_tensor(idx, device=dev)]
                    for k in ref.MODS + ("pid", "camid")} for idx in plan]
        epochs = [1] * len(batches)
        start = inputs.make_weights(s, run.seeds["weights"], dev)
        P = {n: w.clone().requires_grad_(not ref.frozen(n)) for n, w in start.items()}
        losses, g1 = ref.train_steps(P, inputs.make_buffers(s, dev), batches, epochs,
                                     run.seeds["step"], s, cfg, low)
        momentum = {n: (g1[n] if n in g1 else torch.zeros_like(w))
                    + ref.group_of(n, cfg["solver"])[1] * start[n]
                    for n, w in start.items() if not ref.frozen(n)}
        after = {n: w.detach() for n, w in P.items()}
        return train_driver.judge_steps(run, batches, epochs, losses, momentum, after,
                                        ref.Arith())
    split = inputs.eval_split(tf, cfg, run.seeds["data"], dev)
    f = ref.features(inputs.make_weights(s, run.seeds["weights"], dev),
                     inputs.make_buffers(s, dev), split, split["camid"], s, cfg, low,
                     rows=tf["reference_rows"])
    f = f / torch.linalg.vector_norm(f, dim=1, keepdim=True)
    nq, pid, cam = tf["query"], split["pid"], split["camid"]
    cmc, mAP = ref.cmc_map(f[:nq], f[nq:], pid[:nq], pid[nq:], cam[:nq], cam[nq:])
    return eval_driver.judge_passes(run, split, [(cmc, mAP, f[:nq], f[nq:])], ref.Arith())
