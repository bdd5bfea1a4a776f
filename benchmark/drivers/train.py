"""Training traffic: the published training job's P x K batches, gathered
on the device from a synthetic split the size of the training split,
through the program's train step.

Set-up builds the one step object (model, optimizer state, generator),
drives it through the checked steps with the window's own call and feed,
keeps what those steps produced, and hands the same object to the window.
After the window the reference follows the checked steps from the same
weights, batches and seed, and the harness compares:

* ``loss1_gap``: the first step's |loss - reference| / |reference|. The
  later steps' losses are logged, not compared: two SGD steps halve the
  loss, and the bf16 program's second and third losses stray from the
  fp32 reference's by up to 3% on sound runs, as far as the fp8 control's
  do (``PERF.md``), so only the first step's separates the two;
* ``grad_gap``: the first step's gradient, as the optimizer holds it
  (momentum after one step, less the weight decay of the initial weights),
  by the worst leaf: the gap of the two norms over the larger of the
  reference leaf's norm and the median leaf's;
* ``change_gap``: the parameters' change over the checked steps, by the
  worst leaf in the same measure, leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (they move by their
  weight decay and round-off alone).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from benchmark import inputs, program
from benchmark.harness import Outcome, Run, Window, sync
from benchmark.reference import editor as ref

CHECKED_STEPS = 3


def worst_leaf_gap(prog: Dict[str, float], refn: Dict[str, float], names) -> float:
    """max over ``names`` of |prog - ref| / max(ref, median ref)."""
    names = list(names)
    med = sorted(refn[n] for n in names)[len(names) // 2]
    return max(abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30) for n in names)


def drive(run: Run) -> Outcome:
    cfg, tf, dev, s = run.cell.config, run.cell.traffic, run.device, run.shape
    with run.part("kernels"):
        program.build_kernels(dev)
    with run.part("data"):
        split = inputs.train_split(tf, cfg, run.seeds["data"], dev)
        plan = torch.as_tensor(inputs.pk_plan(split["pid"].cpu().numpy(), tf["ids_per_batch"],
                                              tf["instances"], tf["plan_steps"],
                                              run.seeds["plan"]), device=dev)
    with run.part("model"):
        pcfg = program.config(cfg)
        model = program.build_model(cfg, pcfg, inputs.make_weights(s, run.seeds["weights"], dev),
                                    inputs.make_buffers(s, dev), dev)
        step, opt = program.train_step(pcfg, cfg, model, run.seeds["step"])
    per_epoch = tf["ids"] // tf["ids_per_batch"]

    def feed(i: int) -> Dict[str, torch.Tensor]:
        idx = plan[i % plan.shape[0]]
        return {k: split[k].index_select(0, idx) for k in ref.MODS + ("pid", "camid")}

    def epoch(i: int) -> int:
        return 1 + i // per_epoch

    with run.part("checked steps"):
        losses = []
        for i in range(CHECKED_STEPS):
            out = step(feed(i), epoch(i))
            losses.append(out["loss"].detach().clone())
            if i == 0:
                momentum = program.momentum_by_name(model, opt)
        after = program.params_by_name(model)
    run.setup_done()

    counter = program.FusionCounter(model) if run.trace else None
    host: List[float] = []
    i = CHECKED_STEPS
    with Window(run, tf["trace_units"], counter) as win:
        while win.more():
            with run.span("bench.feed"):
                batch = feed(i)
            t = time.perf_counter()
            with run.span("bench.step"):
                step(batch, epoch(i))
            host.append(time.perf_counter() - t)
            i += 1
            win.done()
    if counter:
        counter.close()
    rows = tf["ids_per_batch"] * tf["instances"]

    def judge() -> Dict[str, float]:
        nonlocal model, opt, step
        prog_losses = [float(x) for x in losses]
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return judge_steps(run, [feed(i) for i in range(CHECKED_STEPS)],
                           [epoch(i) for i in range(CHECKED_STEPS)], prog_losses, momentum,
                           after, ref.Arith())

    return Outcome(e2e={"train_samples_per_s": win.units * rows / win.seconds},
                   attempted=win.units * rows, window=win, judge=judge, rows_per_unit=rows,
                   host_unit_s=host, counter=counter)


def judge_steps(run: Run, batches, epochs, prog_losses, momentum, after, arith) -> Dict[str, float]:
    """The reference (or, with ``arith`` below it, the control) through the
    checked steps from the seed's weights, against what the program kept."""
    s, cfg, dev = run.shape, run.cell.config, run.device
    sol = cfg["solver"]
    start = inputs.make_weights(s, run.seeds["weights"], dev)
    P = {n: w.clone().requires_grad_(not ref.frozen(n)) for n, w in start.items()}
    ref_losses, g1 = ref.train_steps(P, inputs.make_buffers(s, dev), batches, epochs,
                                     run.seeds["step"], s, cfg, arith)
    loss1_gap = abs(prog_losses[0] - ref_losses[0]) / abs(ref_losses[0])
    names = [n for n in start if not ref.frozen(n)]
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    g_ref = {n: norm(g1[n]) if n in g1 else 0.0 for n in names}
    g_prog = {n: norm(momentum[n] - ref.group_of(n, sol)[1] * start[n]) for n in names}
    med = sorted(g_ref.values())[len(names) // 2]
    moved = [n for n in names if g_ref[n] >= 1e-3 * med]
    c_ref = {n: norm(P[n].detach() - start[n]) for n in moved}
    c_prog = {n: norm(after[n] - start[n]) for n in moved}
    run.log(f"losses: program {prog_losses}, reference {ref_losses}; "
            f"{len(moved)} of {len(names)} leaves in the change")
    return {"loss1_gap": loss1_gap, "grad_gap": worst_leaf_gap(g_prog, g_ref, names),
            "change_gap": worst_leaf_gap(c_prog, c_ref, moved)}
