"""Evaluation traffic: the whole test split, query rows then gallery rows,
in batches of the test batch size, normalised in the window by the
program's eval transform and scored by ``do_inference`` pass after pass,
as ``cli.test`` and gallery indexing run it.

Every pass of the window is kept and judged once the window has closed,
against the reference's features of every row and the CMC and mAP the
reference computes from its own features:

* ``feat_gap``: the worst row of the worst pass, |f - f_ref| of the
  L2-normalised features;
* ``map_gap``: the worst pass's |mAP - mAP_ref|.

The CMC is logged, not compared: at initialised weights a query's first
match lies past rank 50 nearly always, so the program's CMC, the
reference's and the fp8 control's all read 0 and no limit could separate
them (``PERF.md``).
"""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from benchmark import inputs, program
from benchmark.harness import Outcome, Run, Window
from benchmark.reference import editor as ref


def drive(run: Run) -> Outcome:
    cfg, tf, dev, s = run.cell.config, run.cell.traffic, run.device, run.shape
    with run.part("kernels"):
        program.build_kernels(dev)
    with run.part("data"):
        split = inputs.eval_split(tf, cfg, run.seeds["data"], dev)
    with run.part("model"):
        pcfg = program.config(cfg)
        model = program.build_model(cfg, pcfg, inputs.make_weights(s, run.seeds["weights"], dev),
                                    inputs.make_buffers(s, dev), dev)
        transform = program.eval_transform(pcfg)
    rows, bs, nq = split["pid"].shape[0], tf["batch"], tf["query"]

    def batches():
        for a in range(0, rows, bs):
            with run.span("bench.feed"):
                b = {k: transform(split[k][a:a + bs]) for k in ref.MODS}
                b["pid"], b["camid"] = split["pid"][a:a + bs], split["camid"][a:a + bs]
            yield b

    with run.part("warm-up pass"):
        program.inference(model, pcfg, batches(), nq)
    run.setup_done()

    counter = program.FusionCounter(model) if run.trace else None
    passes: List[tuple] = []
    with Window(run, tf["trace_units"], counter) as win:
        while win.more():
            with run.span("bench.pass"):
                passes.append(program.inference(model, pcfg, batches(), nq))
            win.done()
    if counter:
        counter.close()

    def judge() -> Dict[str, float]:
        nonlocal model
        del model
        gc.collect()
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return judge_passes(run, split, passes, ref.Arith())

    return Outcome(e2e={"eval_samples_per_s": win.units * rows / win.seconds},
                   attempted=win.units * rows, window=win, judge=judge, rows_per_unit=rows,
                   host_unit_s=[], counter=counter)


def judge_passes(run: Run, split, passes, arith) -> Dict[str, float]:
    """The reference's (or, with ``arith`` below it, the control's)
    features and metric against every kept pass."""
    s, cfg, dev, nq = run.shape, run.cell.config, run.device, run.cell.traffic["query"]
    P = inputs.make_weights(s, run.seeds["weights"], dev)
    f = ref.features(P, inputs.make_buffers(s, dev), split, split["camid"], s, cfg, arith,
                     rows=run.cell.traffic["reference_rows"])
    f = f / torch.linalg.vector_norm(f, dim=1, keepdim=True)
    pid, cam = split["pid"], split["camid"]
    cmc, mAP = ref.cmc_map(f[:nq], f[nq:], pid[:nq], pid[nq:], cam[:nq], cam[nq:])
    feat_gap = map_gap = 0.0
    for p_cmc, p_map, qf, gf in passes:
        got = torch.cat([qf, gf]).to(torch.float32)
        feat_gap = max(feat_gap, float(torch.linalg.vector_norm(got - f, dim=1).max()))
        map_gap = max(map_gap, abs(float(p_map) - mAP))
    run.log(f"reference mAP {mAP:.6f} CMC rank-1 {float(cmc[0]):.6f} rank-50 "
            f"{float(cmc[-1]):.6f}; program's first pass mAP {float(passes[0][1]):.6f} "
            f"CMC rank-1 {float(passes[0][0][0]):.6f} rank-50 {float(passes[0][0][-1]):.6f}; "
            f"{len(passes)} passes judged")
    return {"feat_gap": feat_gap, "map_gap": map_gap}
