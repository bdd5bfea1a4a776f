"""Readings that set the limits of ``correct``, at a cell's own size, on
the CUDA device this process finds (not run by the benchmark's runs):

    python3 benchmark/control.py --workload rgbnt201.train --mode program --seeds 1 2 3
    python3 benchmark/control.py --workload rgbnt201.train --mode control --seeds 1 2 3
    python3 benchmark/control.py --workload rgbnt201.eval --mode altered_answer --seeds 1 2 3

``program``: the cell run as the benchmark runs it (a short window), one
seed after another in this process; ``control``: the reference with fp8
products in the program's place; any name of ``faults.FAULTS``: the run
with that fault planted underneath the timed path. One JSON line per seed
with every compared number, then the largest and the smallest of each.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        t = time.time()
        if args.mode == "control":
            run = harness.Run(cell, seed, args.seconds, False, "cuda", t, log=print)
            numbers = faults.control_numbers(run)
        else:
            plant = faults.FAULTS[args.mode]() if args.mode != "program" else None
            with plant if plant is not None else contextlib.nullcontext():
                _, checks = harness.run_cell(cell, seed, args.seconds, False, "cuda", t,
                                             log=print)
            numbers = {k: v for k, (v, _) in checks.items()}
        torch.cuda.empty_cache()
        rows.append(numbers)
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "numbers": numbers, "seconds": time.time() - t}), flush=True)
    for k in rows[0]:
        vals = [r[k] for r in rows]
        print(json.dumps({"workload": args.workload, "mode": args.mode, "number": k,
                          "max": max(vals), "min": min(vals), "n": len(vals)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
