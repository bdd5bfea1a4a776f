"""Run one benchmark cell once, on the CUDA device this process finds.

    python3 benchmark/run.py --workload rgbnt201.train --seed 1234 --seconds 20 --trace 0

From the root of a checkout. Loads the cell's configuration and traffic,
sets up (weights and data made on the device from ``--seed``, every shape
the cell uses warmed up), measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints as its last
line one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the end-to-end metrics; with ``--trace 1`` the per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit.
Exits non-zero, printing no result, without enough CUDA devices, or if a
module of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "editor_tpu")
CHECKOUT = Path(__file__).resolve().parent.parent
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton"}


def process_start() -> float:
    """The wall-clock time this process started, from /proc (the time now
    where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(CHECKOUT / "benchmark" / "_cache" / sub)
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload}: needs {cell.chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                      "cuda", t_start, log=lambda s: print(s, flush=True))
    print(f"card: {card()}", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules that must not run here: {bad}", file=sys.stderr)
        return 3
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
