"""The general harness: finds a cell's files by name, times set-up and the
measured window, profiles a steady stretch at the window's end in a traced
run, runs the per-layer readers, and judges the outputs against the
reference.

A cell ``<cell>`` is ``workloads/<cell>.json``: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``,
whose ``driver`` names ``drivers/<driver>.py``), its chips and the limits of
the numbers that decide ``correct``. Every per-layer reader is a file
``metrics/<metric>.py``; all of them are asked in a traced run, and a reader
with nothing to read returns None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

import torch

from benchmark import inputs
from benchmark.reference.editor import Shape
from benchmark.yardstick import trace as tr
from benchmark.yardstick.flops import ModelShape

ROOT = Path(__file__).resolve().parent
SHARE_MAX = 105.0  # % of a roofline or a peak above which a reading is a fault of the count


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: Dict[str, float]

    @property
    def driver(self) -> ModuleType:
        return _module(ROOT / "drivers" / f"{self.traffic['driver']}.py")


def load_cell(name: str) -> Cell:
    w = _json(ROOT / "workloads" / f"{name}.json")
    return Cell(name=name, config=_json(ROOT / "configs" / f"{w['config']}.json"),
                traffic=_json(ROOT / "traffic" / f"{w['traffic']}.json"),
                chips=int(w["chips"]), limits=dict(w["limits"]))


def metric_readers() -> Dict[str, ModuleType]:
    return {p.name[:-3]: _module(p) for p in sorted((ROOT / "metrics").glob("*.py"))}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """One run of one cell: its seeds, set-up parts, spans and window."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float, log: Callable[[str], None] = print):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.t_start, self.log = t_start, log
        self.seeds = inputs.seeds(seed)
        self.shape = Shape(cell.config)
        self.model_shape = ModelShape.from_config(cell.config)
        self.parts: Dict[str, float] = {}
        self.setup_s: Optional[float] = None

    @contextlib.contextmanager
    def part(self, name: str):
        """Times one part of set-up, to the device's end of it."""
        t = time.perf_counter()
        yield
        sync(self.device)
        self.parts[name] = time.perf_counter() - t

    def span(self, name: str):
        """A benchmark span in the trace (a traced run only)."""
        if not self.trace:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def setup_done(self) -> None:
        sync(self.device)
        self.setup_s = time.time() - self.t_start


class Window:
    """The measured window: ``seconds`` of host clock from a synchronised
    start to the synchronised end of the last unit (step or pass) begun in
    it. In a traced run the last ``stretch`` units are profiled."""

    def __init__(self, run: Run, stretch: int, counter=None):
        self.run, self.stretch, self.counter = run, stretch, counter
        self.units = 0
        self.prof = None
        self.stretch_span = None
        self.stretch_from = (0, 0)  # (units, counter records) at the stretch's start
        self.before_stretch_s = 0.0
        self.seconds = 0.0

    def __enter__(self):
        sync(self.run.device)
        self.t0 = time.perf_counter()
        return self

    def _start_stretch(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        sync(self.run.device)
        self.before_stretch_s = time.perf_counter() - self.t0
        acts = [ProfilerActivity.CPU]
        if self.run.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.stretch_span = torch.profiler.record_function("bench.stretch")
        self.stretch_span.__enter__()
        self.stretch_from = (self.units, len(self.counter.rows) if self.counter else 0)

    def more(self) -> bool:
        elapsed = time.perf_counter() - self.t0
        if self.prof is not None:
            return self.units - self.stretch_from[0] < self.stretch
        if self.run.trace and self.units:
            if elapsed + self.stretch * elapsed / self.units >= self.run.seconds:
                self._start_stretch()
                return True
        return elapsed < self.run.seconds or self.units == 0

    def done(self) -> None:
        self.units += 1

    def __exit__(self, *exc):
        sync(self.run.device)
        self.seconds = time.perf_counter() - self.t0
        if self.prof is not None:
            self.stretch_span.__exit__(None, None, None)
            self.prof.stop()
        return False


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end numbers, its window, and
    ``judge()``, which frees the program's state and returns each compared
    number by name."""
    e2e: Dict[str, float]
    attempted: int
    window: Window
    judge: Callable[[], Dict[str, float]]
    rows_per_unit: float
    host_unit_s: List[float]
    counter: object = None


@dataclasses.dataclass
class TraceView:
    """What a per-layer reader reads: the cell's kind and shapes, the
    window up to the profiled stretch (as an untraced run runs it), the
    stretch, and the benchmark's counters and spans."""
    kind: str
    shape: ModelShape
    window_s: float                 # the window's seconds before the stretch
    units: int                      # its units
    rows_per_unit: float
    forwards: List[tuple]           # (rows, sum valid, sum valid^2) of its forwards
    stretch_forwards: List[tuple]   # the same, of the stretch's
    stretch_units: int
    device: List[tuple]
    host: List[tuple]
    lo: float
    hi: float
    host_unit_s: List[float]        # host seconds of each unit's call before the stretch

    @property
    def stretch_s(self) -> float:
        return (self.hi - self.lo) / 1e6


def trace_view(run: Run, out: Outcome) -> TraceView:
    w = out.window
    device, host = tr.from_profiler(w.prof)
    span = [h for h in host if h[2] == "bench.stretch"]
    lo, hi = span[0][0], span[0][1]
    forwards = out.counter.read() if out.counter else []
    units, records = w.stretch_from
    return TraceView(kind=run.cell.traffic["driver"], shape=run.model_shape,
                     window_s=w.before_stretch_s, units=units, rows_per_unit=out.rows_per_unit,
                     forwards=forwards[:records], stretch_forwards=forwards[records:],
                     stretch_units=w.units - units, device=device, host=host,
                     lo=lo, hi=hi, host_unit_s=out.host_unit_s[:units])


def breakdown(view: TraceView) -> dict:
    cats = tr.seconds_by_category(view.device, view.lo, view.hi)
    ops = sorted(cats.items(), key=lambda kv: -kv[1])[:10]
    gaps = tr.idle_gaps(view.device, view.host, view.lo, view.hi)
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": tr.gaps_by_label(gaps)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             log: Callable[[str], None] = print) -> tuple:
    """Drive the cell once. Returns (the result line's dict without its
    checks, the checks {name: (value, limit)})."""
    run = Run(cell, seed, seconds, trace, device, t_start, log)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    out: Outcome = cell.driver.drive(run)
    result = {"attempted": out.attempted, "failed": 0}
    metrics = {}
    if trace:
        view = trace_view(run, out)
        for name, reader in metric_readers().items():
            value = reader.read(view)
            if value is None:
                continue
            if ("roofline" in name or "mfu" in name) and value > SHARE_MAX:
                raise RuntimeError(f"{name} reads {value}%: a share of a bound or a peak "
                                   "cannot pass 100%, so its count is at fault")
            metrics[name] = {"value": value, "unit": reader.UNIT}
        busy = tr.busy_s(view.device, view.lo, view.hi)
        dev_extra = {"busy_s": busy, "window_s": view.stretch_s}
        result["breakdown"] = breakdown(view)
        out.window.prof = None
    else:
        units = cell.traffic["units"]
        for name, value in out.e2e.items():
            metrics[name] = {"value": value, "unit": units[name]}
        metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
        dev_extra = {}
    peak = (torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0)
    log(f"window: {out.window.units} {cell.traffic['unit_name']} in "
        f"{out.window.seconds:.3f} s; set-up {run.setup_s:.3f} s: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in run.parts.items()))
    log(f"peak device memory: {peak} bytes")
    t = time.perf_counter()
    numbers = out.judge()
    log(f"judged in {time.perf_counter() - t:.3f} s")
    gc.collect()
    checks = {k: (v, cell.limits[k]) for k, v in numbers.items()}
    result["correct"] = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    result["metrics"] = metrics
    result["device"] = dict(device_info(run.device, cell.chips), memory_peak_bytes=peak,
                            **dev_extra)
    return result, checks


def device_info(device, chips: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}
    return {"platform": "cpu", "kind": "cpu", "count": 0}

