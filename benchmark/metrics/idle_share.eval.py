"""The share of the profiled stretch in which nothing ran on the device,
from the trace. Moves ``eval_samples_per_s``."""

from benchmark.yardstick.trace import busy_s

UNIT = "%"


def read(view):
    if view.kind != "eval" or view.hi <= view.lo or not view.device:
        return None
    return 100.0 * (1.0 - busy_s(view.device, view.lo, view.hi) / view.stretch_s)
