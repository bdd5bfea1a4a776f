"""Device ms per batch of 64 rows in the "other elementwise / copy /
reduce" category of the kernel table, over the profiled stretch. Moves
``eval_samples_per_s``."""

from benchmark.yardstick.categories import OTHER
from benchmark.yardstick.trace import seconds_by_category

UNIT = "ms/batch"


def read(view):
    if view.kind != "eval" or view.stretch_units <= 0 or not view.device:
        return None
    glue = seconds_by_category(view.device, view.lo, view.hi).get(OTHER, 0.0)
    return 1e3 * glue / (view.stretch_units * view.rows_per_unit / 64.0)
