"""Host wall ms of one call of the train step, with no synchronise: the
median of the benchmark's spans around ``step(...)`` over the window. Once
the launch queue is full a call waits for the device, so this reads the
host's cost only where it is above the device's. Moves
``train_samples_per_s``."""

import statistics

UNIT = "ms/step"


def read(view):
    if view.kind != "train" or not view.host_unit_s:
        return None
    return 1e3 * statistics.median(view.host_unit_s)
