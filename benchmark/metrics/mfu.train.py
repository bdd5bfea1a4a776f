"""Model operations in training over seconds, as a share of the card's
bf16 peak: ``train_step_flops`` of each step's forward (the fusion at its
kept tokens) in the window before the profiled stretch, which runs as an
untraced window does, over that part's seconds. Moves
``train_samples_per_s``."""

from benchmark.yardstick.flops import train_step_flops
from benchmark.yardstick.peaks import PEAK_BF16_FLOPS

UNIT = "%"


def read(view):
    if view.kind != "train" or not view.forwards:
        return None
    flops = sum(train_step_flops(view.shape, r, a, b) for r, a, b in view.forwards)
    return 100.0 * flops / view.window_s / PEAK_BF16_FLOPS
