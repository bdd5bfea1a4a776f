"""Model operations in evaluation over seconds, as a share of the card's
bf16 peak: ``forward_flops`` of every batch's forward (the fusion at its
kept tokens) in the window before the profiled stretch, which runs as an
untraced window does, over that part's seconds. Moves
``eval_samples_per_s``."""

from benchmark.yardstick.flops import forward_flops
from benchmark.yardstick.peaks import PEAK_BF16_FLOPS

UNIT = "%"


def read(view):
    if view.kind != "eval" or not view.forwards:
        return None
    flops = sum(forward_flops(view.shape, r, a, b) for r, a, b in view.forwards)
    return 100.0 * flops / view.window_s / PEAK_BF16_FLOPS
