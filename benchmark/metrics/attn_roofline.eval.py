"""The least time of the stretch's attention work (the backbone's calls at
every query-key pair, the fusion's at its kept tokens),
from the yardstick's count, over the device time of the kernels the
attention pattern matches, as a share. Moves ``eval_samples_per_s``."""

from benchmark.yardstick.flops import attention_bound_s
from benchmark.yardstick.trace import attention_s

UNIT = "%"


def read(view):
    if view.kind != "eval" or not view.stretch_forwards:
        return None
    spent = attention_s(view.device, view.lo, view.hi)
    if spent <= 0:
        return None
    need = sum(attention_bound_s(view.shape, r, a, b, training=False)
               for r, a, b in view.stretch_forwards)
    return 100.0 * need / spent
