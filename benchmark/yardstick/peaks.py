"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit): every share of a peak or of
a roofline in this benchmark is taken against these numbers."""

PEAK_BF16_FLOPS = 989e12   # bf16 tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12  # HBM3, bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for work of ``flops`` operations
    that reads and writes ``nbytes``: the larger of the two over their peaks."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
