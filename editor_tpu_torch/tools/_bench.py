"""Helpers shared by the measuring tools ``bench_*.py`` and
``chip_smoke.py``: the card check, CUDA-event timing, errors and bounds, one
printed line per variant or case, and a case that fails printed as ``FAIL``
and turned into a non-zero exit."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from editor_tpu_torch.tools.profile_forward import card_name

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and
# HBM3. A bound is the larger of bytes / HBM rate and operations / peak.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def start(tool: str) -> str:
    """Exit non-zero without a CUDA device; else print and return the card's
    name and power limit, with TF32 off for the fp32 plain versions."""
    if not torch.cuda.is_available():
        sys.exit(f"{tool}: no CUDA device")
    card = card_name()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``fn`` from CUDA events over ``iters`` calls after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start_evt = torch.cuda.Event(enable_timing=True)
    end_evt = torch.cuda.Event(enable_timing=True)
    start_evt.record()
    for _ in range(iters):
        fn()
    end_evt.record()
    torch.cuda.synchronize()
    return start_evt.elapsed_time(end_evt) / iters


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in fp32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def ulp_of_max(ref) -> float:
    """One bf16 ulp of the largest magnitude in ``ref`` (a tensor or an
    array): 2^(floor(log2 max) - 7)."""
    mx = ref.abs().max() if isinstance(ref, torch.Tensor) else np.abs(np.asarray(ref)).max()
    return 2.0 ** (math.floor(math.log2(float(mx))) - 7)


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``ref`` (0 where it is 0): an element
    m 2^e with 0.5 <= |m| < 1 has 8 significant bits, so its ulp is 2^(e - 8)."""
    ref = ref.float()
    _, e = torch.frexp(ref)
    return torch.where(ref != 0, torch.ldexp(torch.ones_like(ref), e - 8), torch.zeros_like(ref))


def bf16_off_share(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The share of elements of ``got`` more than one bf16 ulp of ``ref``'s
    element plus 1e-6 of max |ref| away from ``ref``: near 0 where the two
    round at the same points and differ only in fp32 summation order, a few
    % where one of them skips or adds a bf16 rounding before a product."""
    got, ref = got.float(), ref.float()
    tol = bf16_ulp(ref) + 1e-6 * float(ref.abs().max())
    return float(((got - ref).abs() > tol).float().mean())


def mismatch_share(got: torch.Tensor, ref: torch.Tensor, ulps: float = 8.0) -> float:
    """The share of elements of ``got`` farther from ``ref`` than ``ulps``
    fp32 ulps of ``ref``'s element: near 0 where the two round at the same
    points and differ only in fp32 summation order, near 1 where one of them
    skips a rounding."""
    got, ref = got.float(), ref.float()
    tol = ulps * torch.finfo(torch.float32).eps * ref.abs()
    return float(((got - ref).abs() > tol).float().mean())


def bound(flops: float, nbytes: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take,
    bytes over the HBM rate or operations over the bf16 tensor-core peak,
    whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def case(label: str, fn, failed: list):
    """Run one case of a tool: ``fn()``'s result, or, where it raises, None
    after printing ``<label>: FAIL <type>: <message>`` (as the JAX tools do)
    and adding ``label`` to ``failed``, so that the other cases still run."""
    try:
        return fn()
    except Exception as e:  # reported, and turned into the exit code by finish
        print(f"{label}: FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
        failed.append(label)
        return None


def finish(tool: str, failed: list) -> None:
    """Exit non-zero when a case of ``tool`` failed."""
    if failed:
        sys.exit(f"{tool}: {len(failed)} case(s) failed: {', '.join(failed)}")


def report(label: str, ms: float, err=None, bound_ms=None, **extra) -> None:
    """One line per variant: its ms, its relative error and its bound."""
    parts = [f"{label}: {ms:9.4f} ms"]
    if err is not None:
        parts.append(f"relerr={err:.2e}")
    if bound_ms is not None:
        parts.append(f"bound={bound_ms[0]:.4f} ms ({bound_ms[1]})")
    parts += [f"{k}={v}" for k, v in extra.items()]
    print("  ".join(parts), flush=True)
