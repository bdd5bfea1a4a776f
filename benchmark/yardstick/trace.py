"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
readers use: device busy time, device time by kernel category and for
attention, and the idle gaps labelled by what the host was doing.

Works on plain tuples, so the readers and the tests need no profiler:

* device intervals: ``(start_us, end_us, name)`` of every kernel, copy and
  fill on the device;
* host events: ``(start_us, end_us, name)`` of the CPU side, the
  benchmark's own spans (names starting ``bench.``) among them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.yardstick.categories import category, is_attention

Interval = Tuple[float, float, str]
SPAN_PREFIX = "bench."


def from_profiler(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device intervals, host events) of a finished ``torch.profiler``
    run, each sorted by start. A ``record_function`` range is mirrored onto
    the device's timeline as a user annotation that spans every kernel
    under it: it is no operation of the device and is left out."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (float(tr.start), float(tr.end), e.name)
        if e.device_type == DeviceType.CUDA:
            device.append(row)
        elif e.device_type == DeviceType.CPU:
            host.append(row)
    return device_operations(device, host, prof.events()), sorted(host)


def device_operations(device: Sequence[Interval], host: Sequence[Interval],
                      events=()) -> List[Interval]:
    """The device intervals without the user annotations: those the
    profiler flags as such, and any that bears the name of a host range."""
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    annotations |= {name for _, _, name in host}
    return sorted(row for row in device if row[2] not in annotations)


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi), n) for s, e, n in intervals if e > lo and s < hi]


def union(intervals: Sequence[Interval]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e, _ in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(device: Sequence[Interval], lo: float, hi: float) -> float:
    """Seconds in [lo, hi] (us) in which some operation ran on the device."""
    return sum(e - s for s, e in union(clip(device, lo, hi))) / 1e6


def seconds_by_category(device: Sequence[Interval], lo: float, hi: float) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for s, e, name in clip(device, lo, hi):
        out[category(name)] += (e - s) / 1e6
    return dict(out)


def attention_s(device: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(e - s for s, e, name in clip(device, lo, hi) if is_attention(name)) / 1e6


def _innermost(host: Sequence[Interval], starts: List[float], t: float,
               scan: int = 20000) -> Optional[str]:
    """The name of the latest-starting host event that contains t, looking
    back at most ``scan`` events."""
    i = bisect.bisect_right(starts, t) - 1
    for s, e, name in reversed(host[max(0, i - scan + 1):i + 1]):
        if e >= t:
            return name
    return None


def idle_gaps(device: Sequence[Interval], host: Sequence[Interval], lo: float, hi: float
              ) -> List[Tuple[str, float]]:
    """Every gap in [lo, hi] in which nothing ran on the device, as
    (label, seconds), longest first. The label is the benchmark span the host
    was in when the gap began, then the innermost host operation there."""
    spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    span_starts, starts = [h[0] for h in spans], [h[0] for h in host]
    gaps, t = [], lo
    for s, e in union(clip(device, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    out = []
    for s, e in gaps:
        span = _innermost(spans, span_starts, s, scan=len(spans)) or "outside any span"
        op = _innermost(host, starts, s) or "none"
        out.append((f"{span} / {op}", (e - s) / 1e6))
    return sorted(out, key=lambda g: -g[1])


def gaps_by_label(gaps: Sequence[Tuple[str, float]], top: int = 10) -> List[List]:
    """The gaps summed by label, the largest ``top`` sums first."""
    sums: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for label, sec in gaps:
        sums[label][0] += sec
        sums[label][1] += 1
    rows = sorted(sums.items(), key=lambda kv: -kv[1][0])[:top]
    return [[f"{label} (x{int(n)})", sec] for label, (sec, n) in rows]
