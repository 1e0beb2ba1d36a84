"""Reduction of a torch.profiler window to what the per-layer metrics
read: device operations by name, the device's busy time (the union of
its operations' intervals, so overlapping streams are not counted
twice), and the idle gaps inside the window with what the host was
doing in each.

The arithmetic follows the port's ``bench.profile_window`` (kernel
times by name, busy share = busy / window), with two changes: busy time
is a union of intervals rather than a sum, and the window is the
harness's own ``bench.window`` span in the profiler's clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

#: the harness's span around the measured loop
WINDOW_SPAN = "bench.window"
#: idle gaps labelled with the host op under them, longest first
LABELLED_GAPS = 2000


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set. The profiler also
    mirrors each ``record_function`` span onto the device's timeline
    (a user annotation spanning the span's kernels and the gaps between
    them), and those are no operation."""
    return (str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench."))


def events_of(prof) -> Tuple[List[Tuple[str, float, float]],
                            List[Tuple[str, float, float]]]:
    """(device ops, host ops) of a finished profiler as (name, start s,
    end s) in the profiler's clock."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        row = (e.name, tr.start / 1e6, tr.end / 1e6)
        if _is_device(e):
            dev.append(row)
        elif not str(getattr(e, "device_type", "")).endswith("CUDA"):
            host.append(row)
    return dev, host


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _host_label(t: float, host: List[Tuple[str, float, float]],
                starts: List[float], look: int = 400) -> str:
    """The innermost host op running at time ``t``: the shortest of the
    ``look`` ops that started last before ``t`` and still run at ``t``
    (``host`` sorted by start, ``starts`` its start times)."""
    best, width = "host: between ops", float("inf")
    i = bisect.bisect_right(starts, t)
    for name, s, e in host[max(0, i - look):i]:
        if e >= t and e - s < width and name != WINDOW_SPAN:
            best, width = name, e - s
    return best


def reduce(dev: List[Tuple[str, float, float]],
           host: List[Tuple[str, float, float]], top: int = 10) -> Dict:
    """The trace's summary: window and busy seconds, device ops by
    name (seconds, count), and the longest idle time by host label."""
    spans = [(s, e) for name, s, e in host if name == WINDOW_SPAN]
    if spans:
        w0, w1 = spans[0]
    else:
        w0 = min((s for _, s, _ in dev), default=0.0)
        w1 = max((e for _, _, e in dev), default=0.0)
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
              if e > w0 and s < w1]
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for n, s, e in inside:
        by_name[n][0] += e - s
        by_name[n][1] += 1
    busy = _union([(s, e) for _, s, e in inside])
    busy_s = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # label the longest gaps; the rest are summed under one name
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps[:LABELLED_GAPS]:
        idle[_host_label((s + e) / 2, host, starts)] += e - s
    rest = sum(e - s for s, e in gaps[LABELLED_GAPS:])
    if rest:
        idle["shorter gaps, not labelled"] += rest
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": w1 - w0,
        "busy_s": busy_s,
        "ops": {n: (v[0], int(v[1])) for n, v in ops},
        "breakdown": {
            "device_ops": [[n[:120], v[0]] for n, v in ops[:top]],
            "idle_gaps": [[n[:120], s] for n, s in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        },
    }
