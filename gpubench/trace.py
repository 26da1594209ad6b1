"""Reduction of a ``torch.profiler`` trace of the measured window: device
time by kernel, the seconds in which anything ran on the device, and the
idle gaps named by what the host was doing when they opened."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Dict, List, Tuple


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_rows(prof) -> List[Tuple[str, float, int]]:
    """(name, device seconds, calls) of every device row of ``key_averages``,
    largest first: the arithmetic of the program's ``tools/profile_trace``
    (an operator shows its kernels' time as its own, so only device rows
    count)."""
    from torch.autograd import DeviceType

    rows = [(ev.key, ev.self_device_time_total / 1e6, int(ev.count))
            for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce(prof, top: int = 10) -> Dict[str, Any]:
    """``kernels`` (as ``kernel_rows``), ``busy_s`` (the union of every
    device event's interval), ``span_s`` (first device start to last device
    end) and ``breakdown`` (the ``top`` device rows by time, and the idle
    gaps grouped by the innermost host operation open when each began)."""
    from torch.autograd import DeviceType

    kernels = kernel_rows(prof)
    dev = _union([(e.time_range.start, e.time_range.end) for e in _device_events(prof)])
    busy_us = sum(e - s for s, e in dev)
    gaps = [(dev[i][1], dev[i + 1][0]) for i in range(len(dev) - 1) if dev[i + 1][0] > dev[i][1]]
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CPU), key=lambda h: h[0])
    starts = [h[0] for h in host]
    named: Dict[str, float] = defaultdict(float)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        name = "host idle"
        i = bisect.bisect_right(starts, s) - 1
        # the innermost open operation: the latest-starting one still
        # running, CUDA runtime calls aside
        for j in range(i, max(i - 20000, -1), -1):
            if host[j][1] >= s and not host[j][2].startswith("cuda"):
                name = host[j][2]
                break
        named[name] += (e - s) / 1e6
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"kernels": kernels, "busy_s": busy_us / 1e6,
            "span_s": (dev[-1][1] - dev[0][0]) / 1e6 if dev else 0.0,
            "breakdown": {"device_ops": [[n, s] for n, s, _ in kernels[:top]],
                          "idle_gaps": [[n, s] for n, s in idle]}}


def device_seconds(kernels: List[Tuple[str, float, int]], patterns) -> Tuple[float, int]:
    """(seconds, calls) of the rows whose name holds any of ``patterns``."""
    rows = [(s, c) for n, s, c in kernels if any(p in n for p in patterns)]
    return sum(s for s, _ in rows), sum(c for _, c in rows)
