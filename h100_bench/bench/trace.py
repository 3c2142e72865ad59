"""Spans of the benchmark and the reduction of a device trace.

Spans are host intervals that the benchmark records around the program's
calls (a sequence's dispatch, a step's wait on the loader), kept in memory
and timed by ``time.perf_counter``.  The device trace is
``torch.profiler``'s (CUPTI activity: kernels, copies and sets on every
stream), whose timestamps are wall-clock nanoseconds; one anchor taken at
the start converts the spans to that clock.

The reduction, over a window [start, end] of the device clock:

* busy: the union of every device interval (kernels and copies, all
  streams) inside the window, so overlapping copies and kernels count once;
* per kernel name, the summed device time and the launches inside it;
* the longest idle gaps, each named by the benchmark span that the main
  thread was in at the gap's middle.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class Spans:
    """Closed spans (name, start, end, thread name), perf_counter seconds."""

    items: list = field(default_factory=list)
    #: (perf_counter_ns, time_ns) taken together: converts spans to the
    #: profiler's wall clock
    anchor: tuple = field(default_factory=lambda: (time.perf_counter_ns(), time.time_ns()))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.items.append((name, start, end, threading.current_thread().name))

    def named(self, name: str, lo: float = float("-inf"), hi: float = float("inf")) -> list:
        """Durations (s) of the spans ``name`` that start inside [lo, hi]."""
        return [e - s for n, s, e, _ in self.items if n == name and lo <= s <= hi]

    def to_wall_ns(self, t: float) -> int:
        pc, wall = self.anchor
        return int(round(t * 1e9)) - pc + wall


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every device activity in the trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def reduce(events: list, start_ns: int, end_ns: int, spans: Spans | None = None,
           main_thread: str = "MainThread") -> dict:
    """The window's busy time, device time and launches by kernel name, the
    top operations and the longest idle gaps (seconds throughout)."""
    clipped = [(n, max(s, start_ns), min(e, end_ns)) for n, s, e in events
               if e > start_ns and s < end_ns]
    busy = _union([(s, e) for _, s, e in clipped])
    by_name: dict = {}
    for n, s, e in clipped:
        t, k = by_name.get(n, (0, 0))
        by_name[n] = (t + (e - s), k + 1)
    gaps, cursor = [], start_ns
    for s, e in busy + [[end_ns, end_ns]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    labelled = []
    main = []
    if spans is not None:
        main = sorted((spans.to_wall_ns(s), spans.to_wall_ns(e), n)
                      for n, s, e, th in spans.items if th == main_thread)
    for s, e in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = (s + e) // 2
        label = next((n for a, b, n in main if a <= mid <= b), "outside any span")
        labelled.append([label, (e - s) / 1e9])
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    return {
        "window_s": (end_ns - start_ns) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": {n: (t / 1e9, k) for n, (t, k) in by_name.items()},
        "device_ops": [[n, t / 1e9] for n, (t, _) in top],
        "idle_gaps": labelled,
    }


def kernel_time(reduced: dict, pattern: str) -> tuple[float, int]:
    """Summed seconds and launches of the kernels whose name holds
    ``pattern`` as a word (so ``lstm_gates_kernel`` misses
    ``lstm_gates_bwd_kernel``)."""
    import re

    word = re.compile(rf"(?<![A-Za-z0-9_]){re.escape(pattern)}(?![A-Za-z0-9_])")
    t = k = 0
    for name, (sec, n) in reduced["kernels"].items():
        if word.search(name):
            t += sec
            k += n
    return t, k
