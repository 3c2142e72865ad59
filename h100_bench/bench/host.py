"""What this process's threads did on the host over a run's window, read
from ``/proc/self/task`` (Linux; elsewhere the summary is empty).

A thread samples, every ``period`` seconds, the CPU time of each thread of
this process, each named by its Python name where it has one
(``MainThread``, ``evsr-write_0``) and by its system name otherwise.
:meth:`HostSampler.over` takes the samples that bracket a window: the CPUs'
worth each of the busiest threads used, so a run paced by the host shows
which thread paced it.  (The machine-wide ``/proc/stat`` and load average
are not read: under a sandboxed kernel they report every CPU busy and a
load of 0.)
"""
from __future__ import annotations

import os
import threading
import time
from pathlib import Path

_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_TASKS = Path("/proc/self/task")


def _threads(names: dict) -> dict:
    """CPU seconds of each thread of this process, by name."""
    out: dict = {}
    for task in _TASKS.glob("*"):
        try:
            stat = (task / "stat").read_text()
        except OSError:
            continue
        comm = stat[stat.index("(") + 1:stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2:].split()
        cpu = (int(fields[11]) + int(fields[12])) / _TICK  # utime + stime
        name = names.get(int(task.name), comm)
        out[name] = out.get(name, 0.0) + cpu
    return out


class HostSampler:
    def __init__(self, period: float = 1.0):
        self.period = period
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = None

    def _sample(self):
        names = {t.native_id: t.name for t in threading.enumerate() if t.native_id}
        self.samples.append((time.perf_counter(), _threads(names)))

    def _loop(self):
        while True:
            self._sample()
            if self._stop.wait(self.period):
                return

    def start(self) -> "HostSampler":
        if _TASKS.is_dir():
            self._thread = threading.Thread(target=self._loop, name="bench-host", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._sample()

    def over(self, t0: float, t1: float) -> dict:
        """The CPUs' worth each of this process's busiest threads used
        between the last sample at or before ``t0`` and the first at or
        after ``t1``."""
        before = [s for s in self.samples if s[0] <= t0]
        after = [s for s in self.samples if s[0] >= t1]
        if not before or not after:
            return {}
        (a_t, a_th), (b_t, b_th) = before[-1], after[0]
        span = b_t - a_t
        threads = {n: (b_th[n] - a_th.get(n, 0.0)) / span for n in b_th}
        top = sorted(threads.items(), key=lambda kv: -kv[1])[:6]
        return {"seconds": round(span, 3), "cpus": os.cpu_count(),
                "threads_cpus": {n: round(v, 3) for n, v in top}}
