"""Reading a traced window: the device operations of a ``torch.profiler``
trace, the device's busy time, and its idle gaps named by the host stage
that was running.

Host stages come from the program's own stage timer
(``pipeline.para_gen.TIMER``), recorded with their start and end while
the window runs, and from the harness's spans around each job. Profiler
and host times are both taken as nanoseconds since the epoch.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


def device_ops(prof) -> list:
    """(name, start_ns, end_ns) of every operation that ran on the device
    (kernels, copies, fills), by start, read from the profiler's raw
    events (building its per-event Python records would take minutes for
    a window's millions of launches)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda]
    return sorted(ops, key=lambda o: o[1])


def busy_intervals(ops: list, t0: int, t1: int) -> list:
    """The union of the operations' intervals, clipped to [t0, t1]."""
    out = []
    for _, a, b in ops:
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps(busy: list, t0: int, t1: int) -> list:
    """Idle intervals (start_ns, end_ns) of [t0, t1] between busy ones."""
    out, cur = [], t0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        out.append((cur, t1))
    return out


class StageLog:
    """Records (name, start_ns, end_ns) of a StageTimer's stages while
    attached: ``stage`` spans as they close, ``add`` spans as ending when
    they are added."""

    def __init__(self):
        self.spans: list = []
        self._lock = threading.Lock()
        self._undo = []

    def span(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.spans.append((name, t0, t1))

    def attach(self, timer) -> None:
        stage, add = timer.stage, timer.add
        log = self

        class _Stage:
            def __init__(self, name):
                self.name, self.cm = name, stage(name)

            def __enter__(self):
                self.t0 = time.time_ns()
                return self.cm.__enter__()

            def __exit__(self, *exc):
                out = self.cm.__exit__(*exc)
                log.span(self.name, self.t0, time.time_ns())
                return out

        def add_logged(name, seconds):
            now = time.time_ns()
            log.span(name, now - int(seconds * 1e9), now)
            return add(name, seconds)

        timer.stage = _Stage
        timer.add = add_logged
        self._undo.append(timer)

    def detach(self) -> None:
        for timer in self._undo:
            del timer.stage, timer.add  # the class's methods again
        self._undo.clear()

    def name_at(self, t: int) -> str:
        """The shortest span holding time t, or "no stage"."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "no stage"


def breakdown(ops: list, idle: list, log: StageLog, n: int = 10) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps, each named by the host stage running at its
    middle."""
    by_name = defaultdict(int)
    for name, a, b in ops:
        by_name[name] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[k, v / 1e9] for k, v in top],
            "idle_gaps": [[log.name_at((a + b) // 2), (b - a) / 1e9]
                          for a, b in longest]}
