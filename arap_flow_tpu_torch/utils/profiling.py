"""Wall-clock stage timing (the JAX package's utils/profiling.StageTimer).

Stages measured on the host clock: a stage that only enqueues device work
ends before the device finishes it, and the wait lands in whichever later
stage copies results back.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulating, thread-safe wall-clock stage timer."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        """Add a span measured by the caller to stage `name`."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage                      total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:25s} {t:8.3f} {c:7d} {1000*t/c:9.2f}")
        return "\n".join(lines)
