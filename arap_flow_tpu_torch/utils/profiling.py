"""Profiling and solver-quality instrumentation (utils/profiling.py of the
JAX package).

- ``StageTimer``: wall-clock stages on the host clock. A stage that only
  enqueues device work ends before the device finishes it, and the wait
  lands in whichever later stage copies results back.
- ``save_solver_iterations``: the per-GN-step cost CSV.
- ``profile_solve``: an instrumented solve and its wall seconds.
- ``device_trace``: a ``torch.profiler`` Chrome trace of a block (the JAX
  package's ``jax.profiler`` trace).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch


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


def save_solver_iterations(path, costs, times_ms=None, name="gaussNewtonGPU"):
    """CSV of the per-GN-step cost (and optional ms): a header, then
    `iter,cost,time_ms` rows; byte for byte the JAX package's file."""
    if isinstance(costs, torch.Tensor):
        costs = costs.detach().cpu().numpy()
    costs = np.asarray(costs)
    with open(path, "w") as f:
        f.write(f"iter,{name}_cost,{name}_time_ms\n")
        for i, c in enumerate(costs):
            t = "" if times_ms is None else f"{times_ms[i]:.4f}"
            f.write(f"{i},{c:.8g},{t}\n")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_solve(ops, cfg):
    """Run ``solve_instrumented``; returns (x, flow, costs (host numpy),
    wall seconds). The device is synchronised before each clock read, so
    the seconds hold the whole solve and no earlier queued work."""
    from ..ops.solver import solve_instrumented

    device = ops.mask.device
    _sync(device)
    t0 = time.perf_counter()
    x, flow, costs = solve_instrumented(ops, cfg)
    _sync(device)
    wall = time.perf_counter() - t0
    return x, flow, costs.cpu().numpy(), wall


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA when
    a card is present) and write a Chrome trace (``trace-PID-NS.json``,
    viewable in Perfetto or chrome://tracing) into `logdir`. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
