"""Profiling and solver-quality instrumentation (utils/profiling.py of the
JAX package).

- ``StageTimer``: wall-clock stages on the host clock, and with them, while
  recording, one span a stage (name, start and end on the clock
  ``torch.profiler`` stamps its events with, thread, enclosing span, and
  the job, chunk and pair ids of the thread's scope). A stage that only
  enqueues device work ends before the device finishes it, and the wait
  lands in whichever later stage copies results back; once the launch
  queue is full, an enqueue waits for the device too.
- ``TIMER``: the process's one ``StageTimer``. Every module records into
  it, looked up at each call (``profiling.TIMER.stage(...)``), so that a
  caller that replaces ``stage``/``add`` on the instance sees every stage.
- ``entry_call``: the scope of one entry-point call; with
  ``ARAP_TRACE=<dir>`` its spans are written into `dir` as one Chrome
  trace.
- ``save_solver_iterations``: the per-GN-step cost CSV.
- ``profile_solve``: an instrumented solve and its wall seconds.
- ``device_trace``: a ``torch.profiler`` Chrome trace of a block (the JAX
  package's ``jax.profiler`` trace), the block's spans in the same file.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np
import torch


class Span(NamedTuple):
    """One closed stage. Times are nanoseconds since the epoch
    (``time.time_ns()``, the clock of ``torch.profiler``'s events)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int  # native thread id
    parent: int | None  # id of the span that enclosed it on its thread
    ids: dict  # the thread's scope: job, chunk, pair


class StageTimer:
    """Accumulating, thread-safe wall-clock stage timer and span recorder.

    ``stage(name)`` and ``add(name, seconds)`` always add to ``totals`` and
    ``counts``, which only ``reset`` clears. Inside ``recording()`` each
    also appends a ``Span``; outside, a stage costs one branch more than a
    timer without spans."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.spans: list | None = None  # a list while recording
        self.threads: dict = {}  # native id -> name, of threads with spans
        self._lock = threading.Lock()
        self._local = threading.local()
        self._span_ids = itertools.count()
        self._job_ids = itertools.count()

    def _thread(self, recording: bool = False):
        """This thread's open spans, scope and native id; `recording`
        names the thread in ``threads``."""
        st = self._local
        if not hasattr(st, "stack"):
            st.stack, st.ids = [], {}
            st.tid = threading.get_native_id()
        if recording and st.tid not in self.threads:
            self.threads[st.tid] = threading.current_thread().name
        return st

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.spans is None:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._close(name, time.perf_counter() - t0, None)
            return
        st = self._thread(recording=True)
        sid, ids = next(self._span_ids), st.ids
        parent = st.stack[-1] if st.stack else None
        st.stack.append(sid)
        n0, t0 = time.time_ns(), time.perf_counter()
        try:
            yield
        finally:
            dt, n1 = time.perf_counter() - t0, time.time_ns()
            st.stack.pop()
            self._close(name, dt, Span(sid, name, n0, n1, st.tid, parent, ids))

    def add(self, name: str, seconds: float) -> None:
        """Add a span measured by the caller to stage `name`; recorded as
        ending when it is added."""
        span = None
        if self.spans is not None:
            st = self._thread(recording=True)
            n1 = time.time_ns()
            span = Span(next(self._span_ids), name, n1 - round(seconds * 1e9),
                        n1, st.tid, st.stack[-1] if st.stack else None,
                        st.ids)
        self._close(name, seconds, span)

    def _close(self, name: str, seconds: float, span: Span | None) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            if span is not None and self.spans is not None:
                self.spans.append(span)

    @contextlib.contextmanager
    def scope(self, **ids):
        """Tag the spans this thread records in the block with `ids` (job,
        chunk, pair), over those of the enclosing scope."""
        st = self._thread()
        outer = st.ids
        st.ids = {**outer, **ids}
        try:
            yield
        finally:
            st.ids = outer

    def scope_ids(self) -> dict:
        """This thread's scope, to hand to a worker's ``in_scope``."""
        return dict(self._thread().ids)

    def in_scope(self, ids: dict, fn, *args):
        """fn(*args) inside ``scope(**ids)``: a worker thread's call with
        the submitting thread's ids."""
        with self.scope(**ids):
            return fn(*args)

    def next_job(self) -> int:
        return next(self._job_ids)

    @contextlib.contextmanager
    def recording(self):
        """Record spans in the block. Yields the list that holds every
        thread's spans closed in it; inside another recording, the outer
        one gets them too when the block ends."""
        outer, mine = self.spans, []
        self.spans = mine
        try:
            yield mine
        finally:
            with self._lock:
                self.spans = outer
                if outer is not None:
                    outer.extend(mine)

    def reset(self) -> None:
        """A fresh table: totals, counts and the spans recorded so far."""
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            if self.spans is not None:
                self.spans.clear()

    def report(self) -> str:
        lines = ["stage                      total_s   calls   mean_ms"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:25s} {t:8.3f} {c:7d} {1000*t/c:9.2f}")
        return "\n".join(lines)


TIMER = StageTimer()


def chrome_events(spans: list, base_ns: int, threads: dict) -> list:
    """Chrome trace events of `spans`: one complete event each, on the
    track of its thread in this process, `ts` in microseconds after
    `base_ns`; the span's id, parent and scope in its args."""
    pid = os.getpid()
    used = {s.thread for s in spans}
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": threads.get(tid, str(tid))}}
              for tid in sorted(used)]
    events += [{"ph": "X", "cat": "stage", "name": s.name, "pid": pid,
                "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"span": s.id, "parent": s.parent, **s.ids}}
               for s in spans]
    return events


def write_spans(logdir: str, spans: list, threads: dict) -> str:
    """Write `spans` into `logdir` as one Chrome trace
    (``spans-PID-NS.json``); returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"spans-{os.getpid()}-{time.time_ns()}.json")
    base = min((s.start_ns for s in spans), default=0)
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(spans, base, threads),
                   "displayTimeUnit": "ms", "baseTimeNanoseconds": base}, f)
    return path


@contextlib.contextmanager
def entry_call(timer: StageTimer | None = None):
    """The block of one entry-point call (``para_gen.main_pipeline``,
    ``run_arap.main``): its spans carry a new ``job`` id. With
    ``ARAP_TRACE=<dir>`` set, the block's spans are recorded and, when it
    ends, written into `dir` as one Chrome trace (``write_spans``) and
    dropped; the totals are left as they are."""
    timer = TIMER if timer is None else timer
    logdir = os.environ.get("ARAP_TRACE")
    with timer.scope(job=timer.next_job()):
        if not logdir:
            yield
            return
        with timer.recording() as spans:
            try:
                yield
            finally:
                t0 = time.perf_counter()
                path = write_spans(logdir, spans, timer.threads)
                print(f"ARAP_TRACE: {len(spans)} spans written to {path} in "
                      f"{time.perf_counter() - t0:.3f}s", file=sys.stderr)


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
    viewable in Perfetto or chrome://tracing) into `logdir`, with the
    block's ``TIMER`` spans on their threads' tracks, on the profiler's
    clock. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with TIMER.recording() as spans, profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _insert_spans(path, spans, TIMER.threads)


def _insert_spans(path: str, spans: list, threads: dict) -> None:
    """Put `spans` at the head of the event list of the Chrome trace at
    `path`, timed from its ``baseTimeNanoseconds``. Spliced as text: a
    traced window's file runs to gigabytes, which parsing would take
    minutes and tens of GB over."""
    if not spans:
        return
    with open(path) as f:
        text = f.read()
    head = re.search(r'"traceEvents"\s*:\s*\[', text)
    base = re.search(r'"baseTimeNanoseconds"\s*:\s*(\d+)',
                     text[: head.start()])
    events = json.dumps(chrome_events(spans, int(base.group(1)) if base
                                      else 0, threads))[1:-1]
    rest = text[head.end():]
    with open(path, "w") as f:
        f.write(text[: head.end()])
        f.write(events)
        f.write("" if rest.lstrip().startswith("]") else ",")
        f.write(rest)
