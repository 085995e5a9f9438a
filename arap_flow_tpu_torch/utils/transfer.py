"""Copies between host and device that wait only for the work they copy.

``t.cpu()`` on the default stream waits for everything queued on the device
before it. The pipeline enqueues chunk k+1's matcher, then chunk k's solves,
and fetches the matcher's planes from a worker thread while the solves run;
a plain ``.cpu()`` there would wait for the solves too. So the producer
records an event right after its last launch (``mark``), and ``fetch``
copies on a side stream that waits only on that event, into pinned host
buffers, and synchronises on the copy alone. On the CPU both are plain.

The other way, a pageable upload (``torch.tensor(a, device=)``) returns
only once everything queued on the device before it has run, so a host
that uploads a chunk's inputs while the solves before it run is held to
the device's pace. ``upload`` stages the array in pinned memory and copies
it without blocking.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_local = threading.local()


def mark(device) -> torch.cuda.Event | None:
    """An event recorded on `device`'s current stream after the work enqueued
    so far; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def upload(a, device) -> torch.Tensor:
    """A copy of host array `a` on `device`. On CUDA the copy is staged in
    pinned memory and enqueued non-blocking on the current stream, so it
    does not wait for the work queued before it (the caching host allocator
    keeps the pinned buffer until the copy has run). On the CPU it is
    ``torch.tensor(a)``."""
    device = torch.device(device)
    host = torch.tensor(np.asarray(a))
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _side_stream(device) -> torch.cuda.Stream:
    """This thread's copy stream on `device` (one per thread, so two threads'
    copies never queue behind each other's waits)."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    key = device.index
    if key not in streams:
        streams[key] = torch.cuda.Stream(device)
    return streams[key]


def fetch(tensors, ready: torch.cuda.Event | None) -> list[np.ndarray]:
    """Host numpy copies of `tensors` (all on one device). On CUDA the copy
    runs on a side stream after `ready`, the event recorded after the
    kernels that produce them, into pinned buffers; only that copy is waited
    for. On the CPU it is ``.numpy()`` (`ready` is None)."""
    tensors = list(tensors)
    if not tensors:
        return []
    device = tensors[0].device
    if device.type != "cuda":
        return [t.numpy() for t in tensors]
    if ready is None:
        raise ValueError("fetch: a CUDA tensor needs the event of its producer")
    side = _side_stream(device)
    hosts = []
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)  # the allocator must not reuse t early
            hosts.append(h)
        done = torch.cuda.Event()
        done.record(side)
    done.synchronize()
    return [h.numpy() for h in hosts]
