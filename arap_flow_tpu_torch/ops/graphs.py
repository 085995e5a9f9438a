"""Launch sequences that repeat, captured once as CUDA graphs and replayed.

A GN step of the solve and a rasterization each issue hundreds to
thousands of small launches, and both repeat with the same shapes all
through a run. Each keeps a registry of graphs by key, the layout of
everything its launches depend on: the first time a thread meets a key the
work runs eagerly (which also lets plans and kernel libraries load outside
any capture), the second time it is captured and replayed, and every later
time replayed. The replay runs the eager launches in their order, so its
products are bitwise the eager ones. Each thread keeps its own graphs, so
no two threads' replays share static buffers.
"""

from __future__ import annotations

import threading

import torch

SEEN = object()  # a key met once, run eagerly
_LOCAL = threading.local()


def registry(kind: str) -> dict:
    """This thread's graphs of `kind` by key."""
    if not hasattr(_LOCAL, "registries"):
        _LOCAL.registries = {}
    return _LOCAL.registries.setdefault(kind, {})


def engage(graphs: dict, key) -> str:
    """How the work of `key` runs: "eager" the first time the thread meets
    the key, "capture" the second (the caller stores the graph under the
    key, then replays it), "replay" after."""
    entry = graphs.get(key)
    if entry is None:
        graphs[key] = SEEN
        return "eager"
    return "capture" if entry is SEEN else "replay"


def layout(t: torch.Tensor) -> tuple:
    """What a captured launch depends on of a tensor operand."""
    return t.device, t.dtype, tuple(t.shape), t.stride()


def capture(device, fn):
    """(CUDA graph, what `fn` returned) of `fn`'s launches, captured on a
    side stream (the current stream may be the legacy default stream, which
    cannot capture) in thread-local mode (another thread's copies and waits
    neither break nor join the capture), into a memory pool of its own:
    graphs that shared one and replayed out of capture order would
    overwrite each other's intermediates. The capture runs nothing."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream(device)):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out
