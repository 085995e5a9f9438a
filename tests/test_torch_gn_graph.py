"""The per-GN solve's CUDA graphs (``ops/solver.py``: ``_GraphChain``).

On the cuda backend and CUDA tensors a key's first GN step runs eagerly,
its second is captured and replayed, and every later step of every chain
with that key is replayed. The CPU tests hold the capture decision and the
key as plain Python, and check that CPU tensors and the plain backend never
capture. The card tests hold each solve bitwise to a hand loop of eager
``gn_step`` calls on the same operands, with the same PCG launch counts.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io.constraints import add_border_pins
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import graphs as G
from arap_flow_tpu_torch.ops import pcg as P
from arap_flow_tpu_torch.ops import solver as S
from arap_flow_tpu_torch.utils import profiling, transfer

GRAPH_STAGES = ("gn graph capture", "gn graph replay")
SHORT = S.SolverConfig(num_anneal=2, gn_iters=3, max_pcg_iters=40,
                       pcg_iters=40.0, backend="cuda")


def _problem(H, W, seed, device):
    """Numpy-seeded operands at H×W: a solve region inset by a seeded
    margin, a grid of constraints moved by up to 3 px, border pins."""
    rng = np.random.default_rng(seed)
    top, left = (int(v) for v in rng.integers(2, 6, 2))
    mask = np.full((H, W), 255, np.uint8)
    mask[top:H - top, left:W - left] = 0
    ys, xs = np.mgrid[top + 1:H - top - 1:4, left + 2:W - left - 2:8]
    cons = np.stack([xs.ravel(), ys.ravel(),
                     xs.ravel() + rng.integers(-3, 4, xs.size),
                     ys.ravel() + rng.integers(-3, 4, xs.size)],
                    1).astype(np.int32)
    return E.build_operands(mask, add_border_pins(cons, W, H),
                            device=device)


def _operands(B, H, W, seed, device):
    """B stacked problems, or one unbatched problem where B is None."""
    if B is None:
        return _problem(H, W, seed, device)
    probs = [_problem(H, W, seed + k, device) for k in range(B)]
    return E.ArapOperands(**{f: torch.stack([getattr(o, f) for o in probs])
                             for f in vars(probs[0])})


def _eager(ops, cfg):
    """The schedule as a hand loop of eager ``gn_step`` calls."""
    cfg = S.resolve_for(ops, cfg)
    x = E.init_state(ops)
    tot = torch.zeros(x.shape[:-3], dtype=x.dtype, device=x.device)
    for i in range(cfg.num_anneal):
        alpha = np.float32(i + 1.0) / np.float32(cfg.num_anneal)
        cimg = E.anneal_constraints(ops, alpha)
        for _ in range(cfg.gn_iters):
            x, it = S.gn_step(x, ops, cimg, cfg, cfg.pcg_iters, 0.0, 0.0)
            tot = tot + it
    return x, tot


def _counts():
    c = profiling.TIMER.counts
    return {k: c[k] for k in ("gn linearise", "pcg launch", *GRAPH_STAGES)}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _launches():
    return dict(P.LAUNCHES), dict(P.LAUNCH_SHAPES)


def _launch_delta(after, before):
    return ({k: v - before[0].get(k, 0) for k, v in after[0].items()},
            {k: v - before[1].get(k, 0) for k, v in after[1].items()
             if v - before[1].get(k, 0)})


# ---- CPU: the decision, the key, and no capture off the card ----

def test_engage_first_eager_then_capture_then_replay():
    graphs = {}
    assert G.engage(graphs, "a") == "eager"
    assert G.engage(graphs, "b") == "eager"
    assert G.engage(graphs, "a") == "capture"
    assert G.engage(graphs, "a") == "capture"  # until a graph is stored
    graphs["a"] = object()
    assert [G.engage(graphs, "a") for _ in range(3)] == ["replay"] * 3
    assert G.engage(graphs, "b") == "capture"


def _key_parts():
    ops = _operands(2, 16, 32, 0, "cpu")
    return ops, E.init_state(ops)


def _double(ops):
    return E.ArapOperands(**{k: v.double() for k, v in vars(ops).items()})


def _strided(ops):
    vm = ops.vmasks.transpose(-1, -2).contiguous().transpose(-1, -2)
    return E.ArapOperands(**{**vars(ops), "vmasks": vm})


KEY_CHANGES = {
    "budget": lambda ops, x: (x, ops, 39, False),
    "tall": lambda ops, x: (x, ops, 40, True),
    "batch": lambda ops, x: (
        x[:1], E.ArapOperands(**{k: v[:1] for k, v in vars(ops).items()}),
        40, False),
    "dtype": lambda ops, x: (x.double(), _double(ops), 40, False),
    "leaf strides": lambda ops, x: (x, _strided(ops), 40, False),
    "unbatched": lambda ops, x: (
        x[0], E.ArapOperands(**{k: v[0] for k, v in vars(ops).items()}),
        40, False),
}


def _key(x, ops, budget, tall):
    return S._GraphChain(ops, x).key(budget, tall)


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_step_key_tells_apart_what_changes_the_launches(change):
    ops, x = _key_parts()
    key = _key(x, ops, 40, False)
    assert _key(x.clone(), _operands(2, 16, 32, 9, "cpu"), 40,
                False) == key  # the data does not enter it
    assert _key(*KEY_CHANGES[change](ops, x)) != key


@pytest.mark.parametrize("backend", ["cuda", "plain"])
def test_cpu_tensors_never_capture(backend):
    """CPU tensors on either backend: every step is ``gn_step``'s, bitwise
    the hand loop's, nothing is captured and no graph stage is timed."""
    G.registry("gn step").clear()
    ops = _operands(2, 16, 32, 3, "cpu")
    cfg = SHORT._replace(backend=backend, max_pcg_iters=3, pcg_iters=3.0)
    c0 = _counts()
    x, tot = S._per_gn_solve(ops, S.resolve_for(ops, cfg))
    d = _delta(_counts(), c0)
    assert d["gn linearise"] == d["pcg launch"] == 6
    assert d["gn graph capture"] == d["gn graph replay"] == 0
    assert G.registry("gn step") == {}
    xe, te = _eager(ops, cfg)
    assert torch.equal(x, xe) and torch.equal(tot, te)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    G.registry("gn step").clear()
    return torch.device("cuda", 0)


# two crop buckets at B = 1 and 4, and a spread-plan full frame
# (436×1024: p does not fit a 16-CTA cluster) given unbatched
CARD_SHAPES = [(1, 96, 128), (4, 96, 128), (1, 192, 256), (4, 192, 256),
               (None, 436, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", CARD_SHAPES)
def test_graph_chain_bitwise_the_eager_steps(cuda_device, B, H, W):
    ops = _operands(B, H, W, H + W, cuda_device)
    n = SHORT.num_anneal * SHORT.gn_iters
    l0, c0 = _launches(), _counts()
    xe, te = _eager(ops, SHORT)
    eager_launches = _launch_delta(_launches(), l0)
    l1, c1 = _launches(), _counts()
    x, tot = S._per_gn_solve(ops, S.resolve_for(ops, SHORT))
    d = _delta(_counts(), c1)
    assert torch.equal(x, xe) and torch.equal(tot, te)
    assert _launch_delta(_launches(), l1) == eager_launches
    assert eager_launches[0]["pcg_fixed"] == n
    # a fresh key: one eager step, one capture (which replays), n - 2
    # later replays
    assert d["gn linearise"] == d["pcg launch"] == 1
    assert d["gn graph capture"] == 1
    assert d["gn graph replay"] == n - 1
    assert _delta(_counts(), c0)["gn linearise"] == n + 1
    # the key's next chain replays every step, bitwise again
    c2 = _counts()
    x2, _ = S._per_gn_solve(ops, S.resolve_for(ops, SHORT))
    d2 = _delta(_counts(), c2)
    assert torch.equal(x2, xe)
    assert d2["gn linearise"] == d2["gn graph capture"] == 0
    assert d2["gn graph replay"] == n


@pytest.mark.cuda
def test_tall_layout_is_its_own_key(cuda_device, monkeypatch):
    ops = _operands(2, 96, 128, 5, cuda_device)
    xe, _ = _eager(ops, SHORT)
    monkeypatch.setenv("ARAP_TALL_KERNEL", "1")
    xt_e, _ = _eager(ops, SHORT)
    t0 = P.LAUNCHES["pcg_fixed_tall"]
    c0 = _counts()
    xt, _ = S._per_gn_solve(ops, S.resolve_for(ops, SHORT))
    assert torch.equal(xt, xt_e)
    assert P.LAUNCHES["pcg_fixed_tall"] - t0 == 6
    monkeypatch.delenv("ARAP_TALL_KERNEL")
    x, _ = S._per_gn_solve(ops, S.resolve_for(ops, SHORT))
    assert torch.equal(x, xe)
    d = _delta(_counts(), c0)
    assert d["gn graph capture"] == 2 and d["gn linearise"] == 2


@pytest.mark.cuda
def test_one_step_chain_captures_nothing(cuda_device):
    ops = _operands(2, 64, 128, 1, cuda_device)
    one = SHORT._replace(num_anneal=1, gn_iters=1)
    c0 = _counts()
    x, _ = S._per_gn_solve(ops, S.resolve_for(ops, one))
    d = _delta(_counts(), c0)
    assert d["gn linearise"] == 1
    assert d["gn graph capture"] == d["gn graph replay"] == 0
    assert torch.equal(x, _eager(ops, one)[0])
    assert all(v is G.SEEN for v in G.registry("gn step").values())


@pytest.mark.cuda
def test_back_to_back_chains_keep_their_own_results(cuda_device):
    """Two chains of one key issued before either result is read: each
    gives its own eager result (the state is cloned out of the static
    buffer at the end of a chain)."""
    a = _operands(3, 96, 128, 11, cuda_device)
    b = _operands(3, 96, 128, 21, cuda_device)
    cfg = S.resolve_for(a, SHORT)
    S._per_gn_solve(a, cfg)  # meets the key and captures it
    xa, _ = S._per_gn_solve(a, cfg)
    xb, _ = S._per_gn_solve(b, cfg)
    assert torch.equal(xa, _eager(a, SHORT)[0])
    assert torch.equal(xb, _eager(b, SHORT)[0])
    assert not torch.equal(xa, xb)


@pytest.mark.cuda
def test_capture_beside_a_copying_thread(cuda_device):
    """Another thread's device-to-host copies and event waits (the prep
    worker's ``transfer.fetch``) while the main thread captures: no capture
    breaks and every result is the eager one."""
    src = torch.arange(1 << 20, dtype=torch.float32, device=cuda_device)
    stop, copies, errors = threading.Event(), [0], []

    def worker():
        try:
            while not stop.is_set():
                ready = transfer.mark(cuda_device)
                (h,) = transfer.fetch([src * 2.0], ready)
                assert h[-1] == 2.0 * ((1 << 20) - 1)
                copies[0] += 1
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    try:
        outs = []
        for k, (H, W) in enumerate([(64, 128), (96, 128), (128, 128),
                                    (160, 128)]):
            ops = _operands(2, H, W, k, cuda_device)
            outs.append((ops, S._per_gn_solve(ops, S.resolve_for(ops,
                                                                 SHORT))[0]))
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert copies[0] > 0
    for ops, x in outs:
        assert torch.equal(x, _eager(ops, SHORT)[0])


def _replayed_and_eager_kernels() -> tuple[list, list]:
    """The kernels ``torch.profiler`` lists for a replayed GN solve and for
    the eager hand loop on the same operands, fills and copies aside."""
    from torch.profiler import ProfilerActivity, profile

    ops = _operands(2, 96, 128, 7, torch.device("cuda", 0))
    cfg = S.resolve_for(ops, SHORT)
    S._per_gn_solve(ops, cfg)  # the capture

    def kernels(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        return [n for n in names if not n.startswith(("Memcpy", "Memset"))
                and "FillFunctor" not in n]

    return (kernels(lambda: S._per_gn_solve(ops, cfg)),
            kernels(lambda: _eager(ops, SHORT)))


@pytest.mark.cuda
def test_profiler_names_the_replayed_kernels(cuda_device):
    """``torch.profiler`` lists a replay's kernels under their own names:
    fills and copies aside, the graph solve runs the hand loop's kernels
    less the loop's sums of the iteration counts, one add a step, and one
    ``pcg_cluster`` a step. Measured in a fresh interpreter: the profiler
    lists fewer kernel records than ran once its process has made a few
    million launches (from about 4 million, torch 2.11 on an H100), and
    the card suite's earlier tests make more."""
    here = pathlib.Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(here.parent), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run(
        [sys.executable, "-c", "import json, test_torch_gn_graph as t\n"
         "print(json.dumps(t._replayed_and_eager_kernels()))"],
        cwd=here, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    graph, eager = json.loads(out.stdout.splitlines()[-1])
    assert sum("pcg_cluster" in n for n in graph) == 6
    assert sorted(set(graph)) == sorted(set(eager))
    g, e = Counter(graph), Counter(eager)
    assert len(graph) == len(eager) - 6, (
        [(n[:90], c) for n, c in (g - e).items()],
        [(n[:90], c) for n, c in (e - g).items()])


@pytest.mark.cuda
def test_replays_after_other_plans_launch(cuda_device):
    """Each eager launch sets the PCG kernel's shared-memory attributes
    for its own plan; a graph captured under another plan's replays
    bitwise after it."""
    cfg = SHORT._replace(num_anneal=1)
    one = SHORT._replace(num_anneal=1, gn_iters=1)
    shapes = [(1, H, 128) for H in (64, 128, 192, 256, 320, 384, 448, 512)]
    ops = {s: _operands(*s, sum(s), cuda_device) for s in shapes}
    ref = {s: _eager(ops[s], cfg)[0] for s in shapes}
    for s in shapes:
        S._per_gn_solve(ops[s], S.resolve_for(ops[s], cfg))  # captures
    plans = {P.card_plan(*s, False, cuda_device) for s in shapes}
    assert len({p.smem_bytes for p in plans}) > 1
    c0 = _counts()
    for s, other in zip(shapes, shapes[::-1]):
        _eager(ops[other], one)
        x, _ = S._per_gn_solve(ops[s], S.resolve_for(ops[s], cfg))
        assert torch.equal(x, ref[s]), s
    d = _delta(_counts(), c0)
    assert d["gn graph capture"] == 0
    assert d["gn graph replay"] == len(shapes) * cfg.gn_iters
