"""The port's span recorder (``utils/profiling.StageTimer`` and its process
instance ``TIMER``): off by default, the spans' parents, threads and ids
when on, the totals either way, the Chrome traces of ``ARAP_TRACE`` and
``device_trace``, the benchmark's ``StageLog`` over ``TIMER``, and the
stages of ``para_gen --mode batched`` and ``run_arap`` on the CPU at a
short schedule.
"""

import json
import os
import os.path as osp
import threading
import time

import numpy as np
import torch

from arap_flow_tpu_torch.io.image import save_image
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import solver as S
from arap_flow_tpu_torch.pipeline import para_gen as TP
from arap_flow_tpu_torch.pipeline import run_arap as TRA
from arap_flow_tpu_torch.utils import profiling as P
from arap_flow_tpu_torch.utils.config import FrameworkConfig
from benchmark import devtrace

torch.set_num_threads(2)

SHORT = S.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=10,
                       pcg_iters=10.0)
H, W = 72, 136  # the crop buckets are 128 wide at least


def _traces(d):
    return sorted(os.listdir(d)) if osp.isdir(d) else []


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_off_by_default_records_no_span_and_writes_nothing(
        tmp_path, monkeypatch):
    monkeypatch.delenv("ARAP_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    assert P.TIMER.spans is None
    t = P.StageTimer()
    with P.entry_call(t), t.scope(chunk=1), t.stage("a"):
        t.add("b", 0.25)
    assert t.spans is None and t.threads == {}
    assert dict(t.counts) == {"a": 1, "b": 1} and t.totals["b"] == 0.25
    assert os.listdir(tmp_path) == []


def test_spans_parent_thread_ids_and_reset():
    t = P.StageTimer()
    with t.recording() as spans:
        with t.scope(job=3), t.stage("outer"):
            with t.scope(chunk=1, pair=4), t.stage("inner"):
                pass
            t.add("added", 0.001)
            ids = t.scope_ids()

            def work():
                with t.scope(**ids, chunk=2), t.stage("worker"):
                    pass

            th = threading.Thread(target=work, name="prep")
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    assert t.spans is None  # off again after the block
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "inner", "added", "worker"}
    outer = by["outer"]
    assert outer.parent is None and outer.ids == {"job": 3}
    assert by["inner"].parent == by["added"].parent == outer.id
    assert by["inner"].ids == {"job": 3, "chunk": 1, "pair": 4}
    assert by["added"].ids == {"job": 3}
    assert by["worker"].parent is None
    assert by["worker"].ids == {"job": 3, "chunk": 2}
    me = threading.get_native_id()
    assert outer.thread == by["inner"].thread == me != by["worker"].thread
    assert t.threads[by["worker"].thread] == "prep"
    assert outer.start_ns <= by["inner"].start_ns <= by["inner"].end_ns \
        <= outer.end_ns
    assert by["added"].end_ns - by["added"].start_ns == 1_000_000
    assert len({s.id for s in spans}) == 4
    # reset: a fresh table, recording left as it was
    with t.recording() as spans2:
        with t.stage("x"):
            pass
        t.reset()
        assert t.spans == [] and not t.totals and not t.counts
        with t.stage("y"):
            pass
    assert [s.name for s in spans2] == ["y"] and dict(t.counts) == {"y": 1}
    t.reset()
    assert t.spans is None and not t.totals


def test_totals_identical_with_recording_on_and_off():
    def drive(t):
        for k in range(3):
            with t.scope(pair=k), t.stage("s"):
                t.add("a", 0.125 * k)
        t.add("b", 1.5)

    off, on = P.StageTimer(), P.StageTimer()
    drive(off)
    with on.recording() as spans:
        drive(on)
    assert dict(off.counts) == dict(on.counts) == {"s": 3, "a": 3, "b": 1}
    assert (off.totals["a"], off.totals["b"]) == (on.totals["a"],
                                                  on.totals["b"])
    assert len(spans) == 7
    # a recording nested in another hands its spans to the outer one
    with on.recording() as outer:
        with on.recording() as inner:
            drive(on)
    assert len(inner) == len(outer) == 7


def test_arap_trace_writes_one_chrome_trace_per_call(tmp_path, monkeypatch):
    d = tmp_path / "spans"
    monkeypatch.setenv("ARAP_TRACE", str(d))
    t = P.StageTimer()
    for _ in range(2):
        with P.entry_call(t):
            with t.scope(chunk=0), t.stage("a"):
                t.add("b", 0.0)
    assert t.spans is None and dict(t.counts) == {"a": 2, "b": 2}
    files = _traces(d)
    assert len(files) == 2 and all(f.startswith(f"spans-{os.getpid()}-")
                                   for f in files)
    jobs = set()
    for f in files:
        tr = _load(d / f)
        xs = [e for e in tr["traceEvents"] if e["ph"] == "X"]
        assert [e["name"] for e in xs] == ["b", "a"]
        assert {e["tid"] for e in xs} == {threading.get_native_id()}
        assert xs[0]["args"]["parent"] == xs[1]["args"]["span"]
        assert xs[1]["args"]["chunk"] == 0
        jobs.add(xs[1]["args"]["job"])
        assert any(e["ph"] == "M" and e["name"] == "thread_name"
                   for e in tr["traceEvents"])
    assert len(jobs) == 2  # each call is a job of its own


def test_device_trace_puts_spans_and_ops_on_one_clock(tmp_path):
    logdir = tmp_path / "trace"
    a = torch.ones(64, 64)
    with P.device_trace(str(logdir)):
        with P.TIMER.stage("span around mm"):
            # a margin on both sides, far above any skew between the clocks
            time.sleep(0.002)
            torch.mm(a, a)
            time.sleep(0.002)
    assert P.TIMER.spans is None
    (name,) = _traces(logdir)
    assert name.startswith("trace-")
    ev = _load(logdir / name)["traceEvents"]
    (span,) = [e for e in ev if e.get("cat") == "stage"]
    assert span["name"] == "span around mm"
    mms = [e for e in ev if e.get("ph") == "X" and e["name"] == "aten::mm"]
    assert mms
    for op in mms:
        assert span["ts"] <= op["ts"]
        assert op["ts"] + op["dur"] <= span["ts"] + span["dur"]
        assert op["tid"] == span["tid"]


def _problem():
    mask = np.full((24, 32), 255, np.uint8)
    mask[4:20, 4:28] = 0
    cons = np.array([[8, 8, 9, 9], [20, 12, 21, 13]], np.int32)
    from arap_flow_tpu_torch.io.constraints import add_border_pins
    return E.build_operands(mask, add_border_pins(cons, 32, 24),
                            device="cpu")


def test_stage_log_attaches_to_the_process_timer():
    log = devtrace.StageLog()
    log.attach(P.TIMER)
    try:
        assert TP.TIMER is P.TIMER
        S.solve(_problem(), SHORT._replace(num_anneal=1, gn_iters=2,
                                           backend="plain"))
    finally:
        log.detach()
    names = [s[0] for s in log.spans]
    assert names.count("gn linearise") == names.count("pcg launch") == 2
    assert "stage" not in vars(P.TIMER) and "add" not in vars(P.TIMER)
    n = len(log.spans)
    S.solve(_problem(), SHORT._replace(num_anneal=1, gn_iters=1))
    assert len(log.spans) == n  # detached


def _tree(root, n_frames=3):
    """JPEG frames of two textured boxes moving over a dark background."""
    rng = np.random.default_rng(5)
    tex = np.kron(rng.uniform(60, 255, (H // 4 + 2, W // 4 + 2, 3)),
                  np.ones((4, 4, 1)))[:H, :W].astype(np.uint8)
    bg = (tex[::-1, ::-1] // 4).copy()
    for d in ("orgRGB/seq0", "orgMasks/seq0"):
        os.makedirs(osp.join(root, d))
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img, mask = bg.copy(), np.zeros((H, W), np.uint8)
        for k, (y0, x0, dy, dx) in enumerate(((8, 8, 1, 2), (30, 50, 2, -1))):
            y, x = y0 + dy * t, x0 + dx * t
            ob = (yy >= y) & (yy < y + 24) & (xx >= x) & (xx < x + 30)
            img[ob] = tex[yy[ob] - dy * t, xx[ob] - dx * t]
            mask[ob] = k + 1
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


def _diff(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def test_para_gen_batched_records_the_matcher_and_gn_stages(
        tmp_path, monkeypatch):
    inp, trace = str(tmp_path / "in"), tmp_path / "spans"
    _tree(inp, n_frames=4)  # 3 pairs: chunks of 2 and 1
    monkeypatch.setenv("ARAP_TRACE", str(trace))
    monkeypatch.setenv("ARAP_ASYNC_IO", "0")
    before = dict(P.TIMER.counts)
    lines = TP.main_pipeline(
        TP.PipelineFlags(input=inp, output=str(tmp_path / "out"),
                         multseg=True, seed=0, mode="batched", narap=1,
                         device="cpu", match_downscale=4),
        solver_cfg=SHORT)
    c = _diff(dict(P.TIMER.counts), before)
    assert len(lines) == 3
    # one fetch a matched pair, each split into its wait and its selection
    assert c["matching wait"] == c["matching select"] == 3
    # the CPU takes the plain route; each GN step is one of each stage
    steps = SHORT.num_anneal * SHORT.gn_iters
    assert c["gn linearise"] == c["pcg launch"] == \
        steps * c["solve+raster dispatch"]
    (name,) = _traces(trace)
    xs = [e for e in _load(trace / name)["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} >= {"matching wait", "matching select",
                                       "gn linearise", "chunk dispatch"}
    assert len({e["args"]["job"] for e in xs}) == 1
    waits = [e for e in xs if e["name"] == "matching wait"]
    assert sorted(e["args"]["pair"] for e in waits) == [0, 1, 2]
    # the prep worker's spans carry the chunk it preps, on its own thread
    main = {e["tid"] for e in xs if e["name"] == "chunk dispatch"}
    assert len(main) == 1 and not main & {e["tid"] for e in waits}
    assert {e["args"]["chunk"] for e in waits} == {0, 1}
    by_id = {e["args"]["span"]: e for e in xs}
    for e in xs:
        if e["name"] == "gn linearise":
            chain = []
            p = e["args"]["parent"]
            while p is not None:
                chain.append(by_id[p]["name"])
                p = by_id[p]["args"]["parent"]
            assert chain[-1] == "chunk dispatch"


def _sintel(root, n=2, h=32, w=48):
    rng = np.random.default_rng(3)
    for sub in ("clean/s", "masks/clean/s", "cnstr/clean/s"):
        os.makedirs(osp.join(root, sub))
    for i in range(n):
        name = f"frame_{i:04d}"
        save_image(osp.join(root, "clean/s", name + ".png"),
                   rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
        mask = np.full((h, w), 255, np.uint8)
        mask[6:26, 8:40] = 0
        save_image(osp.join(root, "masks/clean/s", name + ".png"), mask)
        with open(osp.join(root, "cnstr/clean/s", name + ".txt"), "w") as f:
            f.write(f"2\n12 10 {13 + i} 11\n30 20 31 {21 - i}\n")


def test_run_arap_records_its_four_stages(tmp_path, monkeypatch):
    root = str(tmp_path / "sintel")
    _sintel(root)
    monkeypatch.delenv("ARAP_TRACE", raising=False)
    monkeypatch.setattr(TRA, "make_framework_config",
                        lambda _: FrameworkConfig.from_env(solver=SHORT))
    before = dict(P.TIMER.counts)
    assert TRA.main(["--input", root, "--passes", "clean",
                     "--device", "cpu"]) == 0
    c = _diff(dict(P.TIMER.counts), before)
    for stage in ("run_arap scan", "run_arap prep", "run_arap solve",
                  "run_arap write"):
        assert c[stage] == 1, stage
    assert c["gn linearise"] == SHORT.num_anneal * SHORT.gn_iters
    assert osp.exists(osp.join(root, "flow_arap/clean/s/frame_0001.flo"))
