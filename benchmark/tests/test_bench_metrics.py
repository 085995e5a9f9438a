"""Each metric's arithmetic on a fixed trace fixture, and the trace
reduction (busy time, idle gaps, their names)."""

import pytest

from benchmark import devtrace, harness, yardstick
from benchmark.harness import Context

MS = 1_000_000  # ns


def _ctx(**kw):
    base = dict(setup_s=31.5, window_s=12.0, pairs=24, attempted=24, jobs=1,
                stages={"chunk prep-wait": 1.2, "decode+preprocess": 0.48,
                        "matching": 0.96, "chunk dispatch": 7.2},
                pcg_shapes={(4, 192, 256): 2, (1, 192, 384): 1},
                zncc_launches=24, frame_hw=(480, 854), pcg_iters=400,
                gn_calls=1, solve_boxes=[],
                ops=[("void pcg_cluster<4, true>(PcgArgs)", 0, 3 * MS),
                     ("zscore_kernel(float const*, float*, int)", 3 * MS,
                      3 * MS + 100_000),
                     ("search_kernel(SearchArgs)", 4 * MS, 5 * MS),
                     ("Memcpy HtoD (Pageable -> Device)", 5 * MS, 6 * MS),
                     ("elementwise_kernel", 6 * MS, 7 * MS)],
                busy_s=3.0)
    base.update(kw)
    return Context(**base)


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_end_to_end():
    assert read("pairs_per_s", _ctx()) == 2.0
    assert read("pairs_per_s.full_frame", _ctx()) == 2.0
    assert read("setup_s", _ctx()) == 31.5


@pytest.mark.parametrize("name,stage", [
    ("prep_wait_s_per_pair", "chunk prep-wait"),
    ("decode_s_per_pair", "decode+preprocess"),
    ("match_s_per_pair", "matching"),
    ("dispatch_s_per_pair", "chunk dispatch")])
def test_stage_metrics(name, stage):
    ctx = _ctx()
    assert read(name, ctx) == pytest.approx(ctx.stages[stage] / 24)
    assert read(name, _ctx(stages={})) is None  # nothing to read: silent


def test_launches_per_pair_counts_kernels_only():
    assert read("launches_per_pair", _ctx()) == pytest.approx(4 / 24)
    assert read("launches_per_pair", _ctx(ops=[])) is None


@pytest.mark.parametrize("name", ["device_idle_share",
                                  "device_idle_share.full_frame"])
def test_device_idle_share(name):
    assert read(name, _ctx()) == pytest.approx(75.0)
    assert read(name, _ctx(busy_s=None)) is None


def test_pcg_roofline_share():
    # 9 problem-calls launched (2 x B = 4, 1 x B = 1), 9 solve boxes needed
    boxes = [(150, 230)] * 8 + [(180, 370)]
    ctx = _ctx(solve_boxes=boxes)
    least = sum(yardstick.pcg_seconds(1, h, w, 400) for h, w in boxes)
    assert read("pcg_roofline_share", ctx) == pytest.approx(
        100 * least / 3e-3)
    # the work comes from the inputs: the canvases the program pads the
    # problems into do not change it
    assert read("pcg_roofline_share", _ctx(
        solve_boxes=boxes, pcg_shapes={(9, 512, 512): 1})) == pytest.approx(
            100 * least / 3e-3)
    # two jobs, two GN steps a problem: four times the work
    assert read("pcg_roofline_share", _ctx(
        solve_boxes=boxes, jobs=2, gn_calls=2,
        pcg_shapes={(9, 512, 512): 4})) == pytest.approx(400 * least / 3e-3)
    # the kernel table's bound: 0.1115 ms a call at B = 4 192x256
    assert yardstick.pcg_seconds(4, 192, 256, 400) == pytest.approx(
        1.1151e-4, rel=1e-3)
    # nothing to read, or another count of problems than the inputs need
    assert read("pcg_roofline_share", _ctx(pcg_shapes={})) is None
    assert read("pcg_roofline_share", _ctx(solve_boxes=boxes[1:])) is None


def test_zncc_roofline_share():
    # 24 pairs: 6 matcher calls of 4 launches (1 + 3 levels)
    searches = yardstick.match_searches(480, 854)
    assert [s[:2] for s in searches] == [(2, 10), (2, 2), (2, 2), (2, 2)]
    assert searches[0][2:] == (60, 106, 13)
    t = 1.1e-3
    assert read("zncc_roofline_share", _ctx()) == pytest.approx(
        100 * 24 * yardstick.match_seconds(480, 854) / t)
    # launches that are not whole matcher calls, or too few: no reading
    assert read("zncc_roofline_share", _ctx(zncc_launches=23)) is None
    assert read("zncc_roofline_share", _ctx(zncc_launches=20)) is None


def test_busy_gaps_and_names():
    ops = [("a", 10, 20), ("b", 15, 30), ("c", 50, 60), ("d", 95, 130)]
    busy = devtrace.busy_intervals(ops, 0, 100)
    assert busy == [[10, 30], [50, 60], [95, 100]]
    idle = devtrace.gaps(busy, 0, 100)
    assert idle == [(0, 10), (30, 50), (60, 95)]
    log = devtrace.StageLog()
    log.span("job", 0, 100)
    log.span("chunk dispatch", 25, 55)
    bd = devtrace.breakdown(ops, idle, log, n=2)
    assert bd["idle_gaps"] == [["job", 35e-9], ["chunk dispatch", 20e-9]]
    assert bd["device_ops"][0] == ["d", 35e-9]


def test_stage_log_records_a_timer():
    from arap_flow_tpu_torch.utils.profiling import StageTimer

    timer, log = StageTimer(), devtrace.StageLog()
    log.attach(timer)
    with timer.stage("x"):
        pass
    timer.add("y", 0.5)
    log.detach()
    with timer.stage("z"):
        pass
    assert [s[0] for s in log.spans] == ["x", "y"]
    assert timer.counts == {"x": 1, "y": 1, "z": 1}
