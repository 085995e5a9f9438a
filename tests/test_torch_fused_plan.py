"""The launch plan of the fused whole-schedule cluster kernel
(ops/fused_solver.py::fused_plan) for every crop bucket and the full frame,
and the build key of the CUDA libraries (_build.lib_path).

The plan is pure Python given the card's active clusters of each candidate
plan, so it is checked here, with those counts injected, for every shape
the solver can hand the kernel: the CTAs' bands cover the rows exactly once
in rank order, a cluster has at most 16 CTAs, the shared memory fits one
block of an H100 and holds a prefix of the groups (s and c, r, Ap, δ, x),
the two shapes whose p does not fit 16 CTAs take the streamed plan, and the
cluster is the largest of which the card holds the whole batch at once
(else the fewest waves), never one of which no cluster fits.
"""

import shutil

import pytest

from arap_flow_tpu_torch import _build
from arap_flow_tpu_torch.models.arap import CROP_BUCKETS
from arap_flow_tpu_torch.ops import fused_solver as TF
from arap_flow_tpu_torch.ops import pcg as TP
from test_torch_pcg_plan import H100_LIKE

FULL_FRAME = (480, 854)
SINTEL_FRAME = (436, 1024)  # MPI-Sintel's frame: run_arap solves it whole
SHAPES = (*CROP_BUCKETS, FULL_FRAME, SINTEL_FRAME)
STREAMED = {(512, 896), FULL_FRAME, SINTEL_FRAME}


def h100_like(plan):
    return H100_LIKE[plan.cluster]


def waves(B, n):
    return -(-B // n)


def _groups_bytes(plan, W):
    """The bytes of the plan's groups in the stated order: p's halo rows
    and band, then s and c with halo rows, r, Ap, δ, x with halo rows."""
    R = plan.rows_per_cta
    base = 24 * W + (12 * R * W if plan.resident else 0)
    order = (2 * (4 * R * W + 8 * W), 12 * R * W, 12 * R * W, 12 * R * W,
             12 * R * W + 24 * W)
    return base, order


@pytest.mark.parametrize("B", [1, 4, 24])
@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_fused_plan(B, H, W):
    plan = TF.fused_plan(B, H, W, h100_like)
    assert 1 <= plan.cluster <= TP.MAX_CLUSTER
    R = plan.rows_per_cta
    bands = [(k * R, min(H, (k + 1) * R)) for k in range(plan.cluster)]
    rows = [y for y0, y1 in bands for y in range(y0, y1)]
    assert rows == list(range(H))  # every row once, in rank order
    assert all(y1 > y0 for y0, y1 in bands)  # no CTA without rows
    assert plan.resident == ((H, W) not in STREAMED)
    # the groups are a prefix of the stated order, and the next one would
    # not fit
    base, order = _groups_bytes(plan, W)
    assert 0 <= plan.groups <= len(order)
    assert plan.smem_bytes == base + sum(order[: plan.groups])
    assert plan.smem_bytes <= TP.SMEM_PER_BLOCK
    if plan.resident and plan.groups < len(order):
        assert (plan.smem_bytes + order[plan.groups]
                > TP.SMEM_PER_BLOCK - TP._STATIC_SMEM)
    if not plan.resident:
        assert plan.cluster == TP.MAX_CLUSTER and plan.groups == 0
        return
    # one wave where a candidate gives one, else the fewest waves; the
    # larger cluster among equals
    cands = TP.candidate_plans(H, W, TF._fused_group_bytes)
    best = min(waves(B, H100_LIKE[p.cluster]) for p in cands)
    assert waves(B, H100_LIKE[plan.cluster]) == best
    assert plan.cluster == max(p.cluster for p in cands
                               if waves(B, H100_LIKE[p.cluster]) == best)


@pytest.mark.parametrize("B,H,W,cluster,groups,smem", [
    (4, 192, 256, 16, 5, 225_280), (1, 192, 384, 16, 3, 218_112),
    (24, 64, 128, 4, 5, 147_456), (1, 480, 854, 16, 0, 20_496)])
def test_fused_plan_of_the_main_shapes(B, H, W, cluster, groups, smem):
    """The pipeline's chunk keeps every plane in shared memory, x included;
    the deform pair's 192×384 bucket keeps p, s and c, r and Ap (δ and x in
    device memory); the pipeline's largest chunk takes 4-CTA clusters in one
    wave; the full frame is streamed."""
    plan = TF.fused_plan(B, H, W, h100_like)
    assert (plan.cluster, plan.groups, plan.smem_bytes) == (cluster, groups,
                                                           smem)


@pytest.mark.parametrize("B,H,W", [(1, 64, 128), (4, 192, 256),
                                   (24, 64, 128), (3, 16, 128)])
def test_fused_plan_skips_plans_that_do_not_fit(B, H, W):
    """With the cluster the H100's counts would take reported as not
    fitting (0 active), another plan is taken, and never one with 0."""
    first = TF.fused_plan(B, H, W, h100_like)

    def active(plan):
        return 0 if plan.cluster == first.cluster else H100_LIKE[plan.cluster]

    plan = TF.fused_plan(B, H, W, active)
    assert plan.cluster != first.cluster and active(plan) > 0


def test_fused_plan_has_the_pcg_plans_cluster_and_more_groups():
    """The same rule as the PCG kernel's: at every bucket B = 4 takes the
    PCG kernel's cluster, and the fused groups extend the PCG groups by x."""
    for H, W in CROP_BUCKETS:
        fused = TF.fused_plan(4, H, W, h100_like)
        pcg = TP.pcg_plan(4, H, W, h100_like)
        assert fused.cluster == pcg.cluster
        assert fused.groups >= pcg.groups
        assert fused.groups <= pcg.groups + 1


def test_lib_path_hashes_the_headers(tmp_path, monkeypatch):
    """Editing a shared header changes the build key of every library, so
    pcg and fused_solver (which include it) both rebuild; nothing is
    built here."""
    src = tmp_path / "csrc"
    shutil.copytree(_build._SRC_DIR, src)
    monkeypatch.setattr(_build, "_SRC_DIR", str(src))
    before = {s: _build.lib_path(s) for s in _build.SOURCES}
    assert before == {s: _build.lib_path(s) for s in _build.SOURCES}
    header = src / "cluster.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {s: _build.lib_path(s) for s in _build.SOURCES}
    for s in ("pcg.cu", "fused_solver.cu"):
        assert after[s] != before[s]
        assert after[s].startswith(str(_build.BUILD_DIR))
    assert '#include "cluster.cuh"' in (src / "pcg.cu").read_text()
    assert '#include "cluster.cuh"' in (src / "fused_solver.cu").read_text()
