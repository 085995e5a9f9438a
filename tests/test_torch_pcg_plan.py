"""The launch plan of the PCG kernel (ops/pcg.py::kernel_plan: the
cluster plans of pcg_plan, the spread plan of spread_plan), for every crop
bucket and the full frames, and the CPU routes of the kernel wrappers (the
plain version, bitwise, and not counted).

The plan is pure Python given the card's active clusters of each candidate
plan and its SMs, so it is checked here for every shape the solver can
hand the kernel, with those counts injected: the CTAs' bands cover the
rows (the spread plan's the pixels) exactly once, a cluster has at most 16
CTAs, the plan fits the shared memory one block of an H100 can use, the
three shapes whose p does not fit 16 CTAs take the spread plan over the
card's 132 SMs, every crop bucket keeps the resident cluster plan, and the
cluster is the largest of which the card holds the whole batch at once
(else the fewest waves).
"""

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.models.arap import CROP_BUCKETS
from arap_flow_tpu_torch.ops import pcg as TP

FULL_FRAME = (480, 854)
SINTEL_FRAME = (436, 1024)  # MPI-Sintel's frame: run_arap solves it whole
SHAPES = (*CROP_BUCKETS, FULL_FRAME, SINTEL_FRAME)
# p does not fit a 16-CTA cluster: the spread plan (the cluster planner
# alone, which the fused kernel uses, takes the streamed plan)
STREAMED = {(512, 896), FULL_FRAME, SINTEL_FRAME}

# Active clusters by cluster size, shaped like an H100's
# (cudaOccupancyMaxActiveClusters of the kernel, one CTA an SM): 7 of 16
# CTAs and 22 of 5 as measured; never more CTAs than the card's 132 SMs.
H100_LIKE = {1: 132, 2: 66, 3: 40, 4: 32, 5: 22, 6: 20, 7: 16, 8: 16, 9: 14,
             10: 12, 11: 11, 12: 10, 13: 9, 14: 8, 15: 8, 16: 7}
SMS = 132


def h100_like(plan):
    """Active clusters of a cluster plan; a spread plan's 1 where the card
    holds all its CTAs, one an SM."""
    if plan.kind == "spread":
        return int(plan.cluster <= SMS)
    return H100_LIKE[plan.cluster]


def assert_spread(plan, H, W, sms=SMS):
    """A spread plan: its pixel bands cover H·W once, in rank order, each
    of at least W pixels (the halos come from the two neighbours) and an
    even count (pixel pairs), no more CTAs than SMs, its shared memory (p,
    s and c with halos, r, Ap, δ) within a block's."""
    assert plan.kind == "spread" and plan.resident and plan.groups == 0
    n, px = plan.cluster, plan.px_per_cta
    assert TP.MAX_CLUSTER < n <= min(sms, TP.MAX_SPREAD)
    assert (n - 1) * px < H * W <= n * px  # every CTA has pixels
    assert px % 2 == 0 and px >= W and H * W - (n - 1) * px >= W
    assert plan.smem_bytes == TP._spread_bytes(px, W)
    assert plan.smem_bytes <= TP.SMEM_PER_BLOCK - TP._STATIC_SMEM


def old_rule(B, H, W):
    """The rule this one replaced: the cluster raised toward 132 // B, from
    the smallest resident cluster up to 16."""
    plans = TP.candidate_plans(H, W)
    if len(plans) == 1:
        return plans[0]
    want = min(TP.MAX_CLUSTER, max(plans[0].cluster, SMS // max(B, 1)))
    return max((p for p in plans if p.cluster <= want),
               key=lambda p: p.cluster)


@pytest.mark.parametrize("B", [1, 2, 3, 4, 24])
@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan(B, H, W):
    """The kernel's plan: the spread plan where p does not fit a 16-CTA
    cluster, else the cluster planner's resident plan unchanged (every crop
    bucket at the batches the crop path runs)."""
    plan = TP.kernel_plan(B, H, W, h100_like, SMS)
    if (H, W) in STREAMED:
        assert_spread(plan, H, W)
        assert TP.pcg_plan(B, H, W, h100_like).kind == "streamed"
        return
    assert plan == TP.pcg_plan(B, H, W, h100_like)
    assert plan.kind == "resident" and plan.px_per_cta == 0
    assert 1 <= plan.cluster <= TP.MAX_CLUSTER
    bands = [(k * plan.rows_per_cta, min(H, (k + 1) * plan.rows_per_cta))
             for k in range(plan.cluster)]
    rows = [y for y0, y1 in bands for y in range(y0, y1)]
    assert rows == list(range(H))  # every row once, in rank order
    assert all(y1 > y0 for y0, y1 in bands)  # no CTA without rows
    assert 0 <= plan.groups <= 4
    assert plan.smem_bytes <= TP.SMEM_PER_BLOCK
    assert plan.smem_bytes >= 12 * plan.rows_per_cta * W  # p's band
    # one wave wherever a candidate gives one
    assert H100_LIKE[plan.cluster] >= B or all(
        H100_LIKE[p.cluster] < B for p in TP.candidate_plans(H, W))


@pytest.mark.parametrize("H,W,px,smem", [
    (436, 1024, 3384, 230_464), (480, 854, 3106, 208_096),
    (512, 896, 3476, 230_496),
    # a band's state does not fit a block's shared memory
    (436, 1100, None, None), (1080, 1920, None, None),
    (576, 1024, None, None),
], ids=["sintel", "frame", "bucket512", "436x1100", "1080p", "576x1024"])
def test_spread_plan(H, W, px, smem):
    """The spread plan over 132 SMs: 132 CTAs at the three shapes that take
    it; where a band's state does not fit, none, and the kernel keeps the
    streamed plan."""
    plan = TP.spread_plan(H, W, SMS)
    if px is None:
        assert plan is None
        assert TP.kernel_plan(1, H, W, h100_like, SMS).kind == "streamed"
        return
    assert_spread(plan, H, W)
    assert (plan.cluster, plan.px_per_cta, plan.smem_bytes) == (SMS, px, smem)
    # a card that holds fewer CTAs at once keeps the streamed plan
    assert TP.kernel_plan(1, H, W, lambda p: (
        0 if p.kind == "spread" else h100_like(p)), SMS).kind == "streamed"


@pytest.mark.parametrize("B,H,W,cluster", [
    (1, 64, 128, 16), (4, 192, 256, 16), (24, 64, 128, 4),
    (24, 192, 256, 4), (8, 192, 256, 15), (72, 16, 128, 1),
    (200, 64, 128, 1)])
def test_plan_takes_the_largest_one_wave_cluster(B, H, W, cluster):
    """With an H100's counts: B = 1 and 4 keep 16 CTAs a problem (7
    clusters of 16 fit), the 24-problem chunk takes 4 (22 clusters of 5
    would run in two waves), 8 problems take 8, 72 one-row problems one
    CTA each, and 200 problems (no one-wave plan) the fewest waves."""
    assert TP.pcg_plan(B, H, W, h100_like).cluster == cluster


@pytest.mark.parametrize("B,counts,cluster", [
    # no size holds the batch at once: the fewest waves
    (40, {c: 20 // c for c in range(1, 17)}, 1),
    (30, {1: 5, 2: 10, 4: 16, 8: 4, 16: 2}, 4),
    # a tie in waves goes to the larger cluster
    (50, {1: 30, 2: 25, 4: 12, 8: 6, 16: 3}, 2),
    # a plan of which no cluster fits is never taken
    (3, {1: 0, 2: 0, 4: 0, 8: 1, 16: 0}, 8),
], ids=["fewest-waves", "fewest-waves-mid", "tie-larger", "skip-zero"])
def test_plan_without_a_one_wave_cluster(B, counts, cluster):
    """16×128 problems (among the trimmed sizes 1, 2, 4, 8 and 16), with
    injected counts."""
    def active(plan):
        return counts.get(plan.cluster, 0)

    assert TP.pcg_plan(B, 16, 128, active).cluster == cluster


# (B, H, W) that the old rule ran in one wave with an H100's counts
ONE_WAVE_BEFORE = [
    (B, H, W) for B in (1, 4, 24, 72) for H, W in (*SHAPES, (16, 128))
    if not old_rule(B, H, W).resident
    or H100_LIKE[old_rule(B, H, W).cluster] >= B]


@pytest.mark.parametrize("B,H,W", ONE_WAVE_BEFORE,
                         ids=[f"B{b}-{h}x{w}" for b, h, w in ONE_WAVE_BEFORE])
def test_plan_keeps_one_wave_plans_of_the_old_rule(B, H, W):
    """Every shape that ran in one wave under the old rule keeps its plan
    (B = 1 at every size, B = 4 192×256, B = 72 16×128 among them)."""
    assert TP.pcg_plan(B, H, W, h100_like) == old_rule(B, H, W)


def test_candidate_plans_are_trimmed_and_distinct():
    plans = TP.candidate_plans(16, 128)
    assert [p.cluster for p in plans] == [1, 2, 3, 4, 6, 8, 16]
    assert [p.rows_per_cta for p in plans] == [16, 8, 6, 4, 3, 2, 1]
    assert TP.candidate_plans(*FULL_FRAME) == [
        TP.pcg_plan(24, *FULL_FRAME, lambda plan: 0)]
    assert [p.kind for p in TP.candidate_plans(*FULL_FRAME)] == ["streamed"]


def _problem(B=2, H=12, W=40, seed=0):
    """B small random SPD-like problems: positive fit and masks."""
    rng = np.random.default_rng(seed)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.tensor(rng.uniform(lo, hi, shape), dtype=torch.float32)

    vm = torch.tensor(rng.integers(0, 2, (B, 4, H, W)), dtype=torch.float32)
    th = t(B, H, W, lo=-3.0, hi=3.0)
    return (t(B, 3, H, W), t(B, 3, H, W, lo=0.01, hi=0.5), torch.sin(th),
            torch.cos(th), vm, t(B, H, W, lo=0.0, hi=1.0),
            torch.tensor([100.0, 30.0][:B]), torch.tensor([0.01, 0.05][:B]))


@pytest.mark.parametrize("tall", [False, True])
def test_cpu_route_is_plain_and_not_counted(tall):
    args = _problem()
    before, shapes = dict(TP.LAUNCHES), dict(TP.LAUNCH_SHAPES)
    plans = dict(TP.PLAN_CALLS)
    torch.testing.assert_close(TP.pcg_fixed(*args, 11, tall=tall),
                               TP.pcg_fixed_plain(*args, 11), rtol=0, atol=0)
    assert TP.LAUNCHES == before and dict(TP.LAUNCH_SHAPES) == shapes
    assert dict(TP.PLAN_CALLS) == plans


def smaller_card(plan):
    """A stand-in card of 66 SMs (one CTA an SM) that holds no cluster of
    more than 12 CTAs."""
    if plan.kind == "spread":
        return int(plan.cluster <= 66)
    return 0 if plan.cluster > 12 else 66 // plan.cluster


@pytest.mark.parametrize("planner", ["pcg", "fused"])
@pytest.mark.parametrize("B", [1, 24])
@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan_on_a_smaller_card(planner, B, H, W):
    """Every bucket, the full frame and Sintel's frame at B = 1 and the
    pipeline's largest chunk (max_chunk_for gives 24 at every bucket), on a
    card that holds fewer and smaller clusters and 66 SMs: no CTA without
    rows, the bands cover the rows, the shared memory within a block's,
    and a resident plan with the fewest waves among those the card holds;
    where it holds none (384x640 needs 14 CTAs), the largest candidate,
    which the kernel's entry then refuses. The large frames' state does
    not fit 66 CTAs' shared memory: the PCG kernel streams them too."""
    from arap_flow_tpu_torch.ops import fused_solver as TF
    from arap_flow_tpu_torch.pipeline.batch import max_chunk_for

    if B > 1:
        assert max_chunk_for((H, W)) == B
    plan = (TP.kernel_plan(B, H, W, smaller_card, 66) if planner == "pcg"
            else TF.fused_plan(B, H, W, smaller_card))
    R, n = plan.rows_per_cta, plan.cluster
    assert 1 <= n <= TP.MAX_CLUSTER
    assert R * n >= H and R * (n - 1) < H  # every CTA has rows
    assert plan.smem_bytes <= TP.SMEM_PER_BLOCK - TP._STATIC_SMEM
    assert plan.resident == ((H, W) not in STREAMED)
    if plan.resident:
        groups = TP._group_bytes if planner == "pcg" else TF._fused_group_bytes
        cands = TP.candidate_plans(H, W, groups)
        runs = [p for p in cands if smaller_card(p) > 0]
        if not runs:
            assert plan == cands[-1] and (H, W) == (384, 640)
            return
        best = min(-(-B // smaller_card(p)) for p in runs)
        assert smaller_card(plan) > 0
        assert -(-B // smaller_card(plan)) == best

