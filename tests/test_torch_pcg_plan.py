"""The launch plan of the cluster PCG kernel (ops/pcg.py::pcg_plan), for
every crop bucket and the full frame, and the CPU routes of the kernel
wrappers (the plain version, bitwise, and not counted).

The plan is pure Python, so it is checked here for every shape the solver
can hand the kernel: the CTAs' bands cover the rows exactly once, a
cluster has at most 16 CTAs, the resident plan fits the shared memory one
block of an H100 can use, and the two shapes whose p does not fit 16 CTAs
take the streamed plan.
"""

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.models.arap import CROP_BUCKETS
from arap_flow_tpu_torch.ops import pcg as TP

FULL_FRAME = (480, 854)
SHAPES = (*CROP_BUCKETS, FULL_FRAME)
STREAMED = {(512, 896), FULL_FRAME}


@pytest.mark.parametrize("B", [1, 4, 24])
@pytest.mark.parametrize("H,W", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_plan(B, H, W):
    plan = TP.pcg_plan(B, H, W)
    assert 1 <= plan.cluster <= TP.MAX_CLUSTER
    bands = [(k * plan.rows_per_cta, min(H, (k + 1) * plan.rows_per_cta))
             for k in range(plan.cluster)]
    rows = [y for y0, y1 in bands for y in range(y0, y1)]
    assert rows == list(range(H))  # every row once, in rank order
    assert all(y1 > y0 for y0, y1 in bands)  # no CTA without rows
    assert 0 <= plan.groups <= 4
    assert plan.smem_bytes <= TP.SMEM_PER_BLOCK
    assert plan.resident == ((H, W) not in STREAMED)
    if plan.resident:
        assert plan.smem_bytes >= 12 * plan.rows_per_cta * W  # p's band
    else:
        assert plan.cluster == TP.MAX_CLUSTER


def test_plan_fills_the_card_at_small_batch():
    """The cluster grows toward SMS // B: B = 1 and 4 take 16 CTAs a
    problem, the 24-problem chunk of the smallest bucket 5 (120 CTAs), and
    a batch of more problems than SMs one CTA each."""
    assert TP.pcg_plan(1, 64, 128).cluster == 16
    assert TP.pcg_plan(4, 192, 256).cluster == 16
    assert TP.pcg_plan(24, 64, 128).cluster == TP.SMS // 24
    assert TP.pcg_plan(200, 64, 128).cluster == 1


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
    before = dict(TP.LAUNCHES)
    torch.testing.assert_close(TP.pcg_fixed(*args, 11, tall=tall),
                               TP.pcg_fixed_plain(*args, 11), rtol=0, atol=0)
    assert TP.LAUNCHES == before


def test_three_pass_cpu_route_is_plain():
    args = _problem(seed=1)
    before = dict(TP.LAUNCHES)
    torch.testing.assert_close(TP._pcg_fixed_three_pass(*args, 9),
                               TP.pcg_fixed_plain(*args, 9), rtol=0, atol=0)
    assert TP.LAUNCHES == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        TP._pcg_fixed_three_pass(*meta, 3)
