"""The port's row-split solve (``parallel/spatial.py``) against the JAX
package's on the CPU, where the JAX side runs on conftest's 8 virtual
devices, as tests/test_parallel.py does, and the port on a mesh of CPU
entries.

``solve_spatial`` at data = 2, space = 4 and at data = 1, space = 8 (the
second with an early/late schedule) equals the port's ``solve`` within
5e-4 (tests/test_parallel.py's bound) and the float64 solve within 5e-4.
JAX's float32 ``solve_spatial`` drifts from the float64 solve by 5.8e-4 to
1.2e-3 px on these problems (the port's by < 1e-5; the two packages'
float64 solves agree to 1e-12), so the port is held to it within the
cross-package solve bound, 0.05 px (tests/test_torch_solver.py). With the ζ
tolerance, in float64, it equals the port's ``solve`` to 1e-9.
"""

import numpy as np
import pytest
import torch

from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu.parallel import make_mesh as jax_mesh
from arap_flow_tpu.parallel import solve_spatial as jax_spatial
from arap_flow_tpu_torch.ops import solver as TS
from arap_flow_tpu_torch.parallel import make_mesh, solve_spatial
from test_torch_parallel import _batches

torch.set_num_threads(1)

CPU = torch.device("cpu")
FLOW_TOL = 0.05
SPATIAL_TOL = 5e-4

SPATIAL_CASES = [
    # tests/test_parallel.py's two cases
    dict(H=32, W=24, seeds=(0, 1), data=2, space=4,
         sched=dict(num_anneal=2, gn_iters=2, pcg_iters=30.0)),
    # (the second with an early/late schedule added)
    dict(H=32, W=16, seeds=(7,), data=1, space=8,
         sched=dict(num_anneal=2, gn_iters=2, pcg_iters=25.0,
                    pcg_iters_early=20.0, anneal_split=1.0)),
]


@pytest.mark.parametrize("case", range(len(SPATIAL_CASES)))
def test_spatial_matches_solve_and_jax(case):
    c = SPATIAL_CASES[case]
    _, jb, tb = _batches(c["H"], c["W"], c["seeds"])
    sched = c["sched"]
    mesh = make_mesh(devices=[CPU] * 8, data=c["data"], space=c["space"])
    xs, flows = solve_spatial(tb, TS.SolverConfig(**sched), mesh)
    x1, f1 = TS.solve(tb, TS.SolverConfig(**sched))
    torch.testing.assert_close(xs, x1, rtol=0, atol=SPATIAL_TOL)
    torch.testing.assert_close(flows, f1, rtol=0, atol=SPATIAL_TOL)
    _, _, tb64 = _batches(c["H"], c["W"], c["seeds"], dtype=np.float64)
    x64, _ = TS.solve(tb64, TS.SolverConfig(**sched))
    assert (xs.double() - x64).abs().max() < SPATIAL_TOL
    _, jflows = jax_spatial(jb, JS.SolverConfig(**sched),
                            jax_mesh(data=c["data"], space=c["space"]))
    assert np.abs(flows.numpy() - np.asarray(jflows)).max() < FLOW_TOL


def test_spatial_tolerance_freezes_converged_problems():
    """With the ζ exit each problem stops on its own flag, on the device.
    The exit branches on float32 noise (the two solves sum their dot
    products in another order, and stop a few iterations apart), so this
    runs in float64, where the row-split solve equals the port's solve,
    whose PCG freezes a converged problem the same way, to 1e-9."""
    _, _, tb = _batches(32, 24, (0, 1), dtype=np.float64)
    cfg = TS.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=30.0,
                          q_tolerance=1e-3)
    xs, _ = solve_spatial(tb, cfg, make_mesh(devices=[CPU] * 4, space=4))
    x1, _, iters = TS.solve_stats(tb, cfg)
    torch.testing.assert_close(xs, x1, rtol=0, atol=1e-9)
    assert iters.max() < 2 * 2 * 30  # the exit did stop early
    x_full, _ = TS.solve(tb, cfg._replace(q_tolerance=0.0))
    assert (x1 - x_full).abs().max() > 1e-3


def test_spatial_needs_rows_divisible_by_space():
    _, _, tb = _batches(30, 24, (0,))
    with pytest.raises(ValueError, match="not divisible"):
        solve_spatial(tb, TS.SolverConfig(num_anneal=1, gn_iters=1,
                                          pcg_iters=2.0),
                      make_mesh(devices=[CPU] * 4, space=4))
