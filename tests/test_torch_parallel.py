"""The port's device meshes (``parallel/``) against the JAX package's on the
CPU, where the JAX side runs on conftest's 8 virtual devices, as
tests/test_parallel.py does, and the port on a mesh of CPU entries.

- Data axis: ``solve_batch_sharded`` on ``[cpu]*8`` equals the port's
  ``solve_batch`` within 1e-5, and JAX's ``solve_batch_sharded`` (data = 8)
  within the bound tests/test_torch_batch_solve.py holds ``solve_batch`` to
  (flows within 0.05 px max, 0.005 px median). The schedule's floats reach
  every slice (there is no executable to cache, so JAX's no-recompile test
  becomes a test that ``pcg_iters`` is honoured).
- The space axis (``solve_spatial``) is in tests/test_torch_spatial.py.
- ``BatchRunner`` on a two-entry mesh, with a chunk of 3 that splits 2 + 1,
  equals the unsharded runner within 1e-5 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arap_flow_tpu.io.constraints import add_border_pins
from arap_flow_tpu.ops import energy as JE
from arap_flow_tpu.ops import solver as JS
from arap_flow_tpu.parallel import make_mesh as jax_mesh
from arap_flow_tpu.parallel import solve_batch_sharded as jax_sharded
from arap_flow_tpu_torch.ops import energy as TE
from arap_flow_tpu_torch.ops import solver as TS
from arap_flow_tpu_torch.parallel import (make_mesh, shard_batch,
                                          solve_batch_sharded)
from arap_flow_tpu_torch.parallel.mesh import batch_slices
from arap_flow_tpu_torch.pipeline import batch as TB

torch.set_num_threads(1)

CPU = torch.device("cpu")
FLOW_TOL = 0.05


def _mask_cons(H, W, seed):
    """tests/test_parallel.py's problem."""
    rng = np.random.default_rng(seed)
    arap_mask = np.full((H, W), 255, np.uint8)
    arap_mask[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 0
    ys, xs = np.mgrid[H // 4 + 1 : 3 * H // 4 - 1 : 4,
                      W // 4 + 1 : 3 * W // 4 - 1 : 4]
    cons = np.stack([xs.ravel(), ys.ravel(),
                     xs.ravel() + rng.integers(-2, 3, xs.size),
                     ys.ravel() + rng.integers(-2, 3, xs.size)],
                    axis=1).astype(np.int32)
    return arap_mask, add_border_pins(cons, W, H)


def _batches(H, W, seeds, dtype=np.float32):
    """The same problems as a JAX batch and a port batch."""
    mcs = [_mask_cons(H, W, s) for s in seeds]
    jb = jax.tree.map(lambda *ls: jnp.stack(ls),
                      *[JE.build_operands(*mc) for mc in mcs])
    tp = [TE.build_operands(*mc, device=CPU, dtype=dtype) for mc in mcs]
    tb = TE.ArapOperands(**{f: torch.stack([getattr(o, f) for o in tp])
                            for f in vars(tp[0])})
    return mcs, jb, tb


def test_make_mesh_shapes_and_errors(monkeypatch):
    mesh = make_mesh(devices=[CPU] * 8, data=2, space=4)
    assert mesh.shape == {"data": 2, "space": 4} and mesh.first == CPU
    assert make_mesh(devices=["cpu"] * 8, n_devices=4).shape == {
        "data": 4, "space": 1}
    with pytest.raises(ValueError, match="mesh 3x2"):
        make_mesh(devices=[CPU] * 8, data=3, space=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    # tensor_split's sizes, empty slices left out
    assert batch_slices(5, 2) == [slice(0, 3), slice(3, 5)]
    assert batch_slices(2, 4) == [slice(0, 1), slice(1, 2)]
    parts = shard_batch(TE.CompactOperands.stack(
        [TE.build_compact(*_mask_cons(16, 16, s)) for s in range(3)]),
        make_mesh(devices=[CPU] * 2))
    assert [p.mask_u8.shape[0] for p in parts] == [2, 1]
    assert all(isinstance(p.wf2, torch.Tensor) for p in parts)


def test_data_sharded_matches_batch_and_jax():
    """24×32, 2×2×40, 8 problems over 8 mesh entries."""
    _, jb, tb = _batches(24, 32, range(8))
    sched = dict(num_anneal=2, gn_iters=2, pcg_iters=40.0)
    _, jflows = jax_sharded(jb, JS.SolverConfig(**sched),
                            jax_mesh(data=8, space=1))
    mesh = make_mesh(devices=[CPU] * 8)
    xs, flows = solve_batch_sharded(tb, TS.SolverConfig(**sched), mesh)
    x1, f1 = TS.solve_batch(tb, TS.SolverConfig(**sched))
    torch.testing.assert_close(xs, x1, rtol=0, atol=1e-5)
    torch.testing.assert_close(flows, f1, rtol=0, atol=1e-5)
    d = np.abs(flows.numpy() - np.asarray(jflows))
    assert d.max() < FLOW_TOL and np.median(d) < 0.005
    # an uneven split (5 problems over 2 entries: 3 + 2) gathers in order
    part = TE.ArapOperands(**{f: v[:5] for f, v in vars(tb).items()})
    x5, _ = solve_batch_sharded(part, TS.SolverConfig(**sched),
                                make_mesh(devices=[CPU] * 2))
    torch.testing.assert_close(x5, x1[:5], rtol=0, atol=1e-5)


def test_data_sharded_honours_dynamic_floats():
    """The schedule's floats reach each slice: 2 PCG iterations against 40
    give another answer (JAX's test_sharded_schedule_sweep_no_recompile,
    whose executable cache has no counterpart here)."""
    _, _, tb = _batches(24, 32, range(4))
    mesh = make_mesh(devices=[CPU] * 4)
    xa, _ = solve_batch_sharded(
        tb, TS.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=2.0), mesh)
    xb, _ = solve_batch_sharded(
        tb, TS.SolverConfig(num_anneal=2, gn_iters=2, pcg_iters=40.0), mesh)
    assert (xa - xb).abs().max() > 1e-3


def _frame(H, W, seed, box, disp):
    rng = np.random.default_rng(seed)
    mask = np.full((H, W), 255, np.uint8)
    y0, y1, x0, x1 = box
    mask[y0:y1, x0:x1] = 0
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[y0 + 2 : y1 - 1 : 4, x0 + 2 : x1 - 1 : 4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + disp[1],
                     ys.ravel() + disp[0]], 1).astype(np.int32)
    return rgb, mask, cons


def test_batch_runner_on_a_mesh_matches_unsharded():
    """Three tasks of one bucket make one remainder chunk, split 2 + 1 over
    a two-entry mesh; a full-frame fallback rides along."""
    sched = TS.SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=40,
                            pcg_iters=40.0)
    buckets = ((32, 48), (48, 48))
    frames = [_frame(56, 72, 40 + k, (10 + k, 30 + k, 12, 42), (1, 2 - k))
              for k in range(3)]
    big = _frame(56, 72, 50, (2, 54, 2, 70), (1, 1))
    mesh = make_mesh(devices=[CPU] * 2)
    assert TB.max_chunk_for((32, 48), mesh.shape["data"]) == 2 * TB.MAX_CHUNK
    tasks = [TB.make_task(k, 0, rgb, mask, cons, TE.ArapWeights(),
                          buckets=buckets)
             for k, (rgb, mask, cons) in enumerate(frames)]
    assert len({(t.bucket, t.canvas, t.transposed) for t in tasks}) == 1
    outs = []
    for m in (None, mesh):
        runner = TB.BatchRunner(sched, device=CPU, mesh=m)
        for t in tasks:
            runner.add(t)
        runner.add_fallback(3, 0, *big)
        outs.append(runner.finish())
    ref, got = outs
    assert sorted(got) == sorted(ref) == [(k, 0) for k in range(4)]
    for key in ref:
        assert np.abs(got[key].flow - ref[key].flow).max() < 1e-5
        assert (got[key].warped_mask == ref[key].warped_mask).all()
        assert (ref[key].warped_mask > 0).sum() > 100
