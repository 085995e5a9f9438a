"""Check and time the mesh paths across every card of one host.

    python3 arap_flow_tpu_torch/tools/mesh_check.py

From the root of a checkout, on a machine with two or more NVIDIA GPUs
(the figures in PERF.md are from four H100s of one host). It builds the
kernels (``chip_smoke.phase_build``) and, with every visible card on a
mesh:

1. ``BatchRunner`` on the mesh against the unsharded runner on the first
   card, on ``chip_smoke``'s deform pair's two tasks repeated once a card
   (a chunk of one task a card a bucket), at 19x8x400, cold and warm:
   max |dflow| < 1e-4 px (the flows are i16, so bitwise), and whether the
   raster products are bitwise too;
2. ``solve_spatial`` of two copies of the pair's segment 0 on the whole
   480x854 frame, at data = 1 (the rows over every card) and at data = 2
   (two row groups), against ``solver.solve`` on the plain backend on the
   first card, at chip_smoke's cut schedule (plain torch): max |dx| <
   5e-4;
3. ``para_gen --mode sharded`` against ``--mode batched`` on chip_smoke's
   phase 5 tree at 19x8x400, in turns (batched, sharded, batched,
   sharded): the products byte-identical, and each run's seconds.

Each line names the card and its power limit; the script exits 1 when a
gate fails or fewer than two cards are visible.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from arap_flow_tpu_torch.io.constraints import add_border_pins
    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops import solver as S
    from arap_flow_tpu_torch.parallel import make_mesh, solve_spatial
    from arap_flow_tpu_torch.pipeline import para_gen
    from arap_flow_tpu_torch.pipeline.batch import BatchRunner

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"mesh_check: {n} CUDA device(s); this check needs two or more")
        return 1
    smi = c.phase_env()
    c.phase_build()
    devs = [torch.device("cuda", i) for i in range(n)]
    dev0 = devs[0]

    def sync():
        for d in devs:
            torch.cuda.synchronize(d)

    full = S.SolverConfig()
    probs, tasks = c.make_tasks()
    mesh = make_mesh()
    many = [t.__class__(**{**vars(t), "pair_idx": k}) for k in range(n)
            for t in tasks if t is not None]
    runs = {}
    for m in (None, mesh):
        for rep in ("cold", "warm"):
            runner = BatchRunner(full, device=dev0, mesh=m)
            c.zero_counts()
            t0 = time.perf_counter()
            for t in many:
                runner.add(t)
            out = runner.finish()
            sync()
            runs[(m is not None, rep)] = (out, time.perf_counter() - t0,
                                          c.read_counts()["pcg_fixed"])
    ref, got = runs[(False, "warm")][0], runs[(True, "warm")][0]
    d = max(float(np.abs(got[k].flow - ref[k].flow).max()) for k in ref)
    bitwise = all(np.array_equal(got[k].warped_rgb, ref[k].warped_rgb)
                  and np.array_equal(got[k].warped_mask, ref[k].warped_mask)
                  for k in ref)
    ok = d < 1e-4
    print(f"mesh_check BatchRunner over {n} cards, {len(many)} tasks at "
          f"19x8x400: max |dflow| against the unsharded runner {d:.3g} px "
          f"(gate < 1e-4), raster products bitwise {bitwise}; seconds cold / "
          f"warm: mesh {runs[(True, 'cold')][1]:.3f} / "
          f"{runs[(True, 'warm')][1]:.3f}, unsharded "
          f"{runs[(False, 'cold')][1]:.3f} / {runs[(False, 'warm')][1]:.3f}; "
          f"pcg_fixed launches {runs[(True, 'warm')][2]} against "
          f"{runs[(False, 'warm')][2]} ({smi})", flush=True)

    _, mask, cons, _ = probs[0]
    ops = E.build_operands(mask, add_border_pins(cons, c.FRAME_W, c.FRAME_H),
                           device=dev0)
    batch = E.ArapOperands(**{f: torch.stack([v, v])
                              for f, v in vars(ops).items()})
    plain = c.cut_config(backend="plain")
    x_p, _ = S.solve(batch, plain)
    for data in (1, 2):
        m = make_mesh(data=data, space=n // data, devices=devs[: n // data
                                                               * data])
        t0 = time.perf_counter()
        x, _ = solve_spatial(batch, plain, m)
        sync()
        secs = time.perf_counter() - t0
        dx = float((x.to(dev0) - x_p).abs().max())
        ok &= dx < 5e-4
        print(f"mesh_check solve_spatial {c.FRAME_H}x{c.FRAME_W} B=2 "
              f"{m.shape} at {'x'.join(map(str, c.CUT))}: {secs:.3f} s, "
              f"max |dx| against the plain solve {dx:.3g} (gate < 5e-4) "
              f"({smi})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        c.make_pipeline_tree(inp)
        digests, secs = {}, {"batched": [], "sharded": []}
        for k, mode in enumerate(("batched", "sharded", "batched",
                                  "sharded")):
            out = os.path.join(tmp, f"{mode}{k}")
            flags = para_gen.PipelineFlags(input=inp, output=out,
                                           multseg=True, seed=0, mode=mode,
                                           device=str(dev0))
            t0 = time.perf_counter()
            lines = para_gen.main_pipeline(flags, solver_cfg=full)
            sync()
            secs[mode].append(round(time.perf_counter() - t0, 3))
            digests.setdefault(mode, []).append(c.tree_digest(out, lines))
        same = all(dg == digests["batched"][0]
                   for dgs in digests.values() for dg in dgs)
        ok &= same
        print(f"mesh_check para_gen --mode sharded over {n} cards against "
              f"--mode batched on one, 4 pairs at 19x8x400: products "
              f"byte-identical {same}; seconds in turns: batched "
              f"{secs['batched']}, sharded {secs['sharded']} ({smi})",
              flush=True)
    print("mesh_check ok" if ok else "mesh_check FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
