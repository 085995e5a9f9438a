"""Time the fused whole-schedule kernel of one checkout on an NVIDIA GPU.

    python3 arap_flow_tpu_torch/tools/fused_times.py [--root DIR]

Imports ``chip_smoke`` and ``arap_flow_tpu_torch`` from DIR (default: the
current directory), builds that checkout's kernels, and prints one JSON
line with the card's name and power limit and the median ms of
``anneal_solve_fused`` (CUDA events) at the rows that ``PERF.md`` compares
across commits: a 1×1×400 call and a 19×8×400 solve at B=4 192×256, a
19×8×400 solve at B=1 192×384 and at B=24 64×128 (the operands of
``chip_smoke.py`` phase 6), and the seconds of a warm fused deform pair
(phase 6b's pair with ``SolverConfig(backend="fused")``, the median of two
warm runs after a cold one). To compare two commits on one card, unpack the
other into a git-ignored directory and run both in one call, in turns:

    for r in _archive/parent . . _archive/parent; do
        python3 arap_flow_tpu_torch/tools/fused_times.py --root $r; done

The script reads nothing else of the checkout than those two modules, so it
times a parent commit whose own tree does not have it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.getcwd(),
                    help="the checkout whose kernel is timed")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fused_times: CUDA is not available", flush=True)
        return 1
    import chip_smoke as C
    from arap_flow_tpu_torch import _build
    from arap_flow_tpu_torch.ops.fused_solver import anneal_solve_fused
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    smi = C.phase_env()
    _, build_s = _build.build()
    dev = torch.device("cuda", 0)

    def sched(na, gn, it):
        return SolverConfig(num_anneal=na, gn_iters=gn, max_pcg_iters=it,
                            pcg_iters=float(it))

    rows = {}
    for (B, H, W), s, reps in (((4, 192, 256), (1, 1, 400), 5),
                               ((4, 192, 256), (19, 8, 400), 3),
                               ((1, 192, 384), (19, 8, 400), 3),
                               ((24, 64, 128), (19, 8, 400), 3)):
        _, batch = C.segment_operands(B, H, W, 400 + H, dev)
        cfg = sched(*s)
        ms = C.cuda_ms(lambda: anneal_solve_fused(batch, cfg), reps=reps)
        rows[f"B={B} {H}x{W} {'x'.join(map(str, s))} ms"] = ms

    probs, tasks = C.make_tasks()
    cfg = SolverConfig(backend="fused")
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        C.run_pair(probs, tasks, cfg, dev)
        secs.append(time.perf_counter() - t0)
    rows["fused deform pair warm s"] = float(np.median(secs[1:]))
    rows["fused deform pair cold s"] = secs[0]
    print(json.dumps({"root": root, "card": smi, "build_s": build_s,
                      **rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
