"""Time para_gen on chip_smoke.py phase 5's tree, for one checkout, on an
NVIDIA GPU.

    python3 arap_flow_tpu_torch/tools/pipeline_times.py [--root DIR] \\
        [--narap N] [--runs N] [--warmup none|libs|full]

Imports ``chip_smoke`` and ``arap_flow_tpu_torch`` from DIR (default: the
current directory), builds that checkout's kernels, writes phase 5's tree
(5 frames at 854x480, two textured ellipses translating, 4 pairs) and runs
``para_gen --mode batched --multseg`` at 19x8x400 on it once cold and
``--runs`` times warm. Prints one JSON line: the card's name and power
limit, the root, ``--narap`` (2: one chunk of 4 pairs, phase 5's run; 1:
two chunks of 2, which the depth-2 loop overlaps), the seconds per pair of the cold run and of each warm run, and the
last warm run's stages (``para_gen.TIMER`` totals, seconds). To compare two
commits on one card, unpack the other into a git-ignored directory and run
both in one call, in turns:

    for r in _archive/parent . . _archive/parent; do
        python3 arap_flow_tpu_torch/tools/pipeline_times.py --root $r; done

``--warmup`` sets what runs between the build and the cold run, which is
what a fresh process's first pairs gain from it: ``none``; ``libs``, the
kernel and host libraries loaded; ``full``, ``para_gen --warmup``'s
``prewarm`` (timed on its own, as ``prewarm_s``). Each run is one fresh
process, so compare the three in turns in one call:

    for w in none libs full full libs none; do
        python3 arap_flow_tpu_torch/tools/pipeline_times.py --runs 1 \\
            --warmup $w; done

The script reads nothing else of the checkout than those two modules, so it
times a parent commit whose own tree does not have it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.getcwd(),
                    help="the checkout whose pipeline is timed")
    ap.add_argument("--narap", type=int, default=2,
                    help="para_gen --narap: chunks of 2 x this many pairs")
    ap.add_argument("--runs", type=int, default=2, help="warm runs")
    ap.add_argument("--warmup", choices=("none", "libs", "full"),
                    default="none",
                    help="before the cold run: nothing, the libraries "
                    "loaded, or para_gen's prewarm")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("pipeline_times: CUDA is not available", flush=True)
        return 1
    import chip_smoke as C
    from arap_flow_tpu_torch import _build
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen

    smi = C.phase_env()
    _, build_s = _build.build()
    t0 = time.perf_counter()
    if args.warmup == "libs":
        for stem in ("pcg", "zncc", "fused_solver"):
            _build.load(stem)
        _build.load_native()
    elif args.warmup == "full":
        from arap_flow_tpu_torch.ops.energy import ArapWeights

        para_gen.prewarm(SolverConfig(), ArapWeights(), batched=True,
                         device="cuda")
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    n_pairs = C.PIPE_FRAMES - 1
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        C.make_pipeline_tree(inp)

        def run(tag: str) -> float:
            flags = para_gen.PipelineFlags(
                input=inp, output=os.path.join(tmp, tag), multseg=True,
                seed=0, mode="batched", narap=args.narap, device="cuda")
            t0 = time.perf_counter()
            lines = para_gen.main_pipeline(flags, solver_cfg=SolverConfig())
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if len(lines) != n_pairs:
                raise AssertionError(f"{tag}: {len(lines)} pairs listed")
            return secs / n_pairs

        cold = run("cold")
        warm = []
        for i in range(args.runs):
            para_gen.TIMER.reset()
            warm.append(run(f"warm{i}"))
        stages = {k: round(v, 4) for k, v in para_gen.TIMER.totals.items()}
    print(json.dumps({"root": root, "card": smi, "build_s": build_s,
                      "narap": args.narap, "warmup": args.warmup,
                      "warmup_s": warmup_s,
                      "cold_s_per_pair": cold, "warm_s_per_pair": warm,
                      "warm_stages_s": stages}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
