"""Time the PCG kernel's plans for the large single problems on an NVIDIA GPU.

    python3 arap_flow_tpu_torch/tools/pcg_times.py [--iters N] [--reps N]
        [--shapes B,H,W ...]

For each shape (default: B = 24 and 1 at MPI-Sintel's 436×1024 frame, B = 1
at 480×854 and 512×896), the plan ``card_plan`` takes and, where that is
the spread plan, the streamed plan it replaced (``pcg_plan``'s), each
checked against the plain version at one iteration (rtol/atol 1e-4), then
timed in turns (streamed, card, card, streamed): the median ms of one
`--iters`-iteration call by CUDA events, and the µs a problem and
iteration. Prints one JSON line with the card's name and power limit, each
plan and its times, and the spread kernels' registers and spills from the
build's compiler report. The operands are ``chip_smoke.py``'s
``pcg_problem``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shapes", nargs="*", default=[
        "24,436,1024", "1,436,1024", "1,480,854", "1,512,896"])
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("pcg_times: CUDA is not available", flush=True)
        return 1
    import chip_smoke as C
    from arap_flow_tpu_torch import _build
    from arap_flow_tpu_torch.ops import pcg as P

    smi = C.phase_env()
    _, build_s = _build.build()
    dev = torch.device("cuda", 0)
    rows = []
    for spec in args.shapes:
        B, H, W = (int(v) for v in spec.split(","))
        plan = P.card_plan(B, H, W, False, dev)
        plans = {"card": plan}
        if plan.kind == "spread":
            plans["streamed"] = P.pcg_plan(
                B, H, W, lambda p: P.active_clusters(p, B, W, False, dev))
        _, a = C.pcg_problem(B, H, W, seed=7, device=dev)
        plain = P.pcg_fixed_plain(*a, 1)
        row = {"shape": [B, H, W]}
        for name, p in plans.items():
            err = float((P._launch(p, *a, 1, False) - plain).abs().max())
            torch.cuda.synchronize()
            if not err <= 1e-4 * (1.0 + float(plain.abs().max())):
                raise AssertionError(f"{name} plan {p} at {spec}: 1-iteration"
                                     f" max |d| {err}")
            row[name] = {"plan": p._asdict(), "kind": p.kind,
                         "max_abs_d_1iter": err, "ms": []}
        order = ["streamed", "card", "card", "streamed"]
        for name in [n for n in order if n in plans]:
            p = plans[name]
            row[name]["ms"].append(C.cuda_ms(
                lambda: P._launch(p, *a, args.iters, False), reps=args.reps))
        for name in plans:
            ms = float(np.median(row[name]["ms"]))
            row[name]["median_ms"] = ms
            row[name]["us_per_problem_iter"] = 1e3 * ms / (B * args.iters)
        rows.append(row)
        print(json.dumps(row), flush=True)
    log = _build.lib_path("pcg.cu")[: -len(".so")] + ".log"
    ptxas = []
    if os.path.exists(log):
        text = open(log).read()
        for m in re.finditer(r"Compiling entry function '(\w*spread\w*)'.*?"
                             r"Used (\d+) registers.*?(?=Compiling|\Z)",
                             text, re.S):
            spill = re.search(r"(\d+) bytes spill stores", m.group(0))
            ptxas.append({"kernel": m.group(1),
                          "registers": int(m.group(2)),
                          "spill_stores": int(spill.group(1)) if spill else 0})
    print(json.dumps({"card": smi, "build_s": build_s, "iters": args.iters,
                      "rows": rows, "ptxas": ptxas}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
