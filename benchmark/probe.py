"""Readings for the limits of ``correct``, and the control.

    python3 benchmark/probe.py --workload CELL --seeds 11 12 13 \\
        [--control] [--out FILE]

For each seed, in one process: the cell's inputs from the seed, one job as
the window runs it, and the numbers ``harness.run_cell`` compares; with
``--control``, beside them the numbers of the control, the plain
reference computed in bfloat16 (the precision below the configuration's
float32) in the program's place. One JSON line a seed, on standard output
and appended to FILE. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os.path as osp
import shutil
import sys
import tempfile
import time

import numpy as np

if __package__ in (None, ""):
    sys.path[0] = osp.dirname(osp.dirname(osp.abspath(__file__)))

from benchmark import harness  # noqa: E402
from benchmark.entries import common  # noqa: E402


def readings(cell_name: str, seeds, control: bool, device: str = "cuda",
             cfg_override=None, wl_override=None):
    """Yield one dict a seed: seed, the program's numbers, the control's
    (or None), pairs written of attempted, and seconds."""
    import torch

    _, cell, cfg, wl = harness.load_cell(cell_name)
    cfg = {**cfg, **(cfg_override or {})}
    wl = {**wl, **(wl_override or {})}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    entry = importlib.import_module(f"benchmark.entries.{cell['config']}")
    for seed in seeds:
        work = tempfile.mkdtemp(prefix="probe-")
        try:
            t0 = time.time()
            state = entry.prepare(cfg, wl, seed, work, dev)
            t1 = time.time()
            job = entry.run_job(state, "0")
            t2 = time.time()
            sample = common.draw_sample(np.random.default_rng([seed, 2]),
                                        entry.n_items(state),
                                        int(wl["sample_pairs"]))
            nums, ctrl = entry.check(state, [job], [sample], dev,
                                     torch.bfloat16 if control else None)
            t3 = time.time()
        finally:
            shutil.rmtree(work, ignore_errors=True)
        yield {"cell": cell_name, "seed": seed, "program": nums,
               "control": ctrl, "written": job.written,
               "attempted": job.attempted,
               "seconds": {"inputs": t1 - t0, "job": t2 - t1,
                           "check": t3 - t2}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    harness.cache_env()
    for r in readings(a.workload, a.seeds, a.control):
        line = json.dumps(r)
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
