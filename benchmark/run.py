"""Runs one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

See ``benchmark/harness.py``."""

import os.path as osp
import sys
import time

T0 = time.time()  # set-up starts here
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path[0] = ROOT  # the checkout, not this directory

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T0))
