"""The control on the card, at each cell's own size: the plain reference
computed in bfloat16 in the program's place must fail one of the cell's
limits, and the program on the same seed must meet them all. Needs an
NVIDIA GPU (the `cuda` marker); on the card:

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import pytest

from benchmark import harness, probe

CELLS = ("davis480.seq24", "sintel1024.passes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.cache_env()
    limits = harness.load_cell(cell)[2]["limits"]
    (r,) = probe.readings(cell, [20251017], control=True)
    assert all(r["program"][k] <= v for k, v in limits.items()), r
    assert any(r["control"][k] > v for k, v in limits.items()), r
