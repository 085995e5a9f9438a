"""The port's golden gate (arap_flow_tpu_torch/tools/golden_cat512.py) on a
fixture tree the port writes itself, on the CPU.

The tree has the cat512 layout (ARAP/deformation: input RGB, mask,
constraints, warped mask and RGB; ARAP/warping: the .flo) at 48×64, its
outputs from the port's ``ArapDeformer`` at the dryrun's 2×2×40 schedule.
The tool at that schedule reproduces them: PASS (exit 0), in a process
where importing PIL, jax or arap_flow_tpu fails. A .flo moved by 0.5 px
gives FAIL (exit 1), and a directory without the fixtures exit 2 with a
message.
"""

import os
import os.path as osp
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io import flo
from arap_flow_tpu_torch.io.constraints import write_constraint_file
from arap_flow_tpu_torch.io.image import save_image
from arap_flow_tpu_torch.models.arap import ArapDeformer
from arap_flow_tpu_torch.ops.solver import SolverConfig
from arap_flow_tpu_torch.tools import golden_cat512 as G

torch.set_num_threads(2)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCHEDULE = ["--num_anneal", "2", "--gn_iters", "2", "--pcg_iters", "40"]


def _write_fixtures(root: str) -> None:
    """A textured ellipse pulled right and down by its constraints; the
    outputs are the port's own solve at the 2×2×40 schedule."""
    H, W = 48, 64
    yy, xx = np.mgrid[0:H, 0:W]
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    inside = ((yy - 22) / 13.0) ** 2 + ((xx - 28) / 18.0) ** 2 < 1
    mask = np.where(inside, 0, 255).astype(np.uint8)
    cons = np.array([[20, 16, 23, 18], [34, 26, 37, 28], [24, 28, 27, 30],
                     [30, 14, 33, 16]], np.int32)
    cfg = SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=40,
                       pcg_iters=40.0)
    res = ArapDeformer(cfg, device="cpu").deform(rgb, mask, cons)
    paths = G.fixture_paths(root)
    for p in paths.values():
        os.makedirs(osp.dirname(p), exist_ok=True)
    save_image(paths["rgb"], rgb)
    save_image(paths["mask"], mask)
    write_constraint_file(paths["constraints"], cons)
    save_image(paths["warped_mask"], res.warped_mask)
    save_image(paths["warped_rgb"], res.warped_rgb)
    flo.flow_write(paths["flow"], res.flow)
    assert (res.warped_mask > 0).mean() > 0.2  # the object is drawn


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    _write_fixtures(root)
    return root


def test_golden_tool_passes_without_pil_and_jax(fixtures):
    code = textwrap.dedent(f"""
        import sys
        for name in ("PIL", "jax", "arap_flow_tpu"):
            sys.modules[name] = None  # any import of them raises
        import torch
        torch.set_num_threads(2)
        from arap_flow_tpu_torch.tools import golden_cat512
        rc = golden_cat512.main(["--reference", {fixtures!r}, "--device",
                                 "cpu", *{SCHEDULE!r}])
        loaded = [m for m, v in sys.modules.items() if v is not None and
                  m.split(".")[0] in ("PIL", "jax", "arap_flow_tpu")]
        print("LOADED", loaded)
        sys.exit(rc)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = proc.stdout
    assert "LOADED []" in out
    assert "EPE vs golden .flo: mean 0.0000px" in out, out
    assert "warped mask agreement: 1.00000" in out
    assert "warped RGB within ±2 on covered: 1.00000" in out
    assert out.splitlines()[-2] == "PASS"


def test_golden_tool_fails_on_a_moved_flow(fixtures, tmp_path, capsys):
    root = str(tmp_path / "moved")
    shutil.copytree(fixtures, root)
    p = G.fixture_paths(root)["flow"]
    u, v = flo.flow_read(p)
    flo.flow_write(p, np.dstack([u + 0.5, v]))
    assert G.main(["--reference", root, "--device", "cpu", *SCHEDULE]) == 1
    out = capsys.readouterr().out
    assert "EPE vs golden .flo: mean 0.5000px" in out
    assert out.splitlines()[-1] == "FAIL"


def test_golden_tool_needs_the_fixtures(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("ARAP_REFERENCE", raising=False)
    assert G.main(["--reference", str(tmp_path), "--device", "cpu"]) == 2
    assert "fixtures missing" in capsys.readouterr().err
    assert G.main(["--device", "cpu"]) == 2
    assert "--reference" in capsys.readouterr().err
