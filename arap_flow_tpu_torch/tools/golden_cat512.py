"""The golden end-to-end gate on the port: the reference schedule on the
cat512 deformation fixture, against the reference solver's shipped outputs
(scripts/golden_cat512.py of the JAX package, on ``ArapDeformer`` of the
port).

    python3 arap_flow_tpu_torch/tools/golden_cat512.py --reference DIR \\
        [--device cuda] [--num_anneal 19 --gn_iters 8 --pcg_iters 400] \\
        [--q_tolerance 0]

DIR is a checkout of the reference repository (default: the environment
variable ARAP_REFERENCE). It reads DIR/ARAP/deformation/cat512_iRGB.png,
cat512_iMsk.png, cat512_iCstr.txt, cat512_wMsk.png and cat512_wRGB.png and
DIR/ARAP/warping/cat512_iFlo.flo with the port's own ``io`` (no PIL, no
JAX), solves twice (the first call builds what it needs, the second is
timed) and prints:

- the mean, p99 and max end-point error of the flow against
  cat512_iFlo.flo;
- the warped mask's agreement with cat512_wMsk.png (covered or not, the
  mask read as PIL's ``convert("L")`` gives it);
- the share of covered pixels whose warped RGB is within ±2 of
  cat512_wRGB.png on every channel;
- PASS when the mean EPE is below 0.1 px and the mask agreement above
  0.99, else FAIL.

Exit code 0 on PASS, 1 on FAIL, 2 when the fixtures are missing. On a
CUDA device the card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import subprocess
import sys
import time

import numpy as np

FIXTURES = {
    "rgb": ("deformation", "cat512_iRGB.png"),
    "mask": ("deformation", "cat512_iMsk.png"),
    "constraints": ("deformation", "cat512_iCstr.txt"),
    "warped_mask": ("deformation", "cat512_wMsk.png"),
    "warped_rgb": ("deformation", "cat512_wRGB.png"),
    "flow": ("warping", "cat512_iFlo.flo"),
}
EPE_LIMIT = 0.1
MASK_LIMIT = 0.99


def fixture_paths(reference: str) -> dict:
    return {k: osp.join(reference, "ARAP", d, f) for k, (d, f) in
            FIXTURES.items()}


def luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L conversion (ITU-R 601-2 luma, Convert.c's L24): gray
    images come back unchanged."""
    c = rgb.astype(np.int64)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def card_line(device) -> str | None:
    """nvidia-smi's name and power limit of the card, on a CUDA device."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", default=os.environ.get("ARAP_REFERENCE"),
                    help="the reference repository's checkout (holds ARAP/); "
                    "default: $ARAP_REFERENCE")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solve (default cuda)")
    ap.add_argument("--num_anneal", type=int, default=19)
    ap.add_argument("--gn_iters", type=int, default=8)
    ap.add_argument("--pcg_iters", type=int, default=400)
    ap.add_argument("--q_tolerance", type=float, default=0.0,
                    help="the PCG early exit (0: off, the parity schedule)")
    a = ap.parse_args(argv)

    if not a.reference:
        print("golden_cat512: no fixtures: pass --reference DIR (a checkout "
              "of the reference repository) or set ARAP_REFERENCE",
              file=sys.stderr)
        return 2
    paths = fixture_paths(a.reference)
    missing = [p for p in paths.values() if not osp.isfile(p)]
    if missing:
        print(f"golden_cat512: fixtures missing under {a.reference}: "
              + ", ".join(missing), file=sys.stderr)
        return 2

    from arap_flow_tpu_torch.io import flo
    from arap_flow_tpu_torch.io.constraints import read_constraint_file
    from arap_flow_tpu_torch.io.image import load_mask, load_rgb
    from arap_flow_tpu_torch.models.arap import ArapDeformer
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.utils.config import cli_device

    device = cli_device(a.device)
    card = card_line(device)
    if card:
        print(card)
    rgb = load_rgb(paths["rgb"])
    mask = load_mask(paths["mask"])
    cons = read_constraint_file(paths["constraints"])
    cfg = SolverConfig(num_anneal=a.num_anneal, gn_iters=a.gn_iters,
                       max_pcg_iters=a.pcg_iters,
                       pcg_iters=float(a.pcg_iters),
                       q_tolerance=a.q_tolerance)
    print(f"device: {device}; config: {cfg}")

    deformer = ArapDeformer(cfg, device=device)
    t0 = time.perf_counter()
    res = deformer.deform(rgb, mask, cons)
    print(f"first call (builds and runs): "
          f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    res = deformer.deform(rgb, mask, cons)
    print(f"second call (runs): {time.perf_counter() - t0:.3f} s")

    gu, gv = flo.flow_read(paths["flow"])
    epe = np.sqrt((res.flow[..., 0] - gu) ** 2 + (res.flow[..., 1] - gv) ** 2)
    print(f"EPE vs golden .flo: mean {epe.mean():.4f}px  p99 "
          f"{np.percentile(epe, 99):.4f}px  max {epe.max():.4f}px")
    gmask = luma(load_rgb(paths["warped_mask"]))
    magree = float(((res.warped_mask > 0) == (gmask > 0)).mean())
    grgb = load_rgb(paths["warped_rgb"])
    covered = gmask > 0
    rdiff = np.abs(res.warped_rgb.astype(int) - grgb.astype(int)).max(-1)
    print(f"warped mask agreement: {magree:.5f}")
    print(f"warped RGB within ±2 on covered: "
          f"{(rdiff[covered] <= 2).mean():.5f}")
    ok = epe.mean() < EPE_LIMIT and magree > MASK_LIMIT
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(
        osp.abspath(__file__)))))
    raise SystemExit(main())
