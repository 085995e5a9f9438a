"""Warp-only batch tool (pipeline/run_warp.py of the JAX package).

Re-applies existing .flo fields to input images and masks for a set of
frame distances: ``{root}/fd{N}/Flow/**.flo`` with the matching inpRGB /
inpMasks files -> wRGB / wMasks.

    python -m arap_flow_tpu_torch run_warp --root ROOT --fd 1 2 3 4 5 9 13
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from ..utils.config import cli_device
from .warp_tool import warp_image

FD_DEFAULT = [1, 2, 3, 4, 5, 9, 13]  # the reference's run_warp.py:32


def scan_jobs(root: str, fds: list[int]):
    """For each fd: {root}/fd{N}/Flow/**.flo + the shared inpRGB/inpMasks ->
    wRGB/wMasks outputs, as (rgb, mask, flo, wrgb, wmask) tuples."""
    jobs = []
    for fd in fds:
        froot = osp.join(root, f"fd{fd}", "Flow")
        rgb_root = osp.join(root, f"fd{fd}", "inpRGB")
        msk_root = osp.join(root, f"fd{fd}", "inpMasks")
        if not osp.isdir(froot):
            continue
        for dirpath, _, files in os.walk(froot):
            rel = osp.relpath(dirpath, froot)
            for f in files:
                if not f.endswith(".flo"):
                    continue
                name = osp.splitext(f)[0]
                rgb = osp.join(rgb_root, rel, name + ".png")
                msk = osp.join(msk_root, rel, name + ".png")
                if not (osp.exists(rgb) and osp.exists(msk)):
                    continue
                wrgb = osp.join(root, f"fd{fd}", "wRGB", rel, name + ".png")
                wmsk = osp.join(root, f"fd{fd}", "wMasks", rel, name + ".png")
                jobs.append((rgb, msk, osp.join(dirpath, f), wrgb, wmsk))
    return jobs


def main(argv=None):
    p = argparse.ArgumentParser(description="Warp-only batch tool")
    p.add_argument("--root", required=True)
    p.add_argument("--fd", nargs="*", type=int, default=FD_DEFAULT)
    p.add_argument("--backend", choices=["device", "host"], default="device",
                   help="device = seed-and-gather rasterizer on --device; "
                        "host = reference-exact splat (C++, on the host)")
    p.add_argument("--device", default="cuda",
                   help="torch device of --backend device (default cuda)")
    a = p.parse_args(argv)
    device = cli_device(a.device) if a.backend == "device" else None
    jobs = scan_jobs(a.root, a.fd)
    print(f"{len(jobs)} warp jobs")
    for rgb, msk, flo_path, wrgb, wmsk in jobs:
        os.makedirs(osp.dirname(wrgb), exist_ok=True)
        os.makedirs(osp.dirname(wmsk), exist_ok=True)
        warp_image(rgb, msk, flo_path, wrgb, wmsk, device=device,
                   backend=a.backend)
    print("Done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
