"""Batch ARAP deformation over explicit path lists (pipeline/run_arap.py of the
JAX package): one process feeding the batched solver.

    # list file of 6-tuples: RGB Mask Cstr Flow wRGB wMask
    python -m arap_flow_tpu_torch run_arap --list jobs.txt [--chunk 20]

    # or build the list from a Sintel-style tree
    python -m arap_flow_tpu_torch run_arap --input ROOT --passes clean final

A call is one job of ``profiling.TIMER``'s spans: stages "run_arap scan"
(the list) and, per chunk, "run_arap prep", "run_arap solve" and "run_arap
write" (``deform_tool._deform_chunk``); with ``ARAP_TRACE=<dir>`` the
call's spans are written there as one Chrome trace.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from ..utils import profiling
from ..utils.config import cli_device
from .deform_tool import FramePaths, deform_frames, make_framework_config
from .deform_tool import parse_list_file


def build_sintel_list(root: str, passes: list[str]) -> list[FramePaths]:
    """Sintel-style tree: ROOT/{pass}/SEQ/frame_XXXX.png + ROOT/masks/... ->
    jobs with outputs under ROOT/flow_arap/{pass}."""
    frames = []
    for pas in passes:
        pdir = osp.join(root, pas)
        if not osp.isdir(pdir):
            continue
        for seq in sorted(os.listdir(pdir)):
            sdir = osp.join(pdir, seq)
            if not osp.isdir(sdir):
                continue
            for f in sorted(os.listdir(sdir)):
                if not f.endswith(".png"):
                    continue
                name = osp.splitext(f)[0]
                mask = osp.join(root, "masks", pas, seq, f)
                cstr = osp.join(root, "cnstr", pas, seq, name + ".txt")
                if not (osp.exists(mask) and osp.exists(cstr)):
                    continue
                out = osp.join(root, "flow_arap", pas, seq)
                os.makedirs(out, exist_ok=True)
                frames.append(
                    FramePaths(
                        rgb=osp.join(sdir, f),
                        mask=mask,
                        cstr=cstr,
                        out_flo=osp.join(out, name + ".flo"),
                        out_rgb=osp.join(out, name + "_wRGB.png"),
                        out_mask=osp.join(out, name + "_wMask.png"),
                    )
                )
    return frames


def main(argv=None):
    with profiling.entry_call():
        return _run(argv)


def _run(argv):
    p = argparse.ArgumentParser(description="Batch ARAP deformation over path lists")
    p.add_argument("--list", default=None, help="file of 6-tuple lines")
    p.add_argument("--input", default=None, help="Sintel-style root")
    p.add_argument("--passes", nargs="*", default=["clean", "final"])
    p.add_argument("--chunk", type=int, default=0,
                   help="process in chunks of N frames (0 = all at once)")
    p.add_argument("--schedule", choices=["parity", "fast"], default="parity")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    a = p.parse_args(argv)

    if not (a.list or a.input):
        p.error("need --list or --input")
    with profiling.TIMER.stage("run_arap scan"):
        frames = (parse_list_file(a.list) if a.list
                  else build_sintel_list(a.input, a.passes))
    if not frames:
        print("No file to be processed")
        return 1
    device = cli_device(a.device)
    fw = make_framework_config(a.schedule)
    chunk = a.chunk or len(frames)
    failed = 0
    for i in range(0, len(frames), chunk):
        failed += len(deform_frames(frames[i : i + chunk], fw.solver,
                                    device=device, fw=fw))
    if failed:
        print(f"{failed} of {len(frames)} frames failed")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
