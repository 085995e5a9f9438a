"""arap_deform equivalent: ARAP-deform frames, emit flow + warped outputs
(pipeline/deform_tool.py of the JAX package).

    # single frame (6 paths)
    python -m arap_flow_tpu_torch deform RGB MASK CSTR FLOW WRGB WMASK
    # list file of 6-path lines
    python -m arap_flow_tpu_torch deform LISTFILE [--device cuda]

The schedule is the reference's 19 × 8 × 400 (``--schedule parity``);
``--schedule fast`` enables the PCG ζ early exit, which runs the plain
torch PCG (``SolverConfig`` backend "auto"). Frames of the same size solve
together as one batch, unless ARAP_RASTER=host asks for the exact host
splat, which runs frame by frame; a batch that fails is retried frame by
frame, and the frames that still fail are reported at the end.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch

from ..io import flo
from ..io.constraints import add_border_pins, read_constraint_file
from ..io.image import image_size, load_mask, load_rgb, save_image
from ..models.arap import ArapDeformer, DeformResult, solve_and_raster_batch
from ..ops import energy as E
from ..ops.solver import SolverConfig
from ..utils import profiling
from ..utils.config import FrameworkConfig, cli_device
from .batch import max_chunk_for


@dataclass
class FramePaths:
    rgb: str
    mask: str
    cstr: str
    out_flo: str
    out_rgb: str
    out_mask: str


def parse_list_file(path) -> list[FramePaths]:
    frames = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 6:
                frames.append(FramePaths(*parts[:6]))
    return frames


def deform_frames(frames: list[FramePaths], cfg: SolverConfig, *, device,
                  fw: FrameworkConfig | None = None) -> list[FramePaths]:
    """Deform a list of frames, writing .flo + warped RGB/mask per frame.

    Frames are grouped by shape (read from the image headers); a group of
    two or more solves as batches of max_chunk_for frames with
    solve_and_raster_batch, a frame whose shape is seen once solves alone.
    A batch that raises is retried frame by frame. Under ``raster="host"``
    (ARAP_RASTER=host) every frame runs the per-frame deformer, whose
    reference-exact host splat the batched path (a device raster) does not
    have. Returns the frames that failed alone, each reported as it
    failed."""
    fw = fw or FrameworkConfig()
    device = torch.device(device)
    deformer = ArapDeformer(cfg, weights=fw.weights, raster=fw.raster,
                            device=device)
    failed: list[FramePaths] = []

    def serial(fr: FramePaths) -> None:
        try:
            _write_result(fr, deformer.deform(
                load_rgb(fr.rgb), load_mask(fr.mask),
                read_constraint_file(fr.cstr)))
        except Exception as e:  # noqa: BLE001 — report it, go on with the list
            print(f"frame failed: {fr.rgb} ({e!r})")
            failed.append(fr)

    if fw.raster == "host":
        for fr in frames:
            serial(fr)
        return failed
    groups: dict[tuple, list[int]] = {}
    n_chunks = 0  # the spans' chunk ids
    for i, fr in enumerate(frames):
        groups.setdefault(image_size(fr.mask), []).append(i)
    for (H, W), idxs in groups.items():
        if len(idxs) < 2:
            serial(frames[idxs[0]])
            continue
        step = max_chunk_for((H, W))
        for c0 in range(0, len(idxs), step):
            chunk = [frames[i] for i in idxs[c0 : c0 + step]]
            try:
                with profiling.TIMER.scope(chunk=n_chunks):
                    _deform_chunk(chunk, H, W, cfg, fw, device)
            except Exception as e:  # noqa: BLE001 — isolate the bad frame
                print(f"batched chunk failed ({e!r}); retrying frame by frame")
                for fr in chunk:
                    serial(fr)
            n_chunks += 1
    return failed


def _write_result(fr: FramePaths, res: DeformResult) -> None:
    flo.flow_write(fr.out_flo, res.flow)
    save_image(fr.out_rgb, res.warped_rgb)
    save_image(fr.out_mask, res.warped_mask)
    print("Saved")


def _deform_chunk(chunk: list[FramePaths], H: int, W: int,
                  cfg: SolverConfig, fw: FrameworkConfig, device) -> None:
    """Solve and rasterize same-shape frames as one batch; writes nothing
    unless the whole batch solved. Stages "run_arap prep" (reads, operands,
    stack, upload), "run_arap solve" (the solves' issue and the wait for
    their products) and "run_arap write"."""
    timer = profiling.TIMER
    with timer.stage("run_arap prep"):
        ops, rgbs = [], []
        for fr in chunk:
            cons = add_border_pins(np.asarray(
                read_constraint_file(fr.cstr), np.int32).reshape(-1, 4), W, H)
            ops.append(E.build_compact(load_mask(fr.mask), cons, fw.weights))
            rgbs.append(np.ascontiguousarray(
                load_rgb(fr.rgb).transpose(2, 0, 1)))
        ops = E.CompactOperands.stack(ops).to(device)
        rgbs = torch.as_tensor(np.stack(rgbs), device=device)
    with timer.stage("run_arap solve"):
        _, flows, wrgbs, wmasks = solve_and_raster_batch(ops, rgbs, cfg)
        flows, wrgbs, wmasks = (t.cpu().numpy()
                                for t in (flows, wrgbs, wmasks))
    with timer.stage("run_arap write"):
        for j, fr in enumerate(chunk):
            _write_result(fr, DeformResult(
                flow=flows[j].transpose(1, 2, 0),
                warped_rgb=wrgbs[j].transpose(1, 2, 0),
                warped_mask=wmasks[j],
            ))


def make_config(schedule: str) -> SolverConfig:
    if schedule == "parity":
        return SolverConfig()
    return SolverConfig(q_tolerance=1e-4)


def make_framework_config(schedule: str) -> FrameworkConfig:
    """--schedule gives the base solver; ARAP_* env vars override on top."""
    return FrameworkConfig.from_env(solver=make_config(schedule))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ARAP-deform frames: constraints + mask -> flow + warped "
                    "outputs."
    )
    p.add_argument("paths", nargs="+",
                   help="either 6 paths (RGB Mask Cstr Flow wRGB wMask) or "
                        "one list file")
    p.add_argument("--schedule", choices=["parity", "fast"], default="parity")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")
    a = p.parse_args(argv)

    if len(a.paths) == 6:
        frames = [FramePaths(*a.paths)]
    elif len(a.paths) == 1:
        frames = parse_list_file(a.paths[0])
    else:
        p.error("expected 6 paths or a single list file")
    if not frames:
        p.error("no frames to process")
    device = cli_device(a.device)
    fw = make_framework_config(a.schedule)
    failed = deform_frames(frames, fw.solver, device=device, fw=fw)
    if failed:
        raise SystemExit(f"{len(failed)} of {len(frames)} frames failed")


if __name__ == "__main__":
    main()
