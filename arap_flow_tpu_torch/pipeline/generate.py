"""Phase-by-phase dataset generator (pipeline/generate.py of the JAX
package).

Runs the reference's serial phases over the whole dataset, each
checkpointed to the filesystem: matching -> mask/constraint conversion ->
ARAP deformation -> background compositing.

    python -m arap_flow_tpu_torch generate --input ROOT --output OUT \\
        [--phases match convert deform bg] [--fd N] [--device cuda] ...
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from ..io import flo
from ..io.constraints import (filter_matches, read_constraint_file,
                              write_constraint_file)
from ..io.image import ARAP_BG, load_mask, load_rgb, mask_to_arap, save_image
from ..models.arap import ArapDeformer
from ..utils.config import cli_device
from .para_gen import (
    BackgroundPool,
    PipelineFlags,
    _check_flags,
    _ensure_dirs,
    add_bg,
    has_mask,
    make_solver_config,
    run_matching,
    scan_pairs,
)


def phase_match(flags: PipelineFlags, pairs):
    """Matching phase: raw matches -> filtered constraint files."""
    for p in pairs:
        _ensure_dirs(p)
        mk1, mk2 = load_mask(p.msk1_org), load_mask(p.msk2_org)
        if not has_mask(mk1, mk2):
            continue
        matches = run_matching(flags, p, load_rgb(p.rgb1_org),
                               load_rgb(p.rgb2_org))
        kept, _ = filter_matches(matches, mk1, mk2)
        write_constraint_file(p.cstr_tmp, kept)
        print("Done matching for " + p.cstr_tmp)


def phase_convert(flags: PipelineFlags, pairs):
    """Mask conversion phase: annotation masks -> ARAP masks, and inpRGB
    copies of the first frames."""
    for p in pairs:
        if not osp.exists(p.cstr_tmp):
            continue
        _ensure_dirs(p)
        save_image(p.msk1_gen, mask_to_arap(load_mask(p.msk1_org)))
        if not osp.exists(p.rgb1_gen):
            save_image(p.rgb1_gen, load_rgb(p.rgb1_org))


def phase_deform(flags: PipelineFlags, pairs, solver_cfg=None):
    """Deformation phase: constraint files + masks -> flow + warped
    outputs."""
    deformer = ArapDeformer(solver_cfg or make_solver_config(flags.schedule),
                            device=torch.device(flags.device))
    for p in pairs:
        if not (osp.exists(p.cstr_tmp) and osp.exists(p.msk1_gen)):
            continue
        cons = read_constraint_file(p.cstr_tmp)
        if len(cons) == 0:
            continue
        res = deformer.deform(load_rgb(p.rgb1_gen), load_mask(p.msk1_gen),
                              cons)
        flo.flow_write(p.flow_gen, res.flow.astype(np.float32))
        save_image(p.rgb2_gen, res.warped_rgb)
        save_image(p.msk2_gen, res.warped_mask)
        print("Saved " + p.flow_gen)


def phase_bg(flags: PipelineFlags, pairs):
    """Background phase: one random background into frame 1 (over ARAP_BG
    pixels) and the warped frame (over uncovered pixels); writes the
    training list."""
    rng = np.random.default_rng(flags.seed)
    pool = BackgroundPool(flags.bg_dir, rng)
    lines = []
    for p in pairs:
        needed = [p.rgb1_gen, p.msk1_gen, p.rgb2_gen, p.msk2_gen, p.flow_gen]
        if not all(osp.exists(x) for x in needed):
            continue
        im1, mk1 = load_rgb(p.rgb1_gen), load_mask(p.msk1_gen)
        im2, mk2 = load_rgb(p.rgb2_gen), load_mask(p.msk2_gen)
        bg = pool.draw(im1.shape)
        if bg is not None:
            save_image(p.rgb1_gen, add_bg(im1, mk1, bg, bgval=ARAP_BG))
            save_image(p.rgb2_gen, add_bg(im2, mk2, bg, bgval=0))
        lines.append("\t".join([p.rgb1_gen, p.rgb2_gen, p.flow_gen]))
    out = osp.join(flags.output, "all_files.list")
    os.makedirs(flags.output, exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines))
    return lines


PHASES = {
    "match": phase_match,
    "convert": phase_convert,
    "deform": phase_deform,
    "bg": phase_bg,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Phase-by-phase ARAP generation")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--bg_dir", default=None)
    p.add_argument("--fd", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--matcher", choices=["native", "binary", "file"],
                   default="native")
    p.add_argument("--dm_bin", default=None)
    p.add_argument("--schedule", choices=["parity", "fast"], default="parity")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--phases", nargs="*",
                   default=["match", "convert", "deform", "bg"],
                   choices=list(PHASES))
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    a = p.parse_args(argv)
    flags = PipelineFlags(
        input=a.input.rstrip(osp.sep), output=a.output.rstrip(osp.sep),
        bg_dir=a.bg_dir, fd=a.fd, resume=a.resume, matcher=a.matcher,
        dm_bin=a.dm_bin, schedule=a.schedule, seed=a.seed,
        device=str(cli_device(a.device)),
    )
    _check_flags(flags)
    pairs = scan_pairs(flags)
    print(f"{len(pairs)} frame pairs")
    for name in a.phases:
        print(f"=== phase: {name} ===")
        PHASES[name](flags, pairs)


if __name__ == "__main__":
    main()
