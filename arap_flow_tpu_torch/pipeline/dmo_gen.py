"""DMO-style dataset assembly (pipeline/dmo_gen.py of the JAX package):
random procedural textures over object masks, then para_gen.

The reference's DMO datasets (D15OM/D15RM: 5 frame distances × 2 texture
sets) pair DAVIS-style object masks with random textures. The assembly:

1. every object id of a sequence gets a procedural texture
   (``ops.textures``, rendered on --device) sampled in object-tracked
   coordinates (the mask's centroid in each frame), so the texture
   translates rigidly with the object and the matcher can recover the
   motion; the background gets its own static texture;
2. the textured frames (baseline JPEG, quality 75) and the original masks
   (symlinked) form an orgRGB/orgMasks tree;
3. para_gen runs on that tree as on real video, once per --fd.

    python -m arap_flow_tpu_torch dmo_gen --masks ROOT --output OUT \\
        [--fd 1 2 3] [--seed 0] [--multseg] [--schedule parity] \\
        [--mode simple] [--texture_sets 2] [--warp_backend device] \\
        [--device cuda]

``--masks ROOT`` holds orgMasks/<seq>/NNNNN.png annotation masks (0 =
background, ids = objects). Textured frames go to OUT/textured/orgRGB and
each fd runs into OUT/fd{N}/.

``--texture_sets K`` (K >= 2) writes the reference's dual-texture-set
layout (D15OM and D15RM share one Flow): set 0 is solved into
OUT/set0/fd{N}; each further set k re-textures the same masks with another
seed and re-applies set 0's .flo with the warp tool. Flow, inpMasks and
wMasks are hard-linked from set 0, so the sets' Flow trees are
byte-identical; only inpRGB and wRGB come from set k's textures. Matching
and solving run once, whatever K. The warps run on --device
(``--warp_backend device``, the default) or with the reference-exact host
splat (``host``).

Nothing here needs PIL: masks and frames go through the port's PNG and
JPEG codecs, and set k's portrait frames through para_gen's numpy
``scale_rotate``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import zlib

import numpy as np
import torch

from ..io.image import load_mask, load_rgb, save_image
from ..ops.textures import random_texture
from ..utils import prng
from ..utils.config import cli_device
from .para_gen import (COLOR_DIR, FLOW_DIR, MASK_DIR, ORGCOLOR, ORGMASK,
                       WMASK_DIR, WRGB_DIR, PipelineFlags, main_pipeline,
                       scale_rotate)
from .warp_tool import warp_image


def _texture_for(key_seed: int, H: int, W: int, device) -> np.ndarray:
    """A random texture of twice the frame's size (object-tracked sampling
    stays inside it), drawn from ``prng.key(key_seed)`` as in the JAX
    package."""
    return random_texture(prng.key(key_seed), 2 * H, 2 * W,
                          device=device).cpu().numpy()


def texture_sequence(mask_paths: list[str], out_dir: str, seed: int, *,
                     device) -> None:
    """Write the textured RGB frames of one sequence of annotation masks."""
    masks = [load_mask(p) for p in mask_paths]
    H, W = masks[0].shape
    ids = sorted(set(int(i) for m in masks for i in np.unique(m)) - {0})

    textures = {0: _texture_for(seed * 1000, H, W, device)}
    for k, oid in enumerate(ids):
        textures[oid] = _texture_for(seed * 1000 + 1 + k, H, W, device)

    # each object's reference centroid, from the first frame it appears in
    ref_centroid = {}
    for oid in ids:
        for m in masks:
            ys, xs = np.where(m == oid)
            if len(ys):
                ref_centroid[oid] = (float(ys.mean()), float(xs.mean()))
                break

    yy, xx = np.mgrid[0:H, 0:W]
    os.makedirs(out_dir, exist_ok=True)
    for m, p in zip(masks, mask_paths):
        frame = textures[0][H // 2 : H // 2 + H, W // 2 : W // 2 + W].copy()
        for oid in ids:
            sel = m == oid
            if not sel.any():
                continue
            cy, cx = float(yy[sel].mean()), float(xx[sel].mean())
            r0y, r0x = ref_centroid[oid]
            # the object's texture in object-tracked coordinates, so that it
            # moves rigidly with the mask
            sy = np.clip((yy[sel] - cy + r0y).astype(int) + H // 2, 0, 2 * H - 1)
            sx = np.clip((xx[sel] - cx + r0x).astype(int) + W // 2, 0, 2 * W - 1)
            frame[sel] = textures[oid][sy, sx]
        name = osp.splitext(osp.basename(p))[0]
        save_image(osp.join(out_dir, name + ".jpg"), frame)


def assemble(masks_root: str, output: str, seed: int, *, device) -> str:
    """Texture every sequence under masks_root/orgMasks; returns the new
    input root (textured orgRGB and symlinked orgMasks)."""
    src = osp.join(masks_root, ORGMASK)
    troot = osp.join(output, "textured")
    for dirpath, _, files in os.walk(src):
        pngs = sorted(osp.join(dirpath, f) for f in files if f.endswith(".png"))
        if not pngs:
            continue
        rel = osp.relpath(dirpath, src)
        texture_sequence(pngs, osp.join(troot, ORGCOLOR, rel),
                         seed + zlib.crc32(rel.encode()) % 100000,
                         device=device)
        mdir = osp.join(troot, ORGMASK, rel)
        os.makedirs(mdir, exist_ok=True)
        for p in pngs:
            dst = osp.join(mdir, osp.basename(p))
            if not osp.exists(dst):
                os.symlink(osp.abspath(p), dst)
    return troot


def _link_or_copy(src: str, dst: str) -> None:
    os.makedirs(osp.dirname(dst), exist_ok=True)
    if osp.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)  # byte-identical by construction
    except OSError:
        shutil.copy2(src, dst)


def replicate_texture_set(set0_out: str, setk_input: str, setk_out: str,
                          fds: list[int], warp_backend: str = "device", *,
                          device) -> int:
    """Texture set k >= 1 of the dual-set layout, without solving again.

    For every pair set 0 produced (its Flow tree holds what survived the
    match and filter), Flow, inpMasks and wMasks are hard-linked from set 0
    (they do not depend on the texture); inpRGB is set k's textured frame
    and wRGB re-applies set 0's .flo to it with the warp tool
    (`warp_backend` on `device`). Returns the number of pairs written."""
    n = 0
    for fd in fds:
        flow_root = osp.join(set0_out, f"fd{fd}", FLOW_DIR)
        if not osp.isdir(flow_root):
            continue
        for dirpath, _, files in os.walk(flow_root):
            rel = osp.relpath(dirpath, flow_root)
            for f in sorted(files):
                if not f.endswith(".flo"):
                    continue
                name = osp.splitext(f)[0]
                flo0 = osp.join(dirpath, f)
                out_fd = osp.join(setk_out, f"fd{fd}")
                # shared, texture-independent products: hard-linked
                _link_or_copy(flo0, osp.join(out_fd, FLOW_DIR, rel, f))
                for d in (MASK_DIR, WMASK_DIR):
                    src = osp.join(set0_out, f"fd{fd}", d, rel, name + ".png")
                    if osp.exists(src):
                        _link_or_copy(src,
                                      osp.join(out_fd, d, rel, name + ".png"))
                # set k's own appearance products. The frame takes the same
                # preprocessing as set 0's (the portrait transpose of
                # scale_rotate; dmo_gen has no --size, so no resize), or its
                # inpRGB and wRGB would not line up with the linked Flow
                src_rgb = osp.join(setk_input, ORGCOLOR, rel, name + ".jpg")
                src_msk = osp.join(setk_input, ORGMASK, rel, name + ".png")
                inp_rgb = osp.join(out_fd, COLOR_DIR, rel, name + ".png")
                os.makedirs(osp.dirname(inp_rgb), exist_ok=True)
                _, im, _ = scale_rotate(load_rgb(src_rgb), load_mask(src_msk),
                                        None)
                save_image(inp_rgb, im)
                # warp mask: 0 = object (the warp tool's convention), the
                # set-0 inpMask (0 object, 255 background)
                msk = osp.join(out_fd, MASK_DIR, rel, name + ".png")
                wrgb = osp.join(out_fd, WRGB_DIR, rel, name + ".png")
                wmsk_tmp = osp.join(out_fd, WMASK_DIR, rel,
                                    name + ".setk.tmp.png")
                os.makedirs(osp.dirname(wrgb), exist_ok=True)
                warp_image(inp_rgb, msk, flo0, wrgb, wmsk_tmp, device=device,
                           backend=warp_backend)
                os.remove(wmsk_tmp)  # the warped mask is linked from set 0
                n += 1
    return n


def run(masks: str, output: str, fds: list[int], seed: int = 0,
        multseg: bool = False, schedule: str = "parity",
        mode: str = "simple", texture_sets: int = 1,
        warp_backend: str = "device", solver_cfg=None, *,
        device="cuda") -> None:
    """Programmatic entry (the CLI parses into this). texture_sets >= 2
    writes OUT/set{k}/fd{N} trees whose Flow is byte-identical across
    sets. Textures, solves and device warps run on `device`."""
    device = torch.device(device)
    multi = texture_sets > 1
    set_out = [osp.join(output, f"set{k}") if multi else output
               for k in range(texture_sets)]
    # a texture seed per set, the same masks
    set_in = [assemble(masks, set_out[k], seed + 7777 * k, device=device)
              for k in range(texture_sets)]
    for fd in fds:
        print(f"=== set0 fd{fd} ===")
        flags = PipelineFlags(
            input=set_in[0], output=osp.join(set_out[0], f"fd{fd}"), fd=fd,
            multseg=multseg, schedule=schedule, seed=seed, mode=mode,
            device=str(device),
        )
        main_pipeline(flags, solver_cfg=solver_cfg)
    for k in range(1, texture_sets):
        print(f"=== set{k}: re-texture + shared-Flow warp ===")
        n = replicate_texture_set(set_out[0], set_in[k], set_out[k], fds,
                                  warp_backend, device=device)
        print(f"set{k}: {n} pairs replicated (Flow hard-linked from set0)")


def main(argv=None):
    ap = argparse.ArgumentParser(description="DMO-style textured dataset generation")
    ap.add_argument("--masks", required=True, help="root containing orgMasks/")
    ap.add_argument("--output", required=True)
    ap.add_argument("--fd", nargs="*", type=int, default=[1])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multseg", action="store_true", default=False)
    ap.add_argument("--schedule", choices=["parity", "fast"], default="parity")
    ap.add_argument("--mode", choices=["simple", "batched"], default="simple")
    ap.add_argument("--texture_sets", type=int, default=1,
                    help=">=2: the reference's dual-texture-set layout "
                    "(D15OM/D15RM): further sets re-texture the same masks "
                    "and share set 0's Flow byte-identically (re-warped, "
                    "not re-solved)")
    ap.add_argument("--warp_backend", choices=["host", "device"],
                    default="device",
                    help="rasterizer of the re-applied warps of sets >= 1: "
                    "device = the seed-and-gather rasterizer on --device, "
                    "host = the reference-exact splat (C++)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the textures, the solves and the "
                    "device warps (default cuda)")
    a = ap.parse_args(argv)
    run(a.masks, a.output, a.fd, a.seed, a.multseg, a.schedule, a.mode,
        a.texture_sets, a.warp_backend, device=cli_device(a.device))


if __name__ == "__main__":
    main()
