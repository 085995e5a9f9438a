"""warp_image equivalent: re-apply a .flo flow field to an image + mask
(pipeline/warp_tool.py of the JAX package).

    python -m arap_flow_tpu_torch warp IMAGE MASK FLOW WARPED_IMG WARPED_MASK

Mask convention: 0 = object (drawn), nonzero = background/excluded.
Backends: ``device`` (the default: the seed-and-gather rasterizer on
``--device``) or ``host`` (the reference-exact splat of the native library,
on the host; the JAX package's default).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..io import flo
from ..io.image import load_mask, load_rgb, save_image
from ..native.host_raster import warp_from_flow
from ..native.runtime import rasterize_warp
from ..ops.rasterize import rasterize_flow
from ..utils.config import cli_device


def warp_image(img_path, mask_path, flo_path, out_img_path, out_mask_path, *,
               device, backend: str = "device"):
    if backend not in ("host", "device"):
        raise ValueError(f"unknown warp backend {backend!r}")
    rgb = load_rgb(img_path)
    mask = load_mask(mask_path)
    u, v = flo.flow_read(flo_path)
    if backend == "host":
        wrgb, wmask = rasterize_warp(
            warp_from_flow(np.dstack([u, v]).astype(np.float32)), rgb, mask)
        save_image(out_img_path, wrgb)
        save_image(out_mask_path, wmask)
        return wrgb, wmask
    drgb, dmask = rasterize_flow(
        torch.as_tensor(np.stack([u, v]), device=device),
        torch.as_tensor(rgb.transpose(2, 0, 1), dtype=torch.float32,
                        device=device),
        torch.as_tensor(mask, device=device),
    )
    wrgb = drgb.to(torch.uint8).cpu().numpy().transpose(1, 2, 0)
    wmask = dmask.to(torch.uint8).cpu().numpy()
    save_image(out_img_path, wrgb)
    save_image(out_mask_path, wmask)
    return wrgb, wmask


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Mask and warp image using the provided optical flow field."
    )
    p.add_argument("image", help="input RGB image (.png)")
    p.add_argument("mask", help="input mask (.png), 0 for object")
    p.add_argument("flow", help="input flow (.flo)")
    p.add_argument("warped_image", help="output warped image (.png)")
    p.add_argument("warped_mask", help="output warped mask (.png)")
    p.add_argument("--backend", choices=["device", "host"], default="device",
                   help="device = seed-and-gather rasterizer on --device; "
                        "host = reference-exact splat (C++, on the host)")
    p.add_argument("--device", default="cuda",
                   help="torch device of --backend device (default cuda)")
    a = p.parse_args(argv)
    device = cli_device(a.device) if a.backend == "device" else None
    warp_image(a.image, a.mask, a.flow, a.warped_image, a.warped_mask,
               device=device, backend=a.backend)
    print("Saved")


if __name__ == "__main__":
    main()
