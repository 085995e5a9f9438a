"""The plain reference of what a cell's jobs write, worked out again from
the inputs the benchmark made (decoded frames, annotation masks,
constraint files it wrote), with no part of the program.

- ``davis_pairs``: ``para_gen --multseg`` pairs: matches (plain
  matcher), the constraint filter, one ARAP problem a segment on a tight
  box around it, all solved together in one padded batch, each segment
  rasterized on the whole frame, composed in segment order.
- ``sintel_frames``: ``run_arap`` frames, each solved whole with its
  constraints and the frame's border pinned, rasterized on the frame.

``dtype`` is the solve's precision (float32, or bfloat16 for the control).
"""

from __future__ import annotations

import numpy as np
import torch

from . import arap
from .matcher import match_pair
from .raster import rasterize

MAX_CONSTRAINT_DIST = 60.0
SOLVE_RIM = 2  # px around an object's box: excluded pixels, inert


def filter_matches(matches, msk1, msk2):
    """Matches inside both frames, 0 < length < 60 px, from an object pixel
    to the same object id: (kept (M, 4) int32, their object ids (M,))."""
    m = np.asarray(matches, np.int64).reshape(-1, 4)
    x1, y1, x2, y2 = m.T
    H, W = msk1.shape
    inb = ((x1 >= 0) & (y1 >= 0) & (x2 >= 0) & (y2 >= 0) & (x1 < W)
           & (x2 < W) & (y1 < H) & (y2 < H))
    s1 = msk1[np.where(inb, y1, 0), np.where(inb, x1, 0)].astype(np.int64)
    s2 = msk2[np.where(inb, y2, 0), np.where(inb, x2, 0)].astype(np.int64)
    d2 = (x2 - x1) ** 2 + (y2 - y1) ** 2
    keep = (inb & (d2 > 0) & (d2 < MAX_CONSTRAINT_DIST ** 2) & (s1 > 0)
            & (s1 == s2))
    return m[keep].astype(np.int32), s1[keep]


def border_pins(W: int, H: int) -> np.ndarray:
    """Identity constraints on every pixel of the frame's border."""
    ys, xs = np.mgrid[0:H, 0:W]
    edge = (ys == 0) | (ys == H - 1) | (xs == 0) | (xs == W - 1)
    b = np.stack([xs[edge], ys[edge]], 1)
    return np.concatenate([b, b], 1).astype(np.int32)


def solve_box(mk: np.ndarray) -> tuple:
    """(y0, x0, h, w): the box of an ARAP mask's solve region (its 0
    pixels) and SOLVE_RIM px around it, inside the frame."""
    H, W = mk.shape
    ys, xs = np.nonzero(mk == 0)
    y0, x0 = max(0, ys.min() - SOLVE_RIM), max(0, xs.min() - SOLVE_RIM)
    y1 = min(H, ys.max() + 1 + SOLVE_RIM)
    x1 = min(W, xs.max() + 1 + SOLVE_RIM)
    return int(y0), int(x0), int(y1 - y0), int(x1 - x0)


def _solve_boxes(problems, H, W, device, schedule, dtype):
    """problems: [(arap mask (H, W) u8, constraints (N, 4) in frame
    coordinates with the border pins)]. Each is solved on its object's box
    plus SOLVE_RIM, all in one batch padded to the largest box. Returns one
    (2, H, W) float32 warp (absolute positions) per problem."""
    boxes, masks, cons = [], [], []
    for mk, c in problems:
        y0, x0, h, w = solve_box(mk)
        c = np.asarray(c, np.int64).reshape(-1, 4)
        inside = ((c[:, 0] >= x0) & (c[:, 0] < x0 + w) & (c[:, 1] >= y0)
                  & (c[:, 1] < y0 + h))
        boxes.append((y0, x0, h, w))
        masks.append(mk[y0:y0 + h, x0:x0 + w])
        cons.append(c[inside] - [x0, y0, x0, y0])
    hmax = max(b[2] for b in boxes)
    wmax = max(b[3] for b in boxes)
    P = arap.build(masks, cons, hmax, wmax, device, dtype)
    x = arap.solve(P, schedule)[:, :2].to(torch.float32)
    warps = []
    gy, gx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    for k, (y0, x0, h, w) in enumerate(boxes):
        warp = torch.stack([gx, gy])
        sub = x[k, :, :h, :w] + torch.tensor([x0, y0], device=device,
                                             dtype=torch.float32)[:, None, None]
        warp[:, y0:y0 + h, x0:x0 + w] = sub
        warps.append(warp)
    return warps


def _raster(warp, rgb, mk, device):
    """Flow (H, W, 2), warped RGB (H, W, 3) u8 and mask (H, W) u8 of one
    solved problem on the whole frame."""
    H, W = mk.shape
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    obj = torch.as_tensor(mk, device=device)
    wrgb, wmask = rasterize(warp, torch.as_tensor(
        np.ascontiguousarray(rgb.transpose(2, 0, 1)), device=device).to(
            torch.float32), obj)
    flow = warp.cpu().numpy() - np.stack([gx, gy])
    flow[:, mk != 0] = 0.0
    return (flow.transpose(1, 2, 0), wrgb.to(torch.uint8).cpu().numpy().
            transpose(1, 2, 0), wmask.to(torch.uint8).cpu().numpy())


def davis_pairs(pairs, device, schedule=(19, 8, 400), dtype=torch.float32):
    """The products of para_gen --multseg pairs [(rgb1, mask1, rgb2, mask2)]
    (no backgrounds), every segment of every pair solved in one batch: one
    dict a pair of flow, wrgb, wmask, inp and the object ids solved, or
    None where the pair has no products (empty masks, or no match survives
    the filter)."""
    problems, owners = [], []
    for k, (rgb1, mk1, rgb2, mk2) in enumerate(pairs):
        if (mk1 != 0).sum() <= 10 or (mk2 != 0).sum() <= 10:
            continue
        kept, seg = filter_matches(match_pair(rgb1, rgb2, mk1, device), mk1,
                                   mk2)
        H, W = mk1.shape
        pins = border_pins(W, H)
        for s in np.unique(seg):
            if s:
                problems.append((np.where(mk1 == s, 0, 255).astype(np.uint8),
                                 np.concatenate([kept[seg == s], pins])))
                owners.append((k, int(s)))
    warps = (_solve_boxes(problems, *pairs[0][1].shape, device, schedule,
                          dtype) if problems else [])
    out = [None] * len(pairs)
    for (k, s), (mk, _), warp in zip(owners, problems, warps):
        flow, wrgb, wmask = _raster(warp, pairs[k][0], mk, device)
        if out[k] is None:  # segments in id order: the first one's products
            out[k] = {"flow": flow.copy(), "wrgb": wrgb.copy(),
                      "wmask": wmask.copy(), "inp": pairs[k][0], "ids": []}
        else:  # a later segment overwrites where it is drawn
            ob = wmask != 0
            for key, v in (("flow", flow), ("wrgb", wrgb), ("wmask", wmask)):
                out[k][key][ob] = v[ob]
        out[k]["ids"].append(s)
    return out


def sintel_frames(frames, device, schedule=(19, 8, 400),
                  dtype=torch.float32):
    """run_arap's products of frames [(rgb (H, W, 3) u8, arap mask (H, W) u8,
    constraints (N, 4))], solved in one batch: a dict per frame of flow,
    wrgb and wmask."""
    H, W = frames[0][1].shape
    pins = border_pins(W, H)
    problems = [(mk, np.concatenate([np.asarray(c, np.int32).reshape(-1, 4),
                                     pins])) for _, mk, c in frames]
    warps = _solve_boxes(problems, H, W, device, schedule, dtype)
    out = []
    for (rgb, mk, _), warp in zip(frames, warps):
        flow, wrgb, wmask = _raster(warp, rgb, mk, device)
        out.append({"flow": flow, "wrgb": wrgb, "wmask": wmask})
    return out
