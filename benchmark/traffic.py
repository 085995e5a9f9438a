"""The benchmark's one traffic generator: scenes of moving textured objects
drawn from a workload file's parameters and the run's seed.

A workload file (``benchmark/workloads/<cell>.json``) gives the frame size,
its sequences' lengths, and for each object its id, a size schedule
(semi-axes; one size a sequence), a scale, the place in that schedule it
starts from, a bounded drift of its centre, and whether its interior
deforms. The seed picks only the textures (and the final pass's
noise), so every seed gives the same objects, sizes and motions, and so
the same crop buckets and batch sizes: seeds change the pixels, not the
work.

The objects are frozen copies of the repository's synthetic dataset
(``scripts/synth_nonrigid.py`` and the endurance tool's sizes and
centres): a rigid ellipse whose texture rides its centre, and an ellipse
whose interior deforms by a sinusoidal field that vanishes at its
boundary, with an analytic flow. Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np


def bounce(t, step, lo, hi):
    """Triangle-wave drift: |motion| is `step` a frame and the value stays
    inside [lo, hi]."""
    span = hi - lo
    ph = (step * t) % (2 * span)
    return lo + (ph if ph <= span else 2 * span - ph)


def make_textures(H: int, W: int, seed: int):
    """(object texture, dim background), both (H, W, 3) uint8: a blocky
    base with fine detail, from the seed."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(40, 255, (H // 8 + 2, W // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:H, :W]
    detail = np.kron(rng.uniform(-30, 30, (H // 2 + 1, W // 2 + 1, 3)),
                     np.ones((2, 2, 1)))[:H, :W]
    tex = np.clip(base + detail, 0, 255).astype(np.uint8)
    bg = np.clip(base[::-1] * 0.4, 0, 255).astype(np.uint8)
    return tex, bg


def nr_field(py, px, ry, rx, amp):
    """Unit-phase displacement field D(p) = (dy, dx) in material
    coordinates: zero value and gradient on the ellipse's boundary."""
    r2 = (py / ry) ** 2 + (px / rx) ** 2
    env = np.clip(1.0 - r2, 0.0, None) ** 2
    dx = amp * env * np.sin(np.pi * py / ry) * np.cos(0.5 * np.pi * px / rx)
    dy = amp * env * np.cos(0.5 * np.pi * py / ry) * np.sin(np.pi * px / rx)
    return dy, dx


def nr_phase(t: int) -> float:
    """Deformation phase of frame t: ±0.5, so each pair carries the whole
    field."""
    return 0.5 if t % 2 else -0.5


def _invert(qy, qx, ry, rx, amp, s, iters=15):
    """Fixed-point inverse of p -> p + s·D(p)."""
    py, px = qy.copy(), qx.copy()
    for _ in range(iters):
        dy, dx = nr_field(py, px, ry, rx, amp)
        py, px = qy - s * dy, qx - s * dx
    return py, px


def nr_amp(ry: float, rx: float, cap: float) -> float:
    """Non-rigid amplitude at semi-axes (ry, rx): scaled to the object, off
    where the matcher's stride cannot resolve it."""
    m = min(ry, rx)
    return min(cap, 0.12 * m) if m >= 35 else 0.0


def size_at(obj: dict, k: int):
    """Semi-axes (ry, rx) of an object in sequence k: entry `start` + k of
    its schedule of sizes (cyclic), times `scale`, at least `min`."""
    sizes = np.asarray(obj["sizes"], np.float64)
    s = sizes[(int(obj.get("start", 0)) + k) % len(sizes)]
    s = s * float(obj.get("scale", 1.0))
    lo = obj.get("min", [0, 0])
    return max(float(lo[0]), float(s[0])), max(float(lo[1]), float(s[1]))


def centre_at(obj: dict, t: int):
    """(cy, cx) of an object at frame t: each axis a ``bounce`` given as
    [step, lo, hi, frame offset]."""
    (sy, ly, hy, oy), (sx, lx, hx, ox) = obj["centre_y"], obj["centre_x"]
    return bounce(t + oy, sy, ly, hy), bounce(t + ox, sx, lx, hx)


class Scene:
    """Frames of a workload at a seed. The workload's `sequences` give the
    frames of each sequence (one sequence of `frames` where absent); frame
    t counts over all of them, and an object keeps its size within a
    sequence. ``frame(t)`` gives (RGB (H, W, 3) uint8, annotation mask
    (H, W) uint8 with the objects' ids)."""

    def __init__(self, workload: dict, seed: int):
        self.H, self.W = int(workload["height"]), int(workload["width"])
        self.lengths = [int(n) for n in (
            workload["sequences"] if "sequences" in workload
            else [workload["frames"]])]
        self.n = sum(self.lengths)
        self.seq = np.repeat(np.arange(len(self.lengths)), self.lengths)
        self.objects = workload["objects"]
        self.tex, self.bg = make_textures(self.H, self.W, seed)

    def geometry(self, obj: dict, t: int):
        """(cy, cx, ry, rx, amp, phase) of an object at frame t."""
        cy, cx = centre_at(obj, t)
        ry, rx = size_at(obj, int(self.seq[min(t, self.n - 1)]))
        amp = nr_amp(ry, rx, float(obj["nonrigid"])) if obj.get(
            "nonrigid") else 0.0
        return cy, cx, ry, rx, amp, (nr_phase(t) if amp > 0 else 0.0)

    def frame(self, t: int):
        H, W = self.H, self.W
        img = self.bg.copy()
        mask = np.zeros((H, W), np.uint8)
        for obj in self.objects:
            cy, cx, ry, rx, amp, s = self.geometry(obj, t)
            y0, y1 = max(0, int(cy - ry)), min(H, int(cy + ry) + 1)
            x0, x1 = max(0, int(cx - rx)), min(W, int(cx + rx) + 1)
            yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float64)
            qy, qx = yy - cy, xx - cx
            inside = (qy / ry) ** 2 + (qx / rx) ** 2 < 1.0
            if amp > 0:  # the texture rides the material, whatever the size
                py, px = _invert(qy, qx, ry, rx, amp, s)
                val = _bilinear(self.tex, py + cy, px + cx)
            else:  # the texture rides the centre
                val = self.tex[(yy.astype(int) - int(round(cy))) % H,
                               (xx.astype(int) - int(round(cx))) % W]
            img[y0:y1, x0:x1][inside] = val[inside]
            mask[y0:y1, x0:x1][inside] = int(obj["id"])
        return img, mask

    def flow(self, obj: dict, t: int, ys: np.ndarray, xs: np.ndarray):
        """The object's analytic flow from frame t to t + 1 at frame-t
        pixels (ys, xs): (dx, dy) float arrays."""
        cy0, cx0, ry0, rx0, amp0, s0 = self.geometry(obj, t)
        cy1, cx1, ry1, rx1, amp1, s1 = self.geometry(obj, t + 1)
        qy, qx = ys - cy0, xs - cx0
        if amp0 > 0:
            py, px = _invert(qy, qx, ry0, rx0, amp0, s0)
        else:
            py, px = qy, qx
        # material point -> frame t+1: scaled with the object's size
        py1, px1 = py * ry1 / ry0, px * rx1 / rx0
        if amp1 > 0:
            dy, dx = nr_field(py1, px1, ry1, rx1, amp1)
            py1, px1 = py1 + s1 * dy, px1 + s1 * dx
        return cx1 + px1 - xs, cy1 + py1 - ys


def _bilinear(tex: np.ndarray, ty: np.ndarray, tx: np.ndarray) -> np.ndarray:
    """Bilinear texture fetch at (ty, tx), the texture tiling the plane."""
    H, W = tex.shape[:2]
    ty, tx = ty % H, tx % W
    iy0, ix0 = np.floor(ty).astype(int), np.floor(tx).astype(int)
    fy, fx = (ty - iy0)[..., None], (tx - ix0)[..., None]
    iy1, ix1 = (iy0 + 1) % H, (ix0 + 1) % W
    iy0, ix0 = iy0 % H, ix0 % W
    val = (tex[iy0, ix0] * (1 - fy) * (1 - fx) + tex[iy0, ix1] * (1 - fy) * fx
           + tex[iy1, ix0] * fy * (1 - fx) + tex[iy1, ix1] * fy * fx)
    return np.clip(val, 0, 255).astype(np.uint8)


def constraint_grid(scene: Scene, t: int, step: int, inner: float):
    """Constraints (N, 4) int32 x1 y1 x2 y2 of frame t: an object pixel
    every `step` px whose material radius² is below `inner`, to where its
    analytic flow moves it, rounded."""
    _, mask = scene.frame(t)
    ys, xs = np.mgrid[0:scene.H:step, 0:scene.W:step]
    rows = []
    for obj in scene.objects:
        cy, cx, ry, rx, _, _ = scene.geometry(obj, t)
        sel = ((((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < inner)
               & (mask[ys, xs] == int(obj["id"])))
        y, x = ys[sel].astype(np.float64), xs[sel].astype(np.float64)
        u, v = scene.flow(obj, t, y, x)
        rows.append(np.stack([x, y, np.round(x + u), np.round(y + v)], 1))
    return np.concatenate(rows).astype(np.int32)
