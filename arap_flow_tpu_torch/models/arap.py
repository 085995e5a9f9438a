"""High-level ARAP deformation model (models/arap.py of the JAX package).

load image/mask/constraints -> pin the border -> solve the annealed GN/PCG
schedule -> rasterize the warped image and mask -> emit flow. Simple mode
solves the full frame; crop mode solves on a tight bucket around the object
and rasterizes on a wider canvas (the batched pipeline's path, with B = 1).
Excluded pixels are inert in the energy, so a crop holding the object and a
1-pixel rim gives the full frame's linear systems.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..io.constraints import add_border_pins
from ..ops import energy as E
from ..ops import rasterize as R
from ..ops import solver as S
from ..ops.solver import SolverConfig


@dataclass
class DeformResult:
    """Products of one ARAP deformation solve (one frame pair / segment)."""

    flow: np.ndarray  # (H, W, 2) float32, u/v
    warped_rgb: np.ndarray  # (H, W, 3) uint8
    warped_mask: np.ndarray  # (H, W) uint8, 255 = covered
    state: np.ndarray | None = None  # (3, H, W) warp positions + angle


def _expand(ops):
    """Compact operands (tensor leaves) expand on their device; full
    operands pass through."""
    if isinstance(ops, E.CompactOperands):
        return E.expand_operands(ops)
    return ops


def _to_f32(rgb: torch.Tensor) -> torch.Tensor:
    return rgb if rgb.dtype == torch.float32 else rgb.to(torch.float32)


def _solve_and_raster(ops, rgb: torch.Tensor, cfg: SolverConfig):
    """One unbatched problem: (state, flow, warped rgb u8, warped mask u8),
    tensors on the operands' device."""
    ops = _expand(ops)
    x = S.anneal_solve(ops, cfg)
    flow = S.flow_from_state(x, ops)
    wrgb, wmask = R.rasterize_replayed(x[:2], _to_f32(rgb), 1.0 - ops.mask)
    return x, flow, wrgb.to(torch.uint8), wmask.to(torch.uint8)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# Fixed crop bucket shapes (rows, cols), copied from the JAX package, where
# widths were chosen for the TPU's 128-lane tiles; they stay until H100 data
# says otherwise.
CROP_BUCKETS: tuple = (
    (64, 128), (96, 128), (128, 128), (160, 128), (192, 128), (224, 128),
    (256, 128), (288, 128), (320, 128), (384, 128), (448, 128), (512, 128),
    (96, 256), (128, 256), (160, 256), (192, 256), (224, 256), (256, 256),
    (320, 256), (384, 256), (128, 384), (160, 384), (192, 384), (208, 384),
    (224, 384), (256, 384), (288, 384), (256, 512), (320, 512), (384, 640),
    (512, 896),
)


def directional_pads(
    cons: np.ndarray, margin: int = 8
) -> tuple[int, int, int, int]:
    """Per-side crop margins (top, bottom, left, right) from the actual
    constraint displacements."""
    if len(cons) == 0:
        return margin, margin, margin, margin
    d = cons[:, 2:4].astype(np.int64) - cons[:, 0:2]
    return (
        margin + int(max(0, -d[:, 1].min())),
        margin + int(max(0, d[:, 1].max())),
        margin + int(max(0, -d[:, 0].min())),
        margin + int(max(0, d[:, 0].max())),
    )


def place_span(lo: int, hi: int, size: int, limit: int) -> int:
    """Start of a `size`-long window covering [lo, hi) inside [0, limit),
    surplus split evenly."""
    start = lo - (size - (hi - lo)) // 2
    return min(max(start, 0), limit - size)


def pick_bucket(
    arap_mask: np.ndarray, cons: np.ndarray, buckets: tuple = CROP_BUCKETS,
    margin: int = 8, bbox: tuple | None = None,
) -> tuple | None:
    """Smallest fixed bucket covering the object bbox + directional
    displacement margins, placed inside the frame: (y0, x0, h, w), or None
    when no bucket fits. `bbox` (ymin, ymax, xmin, xmax) skips the scan."""
    H, W = arap_mask.shape
    if bbox is None:
        ys, xs = np.where(arap_mask == 0)
        if len(ys) == 0:
            return None
        bbox = int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max())
    ymin, ymax, xmin, xmax = bbox
    pt, pb, pl, pr = directional_pads(cons, margin)
    ylo, yhi = ymin - pt, ymax + 1 + pb
    xlo, xhi = xmin - pl, xmax + 1 + pr
    fit = [
        (bh * bw, bh, bw)
        for bh, bw in buckets
        if yhi - ylo <= bh <= H and xhi - xlo <= bw <= W
    ]
    if not fit:
        return None
    _, bh, bw = min(fit)
    return place_span(ylo, yhi, bh, H), place_span(xlo, xhi, bw, W), bh, bw


def crop_box(
    arap_mask: np.ndarray,
    constraints: np.ndarray,
    margin: int = 8,
    h_mult: int = 64,
    w_mult: int = 128,
    extra: int = 0,
) -> tuple[int, int, int, int]:
    """Tight solve window (y0, x0, h, w) around the object, aligned to
    h_mult × w_mult and widened by `extra`."""
    H, W = arap_mask.shape
    ys, xs = np.where(arap_mask == 0)
    if len(ys) == 0:
        return 0, 0, H, W
    pad = margin + extra
    y0 = max(0, int(ys.min()) - pad)
    y1 = min(H, int(ys.max()) + 1 + pad)
    x0 = max(0, int(xs.min()) - pad)
    x1 = min(W, int(xs.max()) + 1 + pad)
    h = min(H, int(np.ceil((y1 - y0) / h_mult)) * h_mult)
    w = min(W, int(np.ceil((x1 - x0) / w_mult)) * w_mult)
    y0 = max(0, min(y0 - (h - (y1 - y0)) // 2, H - h))
    x0 = max(0, min(x0 - (w - (x1 - x0)) // 2, W - w))
    return y0, x0, h, w


class ArapDeformer:
    """Reusable deformation solver on one device.

    `crop` solves on the object's bucket (``pipeline.batch.make_task``) and
    rasterizes on its canvas; `keep_state` returns the solver state and needs
    crop=False. `raster` is "device" (the seed-and-gather rasterizer, on the
    solve's device) or "host" (the reference-exact C++ splat of the native
    library, ``native.runtime.rasterize_warp``, from the solved flow; the
    device products are then not copied back).
    """

    def __init__(
        self,
        cfg: SolverConfig = SolverConfig(),
        weights: E.ArapWeights = E.ArapWeights(),
        pin_border: bool = True,
        keep_state: bool = False,
        crop: bool = False,
        crop_buckets: tuple = CROP_BUCKETS,
        raster: str = "device",
        *,
        device,
    ):
        if keep_state and crop:
            raise ValueError(
                "keep_state=True requires crop=False (the bucketed canvas "
                "path does not return the solver state)"
            )
        if raster not in ("device", "host"):
            raise ValueError(f"unknown raster {raster!r}")
        self.cfg = cfg
        self.weights = weights
        self.pin_border = pin_border
        self.keep_state = keep_state
        self.crop = crop
        self.crop_buckets = crop_buckets
        self.raster = raster
        self.device = torch.device(device)

    def deform(self, rgb: np.ndarray, arap_mask: np.ndarray,
               constraints: np.ndarray) -> DeformResult:
        """Solve one frame: rgb (H,W,3) u8, arap_mask (H,W) (0 = object),
        constraints (N,4) [x1 y1 x2 y2] without border pins (added here)."""
        H, W = arap_mask.shape[:2]
        cons = np.asarray(constraints, np.int32).reshape(-1, 4)
        if self.pin_border:
            cons = add_border_pins(cons, W, H)
        fetch = self.raster == "device"
        if self.crop:
            res = self._deform_cropped(rgb, arap_mask, cons, fetch)
        else:
            res = self._deform_full(rgb, arap_mask, cons, self.keep_state,
                                    fetch)
        return res if fetch else self._host_raster(res, rgb, arap_mask)

    @staticmethod
    def _host_raster(res: DeformResult, rgb, arap_mask) -> DeformResult:
        """The products of the reference-exact host splat of the solved flow
        (warp = flow + grid), in place of the device raster's."""
        from ..native.host_raster import warp_from_flow
        from ..native.runtime import rasterize_warp

        wrgb, wmask = rasterize_warp(warp_from_flow(res.flow),
                                     np.asarray(rgb, np.uint8),
                                     np.asarray(arap_mask))
        return DeformResult(flow=res.flow, warped_rgb=wrgb, warped_mask=wmask,
                            state=res.state)

    def _deform_full(self, rgb, arap_mask, cons, keep_state: bool,
                     fetch_raster: bool = True):
        ops = E.build_compact(np.asarray(arap_mask), cons, self.weights)
        rgb_u8 = torch.as_tensor(np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                                 device=self.device)
        x, flow, wrgb, wmask = _solve_and_raster(ops.to(self.device), rgb_u8,
                                                 self.cfg)
        return DeformResult(
            flow=_numpy(flow).transpose(1, 2, 0),
            warped_rgb=_numpy(wrgb).transpose(1, 2, 0) if fetch_raster else None,
            warped_mask=_numpy(wmask) if fetch_raster else None,
            state=_numpy(x) if keep_state else None,
        )

    def _deform_cropped(self, rgb, arap_mask, cons,
                        fetch_raster: bool = True) -> DeformResult:
        """Solve on the object's tight bucket, rasterize on its canvas, paste
        the products into full-frame arrays. `fetch_raster` False (the host
        splat's callers) copies back the flow only."""
        from ..pipeline.batch import make_task

        H, W = arap_mask.shape[:2]
        t = make_task(0, 0, rgb, arap_mask, cons, self.weights,
                      buckets=self.crop_buckets, pin_border=False)
        if t is None:  # no bucket fits: full-frame solve
            return self._deform_full(rgb, arap_mask, cons, False, fetch_raster)
        ops = E.CompactOperands.stack([t.ops]).to(self.device)
        offs = np.asarray([[t.y0 - t.cy0, t.x0 - t.cx0]], np.int32)
        flows, wrgbs, wmasks = solve_and_raster_canvas(
            ops, torch.as_tensor(t.rgb[None], device=self.device), offs,
            self.cfg, canvas_hw=t.canvas, compact_flow=False,
            transposed=t.transposed,
        )
        bh, bw = t.bucket
        ch, cw = t.canvas
        full_flow = np.zeros((H, W, 2), np.float32)
        full_flow[t.y0 : t.y0 + bh, t.x0 : t.x0 + bw] = (
            _numpy(flows[0]).transpose(1, 2, 0))
        if not fetch_raster:
            return DeformResult(flow=full_flow, warped_rgb=None,
                                warped_mask=None)
        full_rgb = np.zeros((H, W, 3), np.uint8)
        full_rgb[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = (
            _numpy(wrgbs[0]).transpose(1, 2, 0))
        full_mask = np.zeros((H, W), np.uint8)
        full_mask[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = _numpy(wmasks[0])
        return DeformResult(flow=full_flow, warped_rgb=full_rgb,
                            warped_mask=full_mask)

    def solve_flow(self, arap_mask: np.ndarray,
                   constraints: np.ndarray) -> np.ndarray:
        """Flow-only solve (no rasterization); returns (H, W, 2) float32."""
        H, W = arap_mask.shape[:2]
        cons = np.asarray(constraints, np.int32).reshape(-1, 4)
        if self.pin_border:
            cons = add_border_pins(cons, W, H)
        ops = E.build_operands(np.asarray(arap_mask), cons, self.weights,
                               device=self.device)
        _, flow = S.solve(ops, self.cfg)
        return _numpy(flow).transpose(1, 2, 0)


def deform(rgb: np.ndarray, arap_mask: np.ndarray, constraints: np.ndarray,
           cfg: SolverConfig = SolverConfig(),
           weights: E.ArapWeights = E.ArapWeights(), *,
           device) -> DeformResult:
    """One-shot functional API over ArapDeformer."""
    return ArapDeformer(cfg, weights, device=device).deform(
        rgb, arap_mask, constraints)


FLOW_I16_SCALE = 64.0  # 1/64 px quantum, ±512 px range


def _quantize_flow(flows: torch.Tensor) -> torch.Tensor:
    """i16 fixed-point flow (1/64 px, round half to even): half the bytes of
    the largest product plane; dequantized on the host (pipeline/batch.py)."""
    return torch.clamp(torch.round(flows * FLOW_I16_SCALE), -32768, 32767).to(
        torch.int16)


def solve_and_raster_canvas(ops_batched, rgb_batched: torch.Tensor, offs,
                            cfg: SolverConfig, canvas_hw: tuple,
                            compact_flow: bool = True,
                            transposed: bool = False, mesh=None):
    """Batched tight-bucket solve + canvas raster.

    ops_batched: batched operands on the device (CompactOperands with tensor
    leaves, or ArapOperands); rgb_batched (B, 3, h, w) u8 or f32 on the same
    device; offs (B, 2) host ints, (dy, dx) of each solve box inside its
    canvas box. The B problems solve together (one PCG kernel call per GN
    step); each is then placed on its canvas and rasterized. Returns (flows
    (B,2,hs,ws), wrgbs (B,3,Hc,Wc) u8, wmasks (B,Hc,Wc) u8); flows are i16
    fixed point when `compact_flow`.

    `transposed`: the operands hold the reflected problem (x/y swapped, a
    wide object solved on a tall bucket); the state is transposed back (u/v
    swapped, the angle negated) before rasterization, so flow, raster and
    paste stay canonical. rgb is canonical.

    `mesh` (``parallel.make_mesh``) splits the batch over its 'data' axis:
    each device solves and rasterizes its slice and the products are
    gathered on the mesh's first device (``parallel.mesh.data_sharded``);
    the operands and rgb may then be host numpy (each slice is uploaded to
    its device)."""
    if mesh is not None:
        from ..parallel.mesh import data_sharded

        return data_sharded(
            mesh, lambda o, r, f: solve_and_raster_canvas(
                o, r, f, cfg, canvas_hw, compact_flow, transposed),
            ops_batched, torch.as_tensor(rgb_batched), np.asarray(offs))
    o = _expand(ops_batched)
    x = S.anneal_solve(o, cfg)
    mask, grid = o.mask, o.grid
    if transposed:
        x = torch.stack([x[:, 1].mT, x[:, 0].mT, -x[:, 2].mT], dim=1)
        mask = mask.mT
        grid = torch.stack([grid[:, 1].mT, grid[:, 0].mT], dim=1)
    flows = x[:, :2] - grid
    Hc, Wc = canvas_hw
    hs, ws = x.shape[-2:]
    offs = np.asarray(offs, np.int64).reshape(-1, 2)
    wrgbs, wmasks = [], []
    for k in range(x.shape[0]):
        dy, dx = int(offs[k, 0]), int(offs[k, 1])
        # canvas-absolute warped positions (scalar adds: an uploaded
        # offset would wait for the solve queued before it)
        warp = torch.stack((x[k, 0] + dx, x[k, 1] + dy))
        # placement start clamped into the canvas, as a dynamic_update_slice
        py, px = min(max(dy, 0), Hc - hs), min(max(dx, 0), Wc - ws)
        box = (slice(py, py + hs), slice(px, px + ws))
        warp_c = torch.zeros((2, Hc, Wc), dtype=x.dtype, device=x.device)
        warp_c[(slice(None), *box)] = warp
        # the canvas outside the solve box is excluded, so no quad draws there
        mask_c = torch.ones((Hc, Wc), dtype=x.dtype, device=x.device)
        mask_c[box] = 1.0 - mask[k]
        rgb_c = torch.zeros((3, Hc, Wc), dtype=torch.float32, device=x.device)
        rgb_c[(slice(None), *box)] = _to_f32(rgb_batched[k])
        wrgb, wmask = R.rasterize_replayed(warp_c, rgb_c, mask_c)
        wrgbs.append(wrgb.to(torch.uint8))
        wmasks.append(wmask.to(torch.uint8))
    if compact_flow:
        flows = _quantize_flow(flows)
    return flows, torch.stack(wrgbs), torch.stack(wmasks)


def solve_and_raster_batch(ops_batched, rgb_batched: torch.Tensor,
                           cfg: SolverConfig, compact_flow: bool = False,
                           mesh=None):
    """Batched solve + rasterize of same-shape problems. ops_batched: batched
    operands on the device; rgb_batched (B, 3, H, W). Returns (x, flow, wrgb
    u8, wmask u8) batched, flow as i16 fixed point when `compact_flow`.
    `mesh` splits the batch over its 'data' axis, as in
    ``solve_and_raster_canvas``."""
    if mesh is not None:
        from ..parallel.mesh import data_sharded

        return data_sharded(
            mesh, lambda o, r: solve_and_raster_batch(o, r, cfg,
                                                      compact_flow),
            ops_batched, torch.as_tensor(rgb_batched))
    o = _expand(ops_batched)
    x = S.anneal_solve(o, cfg)
    flows = S.flow_from_state(x, o)
    wrgbs, wmasks = [], []
    for k in range(x.shape[0]):
        wrgb, wmask = R.rasterize_replayed(x[k, :2], _to_f32(rgb_batched[k]),
                                           1.0 - o.mask[k])
        wrgbs.append(wrgb.to(torch.uint8))
        wmasks.append(wmask.to(torch.uint8))
    if compact_flow:
        flows = _quantize_flow(flows)
    return x, flows, torch.stack(wrgbs), torch.stack(wmasks)
