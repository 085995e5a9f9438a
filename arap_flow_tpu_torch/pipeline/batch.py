"""Bucketed batch execution of (frame, segment) ARAP problems
(pipeline/batch.py of the JAX package).

Each segment is cropped to a tight bucket-aligned solve box plus a larger
displacement-padded canvas box for rasterization (``make_task``). Tasks
group by their (solve, canvas, orientation) bucket; ``BatchRunner`` solves a
group as one batched call (``models.arap.solve_and_raster_canvas``: one PCG
kernel launch per GN step for the whole chunk). A chunk is enqueued on the
device the moment it fills, so the card works while the host prepares later
tasks; ``collect`` copies the products back and pastes them into full-frame
arrays. Each dispatched chunk records an event after its last launch, and
its copy runs on a side stream that waits on that event alone
(``utils.transfer``), so collecting chunk k−1 does not wait for work queued
after it; pastes run on one worker thread, overlapped with the next copy.
Segments too large for any bucket fall back to a full-frame solve;
``run_tasks`` runs a list of tasks and fallbacks in one call. With a device
mesh (``parallel.make_mesh``) each chunk is split over its 'data' axis.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..io.constraints import add_border_pins
from ..models.arap import (
    CROP_BUCKETS as DEFAULT_BUCKETS,
    FLOW_I16_SCALE,
    DeformResult,
    _solve_and_raster,
    pick_bucket,
    place_span,
    solve_and_raster_canvas,
)
from ..ops import energy as E
from ..ops.solver import SolverConfig
from ..utils import transfer
from ..utils import profiling

# Device bytes of one problem in the PCG kernel call: b, pre, δ and the r, p,
# Ap scratch (3 planes each), s, c, fit (1 each) and vm (4), all float32.
_KERNEL_PLANES = 25
# Device memory a chunk's kernel state may take: 4 GiB of the card's 80 GB,
# leaving the rest to the GN step's torch temporaries and the rasterizer.
_CHUNK_BUDGET = 4 * 2 ** 30
MAX_CHUNK = 24
# The buckets ``para_gen --warmup`` runs ahead of the first pair (the JAX
# package's PREWARM_BUCKETS): the common mid-size shapes of the 31-shape
# ladder.
PREWARM_BUCKETS: tuple = (
    (128, 256), (160, 256), (192, 256), (128, 384), (160, 384), (192, 384),
    (208, 384), (224, 384), (256, 384), (256, 512), (320, 512), (384, 640),
    (512, 896),
)


def max_chunk_for(bucket: tuple, n_data: int = 1) -> int:
    """Largest chunk of this bucket shape whose PCG kernel state fits the
    chunk budget, capped at MAX_CHUNK. The budget is per device, so a chunk
    split over `n_data` devices (``--mode sharded``) is `n_data` times as
    large."""
    bh, bw = bucket
    per_problem = _KERNEL_PLANES * bh * bw * 4
    return n_data * max(1, min(MAX_CHUNK, _CHUNK_BUDGET // per_problem))


@dataclass
class SegmentTask:
    """One segment solve request: the tight SOLVE box (y0/x0/bucket) and the
    CANVAS box (cy0/cx0/canvas ⊇ solve box) where warped pixels land.
    `ops` is host-side CompactOperands; `rgb` the (3, h, w) uint8 crop.
    `transposed`: the operands hold the reflected problem (a wide object
    solved on a tall bucket)."""

    pair_idx: int
    seg_id: int
    frame_hw: tuple
    y0: int
    x0: int
    bucket: tuple
    cy0: int
    cx0: int
    canvas: tuple
    ops: E.CompactOperands
    rgb: np.ndarray
    transposed: bool = False


def make_task(
    pair_idx: int,
    seg_id: int,
    rgb: np.ndarray,
    arap_mask: np.ndarray,
    cons: np.ndarray,
    weights: E.ArapWeights,
    buckets=DEFAULT_BUCKETS,
    pin_border: bool = True,
    margin: int = 8,
    solve_margin: int = 2,
) -> SegmentTask | None:
    """Crop a segment problem into the smallest fitting solve/canvas bucket
    pair (None -> full-frame fallback). `margin` pads the canvas beyond the
    directional displacement bounds; `solve_margin` pads the solve box,
    where exactness needs only a 1-pixel excluded rim."""
    H, W = arap_mask.shape
    cons = np.asarray(cons, np.int32).reshape(-1, 4)
    if pin_border:
        cons = add_border_pins(cons, W, H)
    obj_y, obj_x = np.where(arap_mask == 0)
    if len(obj_y) == 0:
        return None
    bbox = (int(obj_y.min()), int(obj_y.max()),
            int(obj_x.min()), int(obj_x.max()))
    cbox = pick_bucket(arap_mask, cons, buckets, margin=margin, bbox=bbox)
    if cbox is None:
        return None
    cy0, cx0, ch, cw = cbox

    # tight solve box: object bbox + solve_margin, inside the canvas box
    ylo = max(bbox[0] - solve_margin, cy0)
    yhi = min(bbox[1] + 1 + solve_margin, cy0 + ch)
    xlo = max(bbox[2] - solve_margin, cx0)
    xhi = min(bbox[3] + 1 + solve_margin, cx0 + cw)
    hn, wn = yhi - ylo, xhi - xlo
    # smallest solve bucket over both orientations (a transposed bucket
    # (sh, sw) covers a canonical footprint (sw, sh))
    fits = [
        (sh * sw, sh, sw, False)
        for sh, sw in buckets
        if hn <= sh <= ch and wn <= sw <= cw
    ] + [
        (sh * sw, sw, sh, True)
        for sh, sw in buckets
        if wn <= sh <= cw and hn <= sw <= ch
    ]
    if not fits:
        bh, bw, transposed = ch, cw, False
    else:
        _, bh, bw, transposed = min(fits)
    y0 = min(max(place_span(ylo, yhi, bh, H), cy0), cy0 + ch - bh)
    x0 = min(max(place_span(xlo, xhi, bw, W), cx0), cx0 + cw - bw)

    sub_mask = np.ascontiguousarray(arap_mask[y0 : y0 + bh, x0 : x0 + bw])
    sub_rgb = np.ascontiguousarray(rgb[y0 : y0 + bh, x0 : x0 + bw])
    shifted = cons.copy()
    shifted[:, [0, 2]] -= x0
    shifted[:, [1, 3]] -= y0
    inside = (
        (shifted[:, 0] >= 0) & (shifted[:, 0] < bw)
        & (shifted[:, 1] >= 0) & (shifted[:, 1] < bh)
    )
    if transposed:
        # the solver-side problem is the transpose: swap x/y in mask + cons
        cons_t = shifted[inside][:, [1, 0, 3, 2]]
        ops = E.build_compact(np.ascontiguousarray(sub_mask.T), cons_t, weights)
    else:
        ops = E.build_compact(sub_mask, shifted[inside], weights)
    return SegmentTask(
        pair_idx=pair_idx, seg_id=seg_id, frame_hw=(H, W),
        y0=y0, x0=x0, bucket=(bh, bw), cy0=cy0, cx0=cx0, canvas=(ch, cw),
        ops=ops, rgb=np.ascontiguousarray(sub_rgb.transpose(2, 0, 1)),
        transposed=transposed,
    )


class BatchRunner:
    """Streaming bucketed execution on one device: ``add`` tasks as host prep
    produces them; a bucket's chunk is enqueued the moment it fills.
    ``finish`` enqueues the remainders at their real size, copies every
    product back and pastes it into full-frame arrays.

    With a `mesh` (``parallel.make_mesh``) each chunk holds
    ``max_chunk_for(bucket, n_data)`` tasks and is split over the mesh's
    'data' axis, each device solving its slice; the products gather on the
    mesh's first device. Full-frame fallbacks solve on `device`."""

    def __init__(self, cfg: SolverConfig, *, device, timer=None,
                 weights: E.ArapWeights = E.ArapWeights(), mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.timer = timer if timer is not None else profiling.TIMER
        self.weights = weights
        self.mesh = mesh
        self.n_data = 1 if mesh is None else mesh.shape["data"]
        self.buffers: dict[tuple, list[SegmentTask]] = {}
        self.pending: list = []
        self.out: dict[tuple, DeformResult] = {}

    def _dispatch(self, chunk_tasks: list[SegmentTask]) -> None:
        with self.timer.stage("upload+stack"):
            ops = E.CompactOperands.stack([t.ops for t in chunk_tasks])
            rgb = np.stack([t.rgb for t in chunk_tasks])
            if self.mesh is None:  # a mesh uploads each slice to its device
                ops = ops.to(self.device)
                rgb = transfer.upload(rgb, self.device)
            offs = np.asarray(
                [(t.y0 - t.cy0, t.x0 - t.cx0) for t in chunk_tasks], np.int32)
        with self.timer.stage("solve+raster dispatch"):
            flows, wrgbs, wmasks = solve_and_raster_canvas(
                ops, rgb, offs, self.cfg, canvas_hw=chunk_tasks[0].canvas,
                transposed=chunk_tasks[0].transposed, mesh=self.mesh,
            )
        self.pending.append((chunk_tasks, transfer.mark(flows.device), flows,
                             wrgbs, wmasks))

    def add(self, task: SegmentTask) -> None:
        key = (task.bucket, task.canvas, task.transposed)
        buf = self.buffers.setdefault(key, [])
        buf.append(task)
        step = max_chunk_for(task.bucket, self.n_data)
        if len(buf) >= step:
            self._dispatch(buf[:step])
            del buf[:step]

    def add_fallback(self, pair_idx, seg_id, rgb, arap_mask, cons,
                     pin_border: bool = True) -> None:
        """Full-frame solve of one segment (enqueued; fetched in collect).
        Pins the image border itself unless `pin_border` is False."""
        arap_mask = np.asarray(arap_mask)
        if pin_border:
            H, W = arap_mask.shape
            cons = add_border_pins(np.asarray(cons, np.int32).reshape(-1, 4),
                                   W, H)
        ops = E.build_compact(arap_mask, cons, self.weights).to(self.device)
        rgb_u8 = transfer.upload(np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                                 self.device)
        _, flow, wrgb, wmask = _solve_and_raster(ops, rgb_u8, self.cfg)
        self.pending.append(((pair_idx, seg_id), transfer.mark(self.device),
                             flow, wrgb, wmask))

    def flush(self) -> None:
        """Enqueue every buffered remainder without fetching."""
        for buf in self.buffers.values():
            if buf:
                self._dispatch(list(buf))
        self.buffers.clear()

    def finish(self) -> dict[tuple, DeformResult]:
        self.flush()
        return self.collect()

    def _paste_chunk(self, group, flows, wrgbs, wmasks) -> None:
        """Paste one fetched chunk into full-frame arrays (host numpy); i16
        fixed-point flow decodes here (FLOW_I16_SCALE is a power of two, so
        the reciprocal multiply is exact)."""
        with self.timer.stage("host paste"):
            fl = flows.transpose(0, 2, 3, 1)
            if fl.dtype == np.int16:
                fl = fl.astype(np.float32)
                fl *= np.float32(1.0 / FLOW_I16_SCALE)
            else:
                fl = np.ascontiguousarray(fl, np.float32)
            rg = np.ascontiguousarray(wrgbs.transpose(0, 2, 3, 1))
            for i, t in enumerate(group):
                H, W = t.frame_hw
                bh, bw = t.bucket
                ch, cw = t.canvas
                flow = np.zeros((H, W, 2), np.float32)
                flow[t.y0 : t.y0 + bh, t.x0 : t.x0 + bw] = fl[i]
                rgb = np.zeros((H, W, 3), np.uint8)
                rgb[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = rg[i]
                mask = np.zeros((H, W), np.uint8)
                mask[t.cy0 : t.cy0 + ch, t.cx0 : t.cx0 + cw] = wmasks[i]
                self.out[(t.pair_idx, t.seg_id)] = DeformResult(
                    flow=flow, warped_rgb=rgb, warped_mask=mask)

    def _assemble(self, key, flow, wrgb, wmask) -> None:
        """A fetched full-frame fallback's products."""
        self.out[key] = DeformResult(flow=flow.transpose(1, 2, 0),
                                     warped_rgb=wrgb.transpose(1, 2, 0),
                                     warped_mask=wmask)

    def collect(self) -> dict[tuple, DeformResult]:
        """Copy every enqueued chunk back (each copy waits for its own chunk
        on the device) and paste it into full-frame arrays. The pastes run
        on one worker thread, overlapped with the next chunk's copy; only
        the worker writes ``self.out``, which is read after they join. The
        worker's spans take the caller's ids."""
        ids = self.timer.scope_ids()
        with ThreadPoolExecutor(1) as ex:
            futs = []
            for group, ready, flows, wrgbs, wmasks in self.pending:
                with self.timer.stage("D2H fetch"):
                    f_np, r_np, m_np = transfer.fetch((flows, wrgbs, wmasks),
                                                      ready)
                paste = (self._assemble if isinstance(group, tuple)
                         else self._paste_chunk)  # tuple: a fallback's key
                futs.append(ex.submit(self.timer.in_scope, ids, paste, group,
                                      f_np, r_np, m_np))
            for f in futs:
                f.result()  # join, and raise a paste's exception here
        self.pending.clear()
        return self.out


def run_tasks(tasks: list[SegmentTask], fallbacks: list[tuple],
              cfg: SolverConfig, *, device, timer=None, mesh=None,
              weights: E.ArapWeights = E.ArapWeights()
              ) -> dict[tuple, DeformResult]:
    """Run bucketed tasks (batched per bucket) and full-frame fallbacks in one
    call. `fallbacks`: (pair_idx, seg_id, rgb, arap_mask, cons) tuples;
    `weights` applies to the fallback solves (bucketed tasks carry theirs
    from make_task); `mesh` splits each chunk over its 'data' axis. Returns
    {(pair_idx, seg_id): DeformResult} with full-frame arrays."""
    runner = BatchRunner(cfg, device=device, timer=timer, weights=weights,
                         mesh=mesh)
    for t in tasks:
        runner.add(t)
    for pair_idx, seg_id, rgb, arap_mask, cons in fallbacks:
        runner.add_fallback(pair_idx, seg_id, rgb, arap_mask, cons)
    return runner.finish()
