"""Dataset generation entry point (pipeline/para_gen.py of the JAX package).

Scans an input tree for frame pairs at distance --fd, preprocesses them,
finds sparse correspondences with the ZNCC pyramid matcher
(``ops.matching``) or an external matcher binary, filters them to
segment-consistent short-displacement constraints, composites random
backgrounds, ARAP-solves each (frame, segment), composes the per-segment
products and writes Flow/.flo, the warped RGB/mask trees and
``all_files.list``.

    python -m arap_flow_tpu_torch para_gen --input ROOT --output OUT \\
        --mode batched --multseg --device cuda

Input layout: ROOT/orgRGB/SEQ/<n>.{jpg,png} frames and ROOT/orgMasks/SEQ/
<n>.png annotation masks (0 = background, nonzero = segment id). None of it
needs PIL: PNG and baseline JPEG go through the port's codecs
(``io.image``), and --size and --bg_dir resize with PIL-exact resamplers
(``io.resize``: the LANCZOS in the native host library).

Modes: ``simple`` solves pair by pair, with the next pair's host and
matcher prep on a worker thread; ``batched`` decodes a chunk of 2·--narap
pairs, matches same-shaped pairs together (sub-batches of up to
MATCH_SUBBATCH pairs, one zncc_search call per search level for the whole
sub-batch) and solves the chunk's segments bucketed by shape
(``pipeline.batch.BatchRunner``), retrying a failed chunk pair by pair. The
batched loop is the JAX package's depth-2 pipeline: a half-size first
chunk; chunk k+1's matcher enqueued on the main thread before chunk k's
solves; chunk k+1's fetch, filter, backgrounds and bucketing on one worker
thread (one worker keeps the background draws in order); chunk k−1
collected and written while chunk k solves. Products are written by the
native threaded writer (``native.runtime.AsyncWriter``), unless
``FrameworkConfig.async_io`` (``ARAP_ASYNC_IO=0``) turns it off.

``--warmup`` (and ``--exec_pack``, accepted for CLI parity) runs
``prewarm`` before the first pair: every library built and loaded, one
dummy solve per common bucket (every one of the 31 crop buckets under
``ARAP_WARMUP_FULL=1``), one matcher call at the ``--size`` frame.

``--mode sharded`` is the batched loop with each solve chunk split over a
device mesh (``parallel.make_mesh``: every visible CUDA device, or the CPU
under ``--device cpu``), ``max(2·--narap, 2·devices)`` pairs a chunk; on one
card it is the batched path.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import os.path as osp
import re
import subprocess
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..io import flo
from ..io.constraints import filter_matches, read_matches, write_constraint_file
from ..io.image import (load_mask, load_rgb, mask_to_arap, png_encode,
                        save_image, segment_mask_to_arap)
from ..io.resize import (resize_lanczos, resize_lanczos_window,
                         resize_nearest)
from ..models.arap import CROP_BUCKETS, ArapDeformer
from ..ops.solver import SolverConfig
from ..utils.config import FrameworkConfig, cli_device
from ..utils import profiling

log = logging.getLogger("arap_flow_tpu_torch.para_gen")

# the process's stage timer (profiling.TIMER): para_gen's stages, and those
# of ops/ and BatchRunner beneath them
TIMER = profiling.TIMER

# (pairs in the chunk, seconds, end time) of each chunk the batched loop of
# the last main_pipeline call collected: the loop's iteration that
# collected it, from the next chunk's matcher enqueue to its products
# written, so seconds over pairs is the loop's seconds a pair, not a pair's
# latency from submit to write. The end time (time.time()) places each
# chunk in the run (tools/endurance.py).
CHUNK_STATS: list = []

# pairs per matcher call in batched mode (ARAP_MATCH_SUBBATCH, read at
# import)
MATCH_SUBBATCH = int(os.environ.get("ARAP_MATCH_SUBBATCH", "4"))

# directory names of the reference's para_gen.py:18-26
ORGCOLOR = "orgRGB"
ORGMASK = "orgMasks"
COLOR_DIR = "inpRGB"
MASK_DIR = "inpMasks"
CNSTR_DIR = "tmpCnstr"
FLOW_DIR = "Flow"
WRGB_DIR = "wRGB"
WMASK_DIR = "wMasks"

# what a broken input file raises while it is decoded (and a failed
# external matcher: ChildProcessError is an OSError)
_DECODE_ERRORS = (OSError, ValueError, zlib.error)

# failed asynchronous product writes of the last main_pipeline call
WRITE_ERRORS = 0


@dataclass
class PairPaths:
    """All generated and original paths of one frame pair."""

    rgb1_gen: str
    msk1_gen: str
    rgb2_gen: str
    msk2_gen: str
    cstr_tmp: str
    flow_gen: str
    rgb1_org: str
    msk1_org: str
    rgb2_org: str
    msk2_org: str


@dataclass
class PipelineFlags:
    input: str
    output: str
    bg_dir: str | None = None
    gpu: list = field(default_factory=lambda: [0])  # accepted for CLI parity
    multseg: bool = False
    resume: bool = False
    narap: int = 2  # chunk = 2 × narap pairs in batched mode
    size: tuple | None = None  # (w, h) to resize and centre-crop to
    fd: int = 1
    matcher: str = "native"  # native | binary | file
    dm_bin: str | None = None
    schedule: str = "parity"  # parity | fast
    seed: int | None = None
    mode: str = "simple"  # simple | batched | sharded
    warmup: bool = False  # prewarm before the first pair
    shard: tuple | None = None  # (i, n): this host takes pairs i, i+n, ...
    match_downscale: int = 1  # match on a 2^k-pooled image
    # "count" skips pairs with <= 10 object pixels; "refsum" replicates the
    # reference's mask.sum() > 10 over pixel values (para_gen.py:251)
    mask_gate: str = "count"
    device: str = "cuda"


def scale_rotate(im: np.ndarray, mk: np.ndarray, size):
    """Preprocessing (the reference's para_gen.py:253-291): transpose
    portrait frames, then resize (+10 px slack; LANCZOS for the frame,
    NEAREST for the mask, both bitwise PIL's) and centre-crop to `size`
    (w, h). Returns (preprocessed, im, mk). The resize and crop of each
    frame is the stage ``preprocess resize``."""
    if im.shape[:2] != mk.shape[:2]:
        raise ValueError(
            f"Image and mask must be of the same size but given "
            f"{im.shape[1::-1]} vs {mk.shape[1::-1]}")
    preprocessed = False
    if im.shape[0] > im.shape[1]:
        im = np.ascontiguousarray(im.swapaxes(0, 1))
        mk = np.ascontiguousarray(mk.swapaxes(0, 1))
        preprocessed = True
    if size is not None and (im.shape[1], im.shape[0]) != tuple(size):
        r = max(float(size[0] + 10) / im.shape[1],
                float(size[1] + 10) / im.shape[0])
        w, h = (np.array([im.shape[1], im.shape[0]]) * r).astype(int)
        left = w // 2 - size[0] // 2
        upper = h // 2 - size[1] // 2
        # the +10 slack keeps the crop box inside the resized frame
        box = (slice(upper, upper + size[1]), slice(left, left + size[0]))
        with TIMER.stage("preprocess resize"):
            im = np.ascontiguousarray(resize_lanczos(im, (w, h))[box])
            mk = np.ascontiguousarray(resize_nearest(mk, (w, h))[box])
        preprocessed = True
    return preprocessed, im, mk


class BackgroundPool:
    """Random background images: scanned once, drawn without replacement
    until the pool refills; files that fail to decode are dropped
    (para_gen.py:365-375, 484-497). Draws use the numpy Generator `rng` in
    the JAX package's order, so a seed gives the same backgrounds. Fitting
    a background upscales it 1-2× with the PIL-exact LANCZOS and keeps a
    random crop of the frame's size; the crop's offsets depend only on the
    upscaled size, so they are drawn first and the native resample
    computes that window alone (``io.resize.resize_lanczos_window``, about
    a tenth of the upscale at 1080p), with each output's coefficients
    taken from its index in the whole upscale: bitwise the crop of the
    whole, which PIL's ``resize(box=)`` is not. A draw from a pool that
    has files (decode, upscale and crop) is the stage ``background
    draw``."""

    def __init__(self, bg_dir, rng: np.random.Generator):
        self.rng = rng
        self.paths: list[str] = []
        if bg_dir and osp.isdir(bg_dir):
            for root, _, files in os.walk(bg_dir):
                for f in files:
                    up = f.upper()
                    if ".PNG" in up or ".JPG" in up or ".JPEG" in up:
                        self.paths.append(osp.join(root, f))
        self.tmp: list[str] = []

    def fit(self, bg: np.ndarray, shape) -> np.ndarray:
        """Random 1-2× upscale and random crop to `shape` (fit_bg,
        para_gen.py:36-48)."""
        imh, imw = shape[:2]
        bgh, bgw = bg.shape[:2]
        r = self.rng.uniform(1, 2) * max(
            float(max(bgh, imh)) / bgh, float(max(bgw, imw)) / bgw
        )
        w, h = int(bgw * r), int(bgh * r)
        sy = self.rng.integers(0, h - imh + 1)
        sx = self.rng.integers(0, w - imw + 1)
        return resize_lanczos_window(bg, (w, h), sy, sx, imh, imw)[..., :3]

    def draw(self, shape) -> np.ndarray | None:
        with (TIMER.stage("background draw") if self.paths
              else contextlib.nullcontext()):
            while self.paths:
                if not self.tmp:
                    self.tmp = sorted(self.paths)
                p = self.tmp[self.rng.integers(0, len(self.tmp))]
                self.tmp.remove(p)
                try:
                    bg = load_rgb(p)
                except _DECODE_ERRORS:
                    self.paths.remove(p)
                    continue
                return self.fit(bg, shape)
        return None


def add_bg(im: np.ndarray, mk: np.ndarray, bgim: np.ndarray, bgval=0):
    """Background compositing (add_bg, para_gen.py:50-61)."""
    if mk.shape != im.shape[:-1] or bgim.shape != im.shape:
        raise ValueError(f"add_bg: image {im.shape}, mask {mk.shape}, "
                         f"background {bgim.shape}")
    out = im.copy()
    idx = mk == bgval
    out[idx] = bgim[idx]
    return out


def scan_pairs(flags: PipelineFlags) -> list[PairPaths]:
    """Input-tree scan with frame-distance pairing (para_gen.py:384-434):
    frames matched by the trailing number of ``(\\d+).(jpe?g|png)``
    (case-insensitive), masks as .png; a pair is skipped when frame t+fd or
    either mask is missing; --resume skips pairs whose .flo exists."""
    rgb_org = osp.join(flags.input, ORGCOLOR)
    msk_org = osp.join(flags.input, ORGMASK)
    out = flags.output
    reg = re.compile(r"(\d+)\.(jpe?g|png)", flags=re.IGNORECASE)

    pairs: list[PairPaths] = []
    for root, dirs, _ in os.walk(rgb_org):
        for d in sorted(dirs):
            folder = osp.join(root, d)
            files = sorted(
                f for f in os.listdir(folder) if reg.search(f) is not None
            )
            for f1 in files:
                seq = osp.join(root.replace(rgb_org, "").strip(osp.sep), d)
                f, ext = osp.splitext(f1)
                if not osp.exists(osp.join(msk_org, seq, f + ".png")):
                    continue
                num = reg.search(f1)
                n = "{:0" + str(len(num.group(1))) + "d}"
                nxt = int(num.group(1)) + flags.fd
                # substitute only the matched digit run: str.replace would
                # also rewrite an earlier occurrence of the same digits
                a, b = num.span(1)
                f2 = f[:a] + n.format(nxt) + f[b:]
                if not osp.exists(osp.join(rgb_org, seq, f2 + ext)) or not osp.exists(
                    osp.join(msk_org, seq, f2 + ".png")
                ):
                    continue
                pp = PairPaths(
                    rgb1_gen=osp.abspath(osp.join(out, COLOR_DIR, seq, f + ".png")),
                    msk1_gen=osp.abspath(osp.join(out, MASK_DIR, seq, f + ".png")),
                    rgb2_gen=osp.abspath(osp.join(out, WRGB_DIR, seq, f + ".png")),
                    msk2_gen=osp.abspath(osp.join(out, WMASK_DIR, seq, f + ".png")),
                    cstr_tmp=osp.abspath(osp.join(out, CNSTR_DIR, seq, f + ".txt")),
                    flow_gen=osp.abspath(osp.join(out, FLOW_DIR, seq, f + ".flo")),
                    rgb1_org=osp.abspath(osp.join(rgb_org, seq, f1)),
                    msk1_org=osp.abspath(osp.join(msk_org, seq, f + ".png")),
                    rgb2_org=osp.abspath(osp.join(rgb_org, seq, f2 + ext)),
                    msk2_org=osp.abspath(osp.join(msk_org, seq, f2 + ".png")),
                )
                if not flags.resume or not osp.exists(pp.flow_gen):
                    pairs.append(pp)
    if flags.shard is not None:
        # host i of n takes every n-th pair of the sorted scan
        i, n = flags.shard
        if not 0 <= i < n:
            raise ValueError(f"--shard {i}/{n}")
        pairs = pairs[i::n]
    return pairs


def run_matching(flags: PipelineFlags, p: PairPaths, rgb1, rgb2,
                 src_paths=None, roi_mask=None) -> np.ndarray:
    """Raw matches (N, 4+) of a pair: the native matcher on flags.device,
    the external matcher binary (--matcher binary), or the pair's cached
    matcher file (--matcher file).

    The binary is run as the reference runs DeepMatching (para_gen.py:
    227-240): ``DM src1 src2 -nt 0 -out CSTR -ngh_rad 100``, through the
    shell, on `src_paths` — the saved preprocessed frames when --size or a
    transpose changed them, so its matches are in preprocessed coordinates
    — else the original files. A non-zero exit raises ChildProcessError,
    which fails the pair."""
    if flags.matcher == "file":
        return read_matches(p.cstr_tmp)
    if flags.matcher == "binary":
        if not flags.dm_bin or not osp.exists(flags.dm_bin):
            raise FileNotFoundError(f"--dm_bin {flags.dm_bin!r}: file not found")
        src1, src2 = src_paths or (p.rgb1_org, p.rgb2_org)
        cmd = (f"{osp.abspath(flags.dm_bin)} {src1} {src2} -nt 0 "
               f"-out {p.cstr_tmp} -ngh_rad 100")
        status = subprocess.call(cmd, shell=True)
        if status != 0:
            raise ChildProcessError(f"matcher exited with code {status}: {cmd}")
        return read_matches(p.cstr_tmp)
    if flags.matcher != "native":
        raise ValueError(f"unknown --matcher {flags.matcher!r}")
    from ..ops.matching import match_images

    return match_images(
        rgb1, rgb2, radius=100, downscale=flags.match_downscale,
        roi_mask=roi_mask, device=torch.device(flags.device),
    )[:, :4].astype(np.int32)


def has_mask(msk1, msk2, gate: str = "count") -> bool:
    """Both masks must have enough object content (para_gen.py:243-251):
    more than 10 nonzero pixels ("count"), or the reference's sum of pixel
    values above 10 ("refsum")."""
    if gate == "refsum":
        return int(np.sum(msk1)) > 10 and int(np.sum(msk2)) > 10
    return int(np.sum(msk1 != 0)) > 10 and int(np.sum(msk2 != 0)) > 10


def _ensure_dirs(p: PairPaths):
    for path in vars(p).values():
        os.makedirs(osp.dirname(path), exist_ok=True)


@dataclass
class PairWork:
    """Host-side products of one pair's prep stage, awaiting solves."""

    p: PairPaths
    out1: np.ndarray  # frame 1 with the background composited
    bgim: np.ndarray | None
    segments: list  # [(seg_id, arap_mask (H, W) u8, constraints (N, 4))]
    pair: int = 0  # the pair's index in the job (its spans' pair id)


def decode_pair(flags: PipelineFlags, p: PairPaths):
    """Decode and preprocess one pair; returns (im1, mk1, im2, mk2,
    src_paths), or None when a mask is empty (has_mask). `src_paths` names
    the files the external matcher reads: with --matcher binary and
    preprocessed frames, the frames saved (port PNG codec) at rgb1_gen and
    rgb2_gen, as the JAX decode_pair does; else None (the originals)."""
    with TIMER.stage("decode+preprocess"):
        pre1, im1, mk1 = scale_rotate(load_rgb(p.rgb1_org),
                                      load_mask(p.msk1_org), flags.size)
        pre2, im2, mk2 = scale_rotate(load_rgb(p.rgb2_org),
                                      load_mask(p.msk2_org), flags.size)
    if not has_mask(mk1, mk2, flags.mask_gate):
        return None
    src_paths = None
    if flags.matcher == "binary" and (pre1 or pre2):
        save_image(p.rgb1_gen, im1)
        save_image(p.rgb2_gen, im2)
        src_paths = (p.rgb1_gen, p.rgb2_gen)
    return im1, mk1, im2, mk2, src_paths


def prep_pair(
    flags: PipelineFlags, p: PairPaths, bgpool: BackgroundPool,
    prematched: np.ndarray | None = None,
    decoded: tuple | None = None,
) -> PairWork | None:
    """Host and matcher stage of one pair: preprocessing, matching,
    filtering, background, per-segment masks and constraints. `decoded`
    reuses a decode_pair result, `prematched` a match result."""
    _ensure_dirs(p)
    if decoded is None:
        decoded = decode_pair(flags, p)
    if decoded is None:
        return None
    im1, mk1, im2, mk2, src_paths = decoded

    if prematched is not None:
        matches = prematched
    else:
        with TIMER.stage("matching"):
            matches = run_matching(flags, p, im1, im2, src_paths=src_paths,
                                   roi_mask=mk1)
    kept, seg_ids = filter_matches(matches, mk1, mk2)
    write_constraint_file(p.cstr_tmp, kept)
    if len(kept) == 0:
        return None

    with TIMER.stage("background+inputs-io"):
        bgim = bgpool.draw(im1.shape)
        out1 = add_bg(im1, mk1, bgim) if bgim is not None else im1
        save_image(p.rgb1_gen, out1)

    segments = []
    if not flags.multseg:
        arap_mask = mask_to_arap(mk1)
        save_image(p.msk1_gen, arap_mask)
        segments.append((0, arap_mask, kept))
    else:
        for s in np.unique(seg_ids):
            if s == 0:
                continue
            segments.append((int(s), segment_mask_to_arap(mk1, s),
                             kept[seg_ids == s]))
        if not segments:
            return None
        save_image(p.msk1_gen, mask_to_arap(mk1))
    return PairWork(p=p, out1=out1, bgim=bgim, segments=segments)


def finish_pair(work: PairWork, seg_results: list, writer=None) -> list[str]:
    """Compose the per-segment results (flatten, para_gen.py:151-164),
    re-apply the background to uncovered warped pixels and write the
    products, through `writer` (an AsyncWriter; the same bytes) when given.
    Returns the list triple [inpRGB, wRGB, flo]."""
    p = work.p
    flow = seg_results[0].flow.copy()
    wrgb = seg_results[0].warped_rgb.copy()
    wmask = seg_results[0].warped_mask.copy()
    for r in seg_results[1:]:
        ob = r.warped_mask != 0
        flow[ob] = r.flow[ob]
        wrgb[ob] = r.warped_rgb[ob]
        wmask[ob] = r.warped_mask[ob]
    if work.bgim is not None:
        wrgb = add_bg(wrgb, wmask, work.bgim)
    if writer is not None:
        writer.submit_flo(p.flow_gen, flow.astype(np.float32))
        writer.submit_bytes(p.rgb2_gen, png_encode(wrgb))
        writer.submit_bytes(p.msk2_gen, png_encode(wmask))
    else:
        flo.flow_write(p.flow_gen, flow.astype(np.float32))
        save_image(p.rgb2_gen, wrgb)
        save_image(p.msk2_gen, wmask)
    return [p.rgb1_gen, p.rgb2_gen, p.flow_gen]


def solve_pair(work: PairWork, deformer: ArapDeformer,
               writer=None) -> list[str]:
    """Solve a prepped pair's segments and write its products (simple
    mode); returns the list triple."""
    with TIMER.stage("solve+raster"):
        seg_results = [
            deformer.deform(work.out1, arap_mask, cons)
            for _, arap_mask, cons in work.segments
        ]
    with TIMER.stage("compose+outputs-io"):
        return finish_pair(work, seg_results, writer)



def prep_chunk_dispatch_match(flags: PipelineFlags, pairs, first: int = 0):
    """Decode a chunk's pairs and enqueue their matcher on the device
    without waiting for it. Same-shaped pairs go through one
    match_images_dispatch_multi call per sub-batch of up to MATCH_SUBBATCH
    pairs, at their real count. Returns [(pair, handle, decoded)], or None
    when the matcher is not native. `first` is the index of the chunk's
    first pair in the job (the spans' pair ids)."""
    if flags.matcher != "native":
        return None
    from ..ops.matching import match_images_dispatch_multi

    device = torch.device(flags.device)
    handles = []
    with TIMER.stage("match dispatch"):
        decoded = []
        for j, p in enumerate(pairs):
            try:
                _ensure_dirs(p)
                with TIMER.scope(pair=first + j):
                    d = decode_pair(flags, p)
            except _DECODE_ERRORS as e:
                log.warning("pair decode failed: %s (%s)", p.rgb1_org, e)
                continue
            if d is not None:
                decoded.append((p, d))
        groups: dict = {}
        for p, d in decoded:
            groups.setdefault(d[0].shape, []).append((p, d))
        for grp in groups.values():
            for i in range(0, len(grp), MATCH_SUBBATCH):
                sub = grp[i : i + MATCH_SUBBATCH]
                hs = match_images_dispatch_multi(
                    [(d[0], d[2]) for _, d in sub], radius=100,
                    downscale=flags.match_downscale, device=device)
                handles.extend((p, h, d) for (p, d), h in zip(sub, hs))
    return handles


def prep_chunk_finish(flags: PipelineFlags, pairs, handles, weights,
                      bgpool: BackgroundPool, first: int = 0):
    """Fetch a chunk's matches, then filter, composite backgrounds and crop
    each segment into its solve bucket. Returns (works, tasks, fallbacks)
    for dispatch_chunk_batched. `first` is as in
    prep_chunk_dispatch_match."""
    from ..ops.matching import match_images_fetch
    from .batch import make_task

    index = {id(p): first + j for j, p in enumerate(pairs)}
    prematched: dict = {}
    predecoded: dict = {}
    if handles is not None:
        with TIMER.stage("matching"):
            for p, h, d in handles:
                predecoded[id(p)] = d
                # selection restricted to the annotated objects: the
                # constraint filter drops off-object matches anyway
                with TIMER.scope(pair=index[id(p)]):
                    m = match_images_fetch(h, roi_mask=d[1])
                prematched[id(p)] = m[:, :4].astype(np.int32)

    works: list[PairWork] = []
    tasks, fallbacks = [], []
    for p in pairs:
        if handles is not None and id(p) not in predecoded:
            continue  # its decode failed or its masks are empty
        try:
            with TIMER.scope(pair=index[id(p)]):
                w = prep_pair(flags, p, bgpool, prematched.get(id(p)),
                              decoded=predecoded.get(id(p)))
        except _DECODE_ERRORS as e:
            log.warning("pair prep failed: %s (%s)", p.rgb1_org, e)
            w = None
        if w is None:
            continue
        w.pair = index[id(p)]
        idx = len(works)
        works.append(w)
        for seg_id, arap_mask, cons in w.segments:
            t = make_task(idx, seg_id, w.out1, arap_mask, cons, weights)
            if t is not None:
                tasks.append(t)
            else:
                # raw constraints: add_fallback pins the border itself
                fallbacks.append((idx, seg_id, w.out1, arap_mask, cons))
    return works, tasks, fallbacks


def dispatch_chunk_batched(prepped, cfg, weights, device, mesh=None):
    """Enqueue a prepped chunk's solves (split over `mesh`'s 'data' axis when
    given); returns the in-flight state for collect_chunk_batched. A
    dispatch error is kept for the collector, which retries the chunk pair
    by pair."""
    from .batch import BatchRunner

    works, tasks, fallbacks = prepped
    runner = BatchRunner(cfg, device=device, weights=weights, timer=TIMER,
                         mesh=mesh)
    err = None
    try:
        for t in tasks:
            runner.add(t)
        for fb in fallbacks:
            runner.add_fallback(*fb)
        runner.flush()
    except RuntimeError as e:  # a poisoned chunk (CUDA error, out of memory)
        err = e
    return works, runner, err


def collect_chunk_batched(inflight, cfg, weights, device,
                          writer=None) -> list[str]:
    """Copy a dispatched chunk's products back, compose and write each
    pair (through `writer` when given); returns its list lines."""
    works, runner, err = inflight
    results = None
    if err is None:
        try:
            results = runner.collect()
        except RuntimeError as e:
            err = e
    if err is not None:
        # failure isolation: retry the chunk pair by pair on the simple path
        log.warning("batched chunk failed (%s); retrying per pair", err)
        deformer = ArapDeformer(cfg, weights=weights, crop=True, device=device)
        triples = []
        for w in works:
            try:
                seg_results = [
                    deformer.deform(w.out1, m, cns) for _, m, cns in w.segments
                ]
            except RuntimeError as e2:
                log.warning("pair failed: %s (%s)", w.p.rgb1_org, e2)
                continue
            with TIMER.scope(pair=w.pair), TIMER.stage("compose+outputs-io"):
                triples.append(" ".join(finish_pair(w, seg_results, writer)))
        return triples

    triples = []
    for idx, w in enumerate(works):
        seg_results = [
            results[(idx, seg_id)] for seg_id, _, _ in w.segments
            if (idx, seg_id) in results
        ]
        if seg_results:
            with TIMER.scope(pair=w.pair), TIMER.stage("compose+outputs-io"):
                triples.append(" ".join(finish_pair(w, seg_results, writer)))
    return triples


def make_solver_config(schedule: str) -> SolverConfig:
    if schedule == "parity":
        return SolverConfig()
    # fast: full PCG depth only near alpha = 1
    return SolverConfig(pcg_iters_early=150.0, anneal_split=12.0)


def prewarm(cfg: SolverConfig, weights, buckets=None, batched: bool = True,
            frame_shape: tuple | None = None, match_downscale: int = 1,
            device="cuda", mesh=None) -> None:
    """Do before the first pair what the first pairs would otherwise pay
    for (--warmup; the JAX package's ``prewarm``): build and load every
    library (on a CUDA device the three kernel libraries, and the host
    library everywhere); then one dummy ``solve_and_raster_canvas`` for each
    bucket (default ``PREWARM_BUCKETS``) at ``max_chunk_for(bucket)``
    problems in batched mode and at 1 in simple mode, so that each kernel
    plan's occupancy query and the allocator's blocks for those shapes are
    in place; then, given `frame_shape` (H, W), one matcher call at the
    frame with the matcher's clamps (and one sub-batch call in batched
    mode). The solves take `cfg`'s route with one anneal step, one GN step
    and one PCG iteration: the same kernels, plans and buffers as the full
    schedule. With a `mesh` (--mode sharded) the solves run split over it
    at the sharded chunk size, ``max_chunk_for(bucket, n_data)``. Prints the
    seconds of each step."""
    from .. import _build
    from ..io.constraints import add_border_pins
    from ..models.arap import solve_and_raster_canvas
    from ..ops import energy as E
    from .batch import PREWARM_BUCKETS, max_chunk_for

    device = torch.device(device)
    t_all = t0 = time.time()
    if device.type == "cuda":
        _build.build()
        for stem in ("pcg", "zncc", "fused_solver"):
            _build.load(stem)
    _build.load_native()
    print(f"warmup libraries: {time.time() - t0:.3f}s", flush=True)
    short = cfg._replace(num_anneal=1, gn_iters=1, max_pcg_iters=1,
                         pcg_iters=1.0, pcg_iters_early=0.0, anneal_split=0.0)
    for bh, bw in buckets or PREWARM_BUCKETS:
        t0 = time.time()
        mask = np.full((bh, bw), 255, np.uint8)
        mask[8 : bh - 8, 8 : bw - 8] = 0
        cons = add_border_pins(
            np.array([[bw // 2, bh // 2, bw // 2 + 2, bh // 2 + 1]], np.int32),
            bw, bh)
        n_data = 1 if mesh is None else mesh.shape["data"]
        B = max_chunk_for((bh, bw), n_data) if batched else 1
        ops = E.CompactOperands.stack([E.build_compact(mask, cons, weights)]
                                      * B)
        rgb = np.zeros((B, 3, bh, bw), np.uint8)
        if mesh is None:  # a mesh uploads each slice to its device
            ops, rgb = ops.to(device), torch.as_tensor(rgb, device=device)
        out = solve_and_raster_canvas(ops, rgb, np.zeros((B, 2), np.int32),
                                      short, canvas_hw=(bh, bw),
                                      compact_flow=batched, mesh=mesh)
        out[1].cpu()
        print(f"warmup {bh}x{bw}: {time.time() - t0:.3f}s", flush=True)
    if frame_shape is not None:
        from ..ops.matching import (clamp_match_params, match_grid,
                                    match_grid_multi)

        t0 = time.time()
        H, W = frame_shape
        # the clamps match_images applies, so the call has the real shapes
        ds = max(1, int(match_downscale))
        radius, levels = clamp_match_params(H // ds, W // ds,
                                            int(np.ceil(100 / ds)))
        z = torch.zeros((3, H, W), dtype=torch.uint8, device=device)
        match_grid(z, z, stride=max(1, 4 // ds), radius=radius,
                   levels=levels, downscale=ds)[0].cpu()
        if batched:
            zb = torch.zeros((MATCH_SUBBATCH, 3, H, W), dtype=torch.uint8,
                             device=device)
            match_grid_multi(zb, zb, stride=max(1, 4 // ds), radius=radius,
                             levels=levels, downscale=ds)[0].cpu()
        print(f"warmup matcher {H}x{W}: {time.time() - t0:.3f}s", flush=True)
    print(f"warmup done in {time.time() - t_all:.3f}s", flush=True)


def _check_flags(flags: PipelineFlags) -> None:
    if flags.mode not in ("simple", "batched", "sharded"):
        raise ValueError(f"unknown --mode {flags.mode!r}")
    if flags.matcher not in ("native", "binary", "file"):
        raise ValueError(f"unknown --matcher {flags.matcher!r}")
    if flags.matcher == "binary" and not (flags.dm_bin
                                          and osp.exists(flags.dm_bin)):
        raise FileNotFoundError(f"--matcher binary: --dm_bin {flags.dm_bin!r} "
                                "not found")


def plan_chunks(pairs: list, chunk: int) -> list[list]:
    """The batched loop's chunks of `chunk` pairs. The first chunk is half
    as large, rounded down to whole matcher sub-batches (at least one):
    nothing is in flight while it preps, so a smaller first chunk shortens
    the pipeline's fill."""
    first = max(MATCH_SUBBATCH, (chunk // 2) // MATCH_SUBBATCH
                * MATCH_SUBBATCH)
    if len(pairs) > chunk and first < chunk:
        return [pairs[:first]] + [pairs[i : i + chunk]
                                  for i in range(first, len(pairs), chunk)]
    return [pairs[i : i + chunk] for i in range(0, len(pairs), chunk)]


def _run_batched(flags, chunks, n_pairs, deformer, bgpool, device,
                 writer, mesh=None) -> list[str]:
    """The depth-2 batched loop (JAX para_gen.py:876-954). Iteration k:
    enqueue chunk k+1's matcher (main thread, ahead of chunk k's solves on
    the device), wait for chunk k's prep, start chunk k+1's prep on the
    worker, enqueue chunk k's solves (split over `mesh` when given), then
    collect and write chunk k−1. Each of the four steps is a stage whose
    span carries the id of the chunk it works on."""
    cfg, weights = deformer.cfg, deformer.weights
    firsts = [0]
    for ch in chunks:
        firsts.append(firsts[-1] + len(ch))
    job = TIMER.scope_ids()

    def prep(k, handles):
        return ex.submit(TIMER.in_scope, {**job, "chunk": k},
                         prep_chunk_finish, flags, chunks[k], handles,
                         weights, bgpool, firsts[k])

    triples: list[str] = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = None
        if chunks:
            with TIMER.scope(chunk=0):
                ha = prep_chunk_dispatch_match(flags, chunks[0])
            fut = prep(0, ha)
        inflight = None  # the dispatched state of chunk k−1
        started = 0
        for i, ch in enumerate(chunks):
            print(f"{100.0 * started / max(n_pairs, 1):.3f}%", flush=True)
            started += len(ch)
            t0 = time.perf_counter()
            with TIMER.scope(chunk=i + 1), TIMER.stage("chunk phaseA"):
                if i + 1 < len(chunks):
                    ha_next = prep_chunk_dispatch_match(flags, chunks[i + 1],
                                                        firsts[i + 1])
            with TIMER.scope(chunk=i):
                with TIMER.stage("chunk prep-wait"):
                    prepped = fut.result()
                with TIMER.stage("chunk dispatch"):
                    if i + 1 < len(chunks):
                        fut = prep(i + 1, ha_next)
                    disp = dispatch_chunk_batched(prepped, cfg, weights,
                                                  device, mesh)
            with TIMER.scope(chunk=i - 1), TIMER.stage("chunk collect+finish"):
                if inflight is not None:
                    triples += collect_chunk_batched(inflight, cfg, weights,
                                                     device, writer)
            t4 = time.perf_counter()
            if i > 0:
                CHUNK_STATS.append((len(chunks[i - 1]), t4 - t0, time.time()))
            inflight = disp
        if inflight is not None:
            t0 = time.perf_counter()
            with TIMER.scope(chunk=len(chunks) - 1), \
                    TIMER.stage("chunk collect+finish"):
                triples += collect_chunk_batched(inflight, cfg, weights,
                                                 device, writer)
            t4 = time.perf_counter()
            CHUNK_STATS.append((len(chunks[-1]), t4 - t0, time.time()))
    return triples


def _run_simple(flags, pairs, deformer, bgpool, writer) -> list[str]:
    """Simple mode: pair by pair; the next pair's host and matcher prep
    runs on one worker thread while this pair solves (JAX
    para_gen.py:955-992; one worker keeps the background draws in order)."""

    job = TIMER.scope_ids()

    def safe_prep(i):
        try:
            return TIMER.in_scope({**job, "pair": i}, prep_pair, flags,
                                  pairs[i], bgpool)
        except (RuntimeError, *_DECODE_ERRORS) as e:
            log.warning("pair prep failed: %s (%s)", pairs[i].rgb1_org, e)
            return None

    triples: list[str] = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(safe_prep, 0) if pairs else None
        for i, p in enumerate(pairs):
            print(f"{100.0 * i / max(len(pairs), 1):.3f}%", flush=True)
            work = fut.result()
            if i + 1 < len(pairs):
                fut = ex.submit(safe_prep, i + 1)
            if work is None:
                continue
            try:
                with TIMER.scope(pair=i):
                    t = solve_pair(work, deformer, writer)
            except (RuntimeError, *_DECODE_ERRORS) as e:
                # keep generating; log the failure
                log.warning("pair failed: %s (%s)", p.rgb1_org, e)
                continue
            triples.append(" ".join(t))
    return triples


def main_pipeline(
    flags: PipelineFlags, solver_cfg: SolverConfig | None = None
) -> list[str]:
    """Generate the dataset of `flags`; returns the lines of the list file
    (inpRGB wRGB flo per pair) after the final existence sweep. The call is
    one job of ``TIMER``'s spans (``profiling.entry_call``: with
    ``ARAP_TRACE=<dir>`` its spans are written there)."""
    with profiling.entry_call(TIMER):
        return _generate(flags, solver_cfg)


def _generate(flags: PipelineFlags, solver_cfg: SolverConfig | None):
    global WRITE_ERRORS
    fw = FrameworkConfig.from_env(
        solver=solver_cfg or make_solver_config(flags.schedule),
        matcher=flags.matcher,
    )
    flags.matcher = fw.matcher
    if fw.raster == "host" and flags.mode != "simple":
        # the exact host splat runs per pair; batched chunks rasterize on
        # the device
        print("ARAP_RASTER=host: forcing --mode simple (exact per-pair raster)")
        flags.mode = "simple"
    _check_flags(flags)
    device = torch.device(flags.device)
    WRITE_ERRORS = 0
    CHUNK_STATS.clear()
    rng = np.random.default_rng(flags.seed)
    bgpool = BackgroundPool(flags.bg_dir, rng)
    deformer = ArapDeformer(fw.solver, weights=fw.weights, crop=fw.crop,
                            raster=fw.raster, device=device)

    pairs = scan_pairs(flags)
    print(f"{len(pairs)} frame pairs to process")
    mesh = None
    if flags.mode == "sharded":
        from ..parallel import make_mesh

        # every visible card on the 'data' axis; the CPU under --device cpu
        mesh = make_mesh(devices=[device] if device.type == "cpu" else None)
        print(f"sharded over {mesh.shape['data']} devices")
    batched = flags.mode in ("batched", "sharded")
    if flags.warmup and pairs:
        # ARAP_WARMUP_FULL=1: every one of the 31 crop buckets instead of
        # the 13 common ones (JAX para_gen.py:848-856)
        full = os.environ.get("ARAP_WARMUP_FULL", "") not in ("", "0", "off")
        # --size is (w, h): the matcher warms only when the frame shape is
        # known up front, as in the JAX package
        prewarm(deformer.cfg, deformer.weights,
                buckets=CROP_BUCKETS if full else None, batched=batched,
                frame_shape=(flags.size[1], flags.size[0]) if flags.size
                else None,
                match_downscale=flags.match_downscale, device=device,
                mesh=mesh)
    begin = time.time()

    writer = None
    if fw.async_io:
        from ..native.runtime import AsyncWriter

        writer = AsyncWriter(threads=max(1, int(fw.io_threads)))
    try:
        if batched:
            chunk = max(flags.narap, 1) * 2
            if mesh is not None:
                chunk = max(chunk, mesh.shape["data"] * 2)
            chunks = plan_chunks(pairs, chunk)
            triples = _run_batched(flags, chunks, len(pairs), deformer,
                                   bgpool, device, writer, mesh=mesh)
        else:
            triples = _run_simple(flags, pairs, deformer, bgpool, writer)
    finally:
        if writer is not None:
            writer.close()
            n_err = WRITE_ERRORS = writer.errors()
            if n_err:
                # failed or truncated writes (disk full, permissions): the
                # existence sweep below checks presence only
                log.error("%d asynchronous product writes failed (possibly "
                          "truncated files on disk); the all_files.list "
                          "existence sweep cannot detect truncation: verify "
                          "the output tree", n_err)
    print(f"done in {(time.time() - begin) / 60:.2f} mins")
    if os.environ.get("ARAP_PROFILE"):
        print(TIMER.report())

    # final existence sweep (para_gen.py:594-603)
    out_paths = [
        line for line in triples
        if all(osp.exists(part) for part in line.split(" "))
    ]
    os.makedirs(flags.output, exist_ok=True)
    # each shard writes its own list; their union is the unsharded list
    name = (
        "all_files.list" if flags.shard is None
        else f"all_files.list.{flags.shard[0]}of{flags.shard[1]}"
    )
    with open(osp.join(flags.output, name), "w") as f:
        f.write("\n".join(out_paths))
    return out_paths


def parse_args(argv=None) -> PipelineFlags:
    parser = argparse.ArgumentParser(
        description="ARAP flow dataset generation (PyTorch + CUDA)"
    )
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--bg_dir", type=str, default=None,
                        help="background image pool directory")
    parser.add_argument("--gpu", nargs="*", type=int, default=[0],
                        help="accepted for CLI parity; the card is --device")
    parser.add_argument("--multseg", action="store_true", default=False,
                        help="if each object segment is treated separately")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="skip pairs whose .flo already exists")
    parser.add_argument("--narap", type=int, default=2,
                        help="batched mode: chunks of 2 x this many pairs")
    parser.add_argument("--size", nargs=2, type=int, default=None,
                        help="[width] [height] to resize+crop all frames to")
    parser.add_argument("--fd", type=int, default=1,
                        help="frame distance between the pair")
    parser.add_argument("--matcher", choices=["native", "binary", "file"],
                        default="native",
                        help="native = the ZNCC pyramid matcher on --device; "
                        "binary = an external matcher (--dm_bin); file = the "
                        "cached tmpCnstr files")
    parser.add_argument("--dm_bin", default=None,
                        help="external matcher binary (with --matcher binary)")
    parser.add_argument("--arap_bin", default=None,
                        help="ignored (the solver is built in); parity flag")
    # accepted no-ops: the reference parses these but never reads them
    parser.add_argument("--rm-cnstr", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rm-wmask", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rm-tmp-cmd", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--img-pattern", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--schedule", choices=["parity", "fast"],
                        default="parity")
    parser.add_argument("--mode", choices=["simple", "batched", "sharded"],
                        default="simple",
                        help="batched buckets segments across pairs; sharded "
                        "also splits each solve chunk over every visible "
                        "device")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--shard", default=None, metavar="I/N",
                        help="multi-host split: this host processes pairs "
                        "I, I+N, I+2N, ... of the sorted scan (e.g. 0/4)")
    parser.add_argument("--warmup", action="store_true",
                        help="before the first pair, build and load every "
                        "library and run one dummy solve per common bucket "
                        "(every bucket under ARAP_WARMUP_FULL=1) and one "
                        "matcher call with --size")
    parser.add_argument("--match_downscale", type=int, default=1,
                        choices=[1, 2, 4],
                        help="run the matcher on a 2x2^k-pooled image")
    parser.add_argument("--exec_pack", default=None, metavar="DIR",
                        help="accepted for CLI parity; the kernels are "
                        "built once per checkout, and it implies --warmup")
    parser.add_argument("--mask_gate", choices=["count", "refsum"],
                        default="count",
                        help="empty-mask skip: 'count' skips pairs with <= 10 "
                        "object pixels; 'refsum' the reference's pixel-value "
                        "sum <= 10")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain "
                        "torch path)")
    a = parser.parse_args(argv)
    if not 0 < a.fd < 20:
        parser.error("Invalid fd number!")
    return PipelineFlags(
        input=a.input.rstrip(osp.sep),
        output=a.output.rstrip(osp.sep),
        bg_dir=a.bg_dir,
        gpu=a.gpu,
        multseg=a.multseg,
        resume=a.resume,
        narap=a.narap,
        size=tuple(a.size) if a.size else None,
        fd=a.fd,
        matcher=a.matcher,
        dm_bin=a.dm_bin,
        schedule=a.schedule,
        seed=a.seed,
        mode=a.mode,
        warmup=a.warmup or a.exec_pack is not None,
        shard=tuple(int(x) for x in a.shard.split("/")) if a.shard else None,
        match_downscale=a.match_downscale,
        mask_gate=a.mask_gate,
        device=str(cli_device(a.device)),
    )


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    main_pipeline(parse_args(argv))
    return 0


if __name__ == "__main__":
    main()
