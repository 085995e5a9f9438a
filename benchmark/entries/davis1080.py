"""Entry module of the ``davis1080`` configuration: ``para_gen`` over a
DAVIS Full-Resolution-style tree with random backgrounds, driven through
``main_pipeline(parse_args([...]))`` with the flags the configuration file
states (``--size W H`` among them), the run's background directory
(``--bg_dir``) and the run's seed (``--seed``), as a user types them.

``prepare`` makes the run's tree at the workload's source size (JPEG
frames, PNG masks) and its background JPEGs; ``run_job`` generates the
tree once into a fresh output tree; ``check`` compares each job's sample
of pairs, drawn from the seed, with the plain reference
(``reference/fullres.py``), which resizes the frames, replays the
background draws and composites them itself.

The workload's ``height``/``width`` are the frame the matcher and the
solves see (the ``--size`` target); ``source_height``/``source_width``
are the size the frames are rendered and written at.
"""

from __future__ import annotations

import copy
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import images
from ..reference import fullres
from ..traffic import Scene, make_textures
from . import common, davis480
# the tree's layout and the call are davis480's: the flags differ only by
# what the configuration and the State add to them
from .davis480 import n_items, products  # noqa: F401

# threads that render and encode a run's inputs (numpy releases the GIL)
PREP_THREADS = 8


class State(davis480.State):
    def __init__(self, cfg, wl, seed, work, device):
        super().__init__(cfg, wl, seed, work, device)
        self.bg_dir = osp.join(work, "backgrounds")
        # the run's background directory and seed, as a user appends them
        self.cfg = {**cfg, "flags": list(cfg["flags"]) + [
            "--bg_dir", self.bg_dir, "--seed", str(seed)]}
        # the warm job's: no background, which builds no shape, kernel or
        # graph (the matcher and the solves see the frames without it)
        self.warm_cfg = {**cfg, "flags": list(cfg["flags"]) + [
            "--seed", str(seed)]}
        i = cfg["flags"].index("--size")
        self.size = (int(cfg["flags"][i + 1]), int(cfg["flags"][i + 2]))
        self.small_masks = []  # the masks as the solves see them
        self.backgrounds = []  # coefficients of each background, pool order
        self.draws = []  # each pair's background draw, replayed


def prepare(cfg: dict, wl: dict, seed: int, work: str, device) -> State:
    st = State(cfg, wl, seed, work, device)
    if (int(wl["width"]), int(wl["height"])) != st.size:
        raise ValueError(f"workload frame {wl['width']}x{wl['height']} is "
                         f"not --size {st.size}")
    scene = Scene({**wl, "height": int(wl["source_height"]),
                   "width": int(wl["source_width"])}, seed)
    q = int(wl["jpeg_quality"])
    bgs = wl["backgrounds"]
    bg_hw = (int(bgs["height"]), int(bgs["width"]))

    def frame(t):
        img, mask = scene.frame(t)
        return images.jpeg_encode(img, q), mask

    def background(i):
        tex, _ = make_textures(*bg_hw, [seed, 3, i])
        return images.jpeg_encode(tex, int(bgs["jpeg_quality"]))

    with ThreadPoolExecutor(PREP_THREADS) as ex:
        frames = list(ex.map(frame, range(scene.n)))
        backgrounds = list(ex.map(background, range(int(bgs["count"]))))
    os.makedirs(st.bg_dir)
    for i, (data, coefs) in enumerate(backgrounds):
        # names in pool order: the pool draws from its sorted paths
        with open(osp.join(st.bg_dir, f"bg{i:03d}.jpg"), "wb") as f:
            f.write(data)
        st.backgrounds.append(coefs)
    g = 0
    for k, n in enumerate(scene.lengths):
        for d in ("orgRGB", "orgMasks"):
            os.makedirs(osp.join(st.root, d, f"seq{k}"), exist_ok=True)
        for t in range(n):
            (data, coefs), mask = frames[g + t]
            stem = osp.join(f"seq{k}", f"{t:05d}")
            with open(osp.join(st.root, "orgRGB", stem + ".jpg"), "wb") as f:
                f.write(data)
            with open(osp.join(st.root, "orgMasks", stem + ".png"),
                      "wb") as f:
                f.write(images.png_encode(mask))
            st.frames.append(coefs)
            st.masks.append(mask)
            H, W = mask.shape
            w, h, left, upper = fullres.resized_size(H, W, st.size)
            st.small_masks.append(fullres.resize_nearest(mask, (w, h))[
                upper:upper + st.size[1], left:left + st.size[0]])
        st.pairs += [(k, t, g + t) for t in range(n - st.fd)]
        g += n
    st.draws = fullres.background_draws(
        len(st.pairs), [bg_hw] * len(st.backgrounds), st.size[::-1], seed)
    return st


def run_job(st: State, name: str, sched: tuple | None = None) -> common.Job:
    """davis480's call with the run's flags; the warm job (`sched` given)
    runs without ``--bg_dir``, so set-up skips the background draws'
    decodes and upscales (host work that the window's shapes do not
    depend on)."""
    if sched is not None:
        st = copy.copy(st)
        st.cfg = st.warm_cfg
    return davis480.run_job(st, name, sched)


def solve_boxes(st: State) -> list:
    """(h, w) of every problem a job needs: one a segment of each pair's
    first frame, on the reference's tight box around it in the resized
    mask."""
    from ..reference.pipeline import solve_box

    boxes = []
    for _, _, g in st.pairs:
        mk1, mk2 = st.small_masks[g], st.small_masks[g + st.fd]
        for s in np.unique(mk1):
            if s and (mk2 == s).any():
                boxes.append(solve_box(np.where(mk1 == s, 0, 255))[2:])
    return boxes


def _reference(st: State, union: list, device, dtype) -> dict:
    """The reference's products of pairs `union`, the resize and the
    background fit in `dtype` (float64 where Pillow computes in double,
    below it for the control) and the solve in float32 (in `dtype` for
    the control)."""
    import torch

    sched = common.schedule(st.cfg)
    rdt = torch.float64 if dtype is None else dtype
    frame_hw = st.size[::-1]
    pairs = []
    for i in union:
        g = st.pairs[i][2]
        im1, mk1 = fullres.scale_rotate(images.jpeg_pixels(st.frames[g]),
                                        st.masks[g], st.size, device, rdt)
        im2, mk2 = fullres.scale_rotate(
            images.jpeg_pixels(st.frames[g + st.fd]), st.masks[g + st.fd],
            st.size, device, rdt)
        draw = st.draws[i]
        bg = fullres.fit_background(
            images.jpeg_pixels(st.backgrounds[draw[0]]), draw, frame_hw,
            device, rdt)
        pairs.append((im1, mk1, im2, mk2, bg))
    return dict(zip(union, fullres.pairs_with_backgrounds(
        pairs, device, sched, torch.float32 if dtype is None else dtype)))


def background_max_abs(want: dict | None, got: dict | None) -> float:
    """Largest |difference| of the warped RGB over the pixels that neither
    warped mask covers: where ``finish_pair`` composites the pair's
    background (``common.Numbers`` reads the warped RGB only where both
    cover). 0 where either side has no products."""
    if want is None or got is None:
        return 0.0
    bg = (want["wmask"] == 0) & (got["wmask"] == 0)
    if not bg.any():
        return 0.0
    return float(np.abs(want["wrgb"].astype(np.int64)
                        - got["wrgb"])[bg].max())


def check(st: State, jobs: list, samples: list, device, control=None):
    """Numbers compared with the plain reference: in each job, the pairs
    of its sample (indices into the job's pairs, drawn from the seed):
    ``common.Numbers``'s, and ``wrgb_bg_max_abs``, the worst
    ``background_max_abs``. Returns (the program's numbers, the control's
    or None): with `control` (a torch dtype) the whole reference in that
    precision, its resize included, also takes the program's place on
    every sampled pair."""
    union = sorted({i for s in samples for i in s})
    want = _reference(st, union, device, None)

    def regions(i):
        mk1 = st.small_masks[st.pairs[i][2]]
        return [mk1 == s for s in (want[i] or {}).get("ids", [])]

    def result(nums, bg):
        return {**nums.result(), "wrgb_bg_max_abs": max(bg, default=0.0)}

    nums, ctrl = common.Numbers(), common.Numbers()
    bg = []
    for j, sample in zip(jobs, samples):
        for i in sample:
            got = common.read_products(products(st, j.out, i))
            nums.compare(want[i], got, regions(i), inp=True)
            bg.append(background_max_abs(want[i], got))
    if control is None:
        return result(nums, bg), None
    got = _reference(st, union, device, control)
    cbg = []
    for i in union:
        ctrl.compare(want[i], got[i], regions(i), inp=True)
        cbg.append(background_max_abs(want[i], got[i]))
    return result(nums, bg), result(ctrl, cbg)
