"""Entry module of the ``davis480`` configuration: ``para_gen`` over a
DAVIS-style tree, driven through ``main_pipeline(PipelineFlags(...))`` with
the flags the configuration file states, as a user types them.

``prepare`` makes the run's DAVIS-style tree (JPEG frames and PNG masks of
the workload's sequences under the run's scratch directory); ``run_job``
generates it once into a fresh output tree; ``check`` compares each
job's sample of pairs, drawn from the seed, with the plain reference.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from .. import images
from ..traffic import Scene
from . import common


class State:
    def __init__(self, cfg, wl, seed, work, device):
        self.cfg, self.wl, self.seed, self.work = cfg, wl, seed, work
        self.device = device
        self.root = osp.join(work, "in")
        self.fd = int(common.flag(cfg["flags"], "--fd", 1))
        self.frames, self.masks = [], []  # by frame over all sequences
        self.pairs = []  # (sequence, frame in it, first frame's index)


def prepare(cfg: dict, wl: dict, seed: int, work: str, device) -> State:
    st = State(cfg, wl, seed, work, device)
    scene = Scene(wl, seed)
    g = 0
    for k, n in enumerate(scene.lengths):
        for d in ("orgRGB", "orgMasks"):
            os.makedirs(osp.join(st.root, d, f"seq{k}"), exist_ok=True)
        for t in range(n):
            img, mask = scene.frame(g + t)
            data, coefs = images.jpeg_encode(img, int(wl["jpeg_quality"]))
            stem = osp.join(f"seq{k}", f"{t:05d}")
            with open(osp.join(st.root, "orgRGB", stem + ".jpg"), "wb") as f:
                f.write(data)
            with open(osp.join(st.root, "orgMasks", stem + ".png"),
                      "wb") as f:
                f.write(images.png_encode(mask))
            st.frames.append(coefs)
            st.masks.append(mask)
        st.pairs += [(k, t, g + t) for t in range(n - st.fd)]
        g += n
    return st


def _flags(st: State, out: str):
    from arap_flow_tpu_torch.pipeline import para_gen

    flags = para_gen.parse_args(["--input", st.root, "--output", out,
                                 "--device", str(st.device)]
                                + list(st.cfg["flags"]))
    return para_gen, flags


# the products of a pair: key, directory, extension
PRODUCTS = (("flow", "Flow", ".flo"), ("wrgb", "wRGB", ".png"),
            ("wmask", "wMasks", ".png"), ("inp", "inpRGB", ".png"))


def _paths(out: str, pair: tuple) -> dict:
    seq, t, _ = pair
    return {k: osp.join(out, d, f"seq{seq}", f"{t:05d}{ext}")
            for k, d, ext in PRODUCTS}


def n_items(st: State) -> int:
    """The answers of a job: its pairs."""
    return len(st.pairs)


def products(st: State, out: str, i: int) -> dict:
    """The product files of pair `i` in the job tree `out`."""
    return _paths(out, st.pairs[i])


def solve_boxes(st: State) -> list:
    """(h, w) of every problem a job needs: one a segment of each pair's
    first frame, on the reference's tight box around it."""
    from ..reference.pipeline import solve_box

    boxes = []
    for _, _, g in st.pairs:
        mk1, mk2 = st.masks[g], st.masks[g + st.fd]
        for s in np.unique(mk1):
            if s and (mk2 == s).any():
                boxes.append(solve_box(np.where(mk1 == s, 0, 255))[2:])
    return boxes


def run_job(st: State, name: str, sched: tuple | None = None) -> common.Job:
    """One para_gen call over the sequence into a fresh tree (on `sched`
    where given: the warm job)."""
    out = osp.join(st.work, f"out_{name}")
    para_gen, flags = _flags(st, out)
    lines = para_gen.main_pipeline(flags, solver_cfg=common.solver_cfg(
        st.cfg, sched))
    listed = set(lines)
    written = 0
    for pair in st.pairs:
        p = _paths(out, pair)
        line = " ".join((p["inp"], p["wrgb"], p["flow"]))
        if line in listed and all(osp.exists(v) for v in p.values()):
            written += 1
    return common.Job(name=name, out=out, attempted=len(st.pairs),
                      written=written)


def check(st: State, jobs: list, samples: list, device, control=None):
    """Numbers compared with the plain reference: in each job, the pairs
    of its sample (indices into the job's pairs, drawn from the seed).
    Returns (the program's numbers, the control's or None): with `control`
    (a torch dtype) the reference in that precision also takes the
    program's place on every sampled pair."""
    from ..reference import pipeline as ref

    sched = common.schedule(st.cfg)
    union = sorted({i for s in samples for i in s})
    pairs = []
    for i in union:
        g = st.pairs[i][2]
        pairs.append((images.jpeg_pixels(st.frames[g]), st.masks[g],
                      images.jpeg_pixels(st.frames[g + st.fd]),
                      st.masks[g + st.fd]))
    want = dict(zip(union, ref.davis_pairs(pairs, device, sched)))

    def regions(i):
        mk1 = st.masks[st.pairs[i][2]]
        return [mk1 == s for s in (want[i] or {}).get("ids", [])]

    nums, ctrl = common.Numbers(), common.Numbers()
    for j, sample in zip(jobs, samples):
        for i in sample:
            nums.compare(want[i], common.read_products(products(st, j.out, i)),
                         regions(i), inp=True)
    if control is None:
        return nums.result(), None
    for i, c in zip(union, ref.davis_pairs(pairs, device, sched, control)):
        ctrl.compare(want[i], c, regions(i), inp=True)
    return nums.result(), ctrl.result()
