"""Entry module of the ``sintel1024`` configuration: ``run_arap`` over an
MPI-Sintel-shaped tree, driven through ``run_arap.main([...])`` with the
flags the configuration file states.

``prepare`` makes the run's one sequence in every pass (PNG frames, ARAP
masks, constraint files) once; ``run_job`` gives each job its own root of
links to those files, since ``run_arap`` writes inside its input root
(``ROOT/flow_arap/...``); ``check`` compares each job's sample of frames,
drawn from the seed, with the plain reference.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np

from .. import images
from ..traffic import Scene, constraint_grid
from . import common


class State:
    def __init__(self, cfg, wl, seed, work, device):
        self.cfg, self.wl, self.seed, self.work = cfg, wl, seed, work
        self.device = device
        self.data = osp.join(work, "sintel")
        self.items = []  # (pass, frame, rgb, arap mask, constraints, ids)


def _path(root, kind, pas, seq, i, ext):
    base = root if kind == "frames" else osp.join(root, kind)
    return osp.join(base, pas, seq, f"frame_{i:04d}.{ext}")


def _final(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The final pass: the clean frame blurred (3x3 box), darkened and
    noisy."""
    p = np.pad(img.astype(np.float64), ((1, 1), (1, 1), (0, 0)), mode="edge")
    H, W = img.shape[:2]
    blur = sum(p[dy:dy + H, dx:dx + W] for dy in range(3)
               for dx in range(3)) / 9.0
    return np.clip(blur * 0.8 + rng.normal(0, 4, img.shape), 0,
                   255).astype(np.uint8)


def prepare(cfg: dict, wl: dict, seed: int, work: str, device) -> State:
    st = State(cfg, wl, seed, work, device)
    scene = Scene(wl, seed)
    rng = np.random.default_rng([seed, 1])
    seq = wl["sequence"]
    for t in range(scene.n):
        img, annot = scene.frame(t)
        mask = np.where(annot != 0, 0, 255).astype(np.uint8)
        cons = constraint_grid(scene, t, int(wl["constraint_step"]),
                               float(wl["constraint_inner"]))
        text = "\n".join([str(len(cons))] + ["\t".join(str(int(v)) for v in c)
                                             for c in cons])
        for pas in wl["passes"]:
            rgb = img if pas == "clean" else _final(img, rng)
            files = ((("frames", "png"), images.png_encode(rgb)),
                     (("masks", "png"), images.png_encode(mask)),
                     (("cnstr", "txt"), text.encode()))
            for (kind, ext), data in files:
                path = _path(st.data, kind, pas, seq, t + 1, ext)
                os.makedirs(osp.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    f.write(data)
            st.items.append((pas, t + 1, rgb, mask, cons, annot))
    return st


def _outputs(root, pas, seq, i) -> dict:
    stem = osp.join(root, "flow_arap", pas, seq, f"frame_{i:04d}")
    return {"flow": stem + ".flo", "wrgb": stem + "_wRGB.png",
            "wmask": stem + "_wMask.png"}


def n_items(st: State) -> int:
    """The answers of a job: its frames over every pass."""
    return len(st.items)


def products(st: State, out: str, i: int) -> dict:
    """The product files of frame `i` in the job root `out`."""
    pas, frame = st.items[i][:2]
    return _outputs(out, pas, st.wl["sequence"], frame)


def solve_boxes(st: State) -> list:
    """(h, w) of every problem a job needs: one a frame, on the
    reference's tight box around its solve region."""
    from ..reference.pipeline import solve_box

    return [solve_box(mask)[2:] for _, _, _, mask, _, _ in st.items]


def run_job(st: State, name: str, sched: tuple | None = None) -> common.Job:
    """One run_arap call over every pass, in a root of its own (on `sched`
    where given: the warm job)."""
    from arap_flow_tpu_torch.pipeline import run_arap

    root = osp.join(st.work, f"job_{name}")
    os.makedirs(root)
    for pas in st.wl["passes"]:
        os.symlink(osp.join(st.data, pas), osp.join(root, pas))
    for kind in ("masks", "cnstr"):
        os.symlink(osp.join(st.data, kind), osp.join(root, kind))
    with common.stated_schedule(st.cfg, run_arap, sched):
        rc = run_arap.main(["--input", root, "--device", str(st.device)]
                           + list(st.cfg["flags"]))
    written = sum(all(osp.exists(p) for p in products(st, root, i).values())
                  for i in range(len(st.items)))
    return common.Job(name=name, out=root, attempted=len(st.items),
                      written=written, rc=int(rc or 0))


def check(st: State, jobs: list, samples: list, device, control=None):
    """Numbers compared with the plain reference: in each job, the frames
    of its sample (indices into the job's frames, drawn from the seed).
    Returns (the program's numbers, the control's or None): with `control`
    (a torch dtype) the reference in that precision also takes the
    program's place on every sampled frame."""
    from ..reference import pipeline as ref

    sched = common.schedule(st.cfg)
    union = sorted({i for s in samples for i in s})
    frames = [st.items[i][2:5] for i in union]
    want = dict(zip(union, ref.sintel_frames(frames, device, sched)))

    def regions(i):
        annot = st.items[i][5]
        return [annot == s for s in np.unique(annot) if s]

    nums, ctrl = common.Numbers(), common.Numbers()
    for j, sample in zip(jobs, samples):
        for i in sample:
            nums.compare(want[i], common.read_products(products(st, j.out, i)),
                         regions(i))
    if control is None:
        return nums.result(), None
    for i, g in zip(union, ref.sintel_frames(frames, device, sched, control)):
        ctrl.compare(want[i], g, regions(i))
    return nums.result(), ctrl.result()
