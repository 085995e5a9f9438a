"""What the entry modules share: a job's record, the schedule a
configuration states, reading the products a job wrote, and the numbers
that decide ``correct``."""

from __future__ import annotations

import contextlib
import os.path as osp
from dataclasses import dataclass

import numpy as np

from .. import images

PARITY = (19, 8, 400)  # num_anneal x gn_iters x pcg_iters of --schedule parity


@dataclass
class Job:
    name: str
    out: str
    attempted: int
    written: int
    rc: int = 0  # the entry's exit code, where it returns one


def draw_sample(rng: np.random.Generator, n: int, k: int) -> list:
    """`k` of `n` answers (all of them where k >= n), drawn without
    replacement."""
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def flag(flags: list, name: str, default=None):
    """The value after `name` in a flag list, or `default`."""
    return flags[flags.index(name) + 1] if name in flags else default


def schedule(cfg: dict) -> tuple:
    return tuple(int(v) for v in cfg.get("schedule", PARITY))


# the set-up's warm job: the same shapes, kernels and plans as the
# window's, one PCG iteration a solve
WARM = (1, 1, 1)


def solver_cfg(cfg: dict, sched: tuple | None = None):
    """None where a job runs the parity schedule its flags name; else the
    program's SolverConfig of `sched` (default: the configuration's
    stated schedule; a cut only the warm job and CPU tests use)."""
    s = tuple(sched or schedule(cfg))
    if s == PARITY:
        return None
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    return SolverConfig(num_anneal=s[0], gn_iters=s[1], max_pcg_iters=s[2],
                        pcg_iters=float(s[2]))


@contextlib.contextmanager
def stated_schedule(cfg: dict, module, sched: tuple | None = None):
    """Run `module`'s CLI on `sched` (default: the configuration's): a
    no-op on the parity schedule; else its framework config is built on
    that schedule."""
    s = solver_cfg(cfg, sched)
    if s is None:
        yield
        return
    from arap_flow_tpu_torch.utils.config import FrameworkConfig

    old = module.make_framework_config
    module.make_framework_config = lambda _: FrameworkConfig.from_env(solver=s)
    try:
        yield
    finally:
        module.make_framework_config = old


def read_flo(path: str) -> np.ndarray:
    """A Middlebury .flo file -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if tag != np.float32(202021.25):
            raise ValueError(f"{path}: not a .flo file")
        W, H = (int(v) for v in np.frombuffer(f.read(8), np.int32))
        return np.frombuffer(f.read(), np.float32)[:H * W * 2].reshape(H, W, 2)


def read_products(paths: dict) -> dict | None:
    """{"flow", "wrgb", "wmask"[, "inp"]} read back from a pair's files, or
    None where one is missing."""
    if not all(osp.exists(p) for p in paths.values()):
        return None
    out = {}
    for key, p in paths.items():
        if p.endswith(".flo"):
            out[key] = read_flo(p)
        else:
            with open(p, "rb") as f:
                out[key] = images.png_decode(f.read())
    return out


class Numbers:
    """The numbers compared, each the worst over the sampled answers; a
    configuration's ``limits`` name those it is held to:

    - ``flow_epe_px``: mean end-point error of the written flow against the
      reference's over an object's pixels, the worst object;
    - ``flow_epe_median_px``: the same, the median over an object's pixels;
    - ``wmask_mismatch``: pixels whose warped mask differs, over the pixels
      the reference covers;
    - ``wrgb_mean_abs``: mean |difference| of the warped RGB over the pixels
      both cover; ``wrgb_median_abs``: its median;
    - ``inp_max_abs``: largest |difference| of the written input frame
      (para_gen's inpRGB) from the decoded frame;
    - ``sample_missing``: sampled answers that one side has and the other
      has not.
    """

    def __init__(self):
        self.v = dict.fromkeys(
            ("flow_epe_px", "flow_epe_median_px", "wmask_mismatch",
             "wrgb_mean_abs", "wrgb_median_abs", "inp_max_abs",
             "sample_missing"), 0.0)

    def _max(self, key, value):
        self.v[key] = max(self.v[key], float(value))

    def compare(self, want, got, regions, inp: bool = False):
        if want is None or got is None:
            if (want is None) != (got is None):
                self.v["sample_missing"] += 1
            return
        d = want["flow"].astype(np.float64) - got["flow"]
        epe = np.hypot(d[..., 0], d[..., 1])
        for r in regions:
            if r.any():
                self._max("flow_epe_px", epe[r].mean())
                self._max("flow_epe_median_px", np.median(epe[r]))
        wm, gm = want["wmask"] != 0, got["wmask"] != 0
        self._max("wmask_mismatch", (wm != gm).sum() / max(1, wm.sum()))
        both = wm & gm
        if both.any():
            diff = np.abs(want["wrgb"].astype(np.int64) - got["wrgb"])[both]
            self._max("wrgb_mean_abs", diff.mean())
            self._max("wrgb_median_abs", np.median(diff))
        if inp:
            self._max("inp_max_abs", np.abs(want["inp"].astype(np.int64)
                                            - got["inp"]).max())

    def result(self) -> dict:
        return dict(self.v)
