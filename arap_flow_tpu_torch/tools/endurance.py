"""Endurance run of the port: a sustained batched ``para_gen`` run of
DAVIS-style pairs in one process (scripts/endurance.py, ported).

    python3 arap_flow_tpu_torch/tools/endurance.py [--pairs 200] \\
        [--block 8] [--schedule 19x8x400] [--device cuda] [--warm N] \\
        [--match_downscale 1] [--out FILE.json]

The dataset is scripts/endurance.py's: 854x480 frames, two objects of
scripts/synth_nonrigid.py (loaded by its path: numpy only). Object 1 is a
rigid textured ellipse whose size steps through the 12 ``SIZES``, ``--block``
frames a size, so its solves spread over much of the 31-bucket crop ladder,
the transposed path included; object 2 runs the schedule half a cycle
later at 2/3 scale and carries the non-rigid interior field wherever it is
large enough. Frames are JPEG at quality 95 from the port's encoder and
masks PNG from its codec: no PIL.

The run: one warm cycle of ``--block`` x 12 pairs (``--warm``) through
``para_gen.main_pipeline`` (``--mode batched --multseg``, seed 0, the
``--schedule``), then the measured run of ``--pairs`` pairs on a second tree
of the same schedule. Printed, as one JSON line: pairs/s over the whole run
and its second half, p50/p95 seconds a pair from ``para_gen.CHUNK_STATS``,
the pairs dropped, the builds (``_build.BUILDS``) during the measured run,
the plan caches' sizes (``pcg.card_plan``, ``fused_solver.card_plan``) after
each cycle, the (B, H, W) of every PCG launch of the measured run
(``pcg.LAUNCH_SHAPES``) and those whose (H, W) the warm cycle did not
solve, the host RSS and the card's ``torch.cuda.memory_reserved()``
sampled every 0.5 s, and the flow checks.

The gates (``failures``) are scripts/endurance.py's, with what the port
caches in place of XLA's compile set:

- at least 98% of the pairs written (a pair whose matches all fail the
  filters is dropped by design);
- the flow on in-block pairs, every third block's second pair
  (``check_accuracy``): object 1's median flow within 1 px of its
  translation, object 2's median EPE against its analytic flow below 1 px;
  at least one pair checked;
- no nvcc or g++ build after the measured run starts;
- no PCG launch of the measured run at an (H, W) the warm cycle did not
  solve (a new B on a known bucket is a remainder chunk, not growth);
- RSS and memory_reserved bounded: over the samples from 30 s after the
  last build (≥ 10 of them), the second half's maximum within 3% of the
  first half's; with fewer, the last quarter's maximum within 5% of the
  rest's maximum.

Exits 1 when a gate fails. ``--device cpu`` runs the same loop on the CPU's
plain versions (the card's counters then stay 0); the tests run it there at
a cut. On the card the default run takes minutes; the card tests
(tests/test_torch_card_pipelines.py) run it in-process at ``--pairs 48
--block 4``.
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

_REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

H, W = 480, 854
BLOCK = 8  # frames a size block; the pairs inside a block are rigid
# (ry, rx) semi-axes of object 1, small to large, wide-flat (the transposed
# solve) and tall-narrow; object 2 takes the schedule half a cycle later
SIZES = [
    (24, 40), (40, 64), (56, 90), (72, 120), (90, 140), (110, 170),
    (130, 200), (150, 230), (28, 130), (120, 45), (160, 60), (64, 64),
]
JPEG_QUALITY = 95
DEFAULT_PAIRS = 200
DEFAULT_SCHEDULE = "19x8x400"
RSS_PERIOD = 0.5  # seconds between memory samples
MIN_WRITTEN = 0.98  # share of the pairs that must be written


@functools.cache
def synth_nonrigid():
    """scripts/synth_nonrigid.py (numpy only), loaded by its path."""
    path = osp.join(_REPO, "scripts", "synth_nonrigid.py")
    spec = importlib.util.spec_from_file_location("synth_nonrigid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sizes(t: int, block: int = BLOCK):
    b = t // block
    s1 = SIZES[b % len(SIZES)]
    s2 = SIZES[(b + len(SIZES) // 2) % len(SIZES)]
    # object 2 at 2/3 scale keeps the two objects apart
    return s1, (max(12, 2 * s2[0] // 3), max(20, 2 * s2[1] // 3))


def _nr_amp(ry: int, rx: int) -> float:
    """Object 2's non-rigid amplitude at semi-axes (ry, rx): scaled to the
    object, and off for the smallest sizes, where the matcher's stride
    cannot resolve it."""
    m = min(ry, rx)
    return min(6.0, 0.12 * m) if m >= 35 else 0.0


def _centers(t: int):
    """Both objects' centres at frame t: a bounce inside margins wide enough
    for the largest size, so a centre never depends on the size."""
    nr = synth_nonrigid()
    c1 = (nr.bounce(t, 5, 170, 310), nr.bounce(t, 8, 250, 430))
    c2 = (nr.bounce(t + 37, 4, 120, 330), nr.bounce(t + 91, 7, 520, 740))
    return c1, c2


def make_frame(t: int, tex, bg, block: int = BLOCK):
    """Frame t of the dataset: (RGB uint8 (H, W, 3), mask uint8 (H, W))."""
    nr = synth_nonrigid()
    img = bg.copy()
    mask = np.zeros((H, W), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    c1, c2 = _centers(t)
    s1, s2 = _sizes(t, block)
    ob = ((yy - c1[0]) / s1[0]) ** 2 + ((xx - c1[1]) / s1[1]) ** 2 < 1
    img[ob] = tex[(yy[ob] - c1[0]) % H, (xx[ob] - c1[1]) % W]
    mask[ob] = 1
    nr.draw_nonrigid(img, mask, tex, 2, c2[0], c2[1], s2[0], s2[1],
                     _nr_amp(*s2), t)
    return img, mask


def make_dataset(root: str, n_frames: int, seed: int = 0,
                 block: int = BLOCK) -> None:
    """ROOT/orgRGB/seq0/<t>.jpg (the port's encoder, quality 95) and
    ROOT/orgMasks/seq0/<t>.png for t < n_frames."""
    from arap_flow_tpu_torch.io.image import save_image

    tex, bg = synth_nonrigid().make_textures(H, W, seed)
    os.makedirs(osp.join(root, "orgRGB", "seq0"), exist_ok=True)
    os.makedirs(osp.join(root, "orgMasks", "seq0"), exist_ok=True)
    for t in range(n_frames):
        img, mask = make_frame(t, tex, bg, block)
        save_image(osp.join(root, "orgRGB", "seq0", f"{t:05d}.jpg"), img,
                   quality=JPEG_QUALITY)
        save_image(osp.join(root, "orgMasks", "seq0", f"{t:05d}.png"), mask)


def link_prefix(src: str, dst: str, n_frames: int) -> None:
    """`dst` holds frames and masks 0..n_frames-1 of the dataset at `src`,
    as hard links."""
    for d, ext in (("orgRGB", "jpg"), ("orgMasks", "png")):
        os.makedirs(osp.join(dst, d, "seq0"), exist_ok=True)
        for t in range(n_frames):
            name = osp.join(d, "seq0", f"{t:05d}.{ext}")
            os.link(osp.join(src, name), osp.join(dst, name))


class MemorySampler(threading.Thread):
    """(time.time(), host RSS MB, card's memory_reserved MB or None) every
    `period` seconds until ``stop``, and once more when it stops."""

    def __init__(self, device, period: float = RSS_PERIOD):
        super().__init__(daemon=True)
        self.device = device
        self.period = period
        self.samples: list = []
        # not _stop: Thread.join calls self._stop() internally
        self._halt = threading.Event()

    @staticmethod
    def rss_mb() -> float:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    def sample(self) -> None:
        import torch

        reserved = None
        if self.device.type == "cuda":
            reserved = torch.cuda.memory_reserved(self.device) / 2 ** 20
        self.samples.append((time.time(), self.rss_mb(), reserved))

    def run(self) -> None:
        while not self._halt.is_set():
            self.sample()
            self._halt.wait(self.period)

    def stop(self) -> None:
        self._halt.set()
        self.join(10)
        self.sample()


def bounded(samples, t_settle: float) -> dict:
    """scripts/endurance.py's growth gate on (t, value) samples, t in
    seconds from the measured run's start: over the samples after
    `t_settle` (≥ 10 of them) the second half's maximum within 3% of the
    first half's; with fewer, the last quarter's maximum within 5% of the
    rest's maximum."""
    win = [(t, v) for t, v in samples if t > t_settle]
    if len(win) >= 10:
        h = len(win) // 2
        first, second = max(v for _, v in win[:h]), max(v for _, v in win[h:])
        slack, rule = 1.03, "halves after settling"
    elif len(samples) >= 4:
        q = len(samples) // 4
        first = max(v for _, v in samples[: 3 * q])
        second = max(v for _, v in samples[3 * q:])
        slack, rule = 1.05, "last quarter"
    else:
        return {"ok": False, "rule": f"{len(samples)} samples: too few"}
    return {"ok": bool(second <= slack * first), "rule": rule,
            "samples": len(samples), "start_mb": round(samples[0][1], 1),
            "peak_mb": round(max(v for _, v in samples), 1),
            "first_max_mb": round(first, 1), "second_max_mb": round(second, 1)}


def check_accuracy(out_dir: str, data_dir: str, t: int,
                   block: int = BLOCK) -> list:
    """The flow gate of pair (t, t+1), for pairs inside a size block:
    object 1's median flow within 1 px of its translation; object 2's
    median EPE against its analytic non-rigid flow below 1 px. Returns the
    failures."""
    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask

    u, v = flow_read(osp.join(out_dir, "Flow", "seq0", f"{t:05d}.flo"))
    mask = load_mask(osp.join(data_dir, "orgMasks", "seq0", f"{t:05d}.png"))
    c0, c1 = _centers(t), _centers(t + 1)
    bad = []
    sel = mask == 1
    if sel.sum() >= 400:
        du = float(c1[0][1] - c0[0][1])
        dv = float(c1[0][0] - c0[0][0])
        mu, mv = float(np.median(u[sel])), float(np.median(v[sel]))
        if abs(mu - du) >= 1.0 or abs(mv - dv) >= 1.0:
            bad.append((t, 1, (mu, mv), (du, dv)))
    ry, rx = _sizes(t, block)[1]
    ok, msg = synth_nonrigid().nr_check_epe(u, v, mask, 2, c0[1], c1[1], ry, rx,
                              _nr_amp(ry, rx), t, thresh=1.0,
                              label=f"t={t} seg2")
    if not ok:
        bad.append((t, 2, msg))
    return bad


def parse_schedule(text: str):
    """'19x8x400' -> SolverConfig(num_anneal=19, gn_iters=8, 400 PCG
    iterations a GN step)."""
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    a, g, p = (int(x) for x in text.lower().split("x"))
    return SolverConfig(num_anneal=a, gn_iters=g, max_pcg_iters=p,
                        pcg_iters=float(p))


def _cache_sizes() -> dict:
    from arap_flow_tpu_torch.ops import fused_solver, pcg

    return {"pcg": pcg.card_plan.cache_info().currsize,
            "fused": fused_solver.card_plan.cache_info().currsize}


def _shape_key(shape) -> str:
    return "x".join(map(str, shape))


def run(n_pairs: int = DEFAULT_PAIRS, block: int = BLOCK,
        schedule: str = DEFAULT_SCHEDULE, device: str = "cuda",
        n_warm: int | None = None, match_downscale: int = 1) -> dict:
    """The warm cycle, then the measured run of `n_pairs` pairs; returns the
    result record (``failures`` lists the gates that failed). The datasets
    and outputs go to a temporary directory, removed after."""
    import torch

    from arap_flow_tpu_torch import _build
    from arap_flow_tpu_torch.ops import pcg
    from arap_flow_tpu_torch.pipeline import para_gen

    dev = torch.device(device)
    n_warm = block * len(SIZES) if n_warm is None else n_warm
    cfg = parse_schedule(schedule)
    work = tempfile.mkdtemp(prefix="arap_endurance_")
    try:
        def flags(inp, out):
            return para_gen.PipelineFlags(
                input=inp, output=out, fd=1, multseg=True, seed=0,
                mode="batched", match_downscale=match_downscale,
                device=str(dev))

        # the warm tree and the measured one are prefixes of one dataset
        frames = osp.join(work, "frames")
        n_frames = max(n_pairs, n_warm) + 1
        t0 = time.time()
        make_dataset(frames, n_frames, block=block)
        data = osp.join(work, "data")
        link_prefix(frames, data, n_pairs + 1)
        print(f"endurance: {n_frames}-frame dataset in "
              f"{time.time() - t0:.1f} s", flush=True)
        warm_shapes: set = set()
        if n_warm:
            warm = osp.join(work, "warm_data")
            link_prefix(frames, warm, n_warm + 1)
            print(f"endurance: warm cycle of {n_warm} pairs", flush=True)
            pcg.LAUNCH_SHAPES.clear()
            t0 = time.time()
            para_gen.main_pipeline(flags(warm, osp.join(work, "warm_out")),
                                   solver_cfg=cfg)
            warm_shapes = set(pcg.LAUNCH_SHAPES)
            print(f"endurance: warm cycle {time.time() - t0:.1f} s; plan "
                  f"caches {_cache_sizes()}", flush=True)
        caches_warm = _cache_sizes()

        pcg.LAUNCH_SHAPES.clear()
        sampler = MemorySampler(dev)
        out = osp.join(work, "out")
        t0 = time.time()
        sampler.start()
        try:
            triples = para_gen.main_pipeline(flags(data, out),
                                             solver_cfg=cfg)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.time() - t0
        finally:
            sampler.stop()
        shapes = dict(pcg.LAUNCH_SHAPES)
        caches_run = _cache_sizes()
        print(f"endurance: measured run {wall:.1f} s; plan caches "
              f"{caches_run}", flush=True)

        done = {int(osp.basename(line.split()[-1])[:5]) for line in triples}
        dropped = sorted(set(range(n_pairs)) - done)
        stats = list(para_gen.CHUNK_STATS)
        per_pair = sorted(w / p for p, w, _ in stats for _ in range(p) if p)
        half = stats[len(stats) // 2:]
        ss_pairs = sum(p for p, _, _ in half)
        ss_wall = sum(w for _, w, _ in half)
        builds = [name for t, name in _build.BUILDS if t >= t0]
        t_last_build = max((t for t, _ in _build.BUILDS), default=t0) - t0
        rss = bounded([(t - t0, m) for t, m, _ in sampler.samples],
                      t_last_build + 30.0)
        reserved = None
        if dev.type == "cuda":
            reserved = bounded([(t - t0, r) for t, _, r in sampler.samples],
                               t_last_build + 30.0)
        warm_hw = {s[1:] for s in warm_shapes}
        new_hw = sorted({s[1:] for s in shapes} - warm_hw)

        bad, checked = [], 0
        for t in range(1, n_pairs - 1, 3 * block):
            if t in done and (t + 1) // block == t // block:
                checked += 1
                bad += check_accuracy(out, data, t, block)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    result = {
        "n_pairs": n_pairs, "block": block, "schedule": schedule,
        "warm_pairs": n_warm, "match_downscale": match_downscale,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "dropped_pairs": dropped,
        "wall_s": wall,
        "pairs_per_s": len(triples) / wall,
        "steady_state_pairs_per_s": ss_pairs / ss_wall if ss_wall else None,
        "latency_p50_s_per_pair": (per_pair[len(per_pair) // 2]
                                   if per_pair else None),
        "latency_p95_s_per_pair": (
            per_pair[min(len(per_pair) - 1, int(0.95 * len(per_pair)))]
            if per_pair else None),
        "chunk_count": len(stats),
        "builds_during_run": builds,
        "plan_cache_after_warm": caches_warm,
        "plan_cache_after_run": caches_run,
        "pcg_launch_shapes": {_shape_key(k): n
                              for k, n in sorted(shapes.items())},
        "new_hw_after_warm": [_shape_key(s) for s in new_hw],
        "rss": rss,
        "memory_reserved": reserved,
        "accuracy_checked": checked,
        "accuracy_failures": bad,
    }
    result["failures"] = failures(result)
    return result


def failures(result: dict, max_dropped: int | None = None) -> list[str]:
    """The gates `result` fails. `max_dropped` defaults to 2% of the
    pairs."""
    n = result["n_pairs"]
    if max_dropped is None:
        max_dropped = n - int(np.ceil(MIN_WRITTEN * n))
    out = []
    if len(result["dropped_pairs"]) > max_dropped:
        out.append(f"{len(result['dropped_pairs'])} pairs dropped (at most "
                   f"{max_dropped}): {result['dropped_pairs']}")
    if result["accuracy_failures"] or not result["accuracy_checked"]:
        out.append(f"flow checks: {result['accuracy_checked']} pairs "
                   f"checked, failures {result['accuracy_failures']}")
    if result["builds_during_run"]:
        out.append(f"built during the run: {result['builds_during_run']}")
    if result["new_hw_after_warm"]:
        out.append(f"PCG shapes the warm cycle did not solve: "
                   f"{result['new_hw_after_warm']}")
    for name in ("rss", "memory_reserved"):
        gate = result[name]
        if gate is not None and not gate["ok"]:
            out.append(f"{name} still growing: {gate}")
    return out


def cuts(args) -> list[str]:
    """Each argument that cuts the run below the default, as text."""
    out = []
    if args.pairs < DEFAULT_PAIRS:
        out.append(f"--pairs {args.pairs} (default {DEFAULT_PAIRS})")
    if args.block != BLOCK:
        out.append(f"--block {args.block} (default {BLOCK})")
    if args.schedule != DEFAULT_SCHEDULE:
        out.append(f"--schedule {args.schedule} (default {DEFAULT_SCHEDULE})")
    if args.warm is not None and args.warm < args.block * len(SIZES):
        out.append(f"--warm {args.warm} (default --block x {len(SIZES)} = "
                   f"{args.block * len(SIZES)})")
    if args.match_downscale != 1:
        out.append(f"--match_downscale {args.match_downscale} (default 1)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=DEFAULT_PAIRS,
                    help="pairs of the measured run")
    ap.add_argument("--block", type=int, default=BLOCK,
                    help="frames a size block")
    ap.add_argument("--schedule", default=DEFAULT_SCHEDULE,
                    help="anneal x GN x PCG iterations")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--warm", type=int, default=None,
                    help="pairs of the warm cycle (default: --block x 12, "
                    "one cycle of the sizes)")
    ap.add_argument("--match_downscale", type=int, default=1,
                    choices=[1, 2, 4], help="para_gen --match_downscale")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if _REPO not in sys.path:
        sys.path.insert(0, _REPO)
    from arap_flow_tpu_torch.utils.config import cli_device

    device = cli_device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        print(smi[0] if smi else "nvidia-smi: no reading", flush=True)
    for c in cuts(args):
        print(f"endurance cut: {c}", flush=True)
    result = run(args.pairs, args.block, args.schedule, str(device),
                 args.warm, args.match_downscale)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if result["failures"]:
        print("endurance FAILED:\n  " + "\n  ".join(result["failures"]),
              flush=True)
        return 1
    print("endurance ok", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
