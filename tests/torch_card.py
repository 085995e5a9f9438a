"""Builders, constants and the ``card`` fixture shared by the port's card
tests (tests/test_torch_card_*.py): numpy-seeded PCG, segment and ZNCC
problems, the deform pair, the synthetic para_gen tree and its checks, the
DMO mask tree, and the constants recorded from the JAX package
(``TEX_JAX_DRAWS``, ``TEX_JAX_SUMS``, ``TEXGEN_JAX_FIRST``,
``DMO_JAX_ERRS``, which tests/test_torch_smoke_constants.py holds to JAX)
with the DMO flow gate built on them. Imports neither jax nor PIL, as
the port does not.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import pytest
import torch

from arap_flow_tpu_torch.io.constraints import (add_border_pins,
                                                read_constraint_file)
from arap_flow_tpu_torch.io.flo import flow_read
from arap_flow_tpu_torch.io.image import (load_mask, load_rgb, save_image,
                                          segment_mask_to_arap)
from arap_flow_tpu_torch.ops import energy as E
from arap_flow_tpu_torch.ops import fused_solver, pcg, zncc
from arap_flow_tpu_torch.ops.solver import SolverConfig, guarded_invert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="session")
def card():
    """The first CUDA device, with TF32 off for matmuls and cuDNN and the
    standard PCG layout unless a test sets ARAP_TALL_KERNEL; skips without
    a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.pop("ARAP_TALL_KERNEL", None)
    return torch.device("cuda", 0)


def zero_counts() -> None:
    for counts in (pcg.LAUNCHES, zncc.LAUNCHES, fused_solver.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_counts() -> dict:
    return {**pcg.LAUNCHES, **zncc.LAUNCHES, **fused_solver.LAUNCHES}


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cut_config(**kw) -> SolverConfig:
    """The cut schedule 2x2x40 of the plain-torch and routing checks: plain
    torch at 19x8x400 and 480x854 would take minutes."""
    return SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=40,
                        pcg_iters=40.0, **kw)


# ---------------------------------------------------------------------------
# PCG and solve problems
# ---------------------------------------------------------------------------


def stack_operands(probs) -> E.ArapOperands:
    return E.ArapOperands(**{f: torch.stack([getattr(o, f) for o in probs])
                             for f in vars(probs[0])})


def pcg_problem(B: int, H: int, W: int, seed: int, device):
    """B numpy-seeded PCG problems at H×W: an interior solve region with a
    constraint grid and border pins, linearised at a perturbed state (the
    region shared, each problem its own state). Returns (the operands of
    each, pcg_fixed's arguments)."""
    mask = np.full((H, W), 255, np.uint8)
    mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 2,
                     ys.ravel() - 1], 1).astype(np.int32)
    ops = E.build_operands(mask, add_border_pins(cons, W, H), device=device)
    x0 = E.init_state(ops)
    cimg = E.anneal_constraints(ops, 1.0)
    probs = []
    for k in range(B):
        rng = np.random.default_rng(seed + k)
        x = x0 + 0.3 * torch.as_tensor(
            rng.standard_normal((3, H, W)), dtype=torch.float32, device=device)
        s, c = E.trig(x)
        jtf, diag = E.jtf_and_diag(x, ops, cimg)
        probs.append((-jtf, guarded_invert(diag), s, c))
    args = tuple(torch.stack([p[k] for p in probs]).contiguous()
                 for k in range(4))
    args += tuple(torch.stack([t] * B).contiguous()
                  for t in (ops.vmasks, ops.fitmask, ops.wf2, ops.wr2))
    return [ops] * B, args


def jittered_operands(seed: int, H: int, W: int, device) -> E.ArapOperands:
    """tests/test_pallas_solver.py's problem: an interior solve region with a
    constraint grid jittered by up to 3 px and border pins."""
    mask = np.full((H, W), 255, np.uint8)
    mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    rng = np.random.default_rng(seed)
    cons = np.stack([xs.ravel(), ys.ravel(),
                     xs.ravel() + rng.integers(-3, 4, xs.size),
                     ys.ravel() + rng.integers(-3, 4, xs.size)],
                    1).astype(np.int32)
    return E.build_operands(mask, add_border_pins(cons, W, H), device=device)


def jittered_pcg_problem(seeds, state_seed: int, H: int, W: int, device):
    """tests/test_pallas_batched.py's batch: one jittered problem a seed,
    each linearised at the grid plus 0.25·N(0, 1) drawn in turn from
    `state_seed`. Returns (the operands of each, pcg_fixed's arguments)."""
    ops = [jittered_operands(s, H, W, device) for s in seeds]
    rng = np.random.default_rng(state_seed)
    parts = []
    for o in ops:
        x = E.init_state(o) + 0.25 * torch.as_tensor(
            rng.standard_normal((3, H, W)), dtype=torch.float32, device=device)
        s, c = E.trig(x)
        jtf, diag = E.jtf_and_diag(x, o, E.anneal_constraints(o, 1.0))
        parts.append((-jtf, guarded_invert(diag), s, c))
    b = stack_operands(ops)
    args = tuple(torch.stack([p[k] for p in parts]).contiguous()
                 for k in range(4))
    return ops, args + (b.vmasks, b.fitmask, b.wf2, b.wr2)


def relative_residuals(ops, args, delta) -> list[float]:
    """‖b − JtJ·δ‖ / ‖b‖ of every problem of the batch."""
    b, _, s, c = args[:4]
    return [float(torch.linalg.vector_norm(b[k] - E.apply_jtj(
        delta[k], o, s[k], c[k])) / torch.linalg.vector_norm(b[k]))
        for k, o in enumerate(ops)]


def segment_operands(B: int, H: int, W: int, seed: int, device):
    """B numpy-seeded segment problems on an H×W bucket: an elliptical
    object whose constraint grid (every 8 px) moves by a random rigid
    motion, with border pins. Returns the per-problem operands and their
    stack."""
    probs = []
    yy, xx = np.mgrid[0:H, 0:W]
    for k in range(B):
        rng = np.random.default_rng(seed + k)
        cy, cx = H / 2 + rng.uniform(-4, 4), W / 2 + rng.uniform(-4, 4)
        ell = (((yy - cy) / (0.38 * H)) ** 2
               + ((xx - cx) / (0.38 * W)) ** 2) < 1.0
        dx, dy = rng.uniform(-6, 6, 2)
        th = rng.uniform(-0.1, 0.1)
        ys, xs = np.mgrid[0:H:8, 0:W:8]
        sel = ell[::8, ::8]
        sx, sy = xs[sel], ys[sel]
        xr = np.cos(th) * (sx - cx) - np.sin(th) * (sy - cy) + cx + dx
        yr = np.sin(th) * (sx - cx) + np.cos(th) * (sy - cy) + cy + dy
        cons = np.stack([sx, sy, np.round(xr), np.round(yr)], 1).astype(
            np.int32)
        keep = ((cons[:, 2] >= 0) & (cons[:, 2] < W) & (cons[:, 3] >= 0)
                & (cons[:, 3] < H))
        probs.append(E.build_operands(
            np.where(ell, 0, 255).astype(np.uint8),
            add_border_pins(cons[keep], W, H), device=device))
    return probs, stack_operands(probs)


# ---------------------------------------------------------------------------
# The deform pair: bench.py's 854×480 frame with two elliptical segments
# ---------------------------------------------------------------------------

FRAME_H, FRAME_W = 480, 854
SEG_SHAPES = (((90, 330), (180, 300)), ((260, 480), (120, 260)))
SEG_SEEDS = (100, 101)
# MPI-Sintel's frame
SINTEL_H, SINTEL_W = 436, 1024


def segment_problem(seed, center, size):
    """One synthetic segment by bench.py's recipe: elliptical mask, a
    constraint grid moved by a random rigid motion. Returns (rgb, arap_mask,
    constraints, (dx, dy, theta))."""
    H, W = FRAME_H, FRAME_W
    rng = np.random.default_rng(seed)
    cy, cx = center
    sh, sw = size
    yy, xx = np.mgrid[0:H, 0:W]
    ell = ((yy - cy) / (sh / 2)) ** 2 + ((xx - cx) / (sw / 2)) ** 2 < 1.0
    arap_mask = np.where(ell, 0, 255).astype(np.uint8)
    dx, dy = rng.integers(-18, 19), rng.integers(-12, 13)
    th = rng.uniform(-0.1, 0.1)
    ys, xs = np.mgrid[0:H:8, 0:W:8]
    sel = ell[::8, ::8]
    sx, sy = xs[sel], ys[sel]
    xr = np.cos(th) * (sx - cx) - np.sin(th) * (sy - cy) + cx + dx
    yr = np.sin(th) * (sx - cx) + np.cos(th) * (sy - cy) + cy + dy
    cons = np.stack([sx, sy, np.round(xr), np.round(yr)], axis=1).astype(
        np.int32)
    keep = ((cons[:, 2] >= 0) & (cons[:, 2] < W) & (cons[:, 3] >= 0)
            & (cons[:, 3] < H))
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    return rgb, arap_mask, cons[keep], (float(dx), float(dy), float(th))


def rigid_epe_median(flow, arap_mask, center, motion) -> float:
    """Median end-point error over object pixels against the analytic flow
    of the segment's rigid motion."""
    dx, dy, th = motion
    cy, cx = center
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float64)
    u = np.cos(th) * (xx - cx) - np.sin(th) * (yy - cy) + cx + dx - xx
    v = np.sin(th) * (xx - cx) + np.cos(th) * (yy - cy) + cy + dy - yy
    obj = arap_mask == 0
    epe = np.hypot(flow[..., 0] - u, flow[..., 1] - v)[obj]
    return float(np.median(epe))


def make_tasks():
    """The pair's segments and their crop-path tasks."""
    from arap_flow_tpu_torch.pipeline.batch import make_task

    probs = [segment_problem(seed, c, s)
             for seed, (c, s) in zip(SEG_SEEDS, SEG_SHAPES)]
    tasks = [make_task(0, j, rgb, mask, cons, E.ArapWeights())
             for j, (rgb, mask, cons, _) in enumerate(probs)]
    return probs, tasks


def solve_calls(tasks):
    """(B, H, W) of each PCG kernel call the pair makes per GN step: one
    per chunk of a bucket (solver-side shape: a transposed task solves its
    reflection) and one per full-frame fallback."""
    from arap_flow_tpu_torch.pipeline.batch import max_chunk_for

    groups = {}
    for t in tasks:
        if t is not None:
            groups.setdefault((t.bucket, t.canvas, t.transposed), []).append(t)
    calls = []
    for key, ts in groups.items():
        step = max_chunk_for(key[0])
        for i in range(0, len(ts), step):
            calls.append((len(ts[i : i + step]), *ts[0].ops.mask_u8.shape))
    return calls + [(1, FRAME_H, FRAME_W)] * sum(t is None for t in tasks)


def run_pair(probs, tasks, cfg, device):
    """The pair through BatchRunner (the crop path); returns its products."""
    from arap_flow_tpu_torch.pipeline.batch import BatchRunner

    runner = BatchRunner(cfg, device=device)
    for j, ((rgb, mask, cons, _), t) in enumerate(zip(probs, tasks)):
        if t is None:
            runner.add_fallback(0, j, rgb, mask, cons)
        else:
            runner.add(t)
    out = runner.finish()
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# ZNCC search problems
# ---------------------------------------------------------------------------


def texture_planes(n: int, H: int, W: int, seed: int) -> np.ndarray:
    """n gray planes (n, H, W) float32 in 0..255: smooth random blocks plus
    fine detail, the structure the matcher sees in natural frames."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, H, W), np.float32)
    for k in range(n):
        blocks = rng.uniform(0, 255, (H // 6 + 2, W // 6 + 2))
        up = np.kron(blocks, np.ones((6, 6)))[:H, :W]
        out[k] = np.clip(up + rng.normal(0, 12, (H, W)), 0, 255)
    return out


def zncc_inputs(N1: int, N2: int, H: int, W: int, r: int, seed: int):
    """Raw planes p1 (N1, H, W) and p2 (N2, H, W): each search plane is its
    reference moved by a random offset within the radius, plus noise."""
    rng = np.random.default_rng(seed)
    big = texture_planes(N1, H + 2 * r, W + 2 * r, seed)
    p1 = big[:, r : r + H, r : r + W]
    p2 = np.empty((N2, H, W), np.float32)
    g = N2 // N1
    for b in range(N2):
        dy, dx = rng.integers(-r, r + 1, 2) // 2
        p2[b] = big[b // g, r + dy : r + dy + H, r + dx : r + dx + W]
    p2 += rng.normal(0, 3, p2.shape).astype(np.float32)
    return np.ascontiguousarray(p1), p2


def plain_score_at(p1, p2, r, du, dv, where):
    """The plain version's score of the offset (du, dv) at the pixels
    `where` (NaN elsewhere)."""
    import torch.nn.functional as F

    z1 = zncc.zscore(p1, 12).repeat_interleave(p2.shape[0] // p1.shape[0], 0)
    z2 = zncc.zscore(p2, 12)
    N, H, W = z2.shape
    z2p = F.pad(z2, (r, r, r, r))
    out = torch.full((N, H, W), float("nan"), device=p1.device)
    offs = torch.stack([du[where], dv[where]], 1).unique(dim=0)
    for ox, oy in offs.to(torch.int64).tolist():
        sel = where & (du == ox) & (dv == oy)
        shifted = z2p[:, r + oy : r + oy + H, r + ox : r + ox + W]
        out[sel] = (zncc.box_sum(z1 * shifted, 12) / 144.0)[sel]
    return out


def assert_zncc_matches_plain(p1, p2, r) -> None:
    """The kernel against its plain version: scores within 2e-4, (du, dv)
    equal on > 99% of pixels and elsewhere only where the plain scores of
    the two offsets tie within 2e-4; two kernel runs bitwise equal, each
    one launch."""
    n0 = zncc.LAUNCHES["zncc_search"]
    k = zncc.zncc_search(p1, p2, r)
    again = zncc.zncc_search(p1, p2, r)
    pu, pv, ps = zncc.zncc_search_plain(p1, p2, r)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    assert zncc.LAUNCHES["zncc_search"] == n0 + 2
    if p1.dim() == 2:  # one pair as 2-D planes
        p1, p2, k, (pu, pv, ps) = (p1[None], p2[None], [t[None] for t in k],
                                   [t[None] for t in (pu, pv, ps)])
    ku, kv, ks = k
    assert float((ks - ps).abs().max()) < 2e-4
    differ = (ku != pu) | (kv != pv)
    assert 1.0 - float(differ.float().mean()) > 0.99
    if bool(differ.any()):
        at_k = plain_score_at(p1, p2, r, ku, kv, differ)
        assert float((at_k[differ] - ps[differ]).abs().max()) <= 2e-4


# ---------------------------------------------------------------------------
# The synthetic para_gen tree: 5 frames at 854x480, two elliptical objects
# (mask ids 1 and 2) moving by integer translations over a static textured
# background
# ---------------------------------------------------------------------------

PIPE_FRAMES = 5
PIPE_OBJECTS = (  # (centre y, x), (radius y, x), (dx, dy) per frame
    ((150, 230), (90, 120), (6, 3)),
    ((330, 600), (80, 110), (-5, 4)),
)


def rgb_texture(H: int, W: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(40, 255, (H // 8 + 2, W // 8 + 2, 3)),
                   np.ones((8, 8, 1)))[:H, :W]
    detail = np.kron(rng.uniform(-25, 25, (H // 2 + 1, W // 2 + 1, 3)),
                     np.ones((2, 2, 1)))[:H, :W]
    return np.clip(base + detail, 0, 255).astype(np.uint8)


def pipe_object(k: int, t: int, yy, xx):
    """Object k's ellipse in frame t."""
    (cy, cx), (ry, rx), (dx, dy) = PIPE_OBJECTS[k]
    return (((yy - cy - dy * t) / ry) ** 2
            + ((xx - cx - dx * t) / rx) ** 2) < 1.0


def make_pipeline_tree(root: str, n_frames: int = PIPE_FRAMES) -> None:
    H, W = FRAME_H, FRAME_W
    for d in ("orgRGB", "orgMasks"):
        os.makedirs(os.path.join(root, d, "seq0"))
    bg = rgb_texture(H, W, 20) // 3
    texs = [rgb_texture(H, W, 21 + k) for k in range(len(PIPE_OBJECTS))]
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n_frames):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
            ob = pipe_object(k, t, yy, xx)
            img[ob] = texs[k][yy[ob] - dy * t, xx[ob] - dx * t]
            mask[ob] = k + 1
        save_image(os.path.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(os.path.join(root, "orgMasks", "seq0", f"{t:05d}.png"),
                   mask)


def predicted_launches(inp: str, out: str, cfg, masks=None):
    """Kernel launches the code's shapes predict for the run that wrote
    `out`: the matcher's searches for one sub-batch, and one PCG call per
    GN step for every solve chunk the kept constraints give (all pairs are
    one batched chunk). `masks`: each pair's first annotation mask as the
    pipeline saw it (default: the tree's own). Returns (zncc_search, pcg_
    fixed, the kept constraints per (pair, object))."""
    from arap_flow_tpu_torch.ops.matching import clamp_match_params, zncc_calls
    from arap_flow_tpu_torch.pipeline.batch import make_task, max_chunk_for
    from arap_flow_tpu_torch.pipeline.para_gen import MATCH_SUBBATCH

    if masks is None:
        masks = [load_mask(os.path.join(inp, "orgMasks", "seq0",
                                        f"{t:05d}.png"))
                 for t in range(PIPE_FRAMES - 1)]
    n_pairs = len(masks)
    H, W = masks[0].shape
    _, levels = clamp_match_params(H, W)
    n_zncc = -(-n_pairs // MATCH_SUBBATCH) * zncc_calls(levels)
    groups, fallbacks, kept = {}, 0, {}
    rgb = np.zeros((H, W, 3), np.uint8)
    for t in range(n_pairs):
        mk1 = masks[t]
        cons = read_constraint_file(
            os.path.join(out, "tmpCnstr", "seq0", f"{t:05d}.txt"))
        seg = mk1[cons[:, 1], cons[:, 0]]
        for s in np.unique(seg):
            kept[(t, int(s))] = int((seg == s).sum())
            task = make_task(t, int(s), rgb, segment_mask_to_arap(mk1, s),
                             cons[seg == s], E.ArapWeights())
            if task is None:
                fallbacks += 1
                continue
            key = (task.bucket, task.canvas, task.transposed)
            groups[key] = groups.get(key, 0) + 1
    chunks = fallbacks + sum(-(-n // max_chunk_for(key[0]))
                             for key, n in groups.items())
    return n_zncc, chunks * cfg.num_anneal * cfg.gn_iters, kept


def check_pipeline_products(inp: str, out: str, lines,
                            n_pairs: int = PIPE_FRAMES - 1) -> None:
    """The list file, every product, and each object's median |flow − t|
    < 1 px."""
    with open(os.path.join(out, "all_files.list")) as f:
        listed = f.read().splitlines()
    assert len(listed) == n_pairs and listed == lines
    for line in listed:
        rgb1, rgb2, flo = line.split(" ")
        for path in (rgb1, rgb2):
            assert load_rgb(path).shape == (FRAME_H, FRAME_W, 3), path
        u, v = flow_read(flo)
        assert u.shape == (FRAME_H, FRAME_W), flo
        assert np.isfinite(u).all() and np.isfinite(v).all(), flo
    for t in range(n_pairs):
        mk1 = load_mask(os.path.join(inp, "orgMasks", "seq0", f"{t:05d}.png"))
        u, v = flow_read(os.path.join(out, "Flow", "seq0", f"{t:05d}.flo"))
        for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
            obj = mk1 == k + 1
            err = float(np.median(np.hypot(u[obj] - dx, v[obj] - dy)))
            assert err < 1.0, (t, k + 1, err)


def tree_digest(out: str, lines) -> dict:
    """The sha256 of every product file under `out` by relative path, and
    the list file's lines as relative paths (the file holds absolute
    ones)."""
    got = {"all_files.list": [[os.path.relpath(p, out) for p in ln.split(" ")]
                              for ln in lines]}
    for d, _, files in os.walk(out):
        for f in files:
            if f != "all_files.list":
                path = os.path.join(d, f)
                got[os.path.relpath(path, out)] = hashlib.sha256(
                    read_bytes(path)).hexdigest()
    return got


def make_mask_tree(root: str) -> None:
    """The para_gen tree's annotation masks alone: two ellipses (ids 1 and
    2)."""
    os.makedirs(os.path.join(root, "orgMasks", "seq0"))
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W]
    for t in range(PIPE_FRAMES):
        mask = np.zeros((FRAME_H, FRAME_W), np.uint8)
        for k in range(len(PIPE_OBJECTS)):
            mask[pipe_object(k, t, yy, xx)] = k + 1
        save_image(os.path.join(root, "orgMasks", "seq0", f"{t:05d}.png"),
                   mask)


# ---------------------------------------------------------------------------
# Constants recorded from the JAX package (the card's machine has none)
# ---------------------------------------------------------------------------

# The texture families render at the reference renderer's 1280x720.
TEX_H, TEX_W = 720, 1280
# What the JAX package draws for family i from jax.random.PRNGKey(80 + i)
# at TEX_H x TEX_W (arap_flow_tpu/ops/textures.py's render, its splits and
# fold_ins), recorded from JAX 0.9.0 (partitionable threefry, x64 off) on
# the CPU, and the checksums of its 64x96 render from the same key: the
# byte sum and the sum weighted by (index mod 251) + 1 over the flattened
# (64, 96, 3) uint8 image.
TEX_JAX_DRAWS = {
    "brick": {"field": {"bh": 41.466209411621094, "bw": 128.61734008789062,
                        "salt": 4500},
              "c1": (0.7833267450332642, 0.08622419834136963),
              "c2": (0.8968086242675781, 0.6349592208862305),
              "lx": 741.7562866210938, "ly": 237.5738525390625,
              "lz": 1019.6558837890625,
              "lamp": (0.15982317924499512, 0.3082083761692047)},
    "checker": {"field": {"size": 75.69142150878906, "salt": 8367},
                "c1": (0.16992509365081787, 0.5612105131149292),
                "c2": (0.8330081701278687, 0.1864936351776123),
                "lx": 689.0052490234375, "ly": 674.3316650390625,
                "lz": 691.2297973632812,
                "lamp": (0.08031535148620605, 0.4514720141887665)},
    "magic": {"field": {"scale": 168.31243896484375,
                        "turb": 1.1462962627410889},
              "c1": (0.5940728187561035, 0.6032360792160034),
              "c2": (0.6778538227081299, 0.7527016401290894),
              "lx": 1122.1119384765625, "ly": 317.77001953125,
              "lz": 812.8345947265625,
              "lamp": (0.14213669300079346, 0.304582804441452)},
    "musgrave": {"field": {"scale": 282.7886962890625, "salt": 2710},
                 "c1": (0.4351067543029785, 0.15713047981262207),
                 "c2": (0.8525038957595825, 0.40105509757995605),
                 "lx": 534.4094848632812, "ly": 444.499267578125,
                 "lz": 1320.164306640625,
                 "lamp": (0.379291296005249, 0.3209161162376404)},
    "noise": {"field": {"scale": 140.47401428222656, "salt": 5894},
              "c1": (0.3219001293182373, 0.37103450298309326),
              "c2": (0.278814435005188, 0.11680471897125244),
              "lx": 443.0619812011719, "ly": 17.962474822998047,
              "lz": 946.5996704101562,
              "lamp": (0.01751089096069336, 0.28282618522644043)},
    "voronoi": {"field": {"scale": 82.5888900756836, "salt": 8634},
                "c1": (0.27859795093536377, 0.05232644081115723),
                "c2": (0.26984119415283203, 0.26174938678741455),
                "lx": 1187.5316162109375, "ly": 499.50921630859375,
                "lz": 612.8084716796875,
                "lamp": (0.7003108263015747, 0.36502763628959656)},
    "wave": {"field": {"scale": 102.95735931396484,
                       "distort": 4.8272199630737305, "salt": 3401},
             "c1": (0.1135183572769165, 0.8738170862197876),
             "c2": (0.7509418725967407, 0.6336793899536133),
             "lx": 63.840789794921875, "ly": 70.99613952636719,
             "lz": 758.360595703125,
             "lamp": (0.8708604574203491, 0.13437342643737793)},
}
TEX_JAX_SUMS = {  # family: (byte sum, weighted sum) of the 64x96 render
    "brick": (3842737, 482573883), "checker": (3212144, 403932548),
    "magic": (2665213, 335020548), "musgrave": (4007404, 503477752),
    "noise": (3539502, 444739361), "voronoi": (2933338, 368660560),
    "wave": (2856008, 358790033),
}
# texture_gen's seed, the first image's family and the checksums
# (texture_sums) of that family's 64x96 render from the first image's key,
# prng.key(seed * 100003), recorded from the JAX package as TEX_JAX_SUMS
TEXGEN_SEED = 5
TEXGEN_JAX_FIRST = ("noise", (3133716, 393818292))


def texture_sums(img: np.ndarray) -> tuple[int, int]:
    """The byte sum and the (index mod 251) + 1 weighted sum of a uint8
    image (TEX_JAX_SUMS)."""
    v = img.reshape(-1).astype(np.int64)
    return int(v.sum()), int((v * (np.arange(v.size) % 251 + 1)).sum())


def assert_texture_sums(img: np.ndarray, want) -> None:
    """A uint8 64x96 render ≥ 99.9% equal to JAX's and elsewhere within 1
    moves each sum by at most that share of its values (times 251)."""
    got = texture_sums(img)
    n = 64 * 96 * 3
    assert abs(got[0] - want[0]) <= n // 1000, (got, want)
    assert abs(got[1] - want[1]) <= 251 * (n // 1000), (got, want)


# dmo_gen's frame distances on the mask tree
DMO_FDS = (1, 2)
# The JAX package's own dmo_gen on the mask tree (seed 0, set 0, batched
# multseg, 19x8x400, JAX 0.9.0 on the CPU): each object's median |flow -
# fd*(dx, dy)| in px by (fd, pair, object). Object 1's texture (musgrave,
# scale 168, two near colours) is near-uniform, so the reference's
# matcher cannot track it; object 2's it tracks.
DMO_JAX_ERRS = {
    (1, 0, 1): 3.938, (1, 0, 2): 0.891, (1, 1, 1): 5.364, (1, 1, 2): 0.554,
    (1, 2, 1): 4.745, (1, 2, 2): 1.168, (1, 3, 1): 3.673, (1, 3, 2): 1.11,
    (2, 0, 1): 13.416, (2, 0, 2): 0.929, (2, 1, 1): 8.385, (2, 1, 2): 1.358,
    (2, 2, 1): 8.515, (2, 2, 2): 0.79,
}
DMO_TRACKED_MARGIN = 0.5  # px from JAX's error (dmo_flow_gate)
DMO_UNTRACKED = (1,)  # objects whose JAX texture is near-uniform


def dmo_flow_gate(fd: int, t: int, obj: int, err: float) -> str | None:
    """Why object ``obj``'s median flow error ``err`` (px) at the mask
    tree's pair ``t`` of frame distance ``fd`` fails, or None. Every
    object-pair is held to the JAX package's error on it (DMO_JAX_ERRS),
    and below 1 px wherever JAX is: a tracked object within
    DMO_TRACKED_MARGIN of JAX, an untracked one (DMO_UNTRACKED) below JAX
    plus half its motion, which a flow moving it the wrong way or with the
    other object's motion exceeds."""
    ref = DMO_JAX_ERRS[(fd, t, obj)]
    if not np.isfinite(err):
        return f"median flow error {err} is not finite"
    if ref < 1.0 and not err < 1.0:
        return f"median flow error {err} >= 1 px where JAX's is {ref}"
    if obj in DMO_UNTRACKED:
        dx, dy = PIPE_OBJECTS[obj - 1][2]
        bound = ref + fd * float(np.hypot(dx, dy)) / 2
        if not err <= bound:
            return (f"median flow error {err} above JAX's {ref} plus half "
                    f"the motion ({bound:.3f} px)")
    elif not abs(err - ref) <= DMO_TRACKED_MARGIN:
        return (f"median flow error {err} not within {DMO_TRACKED_MARGIN} px "
                f"of JAX's {ref}")
    return None
