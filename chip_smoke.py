"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each reported on its own line; any failure exits non-zero:

0. environment: card name and power limit, torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN.
1. build: compiles the CUDA kernels from ``arap_flow_tpu_torch/csrc``, one
   nvcc process per source, all started together.
2. PCG kernel vs plain: ``pcg_fixed`` (CUDA) against ``pcg_fixed_plain`` on
   the same numpy-seeded problems, on the card: 1 iteration to rtol/atol
   1e-4; at 160 iterations both converged (‖b − JtJ·δ‖ ≤ 1e-5·‖b‖ for every
   problem) with max |Δδ| < 0.01; two kernel runs bitwise equal; µs per
   iteration and ms per 400-iteration call of both.
3. deform path: one 854×480 pair with two segments through the crop path
   (make_task -> BatchRunner -> solve_and_raster_canvas) with the full
   19×8×400 schedule on CUDA; flows written and read back as .flo, checked
   against the segments' analytic rigid motion; launch counts checked.
4. ZNCC kernel vs plain: ``zncc_search`` (CUDA) against
   ``zncc_search_plain`` at the matcher's shapes for an 854×480 sub-batch
   of 4 pairs and at a ragged small shape: scores within 2e-4, (du, dv)
   equal on ≥ 99% of pixels and elsewhere only where the plain scores of
   the two offsets tie within 2e-4, two kernel runs bitwise equal; ms per
   call of both.
5. dataset pipeline: ``para_gen.main_pipeline`` (batched, multseg, 19×8×400)
   on a synthetic tree of 5 frames at 854×480 with two objects moving by
   known translations, written with the port's PNG codec: 4 pairs, one
   matcher sub-batch. The list file, the products, the flow against the
   translations and the launch counts of both kernels are checked; cold
   and warm seconds per pair and the warm run's stages are printed. With
   --profile, one more run under torch.profiler prints the device time by
   kernel and the device's busy share, and a profiled matcher call on the
   same 4 pairs prints the matcher's own device time.

The last line is the JSON device record; the line before it lists the
kernels with their launch counts, errors, times and bounds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores. A kernel's bound is the larger of its bytes
# (each input read once, each output written once) over the first and its
# operations over the second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per pixel and iteration of the PCG on the ARAP system, with the
# loop-constant planes computed once: JtJ·p 62 (neighbour differences 16,
# Laplacians 6, rotation terms 10, gradient terms 14, assembly 16), p·Ap 6,
# δ and r updates 12, z = pre·r 3, r·z 6, p update 6.
PCG_OPS_PER_PIXEL_ITER = 95
# Inputs b, pre (3 planes each), s, c, fit, 4 direction masks; output δ (3).
PCG_PLANES = 13 + 3
# ZNCC search per offset and pixel: the product, a running 12×12 box sum
# (an add and a subtract along each axis) and the running-max compare; the
# z-score per pixel: running sums of p and p² (9) and the mean, variance
# and normalisation (6).
ZNCC_OPS_PER_OFFSET = 6
ZSCORE_OPS = 15


def say(msg: str) -> None:
    print(msg, flush=True)


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(smi)
    say(f"phase 0 env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}; TF32 off (matmul, cudnn)")
    return smi


def phase_build():
    from arap_flow_tpu_torch import _build

    paths, seconds = _build.build()
    _build.load("pcg")
    _build.load("zncc")
    say(f"phase 1 build: {[os.path.relpath(p, ROOT) for p in paths]} in "
        f"{seconds:.2f} s")
    for path in paths:
        log = path[: -len(".so")] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "registers" in line or "spill" in line or (
                            "Compiling entry" in line):
                        say("  ptxas: " + line.strip())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for `nbytes` moved and
    `ops` float32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pcg_bound(B: int, H: int, W: int, iters: int = 400) -> tuple[float, str]:
    px = B * H * W
    return bound(4.0 * px * PCG_PLANES, float(px) * iters * PCG_OPS_PER_PIXEL_ITER)


def zncc_bound(N1: int, N2: int, H: int, W: int, r: int) -> tuple[float, str]:
    n_off = (2 * r + 1) ** 2
    return bound(4.0 * H * W * (N1 + 4 * N2),
                 float(H * W) * (N2 * n_off * ZNCC_OPS_PER_OFFSET
                                 + (N1 + N2) * ZSCORE_OPS))


def pcg_problem(B: int, H: int, W: int, seed: int, device):
    """B numpy-seeded PCG problems at H×W: an interior solve region with a
    constraint grid and border pins, linearised at a perturbed state."""
    import torch

    from arap_flow_tpu_torch.io.constraints import add_border_pins
    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops.solver import guarded_invert

    probs = []
    for k in range(B):
        rng = np.random.default_rng(seed + k)
        mask = np.full((H, W), 255, np.uint8)
        mask[2 : H - 2, 8 : W - 8] = 0
        ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
        cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 2,
                         ys.ravel() - 1], 1).astype(np.int32)
        ops = E.build_operands(mask, add_border_pins(cons, W, H),
                               device=device)
        x = E.init_state(ops) + 0.3 * torch.as_tensor(
            rng.standard_normal((3, H, W)), dtype=torch.float32, device=device)
        cimg = E.anneal_constraints(ops, 1.0)
        s, c = E.trig(x)
        jtf, diag = E.jtf_and_diag(x, ops, cimg)
        probs.append((ops, -jtf, guarded_invert(diag), s, c))
    ops = [p[0] for p in probs]

    def st(xs):
        return torch.stack(xs).contiguous()

    args = (st([p[1] for p in probs]), st([p[2] for p in probs]),
            st([p[3] for p in probs]), st([p[4] for p in probs]),
            st([o.vmasks for o in ops]), st([o.fitmask for o in ops]),
            st([o.wf2 for o in ops]), st([o.wr2 for o in ops]))
    return ops, args


# At 160 iterations CG has converged on these problems: the plain version
# reaches ≤ 3e-7·‖b‖ at every shape below (CPU run), so a bound of 1e-5·‖b‖
# does not depend on where CG stands in its oscillation, as a ratio of two
# residuals after fewer iterations does.
CONVERGED_ITERS = 160


def relative_residuals(ops, args, delta) -> list[float]:
    """‖b − JtJ·δ‖ / ‖b‖ of every problem of the batch."""
    import torch

    from arap_flow_tpu_torch.ops import energy as E

    b, _, s, c = args[:4]
    out = []
    for k, o in enumerate(ops):
        r = b[k] - E.apply_jtj(delta[k], o, s[k], c[k])
        out.append(float(torch.linalg.vector_norm(r)
                         / torch.linalg.vector_norm(b[k])))
    return out


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of one `fn()` call, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return float(np.median(times))


def phase_kernel(shapes, timed_shapes, call_shapes):
    """Kernel vs plain on the card at each (B, H, W). Returns the largest
    1-iteration |difference| and, for each of `call_shapes` (the main
    path's), the median ms of one 400-iteration call of kernel and plain."""
    import torch

    from arap_flow_tpu_torch.ops.pcg import pcg_fixed, pcg_fixed_plain

    dev = torch.device("cuda", 0)
    max_err = 0.0
    for B, H, W in shapes:
        ops, args = pcg_problem(B, H, W, seed=10 * H + W, device=dev)
        k1 = pcg_fixed(*args, 1)
        p1 = pcg_fixed_plain(*args, 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(k1, p1, rtol=1e-4, atol=1e-4)
        err1 = float((k1 - p1).abs().max())
        max_err = max(max_err, err1)
        n = CONVERGED_ITERS
        kn = pcg_fixed(*args, n)
        pn = pcg_fixed_plain(*args, n)
        knb = pcg_fixed(*args, n)
        torch.cuda.synchronize()
        if not torch.equal(kn, knb):
            raise AssertionError(f"kernel not bitwise repeatable at {B}x{H}x{W}")
        res_k = max(relative_residuals(ops, args, kn))
        res_p = max(relative_residuals(ops, args, pn))
        dn = float((kn - pn).abs().max())
        if not (res_k <= 1e-5 and res_p <= 1e-5 and dn < 0.01):
            raise AssertionError(
                f"{n} iterations at {B}x{H}x{W}: residual/|b| {res_k} "
                f"(plain {res_p}), max |d| {dn}")
        line = (f"phase 2 kernel vs plain B={B} {H}x{W}: 1-iter max|d| "
                f"{err1:.3g}; {n}-iter residual/|b| {res_k:.3g} (plain "
                f"{res_p:.3g}), max|d| {dn:.3g}; bitwise repeat ok")
        if (B, H, W) in timed_shapes:
            us_k = cuda_ms(lambda: pcg_fixed(*args, 200)) * 1000.0 / 200
            us_p = cuda_ms(lambda: pcg_fixed_plain(*args, 20),
                           reps=3) * 1000.0 / 20
            line += f"; us/iter kernel {us_k:.2f}, plain {us_p:.2f}"
        say(line)
    call_ms = {}
    for B, H, W in call_shapes:
        _, args = pcg_problem(B, H, W, seed=7, device=dev)
        ms = cuda_ms(lambda: pcg_fixed(*args, 400))
        plain_ms = cuda_ms(lambda: pcg_fixed_plain(*args, 400), reps=3)
        call_ms[(B, H, W)] = (ms, plain_ms)
        bms, by = pcg_bound(B, H, W)
        say(f"phase 2 one 400-iteration call at B={B} {H}x{W}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
            f"({by})")
    return max_err, call_ms


# The bench's frame pair (bench.py): 854×480, two elliptical segments.
FRAME_H, FRAME_W = 480, 854
SEG_SHAPES = (((90, 330), (180, 300)), ((260, 480), (120, 260)))
SEG_SEEDS = (100, 101)


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
    from arap_flow_tpu_torch.ops.energy import ArapWeights
    from arap_flow_tpu_torch.pipeline.batch import make_task

    probs = [segment_problem(seed, c, s)
             for seed, (c, s) in zip(SEG_SEEDS, SEG_SHAPES)]
    tasks = [make_task(0, j, rgb, mask, cons, ArapWeights())
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
    calls += [(1, FRAME_H, FRAME_W)] * sum(t is None for t in tasks)
    return calls


def run_pair(probs, tasks, cfg, device):
    """The pair through BatchRunner (the crop path); returns its products."""
    import torch

    from arap_flow_tpu_torch.pipeline.batch import BatchRunner

    runner = BatchRunner(cfg, device=device)
    for j, ((rgb, mask, cons, _), t) in enumerate(zip(probs, tasks)):
        if t is None:
            runner.add_fallback(0, j, rgb, mask, cons)
        else:
            runner.add(t)
    out = runner.finish()
    torch.cuda.synchronize()
    return out, runner.timer


def phase_main_path(smi, probs, tasks, calls, call_ms):
    """Full 19×8×400 schedule on CUDA through the crop path; returns the
    kernel launch counts of that run. `calls` are the kernel call shapes of
    one GN step (solve_calls), `call_ms` the kernel's measured ms per
    400-iteration call at each."""
    import torch

    from arap_flow_tpu_torch.io.flo import flow_read, flow_write
    from arap_flow_tpu_torch.ops import pcg
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    dev = torch.device("cuda", 0)
    cfg = SolverConfig()
    say(f"phase 3 main path: {len(tasks)} segments, buckets "
        f"{[(t.bucket, t.canvas, t.transposed) if t else None for t in tasks]}"
        f"; kernel calls per GN step {calls}")

    for name in pcg.LAUNCHES:
        pcg.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    out, _ = run_pair(probs, tasks, cfg, dev)
    cold = time.perf_counter() - t0
    launches = dict(pcg.LAUNCHES)
    expect = len(calls) * cfg.num_anneal * cfg.gn_iters
    if launches["pcg_fixed"] != expect:
        raise AssertionError(f"pcg_fixed launched {launches['pcg_fixed']} "
                             f"times, expected {expect}")

    with tempfile.TemporaryDirectory() as tmp:
        for j, (rgb, mask, cons, motion) in enumerate(probs):
            res = out[(0, j)]
            path = os.path.join(tmp, f"seg{j}.flo")
            flow_write(path, res.flow)
            u, v = flow_read(path)
            flow = np.dstack([u, v])
            if not np.array_equal(flow, res.flow):
                raise AssertionError(".flo round trip changed the flow")
            if flow.shape != (FRAME_H, FRAME_W, 2) or not np.isfinite(flow).all():
                raise AssertionError(f"segment {j}: bad flow {flow.shape}")
            epe = rigid_epe_median(flow, mask, SEG_SHAPES[j][0], motion)
            covered = int((res.warped_mask == 255).sum())
            obj = int((mask == 0).sum())
            say(f"phase 3 segment {j}: median rigid EPE {epe:.4f} px over "
                f"{obj} object px; warped mask {covered} px")
            if not epe < 1.0:
                raise AssertionError(f"segment {j}: median EPE {epe} >= 1 px")
            if covered == 0:
                raise AssertionError(f"segment {j}: empty warped mask")

    t0 = time.perf_counter()
    _, timer = run_pair(probs, tasks, cfg, dev)
    warm = time.perf_counter() - t0
    say(f"phase 3 pair seconds: cold {cold:.3f}, warm {warm:.3f} "
        f"({smi}); pcg_fixed launches {launches['pcg_fixed']} (expected "
        f"{expect})")
    pcg_s = sum(cfg.num_anneal * cfg.gn_iters * call_ms[s][0] / 1000.0
                for s in calls)
    say(f"phase 3 PCG kernel time in the pair (GN steps x measured ms per "
        f"call): {pcg_s:.3f} s of the warm {warm:.3f} s")
    say("phase 3 warm-run stages:\n" + timer.report())
    return launches


def small_reference_check():
    """A small crop-path problem on CUDA (kernel) against the same problem
    on the CPU (plain torch): flows within 0.05 px."""
    from arap_flow_tpu_torch.models.arap import ArapDeformer
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    rng = np.random.default_rng(5)
    H, W = 56, 72
    mask = np.full((H, W), 255, np.uint8)
    mask[18:38, 20:44] = 0
    rgb = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
    ys, xs = np.mgrid[20:36:4, 22:42:4]
    cons = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 3, ys.ravel() + 2],
                    1).astype(np.int32)
    cfg = SolverConfig(num_anneal=2, gn_iters=2, max_pcg_iters=40,
                       pcg_iters=40.0)
    buckets = ((32, 32), (32, 48), (48, 48), (48, 64))
    gpu = ArapDeformer(cfg, crop=True, crop_buckets=buckets,
                       device="cuda").deform(rgb, mask, cons)
    cpu = ArapDeformer(cfg, crop=True, crop_buckets=buckets,
                       device="cpu").deform(rgb, mask, cons)
    d = float(np.abs(gpu.flow - cpu.flow).max())
    mdis = float((gpu.warped_mask != cpu.warped_mask).mean())
    say(f"phase 3 small reference (56x72, 2x2x40): max |flow cuda - flow "
        f"cpu| {d:.3g} px, warped-mask disagreement {mdis:.4f}")
    if not (d < 0.05 and mdis <= 0.005):
        raise AssertionError("CUDA path disagrees with the CPU reference")


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
    import torch
    import torch.nn.functional as F

    from arap_flow_tpu_torch.ops.zncc import box_sum, zscore

    z1 = zscore(p1, 12).repeat_interleave(p2.shape[0] // p1.shape[0], 0)
    z2 = zscore(p2, 12)
    N, H, W = z2.shape
    z2p = F.pad(z2, (r, r, r, r))
    out = torch.full((N, H, W), float("nan"), device=p1.device)
    offs = torch.stack([du[where], dv[where]], 1).unique(dim=0)
    for ox, oy in offs.to(torch.int64).tolist():
        sel = where & (du == ox) & (dv == oy)
        shifted = z2p[:, r + oy : r + oy + H, r + ox : r + ox + W]
        corr = box_sum(z1 * shifted, 12) / 144.0
        out[sel] = corr[sel]
    return out


# (N1, N2, H, W, radius) of the searches of one matcher call on a
# sub-batch of 4 pairs at 854x480 (levels 3, radius 100): the coarse bank
# of 8 lanes x 5 hypotheses at r = 13, then one refine per level at r = 2.
ZNCC_MAIN_SHAPES = ((8, 40, 60, 106, 13), (8, 8, 120, 213, 2),
                    (8, 8, 240, 427, 2), (8, 8, 480, 854, 2))
ZNCC_RAGGED = (3, 6, 45, 70, 7)


def phase_zncc():
    """ZNCC kernel vs plain at the matcher's shapes and a ragged one.
    Returns (max |score difference|, kernel ms, plain ms, bound ms, bound_by)
    summed over the four searches of one main-path matcher call."""
    import torch

    from arap_flow_tpu_torch.ops.zncc import zncc_search, zncc_search_plain

    dev = torch.device("cuda", 0)
    max_err = 0.0
    totals = [0.0, 0.0, 0.0]
    by = {}
    for N1, N2, H, W, r in (*ZNCC_MAIN_SHAPES, ZNCC_RAGGED):
        a, b = zncc_inputs(N1, N2, H, W, r, seed=H + W + r)
        p1, p2 = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        ku, kv, ks = zncc_search(p1, p2, r)
        ku2, kv2, ks2 = zncc_search(p1, p2, r)
        pu, pv, ps = zncc_search_plain(p1, p2, r)
        torch.cuda.synchronize()
        if not (torch.equal(ku, ku2) and torch.equal(kv, kv2)
                and torch.equal(ks, ks2)):
            raise AssertionError(f"zncc kernel not bitwise repeatable at "
                                 f"{N2}x{H}x{W} r={r}")
        err = float((ks - ps).abs().max())
        differ = (ku != pu) | (kv != pv)
        agree = 1.0 - float(differ.float().mean())
        at_k = plain_score_at(p1, p2, r, ku, kv, differ)
        tie = float((at_k[differ] - ps[differ]).abs().max()) if bool(
            differ.any()) else 0.0
        line = (f"phase 4 zncc {N1}->{N2}x{H}x{W} r={r}: max|score d| "
                f"{err:.3g}; argmax agreement {agree:.6f}, largest plain "
                f"score gap where they differ {tie:.3g}; bitwise repeat ok")
        if not (err <= 2e-4 and agree >= 0.99 and tie <= 2e-4):
            raise AssertionError(line)
        max_err = max(max_err, err)
        if (N1, N2, H, W, r) in ZNCC_MAIN_SHAPES:
            ms = cuda_ms(lambda: zncc_search(p1, p2, r))
            plain_ms = cuda_ms(lambda: zncc_search_plain(p1, p2, r), reps=3)
            bms, b_by = zncc_bound(N1, N2, H, W, r)
            for i, v in enumerate((ms, plain_ms, bms)):
                totals[i] += v
            by[b_by] = by.get(b_by, 0.0) + bms
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                     f"{bms:.4f} ms ({b_by})")
        say(line)
    say(f"phase 4 one matcher call's four searches: kernel {totals[0]:.4f} "
        f"ms, plain {totals[1]:.3f} ms, bound {totals[2]:.4f} ms")
    return max_err, totals[0], totals[1], totals[2], max(by, key=by.get)


# The synthetic para_gen tree: 5 frames at 854x480, two elliptical objects
# (mask ids 1 and 2) moving by integer translations over a static textured
# background.
PIPE_FRAMES = 5
# The PCG call of the pipeline's solves: both of its solve chunks hold 4
# segments on a 192x256 bucket (phase 5 prints the groups it formed).
PIPE_PCG_SHAPE = (4, 192, 256)
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


def make_pipeline_tree(root: str) -> None:
    from arap_flow_tpu_torch.io.image import save_image

    H, W = FRAME_H, FRAME_W
    for d in ("orgRGB", "orgMasks"):
        os.makedirs(os.path.join(root, d, "seq0"))
    bg = rgb_texture(H, W, 20) // 3
    texs = [rgb_texture(H, W, 21 + k) for k in range(len(PIPE_OBJECTS))]
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(PIPE_FRAMES):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        for k, ((cy, cx), (ry, rx), (dx, dy)) in enumerate(PIPE_OBJECTS):
            ob = (((yy - cy - dy * t) / ry) ** 2
                  + ((xx - cx - dx * t) / rx) ** 2) < 1.0
            img[ob] = texs[k][yy[ob] - dy * t, xx[ob] - dx * t]
            mask[ob] = k + 1
        save_image(os.path.join(root, "orgRGB", "seq0", f"{t:05d}.png"), img)
        save_image(os.path.join(root, "orgMasks", "seq0", f"{t:05d}.png"),
                   mask)


def predicted_launches(inp: str, out: str, cfg, weights):
    """Kernel launches the code's shapes predict for the run that wrote
    `out`: the matcher's searches for one sub-batch, and one PCG call per
    GN step for every solve chunk the kept constraints give (all pairs are
    one batched chunk). Also returns the kept constraints per (pair,
    object)."""
    from arap_flow_tpu_torch.io.constraints import read_constraint_file
    from arap_flow_tpu_torch.io.image import load_mask, segment_mask_to_arap
    from arap_flow_tpu_torch.ops.matching import clamp_match_params, zncc_calls
    from arap_flow_tpu_torch.pipeline.batch import make_task, max_chunk_for
    from arap_flow_tpu_torch.pipeline.para_gen import MATCH_SUBBATCH

    n_pairs = PIPE_FRAMES - 1
    _, levels = clamp_match_params(FRAME_H, FRAME_W)
    zncc = -(-n_pairs // MATCH_SUBBATCH) * zncc_calls(levels)
    groups, fallbacks, kept = {}, 0, {}
    rgb = np.zeros((FRAME_H, FRAME_W, 3), np.uint8)
    for t in range(n_pairs):
        mk1 = load_mask(os.path.join(inp, "orgMasks", "seq0", f"{t:05d}.png"))
        cons = read_constraint_file(
            os.path.join(out, "tmpCnstr", "seq0", f"{t:05d}.txt"))
        seg = mk1[cons[:, 1], cons[:, 0]]
        for s in np.unique(seg):
            kept[(t, int(s))] = int((seg == s).sum())
            task = make_task(t, int(s), rgb, segment_mask_to_arap(mk1, s),
                             cons[seg == s], weights)
            if task is None:
                fallbacks += 1
                continue
            key = (task.bucket, task.canvas, task.transposed)
            groups[key] = groups.get(key, 0) + 1
    chunks = fallbacks + sum(-(-n // max_chunk_for(key[0]))
                             for key, n in groups.items())
    return zncc, chunks * cfg.num_anneal * cfg.gn_iters, kept, groups


def run_pipeline(inp: str, out: str, cfg):
    import torch

    from arap_flow_tpu_torch.pipeline import para_gen

    flags = para_gen.PipelineFlags(input=inp, output=out, multseg=True,
                                   seed=0, mode="batched", device="cuda")
    t0 = time.perf_counter()
    lines = para_gen.main_pipeline(flags, solver_cfg=cfg)
    torch.cuda.synchronize()
    return lines, time.perf_counter() - t0


def check_pipeline_products(inp: str, out: str, lines) -> None:
    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask, load_rgb

    n_pairs = PIPE_FRAMES - 1
    with open(os.path.join(out, "all_files.list")) as f:
        listed = f.read().splitlines()
    if len(listed) != n_pairs or listed != lines:
        raise AssertionError(f"all_files.list holds {len(listed)} lines, "
                             f"expected {n_pairs}")
    for line in listed:
        rgb1, rgb2, flo = line.split(" ")
        for path in (rgb1, rgb2):
            if load_rgb(path).shape != (FRAME_H, FRAME_W, 3):
                raise AssertionError(f"{path}: bad image")
        u, v = flow_read(flo)
        if u.shape != (FRAME_H, FRAME_W) or not (
                np.isfinite(u).all() and np.isfinite(v).all()):
            raise AssertionError(f"{flo}: bad flow")
    for t in range(n_pairs):
        mk1 = load_mask(os.path.join(inp, "orgMasks", "seq0", f"{t:05d}.png"))
        u, v = flow_read(os.path.join(out, "Flow", "seq0", f"{t:05d}.flo"))
        for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
            obj = mk1 == k + 1
            err = float(np.median(np.hypot(u[obj] - dx, v[obj] - dy)))
            say(f"phase 5 pair {t} object {k + 1}: median |flow - ({dx}, "
                f"{dy})| {err:.4f} px over {int(obj.sum())} px")
            if not err < 1.0:
                raise AssertionError(f"pair {t} object {k + 1}: median flow "
                                     f"error {err} >= 1 px")


def device_time_report(prof, wall_s: float, label: str) -> None:
    """Device time by kernel of a torch.profiler run (the device-side
    events only: kernels and copies, each counted once), grouped into the
    port's kernels and the rest, and the device's busy share of `wall_s`."""
    from torch.autograd import DeviceType

    rows: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = rows.get(e.name, (0.0, 0))
            rows[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    total_us = sum(us for us, _ in rows.values())
    if total_us <= 0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    groups = {"pcg kernels": 0.0, "zncc kernels": 0.0, "torch ops": 0.0}
    for name, (us, _) in rows.items():
        key = ("pcg kernels" if "pcg_" in name else "zncc kernels"
               if ("zscore_kernel" in name or "search_kernel" in name)
               else "torch ops")
        groups[key] += us
    say(f"{label}: device busy {total_us / 1e6:.4f} s of {wall_s:.4f} s "
        f"wall under the profiler ({100 * total_us / 1e6 / wall_s:.1f}%); "
        + ", ".join(f"{k} {v / 1e6:.4f} s ({100 * v / total_us:.1f}%)"
                    for k, v in groups.items()))
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, n) in top:
        say(f"  {us / 1e3:10.3f} ms {n:8d} launches  {name[:90]}")


def profile_pipeline(inp: str, out: str, cfg) -> None:
    """The warm pipeline and then its matcher alone under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from arap_flow_tpu_torch.io.image import load_rgb
    from arap_flow_tpu_torch.ops.matching import (match_images_dispatch_multi,
                                                  match_images_fetch)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, wall = run_pipeline(inp, out, cfg)
    device_time_report(prof, wall, "phase 5 profiled warm run")
    frames = [load_rgb(os.path.join(inp, "orgRGB", "seq0", f"{t:05d}.png"))
              for t in range(PIPE_FRAMES)]
    pairs = list(zip(frames[:-1], frames[1:]))
    dev = torch.device("cuda", 0)
    for _ in range(2):  # the first call warms the allocator
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for h in match_images_dispatch_multi(pairs, radius=100,
                                                 device=dev):
                match_images_fetch(h)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    device_time_report(prof, wall, "phase 5 profiled matcher call (4 pairs)")


def phase_pipeline(smi: str, profiled: bool = False):
    """The dataset pipeline on the card; returns its kernel launches."""
    from arap_flow_tpu_torch.ops import pcg, zncc
    from arap_flow_tpu_torch.ops.energy import ArapWeights
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen
    from arap_flow_tpu_torch.utils.profiling import StageTimer

    cfg = SolverConfig()
    n_pairs = PIPE_FRAMES - 1
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        make_pipeline_tree(inp)
        for counts in (pcg.LAUNCHES, zncc.LAUNCHES):
            for name in counts:
                counts[name] = 0
        lines, cold = run_pipeline(inp, os.path.join(tmp, "cold"), cfg)
        launches = {**pcg.LAUNCHES, **zncc.LAUNCHES}
        z_exp, p_exp, kept, groups = predicted_launches(
            inp, os.path.join(tmp, "cold"), cfg, ArapWeights())
        say(f"phase 5 launches: zncc_search {launches['zncc_search']} "
            f"(predicted {z_exp}), pcg_fixed {launches['pcg_fixed']} "
            f"(predicted {p_exp}; solve groups {groups})")
        say(f"phase 5 kept constraints per (pair, object): {kept}")
        if (launches["zncc_search"], launches["pcg_fixed"]) != (z_exp, p_exp):
            raise AssertionError("launch counts differ from the prediction")
        if len(kept) != n_pairs * len(PIPE_OBJECTS) or min(kept.values()) < 20:
            raise AssertionError(f"too few constraints per object: {kept}")
        check_pipeline_products(inp, os.path.join(tmp, "cold"), lines)

        para_gen.TIMER = StageTimer()
        for counts in (pcg.LAUNCHES, zncc.LAUNCHES):
            for name in counts:
                counts[name] = 0
        lines, warm = run_pipeline(inp, os.path.join(tmp, "warm"), cfg)
        if (zncc.LAUNCHES["zncc_search"], pcg.LAUNCHES["pcg_fixed"]) != (
                z_exp, p_exp):
            raise AssertionError("warm run: launch counts differ")
        check_pipeline_products(inp, os.path.join(tmp, "warm"), lines)
        say(f"phase 5 seconds per pair: cold {cold / n_pairs:.3f}, warm "
            f"{warm / n_pairs:.3f} ({n_pairs} pairs, {smi})")
        say("phase 5 warm-run stages:\n" + para_gen.TIMER.report())
        if profiled:
            profile_pipeline(inp, os.path.join(tmp, "profiled"), cfg)
    return launches


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the pipeline's device time (phase 5)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        say("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, ROOT)
    smi = phase_env()
    phase_build()
    probs, tasks = make_tasks()
    calls = solve_calls(tasks)
    main_shapes = sorted(set(calls))
    shapes = [(1, 16, 128), (3, 224, 384), (1, 480, 854), *main_shapes]
    max_err, call_ms = phase_kernel(
        shapes, [(3, 224, 384), (1, 480, 854)],
        [*main_shapes, PIPE_PCG_SHAPE])
    ms, plain_ms = call_ms[PIPE_PCG_SHAPE]
    small_reference_check()
    launches = phase_main_path(smi, probs, tasks, calls, call_ms)
    if launches["pcg_fixed"] <= 0:
        raise AssertionError("the deform path never launched pcg_fixed")
    z_err, z_ms, z_plain, z_bound, z_by = phase_zncc()
    launches = phase_pipeline(smi, args.profile)
    if min(launches.values()) <= 0:
        raise AssertionError(f"the pipeline missed a kernel: {launches}")
    p_bound, p_by = pcg_bound(*PIPE_PCG_SHAPE)
    say(json.dumps({"kernels": [{
        "name": "pcg_fixed", "route": "cuda",
        "source": "arap_flow_tpu_torch/csrc/pcg.cu",
        "replaces": "arap_flow_tpu/ops/pallas_pcg.py:247",
        "launches": launches["pcg_fixed"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": p_bound,
        "bound_by": p_by, "library_ms": None,
    }, {
        "name": "zncc_search", "route": "cuda",
        "source": "arap_flow_tpu_torch/csrc/zncc.cu",
        "replaces": "arap_flow_tpu/ops/pallas_match.py:125",
        "launches": launches["zncc_search"], "max_abs_err": z_err,
        "ms": z_ms, "plain_ms": z_plain, "bound_ms": z_bound,
        "bound_by": z_by, "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
