"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each reported on its own line; any failure exits non-zero:

0. environment: card name and power limit, torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN.
1. build: compiles the three CUDA libraries from ``arap_flow_tpu_torch/csrc``
   (pcg, zncc, fused_solver), one nvcc process per source, all started
   together, and loads them.
2. PCG kernel vs plain: for each shape, the cluster kernel's plan
   (``pcg_plan``: CTAs a problem, rows a CTA, resident or streamed, planes
   in shared memory) and how many of its clusters the card holds at once
   (cudaOccupancyMaxActiveClusters, both layouts); then ``pcg_fixed``
   (CUDA) in both layouts, standard and tall, against ``pcg_fixed_plain``
   on the same numpy-seeded problems, on the card: 1 iteration to
   rtol/atol 1e-4; at 160 iterations both converged (‖b − JtJ·δ‖ ≤
   1e-5·‖b‖ for every problem) with max |Δδ| < 0.01; two kernel runs
   bitwise equal; the tall layout within 1e-5 of the standard one. The
   shapes cover both memory plans (384×640 the largest resident one,
   480×854 and 512×896 streamed). Then ms per 400-iteration call of the
   cluster kernel beside the three-pass yardstick
   (``_pcg_fixed_three_pass``), the tall layout and the plain version.
2b. solve_batch: 4 numpy-seeded 192×256 problems (the pipeline's chunk
   shape) at 3×2×60 against per-problem solves (1e-4) and against the
   plain version on the CPU (max |Δflow| < 0.05 px, median < 0.005 px),
   with the closed-form iteration count; then at 19×8×400 in the standard
   layout and under ARAP_TALL_KERNEL=1, each run's launches counted, the
   tall flows within 1e-5 of the standard ones.
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
6. fused kernel vs plain: ``anneal_solve_fused`` (one cooperative launch a
   solve) against ``anneal_solve_fused_plain`` at 16×128 (3×2×60), B=1
   192×384 and B=4 192×256 (2×2×40): 1×1×1 within 1e-4 and 1×1×3 within
   0.01; over the solve region median |Δx| < 1e-3 and max |Δx| < 0.01;
   every problem's final cost within 5%; two kernel runs bitwise equal; ms
   a call of both, and the kernel's ms a 19×8×400 solve beside 152 per-GN
   PCG calls.
6b. fused deform pair: phase 3's pair again with SolverConfig(backend=
   "fused"): median rigid EPE < 1 px and median |flow − phase 3's flow| <
   0.05 px per segment; one fused launch per solve chunk and no PCG
   launch; cold and warm seconds. With --profile, one more warm run under
   torch.profiler prints its device time by kernel and busy share.

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
# The fused whole-schedule kernel (csrc/fused_solver.cu) solves the same
# system, so its bound counts the fewest operations the schedule needs, not
# the unfactored JtJ that the kernel recomputes each iteration: a PCG
# iteration is PCG_OPS_PER_PIXEL_ITER, and each GN step adds the
# linearisation and the loop-constant planes once. The linearisation: sin
# and cos of one angle 26 (a shared range reduction: the multiply by 2/π,
# the rounding and three fused multiply-adds, 8; the square of the reduced
# angle 1; the sine and cosine polynomials, four fused multiply-adds each,
# 16; a sign 1), the annealed constraint 6, the fit terms 5, per direction
# 20 (residuals 8, gradient terms 12) so 80, z = pre·r and r·z 9, x += δ 3.
# The loop-constant planes of the factored JtJ: the 4 directions' gradient
# weights 12, the fit weight 1, the two rotation sums 10, the degree 4.
FUSED_OPS_PER_PIXEL_GN = 26 + 6 + 5 + 80 + 9 + 3 + 27
# Once a solve: the degree 3 and the two preconditioner planes 9.
FUSED_OPS_SETUP = 12
# Inputs vm (4 planes), fit, con_src (2), con_tgt (2), grid (2); output x (3).
FUSED_PLANES = 11 + 3
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
    for stem in ("pcg", "zncc", "fused_solver"):
        _build.load(stem)
    say(f"phase 1 build: {len(paths)} libraries "
        f"{[os.path.relpath(p, ROOT) for p in paths]} in {seconds:.2f} s")
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


def fused_bound(B: int, H: int, W: int, num_anneal: int, gn_iters: int,
                pcg_iters: int) -> tuple[float, str]:
    px = B * H * W
    per_px = FUSED_OPS_SETUP + num_anneal * gn_iters * (
        FUSED_OPS_PER_PIXEL_GN + pcg_iters * PCG_OPS_PER_PIXEL_ITER)
    return bound(4.0 * px * FUSED_PLANES, float(px) * per_px)


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


# Phase 2's shapes besides the main path's: a thin one (one row a CTA),
# B = 3, the pipeline's chunk, the largest resident bucket (p only in
# shared memory), the two streamed shapes (the full frame and the largest
# bucket), the pipeline's largest chunk (pipeline/batch.py's MAX_CHUNK of
# the smallest bucket), a batch large enough for one-CTA clusters and an
# odd width (one pixel a thread; even widths take pixel pairs).
KERNEL_SHAPES = ((1, 16, 128), (3, 224, 384), (4, 192, 256), (1, 384, 640),
                 (1, 480, 854), (1, 512, 896), (24, 64, 128), (72, 16, 128),
                 (3, 33, 85))
# 400-iteration calls timed besides the main path's: the thin shape (the
# kernel's fixed cost an iteration), the largest resident bucket, the full
# frame (streamed) and the largest chunk.
TIMED_SHAPES = ((1, 16, 128), (1, 384, 640), (1, 480, 854), (24, 64, 128))

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


def check_pcg_layout(ops, args, tall: bool, plain1, plain_n, shape):
    """One layout of the kernel against the plain version: 1 iteration to
    1e-4; converged at CONVERGED_ITERS with max |Δδ| < 0.01; bitwise
    repeatable. Returns (1-iteration δ, converged δ, 1-iteration max |Δ|,
    residual/‖b‖, converged max |Δ|)."""
    import torch

    from arap_flow_tpu_torch.ops.pcg import pcg_fixed

    B, H, W = shape
    k1 = pcg_fixed(*args, 1, tall=tall)
    torch.cuda.synchronize()
    torch.testing.assert_close(k1, plain1, rtol=1e-4, atol=1e-4)
    n = CONVERGED_ITERS
    kn = pcg_fixed(*args, n, tall=tall)
    knb = pcg_fixed(*args, n, tall=tall)
    torch.cuda.synchronize()
    if not torch.equal(kn, knb):
        raise AssertionError(f"kernel (tall={tall}) not bitwise repeatable "
                             f"at {B}x{H}x{W}")
    res = max(relative_residuals(ops, args, kn))
    res_p = max(relative_residuals(ops, args, plain_n))
    dn = float((kn - plain_n).abs().max())
    if not (res <= 1e-5 and res_p <= 1e-5 and dn < 0.01):
        raise AssertionError(
            f"{n} iterations (tall={tall}) at {B}x{H}x{W}: residual/|b| "
            f"{res} (plain {res_p}), max |d| {dn}")
    return k1, kn, float((k1 - plain1).abs().max()), res, dn


def plan_line(B: int, H: int, W: int) -> str:
    """The cluster kernel's plan at (B, H, W) and its active clusters on
    this card in both layouts."""
    from arap_flow_tpu_torch.ops.pcg import active_clusters, pcg_plan

    plan = pcg_plan(B, H, W)
    act = [active_clusters(B, H, W, tall=t) for t in (False, True)]
    if min(act) <= 0:
        raise AssertionError(f"no cluster of {plan} fits the card")
    return (f"phase 2 plan B={B} {H}x{W}: cluster {plan.cluster}, "
            f"{plan.rows_per_cta} rows a CTA, "
            f"{'resident' if plan.resident else 'streamed'}, "
            f"{plan.groups} groups in shared memory, {plan.smem_bytes} B; "
            f"active clusters {act[0]} (tall {act[1]})")


def phase_kernel(shapes, call_shapes):
    """Kernel in both layouts vs plain on the card at each (B, H, W), with
    its plan. Returns the largest 1-iteration |difference| of each layout
    and, for each of `call_shapes`, the median ms of one 400-iteration call
    of the kernel, the plain version, the tall kernel and the three-pass
    yardstick."""
    import torch

    from arap_flow_tpu_torch.ops.pcg import (_pcg_fixed_three_pass,
                                             pcg_fixed, pcg_fixed_plain)

    dev = torch.device("cuda", 0)
    max_err = max_err_tall = 0.0
    for B, H, W in shapes:
        say(plan_line(B, H, W))
        ops, args = pcg_problem(B, H, W, seed=10 * H + W, device=dev)
        p1 = pcg_fixed_plain(*args, 1)
        pn = pcg_fixed_plain(*args, CONVERGED_ITERS)
        k1, kn, err1, res_k, dn = check_pcg_layout(ops, args, False, p1, pn,
                                                   (B, H, W))
        t1, tn, terr1, res_t, dtn = check_pcg_layout(ops, args, True, p1, pn,
                                                     (B, H, W))
        d_std = max(float((t1 - k1).abs().max()), float((tn - kn).abs().max()))
        if not d_std <= 1e-5:
            raise AssertionError(f"tall and standard layouts differ by "
                                 f"{d_std} at {B}x{H}x{W}")
        max_err, max_err_tall = max(max_err, err1), max(max_err_tall, terr1)
        say(f"phase 2 kernel vs plain B={B} {H}x{W}: 1-iter max|d| "
            f"{err1:.3g} (tall {terr1:.3g}); {CONVERGED_ITERS}-iter "
            f"residual/|b| {res_k:.3g} (tall {res_t:.3g}), max|d| "
            f"{dn:.3g} (tall {dtn:.3g}); tall vs standard max|d| "
            f"{d_std:.3g}; bitwise repeat ok")
    call_ms = {}
    for B, H, W in call_shapes:
        _, args = pcg_problem(B, H, W, seed=7, device=dev)
        ms = cuda_ms(lambda: pcg_fixed(*args, 400, tall=False))
        three_ms = cuda_ms(lambda: _pcg_fixed_three_pass(*args, 400))
        tall_ms = cuda_ms(lambda: pcg_fixed(*args, 400, tall=True))
        plain_ms = cuda_ms(lambda: pcg_fixed_plain(*args, 400), reps=3)
        call_ms[(B, H, W)] = (ms, plain_ms, tall_ms, three_ms)
        bms, by = pcg_bound(B, H, W)
        say(f"phase 2 one 400-iteration call at B={B} {H}x{W}: cluster "
            f"kernel {ms:.3f} ms ({ms * 2.5:.2f} us an iteration), three-pass "
            f"{three_ms:.3f} ms ({three_ms * 2.5:.2f} us an iteration), tall "
            f"{tall_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
            f"({by})")
    return max_err, max_err_tall, call_ms


def stack_operands(probs):
    from arap_flow_tpu_torch.ops.energy import ArapOperands
    import torch

    return ArapOperands(**{f: torch.stack([getattr(o, f) for o in probs])
                           for f in vars(probs[0])})


def segment_operands(B: int, H: int, W: int, seed: int, device):
    """B numpy-seeded segment problems on an H×W bucket: an elliptical
    object whose constraint grid (every 8 px) moves by a random rigid
    motion, with border pins. Returns the per-problem operands and their
    stack."""
    from arap_flow_tpu_torch.io.constraints import add_border_pins
    from arap_flow_tpu_torch.ops import energy as E

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


def zero_counts() -> None:
    from arap_flow_tpu_torch.ops import fused_solver, pcg, zncc

    for counts in (pcg.LAUNCHES, zncc.LAUNCHES, fused_solver.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_counts() -> dict:
    from arap_flow_tpu_torch.ops import fused_solver, pcg, zncc

    return {**pcg.LAUNCHES, **zncc.LAUNCHES, **fused_solver.LAUNCHES}


def phase_solve_batch(smi: str) -> int:
    """solve_batch on the pipeline's chunk shape. Returns the tall kernel's
    launches in the 19×8×400 run under ARAP_TALL_KERNEL=1."""
    import torch

    from arap_flow_tpu_torch.ops import solver as S

    dev = torch.device("cuda", 0)
    B, H, W = PIPE_PCG_SHAPE
    cpu_probs, cpu_batch = segment_operands(B, H, W, seed=300, device="cpu")
    probs, batch = segment_operands(B, H, W, seed=300, device=dev)
    short = S.SolverConfig(num_anneal=3, gn_iters=2, max_pcg_iters=60,
                           pcg_iters=60.0)

    def per_problem_gap(flows, cfg):
        return max(float((flows[k] - S.solve(o, cfg)[1]).abs().max())
                   for k, o in enumerate(probs))

    _, f_short = S.solve_batch(batch, short)
    # the kernel route's plain version: backend "cuda" on CPU tensors
    _, f_cpu = S.solve_batch(cpu_batch, short._replace(backend="cuda"))
    d = (f_short.cpu() - f_cpu).abs()
    gap = per_problem_gap(f_short, short)
    counts = []
    for cfg in (short, short._replace(num_anneal=4, gn_iters=1,
                                      pcg_iters_early=20.0, anneal_split=2.0)):
        _, _, n = S.solve_stats(batch, cfg)
        closed = cfg.gn_iters * sum(
            min(cfg.max_pcg_iters, cfg.pcg_iters_early
                if cfg.pcg_iters_early > 0 and i < cfg.anneal_split
                else cfg.pcg_iters) for i in range(cfg.num_anneal))
        counts.append((float(n.min()), float(n.max()), closed))
    line = (f"phase 2b solve_batch B={B} {H}x{W} 3x2x60: max|flow - per-"
            f"problem solve| {gap:.3g}; vs the plain version on the CPU max "
            f"{float(d.max()):.4g} px, median {float(d.median()):.4g} px; "
            f"iterations (min, max, closed form) {counts}")
    say(line)
    if not (gap <= 1e-4 and float(d.max()) < 0.05
            and float(d.median()) < 0.005
            and all(lo == hi == c for lo, hi, c in counts)):
        raise AssertionError(line)

    full = S.SolverConfig()
    steps = full.num_anneal * full.gn_iters
    runs = {}
    for tall in (False, True):
        if tall:
            os.environ["ARAP_TALL_KERNEL"] = "1"
        zero_counts()
        t0 = time.perf_counter()
        _, flows = S.solve_batch(batch, full)
        torch.cuda.synchronize()
        runs[tall] = (flows, time.perf_counter() - t0, read_counts())
        os.environ.pop("ARAP_TALL_KERNEL", None)
    (f_std, s_std, n_std), (f_tall, s_tall, n_tall) = runs[False], runs[True]
    gap = per_problem_gap(f_std, full)
    d_tall = float((f_tall - f_std).abs().max())
    line = (f"phase 2b solve_batch B={B} {H}x{W} 19x8x400: {s_std:.3f} s, "
            f"launches pcg_fixed {n_std['pcg_fixed']} pcg_fixed_tall "
            f"{n_std['pcg_fixed_tall']}; ARAP_TALL_KERNEL=1 {s_tall:.3f} s, "
            f"launches pcg_fixed {n_tall['pcg_fixed']} pcg_fixed_tall "
            f"{n_tall['pcg_fixed_tall']}; max|flow - per-problem solve| "
            f"{gap:.3g}; max|tall flow - standard flow| {d_tall:.3g} ({smi})")
    say(line)
    if not ((n_std["pcg_fixed"], n_std["pcg_fixed_tall"]) == (steps, 0)
            and (n_tall["pcg_fixed"], n_tall["pcg_fixed_tall"]) == (0, steps)
            and gap <= 1e-4 and d_tall <= 1e-5):
        raise AssertionError(line)
    return n_tall["pcg_fixed_tall"]


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
    """Full 19×8×400 schedule on CUDA through the crop path. Returns the
    kernel launch counts of that run, the segments' flows and the pair's
    cold and warm seconds. `calls` are the kernel call shapes of one GN step
    (solve_calls), `call_ms` the kernel's measured ms per 400-iteration call
    at each."""
    import torch

    from arap_flow_tpu_torch.io.flo import flow_read, flow_write
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    dev = torch.device("cuda", 0)
    cfg = SolverConfig()
    say(f"phase 3 main path: {len(tasks)} segments, buckets "
        f"{[(t.bucket, t.canvas, t.transposed) if t else None for t in tasks]}"
        f"; kernel calls per GN step {calls}")

    zero_counts()
    t0 = time.perf_counter()
    out, _ = run_pair(probs, tasks, cfg, dev)
    cold = time.perf_counter() - t0
    launches = read_counts()
    expect = len(calls) * cfg.num_anneal * cfg.gn_iters
    if (launches["pcg_fixed"], launches["pcg_fixed_tall"],
            launches["anneal_solve_fused"]) != (expect, 0, 0):
        raise AssertionError(f"launches {launches}, expected pcg_fixed "
                             f"{expect} and no other")

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
    return launches, {j: out[(0, j)].flow for j in range(len(probs))}, (
        cold, warm)


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
    groups = {"pcg kernels": 0.0, "zncc kernels": 0.0, "fused kernel": 0.0,
              "torch ops": 0.0}
    for name, (us, _) in rows.items():
        key = ("pcg kernels" if "pcg_" in name else "zncc kernels"
               if ("zscore_kernel" in name or "search_kernel" in name)
               else "fused kernel" if "fused_solve" in name else "torch ops")
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
    from arap_flow_tpu_torch.ops.energy import ArapWeights
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen
    from arap_flow_tpu_torch.utils.profiling import StageTimer

    cfg = SolverConfig()
    n_pairs = PIPE_FRAMES - 1
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        make_pipeline_tree(inp)
        zero_counts()
        lines, cold = run_pipeline(inp, os.path.join(tmp, "cold"), cfg)
        launches = read_counts()
        z_exp, p_exp, kept, groups = predicted_launches(
            inp, os.path.join(tmp, "cold"), cfg, ArapWeights())
        say(f"phase 5 launches: zncc_search {launches['zncc_search']} "
            f"(predicted {z_exp}), pcg_fixed {launches['pcg_fixed']} "
            f"(predicted {p_exp}; solve groups {groups})")
        say(f"phase 5 kept constraints per (pair, object): {kept}")
        if (launches["zncc_search"], launches["pcg_fixed"],
                launches["pcg_fixed_tall"],
                launches["anneal_solve_fused"]) != (z_exp, p_exp, 0, 0):
            raise AssertionError("launch counts differ from the prediction")
        if len(kept) != n_pairs * len(PIPE_OBJECTS) or min(kept.values()) < 20:
            raise AssertionError(f"too few constraints per object: {kept}")
        check_pipeline_products(inp, os.path.join(tmp, "cold"), lines)

        para_gen.TIMER = StageTimer()
        zero_counts()
        lines, warm = run_pipeline(inp, os.path.join(tmp, "warm"), cfg)
        warm_launches = read_counts()
        if (warm_launches["zncc_search"], warm_launches["pcg_fixed"]) != (
                z_exp, p_exp):
            raise AssertionError("warm run: launch counts differ")
        check_pipeline_products(inp, os.path.join(tmp, "warm"), lines)
        say(f"phase 5 seconds per pair: cold {cold / n_pairs:.3f}, warm "
            f"{warm / n_pairs:.3f} ({n_pairs} pairs, {smi})")
        say("phase 5 warm-run stages:\n" + para_gen.TIMER.report())
        if profiled:
            profile_pipeline(inp, os.path.join(tmp, "profiled"), cfg)
    return launches


def interior_operands(H: int, W: int, seed: int, device):
    """tests/test_pallas_solver.py's problem: an interior solve region with a
    jittered constraint grid and border pins (one problem, stacked B=1)."""
    from arap_flow_tpu_torch.io.constraints import add_border_pins
    from arap_flow_tpu_torch.ops import energy as E

    mask = np.full((H, W), 255, np.uint8)
    mask[2 : H - 2, 8 : W - 8] = 0
    ys, xs = np.mgrid[3 : H - 3 : 4, 10 : W - 10 : 12]
    rng = np.random.default_rng(seed)
    cons = np.stack([xs.ravel(), ys.ravel(),
                     xs.ravel() + rng.integers(-3, 4, xs.size),
                     ys.ravel() + rng.integers(-3, 4, xs.size)],
                    1).astype(np.int32)
    ops = E.build_operands(mask, add_border_pins(cons, W, H), device=device)
    return [ops], stack_operands([ops])


# (B, H, W) and (num_anneal, gn_iters, pcg_iters) of phase 6's checks
FUSED_CHECKS = (((1, 16, 128), (3, 2, 60)), ((1, 192, 384), (2, 2, 40)),
                ((4, 192, 256), (2, 2, 40)))
# The unit of the fused kernel's times in the kernels line: one anneal step
# of one GN step and 400 PCG iterations at the pipeline's chunk shape, the
# per-GN kernel's 400-iteration call plus its linearisation.
FUSED_UNIT = (1, 1, 400)
# Largest |Δx| over the solve region between the fused kernel and its plain
# version in phase 6's 1×1×3 and short-schedule checks: twice the largest
# reading, 5.05e-3 at 16×128 3×2×60 on an H100 80GB HBM3 at 700 W (both
# sides are deterministic).
FUSED_MAX_DX = 0.01


def phase_fused(smi: str, call_ms):
    """The fused kernel against its plain version on the card. Returns (the
    largest 1×1×1 or 1×1×3 |Δx|, kernel ms and plain ms of FUSED_UNIT at
    the pipeline's chunk shape)."""
    import torch

    from arap_flow_tpu_torch import _build
    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops.fused_solver import (anneal_solve_fused,
                                                      anneal_solve_fused_plain)
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    dev = torch.device("cuda", 0)
    lib = _build.load("fused_solver")

    def sched(na, gn, it):
        return SolverConfig(num_anneal=na, gn_iters=gn, max_pcg_iters=it,
                            pcg_iters=float(it))

    max_err = 0.0
    batches = {}
    for (B, H, W), (na, gn, it) in FUSED_CHECKS:
        if H < 64:
            _, batch = interior_operands(H, W, 400, dev)
        else:
            _, batch = segment_operands(B, H, W, 400 + H, dev)
        batches[(B, H, W)] = batch
        # 1 and 3 PCG iterations of one GN step: the same arithmetic summed
        # in another order; 3 holds β and both rz parities. By the third
        # iteration rounding has grown to at most 8.4e-4 here (B=4 192×256
        # on an H100 80GB HBM3 at 700 W), while a stale β or rz moves x by
        # 0.49 or more on tests/test_torch_fused.py's problem
        short = [float((anneal_solve_fused(batch, sched(1, 1, n))
                        - anneal_solve_fused_plain(batch, sched(1, 1, n))
                        ).abs().max()) for n in (1, 3)]
        cfg = sched(na, gn, it)
        k = anneal_solve_fused(batch, cfg)
        kb = anneal_solve_fused(batch, cfg)
        p = anneal_solve_fused_plain(batch, cfg)
        torch.cuda.synchronize()
        if not torch.equal(k, kb):
            raise AssertionError(f"fused kernel not bitwise repeatable at "
                                 f"{B}x{H}x{W}")
        # over the solve region only: elsewhere x stays at the grid in both
        d = (k - p).abs()[batch.mask[:, None].expand_as(k) > 0]
        med, mx = float(d.median()), float(d.max())
        cimg = E.anneal_constraints(batch, 1.0)
        ck, cp = E.cost(k, batch, cimg), E.cost(p, batch, cimg)
        cost_gap = float(((ck - cp).abs()
                          / torch.clamp(cp.abs(), min=1e-30)).max())
        ms = cuda_ms(lambda: anneal_solve_fused(batch, cfg))
        plain_ms = cuda_ms(lambda: anneal_solve_fused_plain(batch, cfg),
                           reps=1)
        line = (f"phase 6 fused vs plain B={B} {H}x{W} {na}x{gn}x{it}: "
                f"1x1x1 max|dx| {short[0]:.3g}, 1x1x3 max|dx| "
                f"{short[1]:.3g}; over the solve region median|dx| "
                f"{med:.3g}, max|dx| {mx:.3g}; largest relative cost gap "
                f"{cost_gap:.3g}; bitwise repeat ok; "
                f"{lib.fused_solve_blocks(B, H, W)} blocks; kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms a call")
        say(line)
        if not (short[0] < 1e-4 and short[1] < FUSED_MAX_DX and med < 1e-3
                and mx < FUSED_MAX_DX and cost_gap < 0.05):
            raise AssertionError(line)
        max_err = max(max_err, *short)

    batch = batches[PIPE_PCG_SHAPE]
    unit = sched(*FUSED_UNIT)
    unit_ms = cuda_ms(lambda: anneal_solve_fused(batch, unit))
    unit_plain = cuda_ms(lambda: anneal_solve_fused_plain(batch, unit),
                         reps=3)
    bms, by = fused_bound(*PIPE_PCG_SHAPE, *FUSED_UNIT)
    say(f"phase 6 fused {'x'.join(map(str, FUSED_UNIT))} at B=4 192x256: "
        f"kernel {unit_ms:.3f} ms, plain {unit_plain:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")
    full = SolverConfig()
    steps = full.num_anneal * full.gn_iters
    label = f"{full.num_anneal}x{full.gn_iters}x{full.max_pcg_iters}"
    # 16x128 (8 blocks, a pixel a thread) shows the barriers' own cost
    for shape in ((1, 16, 128), (1, 192, 384), PIPE_PCG_SHAPE):
        b = batches[shape]
        ms = cuda_ms(lambda: anneal_solve_fused(b, full), reps=3)
        bms, by = fused_bound(*shape, full.num_anneal, full.gn_iters,
                              full.max_pcg_iters)
        line = (f"phase 6 fused {label} at B={shape[0]} {shape[1]}x"
                f"{shape[2]}: kernel {ms:.3f} ms a solve "
                f"({ms / (steps * full.max_pcg_iters) * 1000:.2f} us an "
                f"iteration), bound {bms:.3f} ms ({by})")
        if shape in call_ms:
            line += (f"; per-GN PCG calls {steps} x {call_ms[shape][0]:.3f} "
                     f"ms = {steps * call_ms[shape][0]:.3f} ms")
        say(f"{line} ({smi})")
    return max_err, unit_ms, unit_plain


def phase_fused_pair(smi, probs, tasks, calls, ref_flows, ref_secs,
                     profiled: bool = False) -> int:
    """Phase 3's pair with backend='fused'. Returns the fused kernel's
    launches in the cold run. With `profiled`, one more warm run under
    torch.profiler prints its device time and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from arap_flow_tpu_torch.ops.solver import SolverConfig

    dev = torch.device("cuda", 0)
    cfg = SolverConfig(backend="fused")
    zero_counts()
    t0 = time.perf_counter()
    out, _ = run_pair(probs, tasks, cfg, dev)
    cold = time.perf_counter() - t0
    launches = read_counts()
    if (launches["anneal_solve_fused"], launches["pcg_fixed"],
            launches["pcg_fixed_tall"]) != (len(calls), 0, 0):
        raise AssertionError(f"fused pair launches {launches}, expected "
                             f"anneal_solve_fused {len(calls)} and no PCG")
    for j, (rgb, mask, cons, motion) in enumerate(probs):
        flow = out[(0, j)].flow
        if flow.shape != (FRAME_H, FRAME_W, 2) or not np.isfinite(flow).all():
            raise AssertionError(f"fused segment {j}: bad flow {flow.shape}")
        epe = rigid_epe_median(flow, mask, SEG_SHAPES[j][0], motion)
        d = np.abs(flow - ref_flows[j])[mask == 0]
        line = (f"phase 6b fused segment {j}: median rigid EPE {epe:.4f} px; "
                f"|flow - per-GN flow| median {float(np.median(d)):.4g} px, "
                f"max {float(d.max()):.4g} px over the object")
        say(line)
        if not (epe < 1.0 and float(np.median(d)) < 0.05):
            raise AssertionError(line)
    t0 = time.perf_counter()
    run_pair(probs, tasks, cfg, dev)
    warm = time.perf_counter() - t0
    say(f"phase 6b fused pair seconds: cold {cold:.3f}, warm {warm:.3f} "
        f"(per-GN phase 3: cold {ref_secs[0]:.3f}, warm {ref_secs[1]:.3f}; "
        f"{smi}); anneal_solve_fused launches {launches['anneal_solve_fused']}"
        f" (one per solve chunk), pcg_fixed {launches['pcg_fixed']}")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_pair(probs, tasks, cfg, dev)
            wall = time.perf_counter() - t0
        device_time_report(prof, wall, "phase 6b profiled warm fused pair")
    return launches["anneal_solve_fused"]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the device time of the pipeline "
                         "(phase 5) and of the fused pair (phase 6b)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        say("chip_smoke: CUDA is not available; this run needs an NVIDIA GPU")
        return 1
    sys.path.insert(0, ROOT)
    # every phase runs the standard PCG layout unless it sets the variable
    os.environ.pop("ARAP_TALL_KERNEL", None)
    smi = phase_env()
    phase_build()
    probs, tasks = make_tasks()
    calls = solve_calls(tasks)
    main_shapes = sorted(set(calls))
    max_err, tall_err, call_ms = phase_kernel(
        [*KERNEL_SHAPES, *main_shapes],
        [PIPE_PCG_SHAPE, *main_shapes, *TIMED_SHAPES])
    ms, plain_ms, tall_ms, _ = call_ms[PIPE_PCG_SHAPE]
    tall_launches = phase_solve_batch(smi)
    small_reference_check()
    launches, pair_flows, pair_secs = phase_main_path(smi, probs, tasks,
                                                      calls, call_ms)
    if launches["pcg_fixed"] <= 0:
        raise AssertionError("the deform path never launched pcg_fixed")
    z_err, z_ms, z_plain, z_bound, z_by = phase_zncc()
    launches = phase_pipeline(smi, args.profile)
    if launches["zncc_search"] <= 0 or launches["pcg_fixed"] <= 0:
        raise AssertionError(f"the pipeline missed a kernel: {launches}")
    f_err, f_ms, f_plain = phase_fused(smi, call_ms)
    f_launches = phase_fused_pair(smi, probs, tasks, calls, pair_flows,
                                  pair_secs, args.profile)
    p_bound, p_by = pcg_bound(*PIPE_PCG_SHAPE)
    f_bound, f_by = fused_bound(*PIPE_PCG_SHAPE, *FUSED_UNIT)
    pcg_row = {"route": "cuda", "source": "arap_flow_tpu_torch/csrc/pcg.cu",
               "plain_ms": plain_ms, "bound_ms": p_bound, "bound_by": p_by,
               "library_ms": None}
    say(json.dumps({"kernels": [{
        "name": "pcg_fixed", **pcg_row,
        "replaces": "arap_flow_tpu/ops/pallas_pcg.py:247, "
                    "arap_flow_tpu/ops/pallas_pcg.py:516",
        "launches": launches["pcg_fixed"], "max_abs_err": max_err, "ms": ms,
    }, {
        "name": "pcg_fixed_tall", **pcg_row,
        "replaces": "arap_flow_tpu/ops/pallas_pcg.py:377, "
                    "arap_flow_tpu/ops/pallas_pcg.py:651",
        "launches": tall_launches, "max_abs_err": tall_err, "ms": tall_ms,
    }, {
        "name": "anneal_solve_fused", "route": "cuda",
        "source": "arap_flow_tpu_torch/csrc/fused_solver.cu",
        "replaces": "arap_flow_tpu/ops/pallas_solver.py:171",
        "launches": f_launches, "max_abs_err": f_err, "ms": f_ms,
        "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
        "library_ms": None,
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
