"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each reported on its own line; any failure exits non-zero:

0. environment: card name and power limit, torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN.
1. build: compiles the three CUDA libraries from ``arap_flow_tpu_torch/csrc``
   (pcg, zncc, fused_solver), one nvcc process per source, all started
   together, and loads them.
2. PCG kernel vs plain: for each shape, the kernel's plan (``card_plan``:
   CTAs a problem, rows a CTA, resident, or spread over the card with its
   pixels a CTA, planes in shared memory), how many of its clusters the
   card holds at once (cudaOccupancyMaxActiveClusters, both layouts; a
   spread plan: 1 where the card holds all its CTAs) and the waves; then
   ``pcg_fixed`` (CUDA) in both layouts, standard and tall, against
   ``pcg_fixed_plain`` on the same numpy-seeded problems, on the card: 1
   iteration to rtol/atol 1e-4; at 160 iterations both converged (‖b −
   JtJ·δ‖ ≤ 1e-5·‖b‖ for every problem) with max |Δδ| < 0.01; two kernel
   runs bitwise equal; the tall layout within 1e-5 of the standard one. The
   shapes cover the three plans (384×640 the largest resident one, 480×854
   and 512×896 spread, 576×1024 streamed: its state does not fit the card's
   shared memory). Then ms per 400-iteration call of the
   cluster kernel beside the tall layout and the plain version, and the
   pipeline's largest chunk (B = 24 64×128) at the earlier 5-CTA plan
   against ``pcg_plan``'s one-wave plan, in turns.
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
   of 4 pairs, the 104-plane coarse bank of STRETCH_HYPOTHESES, a coarse
   search at r = 60 and two ragged small shapes: scores within 2e-4, (du,
   dv) equal on ≥ 99% of pixels and elsewhere only where the plain scores
   of the two offsets tie within 2e-4, two kernel runs bitwise equal; ms
   per call of the kernel at every shape, and of the plain version at the
   matcher's.
5. dataset pipeline: ``para_gen.main_pipeline`` (batched, multseg, 19×8×400)
   on a synthetic tree of 5 frames at 854×480 with two objects moving by
   known translations, written with the port's PNG codec: 4 pairs, one
   matcher sub-batch. The list file, the products, the flow against the
   translations and the launch counts of both kernels are checked; cold
   and warm seconds per pair and the warm run's stages are printed. With
   --profile, one more run under torch.profiler prints the device time by
   kernel and the device's busy share, and a profiled matcher call on the
   same 4 pairs prints the matcher's own device time.
6. fused kernel vs plain: for each shape the fused kernel's plan
   (``fused_solver.card_plan``: CTAs a problem, rows a CTA, resident or
   streamed, groups in shared memory, bytes, active clusters, waves; a plan
   with 0 active clusters fails), then ``anneal_solve_fused`` (one
   thread-block-cluster launch a solve) against
   ``anneal_solve_fused_plain`` at 16×128 (3×2×60), B=1 192×384, B=4
   192×256, B=24 64×128 (2×2×40) and the 480×854 frame (streamed, 1×2×40):
   1×1×1 within 1e-4 and 1×1×3 within 0.01; over the solve region median
   |Δx| < 1e-3 and max |Δx| < 0.01; every problem's final cost within 5%;
   two kernel runs bitwise equal; ms a call of both, and the kernel's ms a
   19×8×400 solve beside 152 per-GN PCG calls.
6b. fused deform pair: phase 3's pair again with SolverConfig(backend=
   "fused"): median rigid EPE < 1 px and median |flow − phase 3's flow| <
   0.05 px per segment; one fused launch per solve chunk and no PCG
   launch; cold and warm seconds. With --profile, one more warm run under
   torch.profiler prints its device time by kernel and busy share.
7. para_gen's host layer (phase 1 builds the native host library with g++
   beside the nvcc builds and prints its seconds):
   7a. ``ArapDeformer(raster="host")`` on phase 3's pair: the C++ splat of
       the solved flow bitwise equal to its numpy plain version and to the
       deformer's products, the share of pixels where the host and the
       device rasterizer's masks agree on the same flow, seconds per splat,
       the rigid EPE (< 1 px) and the flow against phase 3's.
   7b. a JPEG tree at DAVIS's full resolution, written with the port's
       encoder at quality 95: 5 frames at 1280x720 with a rigid ellipse and
       the non-rigid object of scripts/synth_nonrigid.py (loaded by path),
       3 backgrounds. Every decoded file has PSNR >= 30 dB against its
       source; ``para_gen --mode batched --multseg --size 854 480 --bg_dir
       --seed 0`` at 19x8x400, cold and warm: the list file and every
       product, no failed asynchronous write, the launches of both kernels
       as predicted, and in preprocessed coordinates the rigid object's
       median |flow - s*t| < 1 px and the non-rigid object's median EPE <
       0.8 px against its analytic flow mapped through the resize; seconds
       per pair and the warm run's stages (chunk prep-wait, dispatch,
       collect+finish and those inside them).
   7c. ``--matcher binary`` on 2 pairs of phase 5's tree with a stand-in
       matcher script (the reference's DeepMatching argv) that copies
       prepared translation matches: the list file, the flow gate, no
       ZNCC launch.

8. the DMO dataset path:
   8a. ``ops.textures``: each of the 7 families drawn from the key
       ``prng.key(80 + i)``: the drawn values equal, bitwise, the ones the
       JAX package draws from ``jax.random.PRNGKey(80 + i)`` (constants
       recorded from JAX: this machine has none), and a 64x96 render's
       byte checksums on the card and on the CPU hold JAX's within the
       texture tolerance; then rendered at 1280x720 on the card and on the
       CPU: fields within 1e-4, uint8 images equal on >= 99.9% of values
       and elsewhere within 1; ms a texture on the card.
   8b. ``dmo_gen.run`` on phase 5's two ellipses (masks only, 5 frames at
       854x480) at fd 1 and 2 with two texture sets, batched and multseg
       at 19x8x400, cold and warm into fresh trees: the set-0 and set-1
       Flow and wMasks byte-identical, their inpRGB and wRGB different
       (mean |d| > 2), each object's median |flow - fd*t| held to the
       JAX package's own run of this tree (DMO_JAX_ERRS, recorded from
       JAX: with its textures the reference misses the motion of the
       near-uniform object 1, and of object 2 by up to 1.36 px): < 1 px
       wherever JAX's is, object 2 within 0.5 px of JAX's, object 1 below
       JAX's plus half its motion (dmo_flow_gate); the launches of
       zncc_search and pcg_fixed as predicted (> 0 each), no failed write;
       seconds a solved pair and the textured frames' seconds.
   8c. ``matching._search_subpatch`` at the 854x480 frame's coarse shape
       (60x106, r = 13) on the card against the CPU: scores within 2e-4,
       offsets equal on >= 99% of pixels and elsewhere only on ties within
       2e-4, no zncc_search launch; then ``match_images(subpatch=True,
       rotations=(0.0,))`` on an 854x480 pair translated by (6, -3):
       > 100 matches, median within 0.5 px, > 80% within 1 px
       (tests/test_matching.py's gate), zncc_search launched once a refine
       level.

9. the Opt C-API facade and the generality path, on phase 3's 854x480
   frame with segment 0's ellipse moved by OPT_T (a constraint every 8 px,
   the border pins) in the Opt layout (Offset and UrShape the grid, Angle
   0, the constraint image annealed per outer iteration, Mask 0 on the
   object, w_fitSqrt 10, w_regSqrt sqrt(0.01)):
   9a. ``compat`` with gaussNewtonGPU at 19 outer x nIterations 8 x
       lIterations 400: the object's median |flow - t| < 1 px and 152
       pcg_fixed launches (one a step); wall seconds and the final cost.
   9b. LMGPU on the same inputs (LM_OUTER outer iterations; a cut is
       printed): median |flow - t| < 1 px, mean |flow_LM - flow_GN| < 2 px
       over the object (scripts/lm_check.py's bound), at least one
       accepted step in every outer iteration and every outer iteration's
       final cost below OPT_DROP of its starting cost (the problem is a
       pure translation, exactly solvable: a solver that barely moves
       fails); the PCG iterations the zeta exit left and the wall seconds.
   9c. both kinds at 2 x 2 x 60 on the card against the CPU: max |d Offset|
       < 0.05 px, LM's accepts printed; an lIterations = 0 step leaves the
       bound buffers bitwise unchanged.
   9d. ``generic.gn_solve`` (torch.func) on a 192x384 crop of the object,
       and the graph energy (grid_edges) through it, against the
       specialised solve at 1x3x80 (the PCG kernel): max |dx| < 0.01 over
       the solve region.
   9e. ``solve_instrumented`` on phase 3's first segment at 19x8x400: 152
       finite costs, x bitwise solve's, 152 pcg_fixed launches; the CSV
       (save_solver_iterations) and a non-empty device trace holding the
       PCG kernel.
   9f. ``para_gen --warmup`` in a fresh process on phase 5's tree: the
       prewarm's seconds by step, the pairs' seconds after it against phase
       5's cold pair (which the earlier phases warmed in this process;
       tools/pipeline_times.py --warmup compares fresh processes), the
       products byte-identical to phase 5's.

10. the last modules (CUT = 2x2x40 where a line says so: plain torch at
   19x8x400 and 480x854 would take minutes, and 10e/10f check routing and
   bytes):
   10a. ``para_gen --mode sharded`` on phase 5's tree: a mesh of the one
        card, so the batched path; products byte-identical to phase 5's
        (the JAX package's __graft_entry__.py:205 check); pcg_fixed and
        zncc_search launched.
   10b. ``BatchRunner(mesh=make_mesh(devices=[cuda:0, cuda:0]))`` on phase
        3's tasks three times over (a chunk of 3 a bucket, split 2 + 1)
        against the unsharded runner: max |dflow| < 1e-4 px, bitwise where
        the PCG plans of B = 3, 2 and 1 agree (printed). Two mesh entries
        on one card test the split and the gather, not scaling.
   10c. ``solve_spatial`` at 480x854 at CUT over [cuda:0]*4 (space = 4)
        and [cuda:0]: max |dx| and |dflow| < 5e-4 against ``solver.solve``
        on the plain backend, < 0.05 px against the PCG kernel's route;
        seconds beside solver.solve's.
   10d. ``solve_pyramid`` on phase 3's first segment's solve box: card
        against the CPU at CUT (max |dflow| < 1e-3 px); at 19x8x400,
        fine_anneal = 1, the median rigid EPE, seconds and 160 pcg_fixed
        launches, beside the flat solve of the same box.
   10e. ``ARAP_RASTER=host`` deform on a list of phase 3's two frames at
        CUT: 2 calls of the native splat, products byte-identical to
        ``ArapDeformer(raster="host")``'s.
   10f. ``run_tasks`` on phase 3's tasks and one full-frame fallback at
        CUT: bitwise equal to a BatchRunner fed the same.

11. the remaining entry points, each as a user types it
   (``arap_flow_tpu_torch.__main__.main``, in this process) on the default
   --device cuda, at 19x8x400:
   11a. ``generate --phases match convert deform bg`` on phase 5's tree (4
        pairs; generate solves each frame whole): every product and list
        line written, each object's median |flow - t| < 1 px, the median
        |flow - phase 5's batched flow| over the objects < 0.05 px, the
        launches of zncc_search and pcg_fixed as predicted (one matcher
        call and 152 PCG calls a pair).
   11b. ``run_arap --input ROOT --passes clean final`` on an MPI-Sintel-
        style tree at 1024x436 (2 frames a pass; two textured ellipses, one
        230x940, wider than any crop bucket, with translation constraints
        every 8 px; run_arap solves each frame whole, the 4 frames as one
        batch), then the same jobs through ``run_arap --list``: each
        object's median |flow - t| < 1 px, the two runs' products
        byte-identical, pcg_fixed launched.
   11c. ``run_warp --backend device`` and ``--backend host`` over phase
        5's output tree (as ROOT/fd1): every product bitwise
        ``warp_tool.warp_image``'s on the same files, the two backends'
        wMasks agreeing on >= 98% of the pixels (printed); and
        ``python3 -m arap_flow_tpu_torch warp`` in a subprocess on an 11b
        frame and its flow (started before the run_warp checks, waited for
        after 11e), bitwise the in-process call's.
   11d. ``texture_gen --num 7 --seed TEXGEN_SEED --size 1280 720``: 7
        files, the first one's family JAX's and its 64x96 render's
        checksums JAX's (TEXGEN_JAX_FIRST, recorded as 8a's) within 8a's
        tolerance, the file bitwise the card's render of its key.
   11e. the matcher on a sub-batch of 4 Sintel-shaped pairs (11b's frames)
        gives the shapes of its zncc_search calls; at each, the kernel
        against the plain version on phase 4's inputs with phase 4's gates.

12. the crop-bucket ladder: each of the 31 CROP_BUCKETS at B = 1 and at
   B = max_chunk_for (24 at every bucket), and the full frames 436x1024
   (Sintel) and 480x854 at B = 1 (a fallback solves alone): the PCG plans
   of both layouts and the fused plan (a plan with 0 active clusters
   fails); ``pcg_fixed`` against ``pcg_fixed_plain``, 1 iteration within
   1e-4 and two 40-iteration runs bitwise equal (B = 1's converged check
   of phase 2 is cut, LADDER_CONVERGED, to keep the smoke within 300 s);
   at the largest B the tall layout within 1e-5 of the standard
   one; ``anneal_solve_fused`` against its plain version at 1x1x1 within
   1e-4 at both B. Prints the distinct plans and the phase's seconds.

13. the endurance run, cut: ``tools/endurance.py`` in this process at
   --pairs 48 --block 4 (its warm cycle of one size cycle, 48 pairs, then
   48 measured pairs), 19x8x400: the tool's flow checks on the in-block
   pairs, at most 2 of 48 pairs dropped, no build during the measured
   run, no PCG shape the warm cycle did not solve, RSS and
   memory_reserved not growing, both kernels launched; prints pairs/s,
   p50/p95 seconds a pair, the plan caches' sizes and the (B, H, W) the
   run solved.

The last line is the JSON device record; the line before it lists the
kernels with their launch counts (phase 5's pipeline, phase 10's sharded
pipeline, mesh runner, pyramid and run_tasks, phase 11's generate and
run_arap, and phase 13's endurance run), errors, times and bounds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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


def phase_build() -> float:
    """Build the CUDA libraries and, beside them, the native host library
    (g++); returns the host library's build seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from arap_flow_tpu_torch import _build

    with ThreadPoolExecutor(1) as ex:
        native = ex.submit(_build.build_native)
        paths, seconds = _build.build()
        native_path, native_s = native.result()
    for stem in ("pcg", "zncc", "fused_solver"):
        _build.load(stem)
    _build.load_native()
    say(f"phase 1 build: {len(paths)} libraries "
        f"{[os.path.relpath(p, ROOT) for p in paths]} in {seconds:.2f} s; "
        f"host library {os.path.relpath(native_path, ROOT)} (g++) in "
        f"{native_s:.2f} s beside them")
    for path in paths:
        log = path[: -len(".so")] + ".log"
        if os.path.exists(log):
            with open(log) as f:
                for line in f:
                    if "registers" in line or "spill" in line or (
                            "Compiling entry" in line):
                        say("  ptxas: " + line.strip())
    return native_s


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

    # the problems share the region and the constraints; each has its own
    # state
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
# shared memory), the two spread shapes (the full frame and the largest
# bucket), a streamed one (576×1024: a band's state does not fit a block's
# shared memory, so p lives in device memory), the pipeline's largest
# chunk (pipeline/batch.py's MAX_CHUNK of the smallest bucket), a batch
# large enough for one-CTA clusters and an odd width (one pixel a thread;
# even widths take pixel pairs).
KERNEL_SHAPES = ((1, 16, 128), (3, 224, 384), (4, 192, 256), (1, 384, 640),
                 (1, 480, 854), (1, 512, 896), (1, 576, 1024), (24, 64, 128),
                 (72, 16, 128), (3, 33, 85))
# 400-iteration calls timed besides the main path's: the thin shape (the
# kernel's fixed cost an iteration), the largest resident bucket, the full
# frame (spread), the streamed shape and the largest chunk.
TIMED_SHAPES = ((1, 16, 128), (1, 384, 640), (1, 480, 854), (1, 576, 1024),
                (24, 64, 128))

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


def plan_line(B: int, H: int, W: int, label: str = "phase 2 plan") -> str:
    """The cluster kernel's plan at (B, H, W) in both layouts and its active
    clusters on this card."""
    import torch

    from arap_flow_tpu_torch.ops.pcg import active_clusters, card_plan

    dev = torch.device("cuda", 0)
    plans = [card_plan(B, H, W, t, dev) for t in (False, True)]
    act = [active_clusters(p, B, W, t, dev)
           for p, t in zip(plans, (False, True))]
    if min(act) <= 0:
        raise AssertionError(f"no cluster of {plans} fits the card")
    plan = plans[0]
    tall = "" if plans[1] == plan else f", tall cluster {plans[1].cluster}"
    if plan.kind == "spread":
        return (f"{label} B={B} {H}x{W}: spread over {plan.cluster} CTAs, "
                f"{plan.px_per_cta} px a CTA, {plan.groups} groups in shared "
                f"memory, {plan.smem_bytes} B; the card holds it "
                f"(tall {act[1]}{tall}), {B} problem(s) in turn")
    return (f"{label} B={B} {H}x{W}: cluster {plan.cluster}, "
            f"{plan.rows_per_cta} rows a CTA, {plan.kind}, "
            f"{plan.groups} groups in shared memory, {plan.smem_bytes} B; "
            f"active clusters {act[0]} (tall {act[1]}{tall}), "
            f"{-(-B // act[0])} wave(s)")


# The pipeline's largest chunk and the plan the earlier rule gave it: the
# cluster raised toward 132 SMs // 24 problems = 5 CTAs, of which the card
# holds 22 at once, so 24 problems ran in two waves.
WAVE_SHAPE = (24, 64, 128)
WAVE_OLD_CLUSTER = 5


def phase_waves(smi: str) -> None:
    """The pipeline's largest chunk at the earlier 5-CTA plan and at
    ``pcg_plan``'s plan, in turns (old, new, new, old): ms a 400-iteration
    call, active clusters and waves of each. The new plan must hold the
    whole batch at once, and its δ after one iteration must agree with the
    old plan's to rtol/atol 1e-4 (the cluster size changes only the order
    of the α and β sums)."""
    import torch

    from arap_flow_tpu_torch.ops import pcg as TP

    dev = torch.device("cuda", 0)
    B, H, W = WAVE_SHAPE
    new = TP.card_plan(B, H, W, False, dev)
    old = next(p for p in TP.candidate_plans(H, W)
               if p.cluster == WAVE_OLD_CLUSTER)
    _, args = pcg_problem(B, H, W, seed=7, device=dev)
    d_old = TP._launch(old, *args, 1, False)
    d_new = TP._launch(new, *args, 1, False)
    torch.testing.assert_close(d_new, d_old, rtol=1e-4, atol=1e-4)
    d = float((d_new - d_old).abs().max())
    ms = {}
    for name, plan in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        ms.setdefault(name, []).append(
            cuda_ms(lambda: TP._launch(plan, *args, 400, False)))
    parts = []
    for name, plan in (("old", old), ("new", new)):
        act = TP.active_clusters(plan, B, W, False, dev)
        t = float(np.median(ms[name]))
        parts.append(f"{name} plan cluster {plan.cluster} ({plan.groups} "
                     f"groups): active clusters {act}, {-(-B // act)} "
                     f"wave(s), {t:.3f} ms ({t * 2.5:.2f} us an iteration; "
                     f"runs {', '.join(f'{v:.3f}' for v in ms[name])})")
    line = (f"phase 2 waves B={B} {H}x{W} 400 iterations: " + "; ".join(parts)
            + f"; 1-iteration max|d old - new| {d:.3g} ({smi})")
    say(line)
    if TP.active_clusters(new, B, W, False, dev) < B:
        raise AssertionError(line)


def phase_kernel(shapes, call_shapes):
    """Kernel in both layouts vs plain on the card at each (B, H, W), with
    its plan. Returns the largest 1-iteration |difference| of each layout
    and, for each of `call_shapes`, the median ms of one 400-iteration call
    of the kernel, the plain version and the tall kernel."""
    import torch

    from arap_flow_tpu_torch.ops.pcg import pcg_fixed, pcg_fixed_plain

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
        tall_ms = cuda_ms(lambda: pcg_fixed(*args, 400, tall=True))
        plain_ms = cuda_ms(lambda: pcg_fixed_plain(*args, 400), reps=1)
        call_ms[(B, H, W)] = (ms, plain_ms, tall_ms)
        bms, by = pcg_bound(B, H, W)
        say(f"phase 2 one 400-iteration call at B={B} {H}x{W}: cluster "
            f"kernel {ms:.3f} ms ({ms * 2.5:.2f} us an iteration), tall "
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
# Beside them: the coarse bank of the 13 STRETCH_HYPOTHESES, the largest
# coarse radius clamp_match_params allows at 854x480 (60), and two ragged
# shapes (planes smaller than a warp's 21x32 tile, odd sizes).
ZNCC_OTHER_SHAPES = ((8, 104, 60, 106, 13), (8, 40, 60, 106, 60),
                     (3, 6, 45, 70, 7), (1, 3, 19, 37, 5))


def zncc_device_ms(fn) -> dict:
    """Device ms by kernel of one `fn()` call under torch.profiler (after a
    warm-up call): the z-score, search and reduce kernels of ``zncc.cu``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"zscore": 0.0, "search": 0.0, "reduce": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for k in out:
                if f"{k}_kernel" in e.name:
                    out[k] += e.time_range.elapsed_us() / 1e3
    return out


def phase_zncc():
    """ZNCC kernel vs plain at the matcher's shapes and the others. Returns
    (max |score difference|, kernel ms, plain ms, bound ms, bound_by)
    summed over the four searches of one main-path matcher call."""
    import torch

    from arap_flow_tpu_torch.ops.zncc import zncc_search, zncc_search_plain

    dev = torch.device("cuda", 0)
    max_err = 0.0
    totals = [0.0, 0.0, 0.0]
    by = {}
    for N1, N2, H, W, r in (*ZNCC_MAIN_SHAPES, *ZNCC_OTHER_SHAPES):
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
        ms = cuda_ms(lambda: zncc_search(p1, p2, r))
        dev_ms = zncc_device_ms(lambda: zncc_search(p1, p2, r))
        bms, b_by = zncc_bound(N1, N2, H, W, r)
        line += (f"; kernel {ms:.4f} ms a call (device: "
                 + ", ".join(f"{k} {v:.4f}" for k, v in dev_ms.items())
                 + f" ms), bound {bms:.4f} ms ({b_by})")
        if (N1, N2, H, W, r) in ZNCC_MAIN_SHAPES:
            plain_ms = cuda_ms(lambda: zncc_search_plain(p1, p2, r), reps=3)
            for i, v in enumerate((ms, plain_ms, bms)):
                totals[i] += v
            by[b_by] = by.get(b_by, 0.0) + bms
            line += f", plain {plain_ms:.3f} ms"
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


def pipe_object(k: int, t: int, yy, xx):
    """Object k's ellipse in frame t."""
    (cy, cx), (ry, rx), (dx, dy) = PIPE_OBJECTS[k]
    return (((yy - cy - dy * t) / ry) ** 2
            + ((xx - cx - dx * t) / rx) ** 2) < 1.0


def make_pipeline_tree(root: str, n_frames: int = PIPE_FRAMES) -> None:
    from arap_flow_tpu_torch.io.image import save_image

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


def predicted_launches(inp: str, out: str, cfg, weights, masks=None):
    """Kernel launches the code's shapes predict for the run that wrote
    `out`: the matcher's searches for one sub-batch, and one PCG call per
    GN step for every solve chunk the kept constraints give (all pairs are
    one batched chunk). `masks`: each pair's first annotation mask as the
    pipeline saw it (default: the tree's own). Also returns the kept
    constraints per (pair, object)."""
    from arap_flow_tpu_torch.io.constraints import read_constraint_file
    from arap_flow_tpu_torch.io.image import load_mask, segment_mask_to_arap
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
    zncc = -(-n_pairs // MATCH_SUBBATCH) * zncc_calls(levels)
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


def check_pipeline_products(inp: str, out: str, lines,
                            n_pairs: int = PIPE_FRAMES - 1,
                            label: str = "phase 5") -> None:
    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask, load_rgb

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
            say(f"{label} pair {t} object {k + 1}: median |flow - ({dx}, "
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
               else "fused kernel" if "fused_cluster" in name else "torch ops")
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


def tree_digest(out: str, lines) -> dict:
    """The sha256 of every product file under `out` by relative path, and
    the list file's lines as relative paths (the file holds absolute
    ones)."""
    import hashlib

    got = {"all_files.list": [[os.path.relpath(p, out) for p in ln.split(" ")]
                              for ln in lines]}
    for d, _, files in os.walk(out):
        for f in files:
            if f != "all_files.list":
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    got[os.path.relpath(path, out)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return got


def phase_pipeline(smi: str, profiled: bool = False, keep: str | None = None):
    """The dataset pipeline on the card; returns its kernel launches, the
    cold run's product digest (tree_digest) and its seconds per pair. With
    `keep`, the input tree and the cold run's output tree are copied to
    `keep`/in and `keep`/out (phase 11 reads them)."""
    from arap_flow_tpu_torch.ops.energy import ArapWeights
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen

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
        digest = tree_digest(os.path.join(tmp, "cold"), lines)
        if keep is not None:
            shutil.copytree(inp, os.path.join(keep, "in"))
            shutil.copytree(os.path.join(tmp, "cold"),
                            os.path.join(keep, "out"))

        para_gen.TIMER.reset()
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
    return launches, digest, cold / n_pairs


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


# (B, H, W) and (num_anneal, gn_iters, pcg_iters) of phase 6's checks: a
# thin problem (one row a CTA), the deform pair's larger bucket, the
# pipeline's chunk, its largest chunk (B = 24 of the smallest bucket) and
# the full frame (the streamed plan)
FUSED_CHECKS = (((1, 16, 128), (3, 2, 60)), ((1, 192, 384), (2, 2, 40)),
                ((4, 192, 256), (2, 2, 40)), ((24, 64, 128), (2, 2, 40)),
                ((1, FRAME_H, FRAME_W), (1, 2, 40)))
# 19×8×400 solves timed beside 152 per-GN PCG calls
FUSED_TIMED = ((1, 16, 128), (1, 192, 384), PIPE_PCG_SHAPE, (24, 64, 128))
# The unit of the fused kernel's times in the kernels line: one anneal step
# of one GN step and 400 PCG iterations at the pipeline's chunk shape, the
# per-GN kernel's 400-iteration call plus its linearisation.
FUSED_UNIT = (1, 1, 400)
# Largest |Δx| over the solve region between the fused kernel and its plain
# version in phase 6's 1×1×3 and short-schedule checks: twice the largest
# reading, 5.05e-3 at 16×128 3×2×60 on an H100 80GB HBM3 at 700 W (both
# sides are deterministic).
FUSED_MAX_DX = 0.01


def fused_plan_line(B: int, H: int, W: int,
                    label: str = "phase 6 plan") -> str:
    """The fused kernel's plan at (B, H, W) and its active clusters on this
    card."""
    import torch

    from arap_flow_tpu_torch.ops.fused_solver import active_clusters, card_plan

    dev = torch.device("cuda", 0)
    plan = card_plan(B, H, W, dev)
    act = active_clusters(plan, B, dev)
    line = (f"{label} B={B} {H}x{W}: cluster {plan.cluster}, "
            f"{plan.rows_per_cta} rows a CTA, "
            f"{'resident' if plan.resident else 'streamed'}, "
            f"{plan.groups} groups in shared memory, {plan.smem_bytes} B; "
            f"active clusters {act}, "
            f"{-(-B // act) if act > 0 else 'no'} wave(s)")
    if act <= 0:
        raise AssertionError(line)
    return line


def phase_fused(smi: str, call_ms):
    """The fused kernel against its plain version on the card. Returns (the
    largest 1×1×1 or 1×1×3 |Δx|, kernel ms and plain ms of FUSED_UNIT at
    the pipeline's chunk shape)."""
    import torch

    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops.fused_solver import (anneal_solve_fused,
                                                      anneal_solve_fused_plain)
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    dev = torch.device("cuda", 0)

    def sched(na, gn, it):
        return SolverConfig(num_anneal=na, gn_iters=gn, max_pcg_iters=it,
                            pcg_iters=float(it))

    max_err = 0.0
    batches = {}
    for (B, H, W), (na, gn, it) in FUSED_CHECKS:
        say(fused_plan_line(B, H, W))
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
                f"{cost_gap:.3g}; bitwise repeat ok; kernel "
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
                         reps=1)
    bms, by = fused_bound(*PIPE_PCG_SHAPE, *FUSED_UNIT)
    say(f"phase 6 fused {'x'.join(map(str, FUSED_UNIT))} at B=4 192x256: "
        f"kernel {unit_ms:.3f} ms, plain {unit_plain:.3f} ms, bound "
        f"{bms:.4f} ms ({by})")
    full = SolverConfig()
    steps = full.num_anneal * full.gn_iters
    label = f"{full.num_anneal}x{full.gn_iters}x{full.max_pcg_iters}"
    # 16x128 (16 CTAs of one row) shows the synchronisation's own cost
    for shape in FUSED_TIMED:
        b = batches[shape]
        ms = cuda_ms(lambda: anneal_solve_fused(b, full), reps=1)
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


# Phase 7b's JPEG tree: DAVIS's full resolution, 5 frames, brought to
# 854x480 by --size; a rigid textured ellipse and the JAX gates' non-rigid
# object (scripts/synth_nonrigid.py) at 1.5x the bench's scale, so both are
# the bench's size after the resize; 3 JPEG backgrounds.
JPEG_H, JPEG_W, JPEG_FRAMES, JPEG_QUALITY = 720, 1280, 5, 95
JPEG_SIZE = (FRAME_W, FRAME_H)  # --size 854 480
JPEG_RIGID = ((200, 330), (135, 210), (9, 13))  # centre, radii, (dy, dx) a frame
JPEG_NONRIGID = ((470, 930), (90, 135), 9.0, (6, -10))  # centre, radii, amp, drift
JPEG_BACKGROUNDS = ((600, 1000), (720, 1280), (540, 960))


def synth_nonrigid():
    """scripts/synth_nonrigid.py (numpy only), loaded by its path."""
    import importlib.util

    path = os.path.join(ROOT, "scripts", "synth_nonrigid.py")
    spec = importlib.util.spec_from_file_location("synth_nonrigid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_native(smi, probs, native_s: float, pair_flows) -> None:
    """7a: the native host library on phase 3's pair: ArapDeformer(raster=
    "host") on the card, its C++ splat against the numpy plain version on
    the same warp (bitwise), and against the device rasterizer's mask on
    the same flow."""
    import torch

    from arap_flow_tpu_torch.models.arap import ArapDeformer
    from arap_flow_tpu_torch.native.host_raster import (rasterize_warp_exact,
                                                        warp_from_flow)
    from arap_flow_tpu_torch.native.runtime import rasterize_warp
    from arap_flow_tpu_torch.ops.rasterize import rasterize_flow
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    dev = torch.device("cuda", 0)
    say(f"phase 7a native host library: built with g++ in {native_s:.2f} s "
        "(phase 1, beside nvcc)")
    deformer = ArapDeformer(SolverConfig(), crop=True, raster="host",
                            device=dev)
    for j, (rgb, mask, cons, motion) in enumerate(probs):
        res = deformer.deform(rgb, mask, cons)
        obj = mask == 0
        d_flow = np.abs(res.flow - pair_flows[j])[obj]
        warp = warp_from_flow(res.flow)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            c_rgb, c_mask = rasterize_warp(warp, rgb, mask)
            secs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        p_rgb, p_mask = rasterize_warp_exact(warp, rgb, mask)
        plain_s = time.perf_counter() - t0
        bitwise = (np.array_equal(c_rgb, p_rgb)
                   and np.array_equal(c_mask, p_mask)
                   and np.array_equal(res.warped_rgb, c_rgb)
                   and np.array_equal(res.warped_mask, c_mask))
        _, dmask = rasterize_flow(
            torch.as_tensor(np.ascontiguousarray(res.flow.transpose(2, 0, 1)),
                            device=dev),
            torch.as_tensor(rgb.transpose(2, 0, 1), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(mask, device=dev))
        dmask = dmask.to(torch.uint8).cpu().numpy() > 0
        hmask = c_mask > 0
        union = hmask | dmask
        epe = rigid_epe_median(res.flow, mask, SEG_SHAPES[j][0], motion)
        line = (f"phase 7a segment {j}: host splat bitwise equal to its plain "
                f"version: {bitwise}; {int(hmask.sum())} px covered; host and "
                f"device masks agree on {float((hmask == dmask).mean()):.6f} "
                f"of the frame, {float((hmask == dmask)[union].mean()):.6f} "
                f"of the covered pixels; splat {np.median(secs):.4f} s "
                f"(numpy plain version {plain_s:.3f} s); median rigid EPE "
                f"{epe:.4f} px; |flow - phase 3's| median "
                f"{float(np.median(d_flow)):.2e}, max {float(d_flow.max()):.2e}")
        say(line)
        if not (bitwise and hmask.sum() > 0 and epe < 1.0
                and float(np.median(d_flow)) < 0.01):
            raise AssertionError(line)


def luma_texture(H: int, W: int, seed: int) -> np.ndarray:
    """Gray 8x8 blocks and 2x2 detail, with a gentle colour tint in 32x32
    blocks and no clipping: the detail is in luma, as in natural frames.
    (make_textures' saturated per-channel colour changes every 2 and 8 px
    are chroma detail that 4:2:0 discards: 24-30 dB at quality 95, PIL's
    encoder as the port's.)"""
    rng = np.random.default_rng(seed)

    def blocks(n, lo, hi, ch):
        return np.kron(rng.uniform(lo, hi, (H // n + 2, W // n + 2, ch)),
                       np.ones((n, n, 1)))[:H, :W]

    img = blocks(8, 50, 200, 1) + blocks(32, -25, 25, 3) + blocks(2, -25, 25, 1)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_jpeg_tree(root: str, nr) -> list:
    """Phase 7b's tree, every image a JPEG from the port's encoder (the
    masks PNG); returns (path, source array) of every JPEG."""
    from arap_flow_tpu_torch.io.image import save_image

    H, W = JPEG_H, JPEG_W
    for d in ("orgRGB/seq0", "orgMasks/seq0", "bg"):
        os.makedirs(os.path.join(root, d))
    tex = luma_texture(H, W, 7)
    bg = (luma_texture(H, W, 8)[::-1] * 0.4).astype(np.uint8)
    (cy, cx), (ry, rx), (dy, dx) = JPEG_RIGID
    (ny, nx), (nry, nrx), amp, (ndy, ndx) = JPEG_NONRIGID
    yy, xx = np.mgrid[0:H, 0:W]
    written = []
    for t in range(JPEG_FRAMES):
        img = bg.copy()
        mask = np.zeros((H, W), np.uint8)
        ob = (((yy - cy - dy * t) / ry) ** 2
              + ((xx - cx - dx * t) / rx) ** 2) < 1.0
        img[ob] = tex[(yy[ob] - dy * t) % H, (xx[ob] - dx * t) % W]
        mask[ob] = 1
        nr.draw_nonrigid(img, mask, tex, 2, ny + ndy * t, nx + ndx * t, nry,
                         nrx, amp, t)
        path = os.path.join(root, "orgRGB", "seq0", f"{t:05d}.jpg")
        save_image(path, img, quality=JPEG_QUALITY)
        save_image(os.path.join(root, "orgMasks", "seq0", f"{t:05d}.png"),
                   mask)
        written.append((path, img))
    for i, (bh, bw) in enumerate(JPEG_BACKGROUNDS):
        img = luma_texture(bh, bw, 30 + i)
        path = os.path.join(root, "bg", f"b{i}.jpg")
        save_image(path, img, quality=JPEG_QUALITY)
        written.append((path, img))
    return written


def run_jpeg_pipeline(inp: str, out: str, cfg):
    import torch

    from arap_flow_tpu_torch.pipeline import para_gen

    flags = para_gen.PipelineFlags(
        input=inp, output=out, multseg=True, seed=0, mode="batched",
        size=JPEG_SIZE, bg_dir=os.path.join(inp, "bg"), device="cuda")
    t0 = time.perf_counter()
    lines = para_gen.main_pipeline(flags, solver_cfg=cfg)
    torch.cuda.synchronize()
    return lines, time.perf_counter() - t0, para_gen.WRITE_ERRORS


def check_jpeg_products(inp: str, out: str, lines, nr, pre_masks) -> None:
    """The list file, the products, and the flow gates in preprocessed
    coordinates: the rigid object's median |flow − s·(dx, dy)| < 1 px, the
    non-rigid object's median EPE < 0.8 px against the analytic flow
    mapped through the resize (nr_check_epe with the object's centre, radii
    and amplitude in preprocessed pixels)."""
    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask, load_rgb

    n_pairs = JPEG_FRAMES - 1
    with open(os.path.join(out, "all_files.list")) as f:
        listed = f.read().splitlines()
    if len(listed) != n_pairs or listed != lines:
        raise AssertionError(f"phase 7b: all_files.list holds {len(listed)} "
                             f"lines, expected {n_pairs}")
    for t, line in enumerate(listed):
        rgb1, rgb2, flo = line.split(" ")
        for path in (rgb1, rgb2):
            if load_rgb(path).shape != (FRAME_H, FRAME_W, 3):
                raise AssertionError(f"{path}: bad image")
        for sub in ("inpMasks", "wMasks"):
            m = load_mask(os.path.join(out, sub, "seq0", f"{t:05d}.png"))
            if m.shape != (FRAME_H, FRAME_W):
                raise AssertionError(f"{sub} {t}: bad mask")
        u, v = flow_read(flo)
        if u.shape != (FRAME_H, FRAME_W) or not (
                np.isfinite(u).all() and np.isfinite(v).all()):
            raise AssertionError(f"{flo}: bad flow")
    r = max((JPEG_SIZE[0] + 10) / JPEG_W, (JPEG_SIZE[1] + 10) / JPEG_H)
    w, h = int(JPEG_W * r), int(JPEG_H * r)
    left, upper = w // 2 - JPEG_SIZE[0] // 2, h // 2 - JPEG_SIZE[1] // 2
    sx, sy = w / JPEG_W, h / JPEG_H  # the resize's own scales

    def pre(cy, cx):  # a point of the original frame, in preprocessed pixels
        return sy * (cy + 0.5) - 0.5 - upper, sx * (cx + 0.5) - 0.5 - left

    (_, _, (dy, dx)) = JPEG_RIGID
    (ny, nx), (nry, nrx), amp, (ndy, ndx) = JPEG_NONRIGID
    s = 0.5 * (sx + sy)
    for t in range(n_pairs):
        u, v = flow_read(os.path.join(out, "Flow", "seq0", f"{t:05d}.flo"))
        mk = pre_masks[t]
        obj = mk == 1
        err = float(np.median(np.hypot(u[obj] - sx * dx, v[obj] - sy * dy)))
        say(f"phase 7b pair {t} rigid object: median |flow - ({sx * dx:.3f}, "
            f"{sy * dy:.3f})| {err:.4f} px over {int(obj.sum())} px")
        if not (err < 1.0 and obj.sum() > 1000):
            raise AssertionError(f"phase 7b pair {t}: rigid median flow error "
                                 f"{err} >= 1 px")
        c0 = pre(ny + ndy * t, nx + ndx * t)
        c1 = pre(ny + ndy * (t + 1), nx + ndx * (t + 1))
        ok, msg = nr.nr_check_epe(u, v, mk, 2, c0, c1, s * nry, s * nrx,
                                  s * amp, t, thresh=0.8,
                                  label=f"pair {t} non-rigid object")
        say("phase 7b" + msg)
        if not (ok and (mk == 2).sum() > 1000 and "skipped" not in msg):
            raise AssertionError(f"phase 7b: {msg.strip()}")


def phase_jpeg_pipeline(smi: str) -> None:
    """7b: para_gen on a JPEG tree at 1280x720 with --size 854 480 and
    --bg_dir, cold and warm."""
    from arap_flow_tpu_torch.io.image import load_mask, load_rgb
    from arap_flow_tpu_torch.ops.energy import ArapWeights
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen

    nr = synth_nonrigid()
    cfg = SolverConfig()
    n_pairs = JPEG_FRAMES - 1
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        t0 = time.perf_counter()
        written = make_jpeg_tree(inp, nr)
        enc_s = time.perf_counter() - t0
        psnrs = []
        for path, src in written:
            got = load_rgb(path)
            mse = float(np.mean((got.astype(np.float64) - src) ** 2))
            psnrs.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
        line = (f"phase 7b JPEG tree: {len(written)} files ({JPEG_FRAMES} "
                f"frames {JPEG_W}x{JPEG_H}, {len(JPEG_BACKGROUNDS)} "
                f"backgrounds) at quality {JPEG_QUALITY} in {enc_s:.2f} s; "
                f"decoded PSNR min {min(psnrs):.2f} dB, max "
                f"{max(psnrs):.2f} dB")
        say(line)
        if min(psnrs) < 30.0:
            raise AssertionError(line)
        pre_masks = [
            para_gen.scale_rotate(load_rgb(written[t][0]),
                                  load_mask(os.path.join(
                                      inp, "orgMasks", "seq0",
                                      f"{t:05d}.png")), JPEG_SIZE)[2]
            for t in range(n_pairs)]
        zero_counts()
        lines, cold, cold_err = run_jpeg_pipeline(
            inp, os.path.join(tmp, "cold"), cfg)
        launches = read_counts()
        z_exp, p_exp, kept, groups = predicted_launches(
            inp, os.path.join(tmp, "cold"), cfg, ArapWeights(), pre_masks)
        line = (f"phase 7b launches: zncc_search {launches['zncc_search']} "
                f"(predicted {z_exp}), pcg_fixed {launches['pcg_fixed']} "
                f"(predicted {p_exp}; solve groups {groups}); kept "
                f"constraints per (pair, object) {kept}; writer errors "
                f"{cold_err}")
        say(line)
        if ((launches["zncc_search"], launches["pcg_fixed"],
             launches["pcg_fixed_tall"], launches["anneal_solve_fused"])
                != (z_exp, p_exp, 0, 0) or cold_err != 0):
            raise AssertionError(line)
        check_jpeg_products(inp, os.path.join(tmp, "cold"), lines, nr,
                            pre_masks)
        para_gen.TIMER.reset()
        zero_counts()
        lines, warm, warm_err = run_jpeg_pipeline(
            inp, os.path.join(tmp, "warm"), cfg)
        warm_launches = read_counts()
        if (warm_launches["zncc_search"], warm_launches["pcg_fixed"],
                warm_err) != (z_exp, p_exp, 0):
            raise AssertionError(f"phase 7b warm run: launches "
                                 f"{warm_launches}, writer errors {warm_err}")
        check_jpeg_products(inp, os.path.join(tmp, "warm"), lines, nr,
                            pre_masks)
        say(f"phase 7b seconds per pair: cold {cold / n_pairs:.3f}, warm "
            f"{warm / n_pairs:.3f} ({n_pairs} pairs, JPEG {JPEG_W}x{JPEG_H} "
            f"-> --size {JPEG_SIZE[0]} {JPEG_SIZE[1]}, backgrounds; {smi})")
        say("phase 7b warm-run stages:\n" + para_gen.TIMER.report())


def write_stand_in_matcher(root: str, n_pairs: int) -> str:
    """A stand-in external matcher (the reference's DeepMatching contract,
    ``DM src1 src2 -nt 0 -out CSTR -ngh_rad 100``): a shell script that
    copies the match file prepared for its first frame, the objects' grid
    points every 8 px moved by their known translations."""
    from arap_flow_tpu_torch.io.image import load_mask

    mdir = os.path.join(root, "matches")
    os.makedirs(mdir)
    for t in range(n_pairs):
        mk = load_mask(os.path.join(root, "in", "orgMasks", "seq0",
                                    f"{t:05d}.png"))
        rows = []
        for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
            ys, xs = np.nonzero(mk[::8, ::8] == k + 1)
            rows += [f"{8 * x} {8 * y} {8 * x + dx} {8 * y + dy} 0.9"
                     for y, x in zip(ys, xs)]
        with open(os.path.join(mdir, f"{t:05d}.png.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    script = os.path.join(root, "stand_in_dm.sh")
    with open(script, "w") as f:
        f.write("#!/bin/sh\n"
                f'exec cp {mdir}/$(basename "$1").txt "$6"\n')
    os.chmod(script, 0o755)
    return script


def phase_binary_matcher(smi: str) -> None:
    """7c: --matcher binary on 2 pairs of phase 5's tree."""
    import torch

    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen

    n_pairs = 2
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in")
        make_pipeline_tree(inp, n_frames=n_pairs + 1)
        dm = write_stand_in_matcher(tmp, n_pairs)
        flags = para_gen.PipelineFlags(
            input=inp, output=os.path.join(tmp, "out"), multseg=True, seed=0,
            mode="batched", matcher="binary", dm_bin=dm, device="cuda")
        zero_counts()
        t0 = time.perf_counter()
        lines = para_gen.main_pipeline(flags, solver_cfg=SolverConfig())
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counts()
        check_pipeline_products(inp, flags.output, lines, n_pairs=n_pairs,
                                label="phase 7c")
        line = (f"phase 7c --matcher binary: {len(lines)} pairs in "
                f"{secs:.3f} s; launches zncc_search "
                f"{launches['zncc_search']}, pcg_fixed "
                f"{launches['pcg_fixed']}; writer errors "
                f"{para_gen.WRITE_ERRORS} ({smi})")
        say(line)
        if (launches["zncc_search"] != 0 or launches["pcg_fixed"] <= 0
                or para_gen.WRITE_ERRORS != 0):
            raise AssertionError(line)


# Phase 8: the DMO dataset path. 8a renders every texture family at the
# reference renderer's 1280x720; 8b runs dmo_gen on phase 5's objects
# (masks only) at two frame distances and two texture sets; 8c holds the
# subpatch search to itself on the CPU at the 854x480 frame's coarse shape
# (60x106, r = 13) and matches a translated 854x480 pair with it.
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
DMO_FDS = (1, 2)
# The JAX package's own dmo_gen on phase 8b's tree (seed 0, set 0, batched
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
SUBPATCH_SHAPE = (60, 106, 13)
SUBPATCH_SHIFT = (6, -3)  # (dx, dy) of the translated pair


def texture_sums(img: np.ndarray) -> tuple[int, int]:
    """The byte sum and the (index mod 251) + 1 weighted sum of a uint8
    image (TEX_JAX_SUMS)."""
    v = img.reshape(-1).astype(np.int64)
    return int(v.sum()), int((v * (np.arange(v.size) % 251 + 1)).sum())


def phase_textures(smi: str) -> None:
    """8a: each family's draws from prng.key(80 + i) against JAX's recorded
    values, a 64x96 render's checksums against JAX's, and the field and
    image on the card against the CPU from the same drawn values."""
    import torch

    from arap_flow_tpu_torch.ops import textures
    from arap_flow_tpu_torch.utils import prng

    dev = torch.device("cuda", 0)
    for i, fam in enumerate(textures.FAMILIES):
        key = prng.key(80 + i)
        p = textures.draw_render_params(fam, TEX_H, TEX_W, key)
        if p != TEX_JAX_DRAWS[fam]:
            raise AssertionError(f"phase 8a {fam}: drawn values {p} are not "
                                 f"JAX's {TEX_JAX_DRAWS[fam]}")
        # a uint8 image >= 99.9% equal to JAX's and elsewhere within 1
        # moves each sum by at most that share of its values (times 251)
        n = 64 * 96 * 3
        want = TEX_JAX_SUMS[fam]
        for where in (dev, "cpu"):
            got = texture_sums(textures.render(key, fam, 64, 96,
                                               device=where).cpu().numpy())
            line = (f"phase 8a {fam}: draws equal JAX's; 64x96 render on "
                    f"{where}: checksums {got}, JAX's {want}")
            say(line)
            if not (abs(got[0] - want[0]) <= n // 1000
                    and abs(got[1] - want[1]) <= 251 * (n // 1000)):
                raise AssertionError(line)
        f_err = float((textures.field(fam, p["field"], TEX_H, TEX_W, dev).cpu()
                       - textures.field(fam, p["field"], TEX_H, TEX_W, "cpu")
                       ).abs().max())
        card = textures.render_params(fam, p, TEX_H, TEX_W, dev).cpu().numpy()
        d = np.abs(card.astype(np.int16) - textures.render_params(
            fam, p, TEX_H, TEX_W, "cpu").numpy())
        ms = cuda_ms(lambda: textures.render_params(fam, p, TEX_H, TEX_W, dev))
        line = (f"phase 8a {fam}: field max |card - cpu| {f_err:.3g}; image "
                f"{100 * (d != 0).mean():.4f}% of values differ, max "
                f"{int(d.max())}; {ms:.3f} ms a {TEX_W}x{TEX_H} texture on "
                f"the card ({smi})")
        say(line)
        if not (f_err <= 1e-4 and (d != 0).mean() <= 1e-3 and d.max() <= 1):
            raise AssertionError(line)


def dmo_flow_gate(fd: int, t: int, obj: int, err: float) -> str | None:
    """Why object ``obj``'s median flow error ``err`` (px) at 8b's pair
    ``t`` of frame distance ``fd`` fails, or None. Every object-pair is held
    to the JAX package's error on it (DMO_JAX_ERRS), and below 1 px
    wherever JAX is: a tracked object within DMO_TRACKED_MARGIN of JAX, an
    untracked one (DMO_UNTRACKED) below JAX plus half its motion, which a
    flow moving it the wrong way or with the other object's motion
    exceeds."""
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


def make_mask_tree(root: str) -> None:
    """Phase 5's annotation masks alone: two ellipses (ids 1 and 2)."""
    from arap_flow_tpu_torch.io.image import save_image

    os.makedirs(os.path.join(root, "orgMasks", "seq0"))
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W]
    for t in range(PIPE_FRAMES):
        mask = np.zeros((FRAME_H, FRAME_W), np.uint8)
        for k in range(len(PIPE_OBJECTS)):
            mask[pipe_object(k, t, yy, xx)] = k + 1
        save_image(os.path.join(root, "orgMasks", "seq0", f"{t:05d}.png"),
                   mask)


def run_dmo(masks: str, out: str, cfg) -> tuple[float, float]:
    """dmo_gen at DMO_FDS with two texture sets on the card; returns (the
    run's seconds, the seconds of its textured frames: renders, copies and
    JPEG encodes)."""
    import torch

    from arap_flow_tpu_torch.pipeline import dmo_gen

    spent = [0.0]
    texture_sequence = dmo_gen.texture_sequence

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        texture_sequence(*args, **kwargs)
        spent[0] += time.perf_counter() - t0

    dmo_gen.texture_sequence = timed
    try:
        t0 = time.perf_counter()
        dmo_gen.run(masks, out, fds=list(DMO_FDS), multseg=True,
                    mode="batched", texture_sets=2, solver_cfg=cfg,
                    device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, spent[0]
    finally:
        dmo_gen.texture_sequence = texture_sequence


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def check_dmo(masks: str, out: str, cfg, launches: dict) -> None:
    """The dual-set products, the flow against each object's motion and
    the kernels' launches against the prediction."""
    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask, load_rgb
    from arap_flow_tpu_torch.ops.energy import ArapWeights

    z_exp = p_exp = 0
    mk = [load_mask(os.path.join(masks, "orgMasks", "seq0", f"{t:05d}.png"))
          for t in range(PIPE_FRAMES)]
    for fd in DMO_FDS:
        n_pairs = PIPE_FRAMES - fd
        s0, s1 = (os.path.join(out, s, f"fd{fd}") for s in ("set0", "set1"))
        with open(os.path.join(s0, "all_files.list")) as f:
            if len(f.read().splitlines()) != n_pairs:
                raise AssertionError(f"fd {fd}: not {n_pairs} pairs listed")
        for t in range(n_pairs):
            name = f"{t:05d}"
            for d, ext in (("Flow", "flo"), ("wMasks", "png")):
                a, b = (_read_bytes(os.path.join(s, d, "seq0", f"{name}.{ext}"))
                        for s in (s0, s1))
                if a != b:
                    raise AssertionError(f"fd {fd} {d} {name}: the sets differ")
            for d in ("inpRGB", "wRGB"):
                a, b = (load_rgb(os.path.join(s, d, "seq0", name + ".png"))
                        .astype(np.int16) for s in (s0, s1))
                if not np.abs(a - b).mean() > 2.0:
                    raise AssertionError(f"fd {fd} {d} {name}: the sets' "
                                         "textures do not differ")
            u, v = flow_read(os.path.join(s0, "Flow", "seq0", name + ".flo"))
            for k, (_, _, (dx, dy)) in enumerate(PIPE_OBJECTS):
                obj = mk[t] == k + 1
                err = float(np.median(np.hypot(u[obj] - fd * dx,
                                               v[obj] - fd * dy)))
                say(f"phase 8b fd {fd} pair {t} object {k + 1}: median |flow "
                    f"- ({fd * dx}, {fd * dy})| {err:.4f} px (JAX "
                    f"{DMO_JAX_ERRS[(fd, t, k + 1)]:.3f})")
                why = dmo_flow_gate(fd, t, k + 1, err)
                if not (np.isfinite(u[obj]).all()
                        and np.isfinite(v[obj]).all()):
                    why = "the flow is not finite"
                if why:
                    raise AssertionError(f"fd {fd} pair {t} object {k + 1}: "
                                         f"{why}")
        z, p, _, _ = predicted_launches(
            os.path.join(out, "set0", "textured"), s0, cfg, ArapWeights(),
            masks=mk[:n_pairs])
        z_exp += z
        p_exp += p
    line = (f"phase 8b launches: zncc_search {launches['zncc_search']} "
            f"(predicted {z_exp}), pcg_fixed {launches['pcg_fixed']} "
            f"(predicted {p_exp})")
    say(line)
    if (launches["zncc_search"], launches["pcg_fixed"]) != (z_exp, p_exp) or (
            min(z_exp, p_exp) <= 0):
        raise AssertionError(line)


def phase_dmo(smi: str) -> dict:
    """8b: dmo_gen on the card, cold and warm; returns the cold run's
    launches."""
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen

    cfg = SolverConfig()
    n_pairs = sum(PIPE_FRAMES - fd for fd in DMO_FDS)
    with tempfile.TemporaryDirectory() as tmp:
        masks = os.path.join(tmp, "masks")
        make_mask_tree(masks)
        secs = {}
        for run in ("cold", "warm"):
            zero_counts()
            out = os.path.join(tmp, run)
            secs[run] = run_dmo(masks, out, cfg)
            launches = read_counts()
            if para_gen.WRITE_ERRORS:
                raise AssertionError(f"phase 8b {run}: "
                                     f"{para_gen.WRITE_ERRORS} failed writes")
            check_dmo(masks, out, cfg, launches)
            if run == "cold":
                cold_launches = launches
        say(f"phase 8b dmo_gen (fd {list(DMO_FDS)}, 2 texture sets, batched, "
            f"multseg, {FRAME_W}x{FRAME_H}, {n_pairs} solved pairs): cold "
            f"{secs['cold'][0]:.3f} s ({secs['cold'][0] / n_pairs:.3f} a "
            f"pair), warm {secs['warm'][0]:.3f} s ({secs['warm'][0] / n_pairs:.3f}"
            f" a pair); textured frames {secs['cold'][1]:.3f} / "
            f"{secs['warm'][1]:.3f} s of them ({smi})")
    return cold_launches


def phase_subpatch(smi: str) -> None:
    """8c: the split-and-rescore search on the card against the CPU, then
    match_images(subpatch=True) on a translated 854x480 pair."""
    import torch

    from arap_flow_tpu_torch.ops import matching

    H, W, r = SUBPATCH_SHAPE
    side = 2 * r + 1
    if not matching.subpatch_fits(H, W, r, 2):
        raise AssertionError("the coarse shape falls back to the rigid search")
    p1, p2 = (torch.tensor(a[0]) for a in zncc_inputs(1, 1, H, W, r, 90))
    dev = torch.device("cuda", 0)
    g1, g2 = p1.to(dev), p2.to(dev)
    zero_counts()
    ku, kv, ks = (a.cpu() for a in matching._search_subpatch(g1, g2, r, 12, 2))
    pu, pv, ps = matching._search_subpatch(p1, p2, r, 12, 2)
    err = float((ks - ps).abs().max())
    diff = (ku != pu) | (kv != pv)
    idx = ((kv + r) * side + (ku + r)).to(torch.int64)
    at_card = torch.take_along_dim(matching.subpatch_scores(p1, p2, r, 12),
                                   idx[None], dim=0)[0]
    tie_gap = float((ps - at_card)[diff].max()) if diff.any() else 0.0
    ms = cuda_ms(lambda: matching._search_subpatch(g1, g2, r, 12, 2))
    t0 = time.perf_counter()
    matching._search_subpatch(p1, p2, r, 12, 2)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    line = (f"phase 8c subpatch search {H}x{W} r={r}: scores max |card - "
            f"cpu| {err:.3g}; offsets differ on {100 * diff.float().mean():.3f}"
            f"% of pixels, all ties within {tie_gap:.3g}; {ms:.3f} ms on the "
            f"card, {cpu_ms:.1f} ms on the host CPU; zncc_search launches "
            f"{read_counts()['zncc_search']} ({smi})")
    say(line)
    if not (err < 2e-4 and diff.float().mean() <= 0.01 and tie_gap <= 2e-4
            and read_counts()["zncc_search"] == 0):
        raise AssertionError(line)

    dx, dy = SUBPATCH_SHIFT
    im1 = rgb_texture(FRAME_H, FRAME_W, 91)
    im2 = np.roll(np.roll(im1, dy, axis=0), dx, axis=1)
    zero_counts()
    t0 = time.perf_counter()
    m = matching.match_images(im1, im2, subpatch=True, rotations=(0.0,),
                              device=dev)
    secs = time.perf_counter() - t0
    n = read_counts()["zncc_search"]
    _, levels = matching.clamp_match_params(FRAME_H, FRAME_W)
    u, v = m[:, 2] - m[:, 0], m[:, 3] - m[:, 1]
    good = float(((np.abs(u - dx) <= 1) & (np.abs(v - dy) <= 1)).mean())
    line = (f"phase 8c match_images(subpatch=True) {FRAME_W}x{FRAME_H} "
            f"shifted ({dx}, {dy}): {len(m)} matches, median ({np.median(u)}, "
            f"{np.median(v)}), {100 * good:.1f}% within 1 px, {secs:.3f} s; "
            f"zncc_search launches {n} (the refine levels: {levels})")
    say(line)
    if not (len(m) > 100 and abs(np.median(u) - dx) <= 0.5
            and abs(np.median(v) - dy) <= 0.5 and good > 0.8 and n == levels):
        raise AssertionError(line)


# Phase 9: the Opt C-API facade and the generality path on phase 3's frame:
# segment 0's ellipse translated by OPT_T (no rotation), a constraint every
# 8 px of the object and the border pins, in the Opt layout.
OPT_T = (10.0, 8.0)
OPT_SCHEDULE = (19, 8, 400)  # outer (annealing) × nIterations × lIterations
# LM's outer count (9b), cut from the reference's 19: the plain-torch LM
# reads a flag back every damped-PCG iteration, so the host issues each
# iteration's ≈ 100 launches with the queue drained (3.4 ms an iteration,
# 24.1 s at 19 outer on the H100), more than phase 9's time allows.
LM_OUTER = 4
# 9a/9b: every outer iteration's final cost is below this fraction of its
# starting cost (the exact solution's cost is 0)
OPT_DROP = 1e-2
OPT_SHORT = (2, 2, 60)  # 9c: the card against the CPU
GENERIC_CROP = (192, 384)  # 9d
GENERIC_SCHEDULE = (3, 80)  # 9d: GN steps × PCG iterations


def opt_problem():
    """(arap mask, constraint sources (K, 2), targets (K, 2)) of phase 9's
    object: segment 0's ellipse moved by OPT_T, the border pins appended."""
    from arap_flow_tpu_torch.io.constraints import add_border_pins

    _, arap_mask, _, _ = segment_problem(SEG_SEEDS[0], *SEG_SHAPES[0])
    ell = arap_mask == 0
    ys, xs = np.mgrid[0:FRAME_H:8, 0:FRAME_W:8]
    sel = ell[::8, ::8]
    sx, sy = xs[sel], ys[sel]
    tx, ty = sx + int(OPT_T[0]), sy + int(OPT_T[1])
    keep = (tx >= 0) & (tx < FRAME_W) & (ty >= 0) & (ty < FRAME_H)
    cons = add_border_pins(np.stack([sx, sy, tx, ty], 1)[keep].astype(
        np.int32), FRAME_W, FRAME_H)
    return (arap_mask, cons[:, :2].astype(np.float32),
            cons[:, 2:].astype(np.float32))


def opt_lifecycle(kind: str, schedule, device, problem):
    """The Opt.h lifecycle of examples/opt_api_lifecycle.py on phase 9's
    object: Offset and UrShape the grid, Angle 0, the constraint image
    annealed per outer iteration (α = (i + 1) / outer), Mask 0 on the
    object, w_fitSqrt 10, w_regSqrt √0.01; each outer iteration an Init and
    Steps until done. Returns (Offset, Angle, the costs of each outer
    iteration's steps, each preceded by its starting cost, LM's accepts
    per step, seconds)."""
    import torch

    from arap_flow_tpu_torch import compat as opt
    from arap_flow_tpu_torch.ops import energy as E

    arap_mask, src, tgt = problem
    n_outer, n_iter, l_iter = schedule
    H, W = arap_mask.shape
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1)
    angle = np.zeros((H, W), np.float32)
    urshape = offset.copy()
    mask = (arap_mask != 0).astype(np.float32)
    sxi, syi = src[:, 0].astype(np.int64), src[:, 1].astype(np.int64)
    state = opt.Opt_NewState(device=device)
    prob = opt.Opt_ProblemDefine(state, "arap_plan.t", kind)
    plan = opt.Opt_ProblemPlan(state, prob, (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", n_iter)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", l_iter)
    costs, accepts = [], []
    t0 = time.perf_counter()
    for i in range(n_outer):
        alpha = np.float32(i + 1) / np.float32(n_outer)
        cons = np.full((H, W, 2), -1.0, np.float32)
        cons[syi, sxi] = src + alpha * (tgt - src)
        params = [offset, angle, urshape, cons, mask, np.float32(10.0),
                  np.float32(np.sqrt(0.01))]
        opt.Opt_ProblemInit(state, plan, params)
        # the starting cost, which the Opt API does not report before a step
        row, acc = [float(E.cost(plan.x, plan.ops, plan.ops.con_tgt))], []
        while True:
            more = opt.Opt_ProblemStep(state, plan, params)
            row.append(opt.Opt_ProblemCurrentCost(state, plan))
            if kind == "LMGPU":
                acc.append(float(plan.lm_state[2]) == 2.0)
            if not more:
                break
        costs.append(row)
        accepts.append(acc)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    opt.Opt_PlanFree(state, plan)
    opt.Opt_ProblemDelete(state, prob)
    return offset, angle, costs, accepts, secs


def object_error(offset, arap_mask) -> float:
    """Median |flow − OPT_T| over the object, flow = Offset − grid."""
    H, W = arap_mask.shape
    gx, gy = np.meshgrid(np.arange(W), np.arange(H))
    obj = arap_mask == 0
    return float(np.median(np.hypot(offset[..., 0][obj] - gx[obj] - OPT_T[0],
                                    offset[..., 1][obj] - gy[obj] - OPT_T[1])))


def phase_opt(smi: str) -> dict:
    """9a-9c: the Opt facade's two solver kinds on the card at the
    reference schedule, then the card against the CPU on a short one.
    Returns the pcg_fixed launches of 9a."""
    import torch

    from arap_flow_tpu_torch import compat as opt
    from arap_flow_tpu_torch.ops import lm

    dev = torch.device("cuda", 0)
    problem = opt_problem()
    arap_mask = problem[0]
    obj = arap_mask == 0
    n_outer, n_iter, l_iter = OPT_SCHEDULE
    zero_counts()
    gn_off, _, gn_costs, _, gn_s = opt_lifecycle("gaussNewtonGPU",
                                                 OPT_SCHEDULE, dev, problem)
    launches = read_counts()
    err = object_error(gn_off, arap_mask)
    drop = max(r[-1] / r[0] for r in gn_costs)
    line = (f"phase 9a Opt gaussNewtonGPU {FRAME_W}x{FRAME_H} {n_outer}x"
            f"{n_iter}x{l_iter}: {gn_s:.3f} s, starting cost "
            f"{gn_costs[0][0]:.6g}, final cost {gn_costs[-1][-1]:.6g}, the "
            f"largest final/starting cost of an outer iteration {drop:.3g} "
            f"(gate < {OPT_DROP:g}), object median |flow - t| {err:.4f} px "
            f"over {int(obj.sum())} px; pcg_fixed launches "
            f"{launches['pcg_fixed']} (expected {n_outer * n_iter}) ({smi})")
    say(line)
    if not (err < 1.0 and drop < OPT_DROP
            and launches["pcg_fixed"] == n_outer * n_iter
            and sum(launches.values()) == launches["pcg_fixed"]):
        raise AssertionError(line)

    lm_schedule = (LM_OUTER, n_iter, l_iter)
    lm.ITERATIONS["pcg_damped"] = 0
    zero_counts()
    lm_off, _, lm_costs, lm_acc, lm_s = opt_lifecycle("LMGPU", lm_schedule,
                                                      dev, problem)
    steps = sum(len(r) - 1 for r in lm_costs)
    ran = lm.ITERATIONS["pcg_damped"]
    err = object_error(lm_off, arap_mask)
    gap = float(np.mean(np.hypot(*(lm_off - gn_off)[obj].T)))
    drop = max(r[-1] / r[0] for r in lm_costs)
    accepted_each = all(any(a) for a in lm_acc)
    line = (f"phase 9b Opt LMGPU {LM_OUTER}x{n_iter}x{l_iter}"
            f"{'' if LM_OUTER == n_outer else f' (outer cut from {n_outer})'}"
            f": {lm_s:.3f} s, {steps} steps, {sum(map(sum, lm_acc))} accepted;"
            f" PCG iterations run {ran} of {steps * l_iter} (the ζ exit left "
            f"{steps * l_iter - ran}); final cost {lm_costs[-1][-1]:.6g}; "
            f"object median |flow - t| {err:.4f} px; mean |flow_LM - flow_GN|"
            f" {gap:.4f} px over the object; accepts per outer iteration "
            f"{[sum(a) for a in lm_acc]} (each > 0: {accepted_each}); the "
            f"largest final/starting cost of an outer iteration {drop:.3g} "
            f"(gate < {OPT_DROP:g}); launches {read_counts()} ({smi})")
    say(line)
    if not (err < 1.0 and gap < 2.0 and accepted_each and drop < OPT_DROP):
        raise AssertionError(line)

    for kind in ("gaussNewtonGPU", "LMGPU"):
        card = opt_lifecycle(kind, OPT_SHORT, dev, problem)
        cpu = opt_lifecycle(kind, OPT_SHORT, "cpu", problem)
        d = float(np.abs(card[0] - cpu[0]).max())
        pattern = ("" if kind == "gaussNewtonGPU" else
                   f"; accepts card {card[3]}, cpu {cpu[3]}")
        line = (f"phase 9c Opt {kind} {'x'.join(map(str, OPT_SHORT))} card "
                f"against the CPU: max |d Offset| {d:.4g} px, card {card[4]:.3f}"
                f" s, cpu {cpu[4]:.3f} s{pattern}")
        say(line)
        if not d < 0.05:
            raise AssertionError(line)
    # lIterations = 0 leaves the bound buffers bitwise unchanged
    H, W = arap_mask.shape
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32),
                         np.arange(H, dtype=np.float32))
    offset = np.stack([gx, gy], -1)
    angle = np.zeros((H, W), np.float32)
    before = offset.tobytes(), angle.tobytes()
    state = opt.Opt_NewState(device=dev)
    plan = opt.Opt_ProblemPlan(state, opt.Opt_ProblemDefine(
        state, "arap_plan.t", "gaussNewtonGPU"), (W, H))
    opt.Opt_SetSolverParameter(state, plan, "nIterations", 1)
    opt.Opt_SetSolverParameter(state, plan, "lIterations", 0)
    cons = np.full((H, W, 2), -1.0, np.float32)
    src, tgt = problem[1:]
    cons[src[:, 1].astype(int), src[:, 0].astype(int)] = tgt
    zero_counts()
    opt.Opt_ProblemSolve(state, plan, [offset, angle, offset.copy(), cons,
                                       (arap_mask != 0).astype(np.float32),
                                       np.float32(10.0),
                                       np.float32(np.sqrt(0.01))])
    same = (offset.tobytes(), angle.tobytes()) == before
    line = (f"phase 9c lIterations = 0: buffers bitwise unchanged {same}; "
            f"pcg_fixed launches {read_counts()['pcg_fixed']} (iters = 0)")
    say(line)
    if not same:
        raise AssertionError(line)
    return launches


def generic_crop():
    """Phase 9's object on a GENERIC_CROP crop of the frame around it,
    the constraints inside the crop and the crop's border pins."""
    from arap_flow_tpu_torch.io.constraints import add_border_pins

    arap_mask, src, tgt = opt_problem()
    ch, cw = GENERIC_CROP
    ys, xs = np.where(arap_mask == 0)
    y0 = min(max(int(ys.mean()) - ch // 2, 0), FRAME_H - ch)
    x0 = min(max(int(xs.mean()) - cw // 2, 0), FRAME_W - cw)
    m = arap_mask[y0 : y0 + ch, x0 : x0 + cw]
    if (m == 0).sum() != (arap_mask == 0).sum():
        raise AssertionError("the object does not fit the crop")
    c = np.concatenate([src, tgt], 1).astype(np.int64) - [x0, y0, x0, y0]
    keep = ((c[:, 0] >= 0) & (c[:, 0] < cw) & (c[:, 1] >= 0) & (c[:, 1] < ch)
            & (c[:, 2] >= 0) & (c[:, 2] < cw) & (c[:, 3] >= 0)
            & (c[:, 3] < ch))
    return m, add_border_pins(c[keep].astype(np.int32), cw, ch)


def phase_generic(smi: str) -> None:
    """9d: ops.generic.gn_solve (torch.func) and the graph energies on the
    card against the specialised solve (the PCG kernel)."""
    import torch

    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops import generic as G
    from arap_flow_tpu_torch.ops import graph as GR
    from arap_flow_tpu_torch.ops import solver as S

    dev = torch.device("cuda", 0)
    m, cons = generic_crop()
    ch, cw = m.shape
    gn_iters, pcg_iters = GENERIC_SCHEDULE
    ops = E.build_operands(m, cons, device=dev)
    cimg = E.anneal_constraints(ops, 1.0)
    zero_counts()
    t0 = time.perf_counter()
    x_spec, _ = S.solve(ops, S.SolverConfig(num_anneal=1, gn_iters=gn_iters,
                                            max_pcg_iters=pcg_iters,
                                            pcg_iters=float(pcg_iters)))
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    spec_launches = read_counts()["pcg_fixed"]

    def diag_fn(x):
        return E.jtf_and_diag(x, ops, cimg)[1]

    t0 = time.perf_counter()
    x_gen = G.gn_solve(lambda x: E.residuals(x, ops, cimg), E.init_state(ops),
                       gn_iters, pcg_iters, diag_fn=diag_fn)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    edges = torch.as_tensor(GR.grid_edges(m), device=dev)
    ur = ops.grid.reshape(2, -1)
    verts = torch.nonzero(ops.fitmask.reshape(-1) > 0)[:, 0]
    tgts = cimg.reshape(2, -1)[:, verts].T

    def graph_residuals(xf):
        return (GR.arap_graph_residuals(xf, edges, ur, torch.sqrt(ops.wr2)),
                GR.fit_graph_residuals(xf, verts, tgts, torch.sqrt(ops.wf2)))

    t0 = time.perf_counter()
    x_graph = G.gn_solve(graph_residuals, E.init_state(ops).reshape(3, -1),
                         gn_iters, pcg_iters,
                         diag_fn=lambda xf: diag_fn(
                             xf.reshape(3, ch, cw)).reshape(3, -1))
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    act = ops.mask > 0
    d_gen = float((x_gen - x_spec).abs()[:, act].max())
    d_graph = float((x_graph.reshape(3, ch, cw) - x_spec).abs()[:, act].max())
    line = (f"phase 9d generic {ch}x{cw} 1x{gn_iters}x{pcg_iters}: max |x_generic"
            f" - x_solve| {d_gen:.3g}, graph ({edges.shape[0]} edges, "
            f"{verts.numel()} fit vertices) {d_graph:.3g} over the solve "
            f"region; seconds: solve {spec_s:.3f} ({spec_launches} pcg_fixed "
            f"launches), generic {gen_s:.3f}, graph {graph_s:.3f} ({smi})")
    say(line)
    if not (d_gen < 0.01 and d_graph < 0.01 and spec_launches == gn_iters):
        raise AssertionError(line)


def phase_instrumented(smi: str, tasks) -> int:
    """9e: solve_instrumented on phase 3's first segment at 19x8x400, its
    CSV and a device trace. Returns its pcg_fixed launches."""
    import torch

    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops import solver as S
    from arap_flow_tpu_torch.utils import profiling as P

    dev = torch.device("cuda", 0)
    task = tasks[0]
    ops = E.expand_operands(E.CompactOperands.stack([task.ops]).to(dev))
    cfg = S.SolverConfig()
    n = cfg.num_anneal * cfg.gn_iters
    zero_counts()
    x, _, costs, wall = P.profile_solve(ops, cfg)
    launches = read_counts()["pcg_fixed"]
    same = torch.equal(x, S.solve(ops, cfg)[0])
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "iterations.csv")
        P.save_solver_iterations(csv, costs[0])
        with open(csv) as f:
            rows = f.read().splitlines()
        logdir = os.path.join(tmp, "trace")
        with P.device_trace(logdir):
            S.solve_instrumented(ops, cfg._replace(num_anneal=1, gn_iters=2))
            torch.cuda.synchronize()
        traces = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        size = sum(os.path.getsize(p) for p in traces)
        with open(traces[0]) as f:
            has_kernel = "pcg_cluster" in f.read()
    line = (f"phase 9e solve_instrumented {tuple(ops.mask.shape)} 19x8x400: "
            f"{wall:.3f} s, {costs.shape[-1]} costs (first {costs[0, 0]:.6g}, "
            f"last {costs[0, -1]:.6g}), all finite {bool(np.isfinite(costs).all())};"
            f" x bitwise solve's {same}; pcg_fixed launches {launches}; CSV "
            f"{len(rows)} lines; device trace {len(traces)} file(s), {size} "
            f"bytes, PCG kernel in it {has_kernel} ({smi})")
    say(line)
    if not (costs.shape == (1, n) and np.isfinite(costs).all() and same
            and launches == n and len(rows) == n + 1 and size > 0
            and has_kernel):
        raise AssertionError(line)
    return launches


def phase_warmup(smi: str, digest: dict, cold_pair: float) -> None:
    """9f: ``para_gen --warmup`` in a fresh process on phase 5's tree: the
    prewarm's seconds by step, the pipeline's seconds a pair after it, and
    the products byte-identical to phase 5's."""
    code = ("import json, sys, time\n"
            "from arap_flow_tpu_torch.pipeline import para_gen\n"
            "t0 = time.perf_counter()\n"
            "para_gen.main(sys.argv[1:])\n"
            "print(json.dumps({'main_s': time.perf_counter() - t0}))\n")
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        make_pipeline_tree(inp)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", code, "--input", inp, "--output", out,
             "--mode", "batched", "--multseg", "--seed", "0", "--warmup"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        proc_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"para_gen --warmup exited {proc.returncode}:"
                                 f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        warm = [ln for ln in proc.stdout.splitlines() if ln.startswith("warmup")]
        main_s = json.loads(proc.stdout.strip().splitlines()[-1])["main_s"]
        warm_s = float(warm[-1].rsplit(" ", 1)[1].rstrip("s"))
        with open(os.path.join(out, "all_files.list")) as f:
            lines = f.read().splitlines()
        same = tree_digest(out, lines) == digest
    n_pairs = PIPE_FRAMES - 1
    say("phase 9f prewarm:\n  " + "\n  ".join(warm))
    line = (f"phase 9f para_gen --warmup in a fresh process: {proc_s:.3f} s "
            f"(main {main_s:.3f} s, prewarm {warm_s:.3f} s); the pairs after "
            f"the prewarm {(main_s - warm_s) / n_pairs:.3f} s a pair against "
            f"phase 5's cold {cold_pair:.3f} (in this process, warmed by the "
            f"phases before it); products byte-identical to phase 5's: "
            f"{same} ({smi})")
    say(line)
    if not (same and len(warm) >= 3):
        raise AssertionError(line)


# Phase 10: the last modules. The cut schedule of the plain-torch row-split
# solve (10c) and of the checks whose point is routing or bytes (10e, 10f):
# plain torch at 19x8x400 and 480x854 would take minutes.
CUT = (2, 2, 40)


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cut_config(**kw):
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    a, g, p = CUT
    return SolverConfig(num_anneal=a, gn_iters=g, max_pcg_iters=p,
                        pcg_iters=float(p), **kw)


def phase_sharded_pipeline(smi: str, digest: dict, dev) -> dict:
    """10a: ``para_gen --mode sharded`` on phase 5's tree, on a mesh of the
    one card: products byte-identical to phase 5's ``--mode batched``
    digest (the check of the JAX package's __graft_entry__.py:205).
    Returns the run's launches."""
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline import para_gen

    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        make_pipeline_tree(inp)
        flags = para_gen.PipelineFlags(input=inp, output=out, multseg=True,
                                       seed=0, mode="sharded",
                                       device=str(dev))
        zero_counts()
        t0 = time.perf_counter()
        lines = para_gen.main_pipeline(flags, solver_cfg=SolverConfig())
        sync(dev)
        secs = time.perf_counter() - t0
        launches = read_counts()
        same = tree_digest(out, lines) == digest
    line = (f"phase 10a para_gen --mode sharded (a mesh of 1 device, the "
            f"batched path on one card): {secs / (PIPE_FRAMES - 1):.3f} s a "
            f"pair; launches pcg_fixed {launches['pcg_fixed']}, zncc_search "
            f"{launches['zncc_search']}; products byte-identical to phase "
            f"5's --mode batched: {same} ({smi})")
    say(line)
    if not (same and launches["pcg_fixed"] > 0
            and launches["zncc_search"] > 0):
        raise AssertionError(line)
    return launches


def phase_mesh_runner(smi: str, probs, tasks, dev) -> int:
    """10b: BatchRunner on a mesh of two entries of the one card against
    the unsharded runner, on phase 3's tasks three times over (a chunk of 3
    a bucket, which the mesh splits 2 + 1). Returns the mesh run's
    pcg_fixed launches."""
    from arap_flow_tpu_torch.ops.pcg import card_plan
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.parallel import make_mesh
    from arap_flow_tpu_torch.pipeline.batch import BatchRunner

    mesh = make_mesh(devices=[dev, dev])
    many = [t.__class__(**{**vars(t), "pair_idx": k}) for k in range(3)
            for t in tasks if t is not None]
    runs = {}
    for m in (None, mesh):
        runner = BatchRunner(SolverConfig(), device=dev, mesh=m)
        zero_counts()
        t0 = time.perf_counter()
        for t in many:
            runner.add(t)
        out = runner.finish()
        sync(dev)
        runs[m is not None] = (out, time.perf_counter() - t0,
                               read_counts()["pcg_fixed"])
    (ref, ref_s, ref_n), (got, got_s, got_n) = runs[False], runs[True]
    shapes = sorted({t.ops.mask_u8.shape for t in many})
    plans = {hw: [card_plan(B, *hw, False, dev) for B in (3, 2, 1)]
             for hw in shapes}
    same_plan = all(p[0] == p[1] == p[2] for p in plans.values())
    d = max(float(np.abs(got[k].flow - ref[k].flow).max()) for k in ref)
    bitwise = all(np.array_equal(got[k].flow, ref[k].flow)
                  and np.array_equal(got[k].warped_rgb, ref[k].warped_rgb)
                  and np.array_equal(got[k].warped_mask, ref[k].warped_mask)
                  for k in ref)
    plan_txt = "; ".join(
        f"{h}x{w}: " + ", ".join(f"B={B} cluster {p.cluster} rows "
                                 f"{p.rows_per_cta}"
                                 for B, p in zip((3, 2, 1), ps))
        for (h, w), ps in plans.items())
    line = (f"phase 10b BatchRunner on make_mesh([cuda:0, cuda:0]) (two mesh "
            f"entries on one card: this tests the split and the gather, not "
            f"scaling across cards), {len(many)} tasks at 19x8x400: max "
            f"|dflow| against the unsharded runner {d:.3g} px (gate < 1e-4), "
            f"bitwise {bitwise} (required where the plans agree: "
            f"{same_plan}); plans {plan_txt}; pcg_fixed launches {got_n} "
            f"(unsharded {ref_n}); {got_s:.3f} s (unsharded {ref_s:.3f}) "
            f"({smi})")
    say(line)
    if not (sorted(got) == sorted(ref) and d < 1e-4
            and (bitwise or not same_plan) and got_n > 0):
        raise AssertionError(line)
    return got_n


def phase_spatial(smi: str, probs, dev) -> None:
    """10c: solve_spatial at the 480x854 frame (segment 0 of phase 3 on the
    whole frame) over [cuda:0]*4 (space = 4) and [cuda:0] (space = 1),
    against solver.solve on the card at the cut schedule: the plain backend
    (the same arithmetic, summed in another order) within 5e-4, the PCG
    kernel's route within 0.05 px (the full-solve bound)."""
    import torch

    from arap_flow_tpu_torch.io.constraints import add_border_pins
    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops import solver as S
    from arap_flow_tpu_torch.parallel import make_mesh, solve_spatial

    _, mask, cons, _ = probs[0]
    ops = E.build_operands(mask, add_border_pins(cons, FRAME_W, FRAME_H),
                           device=dev)
    batch = E.ArapOperands(**{f: v[None] for f, v in vars(ops).items()})

    def timed(fn):
        t0 = time.perf_counter()
        x, flow = fn()
        sync(dev)
        return x, flow, time.perf_counter() - t0

    plain = cut_config(backend="plain")
    x_p, f_p, s_p = timed(lambda: S.solve(batch, plain))
    x_k, f_k, s_k = timed(lambda: S.solve(batch, cut_config()))
    ok = True
    parts = []
    for space in (4, 1):
        mesh = make_mesh(devices=[dev] * space, space=space)
        x, flow, secs = timed(lambda: solve_spatial(batch, plain, mesh))
        dx = float((x - x_p).abs().max())
        df = float((flow - f_p).abs().max())
        dk = float((flow - f_k).abs().max())
        ok &= dx < 5e-4 and df < 5e-4 and dk < 0.05 and bool(
            torch.isfinite(x).all())
        parts.append(f"space={space}: {secs:.3f} s, max |dx| {dx:.3g}, max "
                     f"|dflow| {df:.3g} against the plain solve, {dk:.3g} "
                     f"against the kernel route")
    line = (f"phase 10c solve_spatial {FRAME_H}x{FRAME_W} at the cut schedule "
            f"{'x'.join(map(str, CUT))} (plain torch; 19x8x400 would take "
            f"minutes): " + "; ".join(parts) + f"; solver.solve {s_p:.3f} s "
            f"plain, {s_k:.3f} s on the PCG kernel (gates 5e-4 against the "
            f"plain solve, 0.05 px against the kernel route) ({smi})")
    say(line)
    if not ok:
        raise AssertionError(line)


def segment_crop(prob, tasks_j):
    """Phase 3's segment on its task's canonical solve box: (mask, pinned
    constraints in the box, y0, x0), as make_task cuts it before any
    transposition."""
    from arap_flow_tpu_torch.io.constraints import add_border_pins

    _, mask, cons, _ = prob
    t = tasks_j
    bh, bw = t.bucket
    pinned = add_border_pins(cons, FRAME_W, FRAME_H).astype(np.int64)
    sub = np.ascontiguousarray(mask[t.y0 : t.y0 + bh, t.x0 : t.x0 + bw])
    shifted = pinned.copy()
    shifted[:, [0, 2]] -= t.x0
    shifted[:, [1, 3]] -= t.y0
    inside = ((shifted[:, 0] >= 0) & (shifted[:, 0] < bw)
              & (shifted[:, 1] >= 0) & (shifted[:, 1] < bh))
    return sub, shifted[inside].astype(np.int32), t.y0, t.x0


def phase_pyramid(smi: str, probs, tasks, dev) -> int:
    """10d: solve_pyramid on phase 3's first segment (its solve box) on the
    card: at the cut schedule against the port's CPU run of the same call
    (< 1e-3 px), then at 19x8x400 with fine_anneal = 1: the median rigid
    EPE, seconds and pcg_fixed launches (19x8 coarse + 1x8 fine = 160)
    beside the flat solve of the same box. Returns the full run's
    launches."""
    import torch

    from arap_flow_tpu_torch.ops import energy as E
    from arap_flow_tpu_torch.ops import solver as S
    from arap_flow_tpu_torch.ops.pyramid import solve_pyramid

    sub, cons, y0, x0 = segment_crop(probs[0], tasks[0])
    _, f_gpu = solve_pyramid(sub, cons, cut_config(), device=dev)
    _, f_cpu = solve_pyramid(sub, cons, cut_config(), device="cpu")
    d = float((f_gpu.cpu() - f_cpu).abs().max())

    def epe(flow):
        full = np.zeros((FRAME_H, FRAME_W, 2), np.float32)
        full[y0 : y0 + sub.shape[0], x0 : x0 + sub.shape[1]] = (
            flow.cpu().numpy().transpose(1, 2, 0))
        return rigid_epe_median(full, probs[0][1], SEG_SHAPES[0][0],
                                probs[0][3])

    full = S.SolverConfig()
    zero_counts()
    t0 = time.perf_counter()
    _, f_pyr = solve_pyramid(sub, cons, full, fine_anneal=1, device=dev)
    sync(dev)
    s_pyr = time.perf_counter() - t0
    n_pyr = read_counts()["pcg_fixed"]
    ops = E.build_operands(sub, cons, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    _, f_flat = S.solve(ops, full)
    sync(dev)
    s_flat = time.perf_counter() - t0
    n_flat = read_counts()["pcg_fixed"]
    expect = full.num_anneal * full.gn_iters + full.gn_iters
    obj = sub == 0
    gap = (f_pyr - f_flat).abs().amax(0).cpu().numpy()[obj]
    line = (f"phase 10d solve_pyramid {sub.shape[0]}x{sub.shape[1]} (phase 3's "
            f"segment 0): card against the CPU at {'x'.join(map(str, CUT))} "
            f"max |dflow| {d:.3g} px (gate < 1e-3); 19x8x400 fine_anneal=1: "
            f"median rigid EPE {epe(f_pyr):.4f} px, {s_pyr:.3f} s, pcg_fixed "
            f"launches {n_pyr} (expected {expect}); the flat solve: EPE "
            f"{epe(f_flat):.4f} px, {s_flat:.3f} s, {n_flat} launches; "
            f"|flow pyramid - flow flat| over the object: median "
            f"{float(np.median(gap)):.3g}, max {float(gap.max()):.3g} px "
            f"({smi})")
    say(line)
    if not (d < 1e-3 and n_pyr == expect and bool(torch.isfinite(f_pyr).all())):
        raise AssertionError(line)
    return n_pyr


def phase_host_deform(smi: str, probs, dev) -> None:
    """10e: ``ARAP_RASTER=host`` deform on a list of phase 3's two frames
    (one shape) at the cut schedule: the native splat runs once a frame (2
    calls) and the products are byte-identical to ArapDeformer(raster=
    "host")'s, frame by frame."""
    from arap_flow_tpu_torch.io import flo
    from arap_flow_tpu_torch.io.image import save_image
    from arap_flow_tpu_torch.models.arap import ArapDeformer
    from arap_flow_tpu_torch.native import runtime
    from arap_flow_tpu_torch.pipeline import deform_tool
    from arap_flow_tpu_torch.utils.config import FrameworkConfig

    cfg = cut_config()
    calls = []
    splat = runtime.rasterize_warp

    def spy(*a, **k):
        calls.append(1)
        return splat(*a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        frames = []
        for j, (rgb, mask, cons, _) in enumerate(probs):
            paths = [os.path.join(tmp, f"{n}{j}.{e}") for n, e in (
                ("rgb", "png"), ("mask", "png"), ("cstr", "txt"),
                ("flow", "flo"), ("w", "png"), ("m", "png"))]
            save_image(paths[0], rgb)
            save_image(paths[1], mask)
            with open(paths[2], "w") as f:
                f.write(f"{len(cons)}\n" + "\n".join(
                    " ".join(str(v) for v in row) for row in cons))
            frames.append(deform_tool.FramePaths(*paths))
        runtime.rasterize_warp = spy
        try:
            failed = deform_tool.deform_frames(
                frames, cfg, device=dev,
                fw=FrameworkConfig(solver=cfg, raster="host"))
        finally:
            runtime.rasterize_warp = splat
        deformer = ArapDeformer(cfg, raster="host", device=dev)
        same = []
        for j, (rgb, mask, cons, _) in enumerate(probs):
            res = deformer.deform(rgb, mask, cons)
            ref = [os.path.join(tmp, f"ref{j}.{e}") for e in
                   ("flo", "w.png", "m.png")]
            flo.flow_write(ref[0], res.flow)
            save_image(ref[1], res.warped_rgb)
            save_image(ref[2], res.warped_mask)
            fr = frames[j]
            same.append(all(_read_bytes(a) == _read_bytes(b) for a, b in zip(
                (fr.out_flo, fr.out_rgb, fr.out_mask), ref)))
    line = (f"phase 10e ARAP_RASTER=host deform on a {len(probs)}-frame "
            f"{FRAME_W}x{FRAME_H} list at {'x'.join(map(str, CUT))}: "
            f"rasterize_warp calls {len(calls)} (expected {len(probs)}), "
            f"products byte-identical to ArapDeformer(raster='host') frame "
            f"by frame: {same}; failed frames {len(failed)} ({smi})")
    say(line)
    if not (len(calls) == len(probs) and all(same) and not failed):
        raise AssertionError(line)


def phase_run_tasks(smi: str, probs, tasks, dev) -> int:
    """10f: run_tasks on phase 3's tasks plus segment 0 again as a
    full-frame fallback, at the cut schedule: bitwise equal to a
    BatchRunner fed the same. Returns run_tasks' pcg_fixed launches."""
    from arap_flow_tpu_torch.io.constraints import add_border_pins
    from arap_flow_tpu_torch.pipeline.batch import BatchRunner, run_tasks

    cfg = cut_config()
    rgb, mask, cons, _ = probs[0]
    fallback = (1, 0, rgb, mask, add_border_pins(cons, FRAME_W, FRAME_H))
    live = [t for t in tasks if t is not None]
    zero_counts()
    got = run_tasks(live, [fallback], cfg, device=dev)
    n = read_counts()["pcg_fixed"]
    runner = BatchRunner(cfg, device=dev)
    for t in live:
        runner.add(t)
    runner.add_fallback(*fallback)
    ref = runner.finish()
    same = sorted(got) == sorted(ref) and all(
        np.array_equal(got[k].flow, ref[k].flow)
        and np.array_equal(got[k].warped_rgb, ref[k].warped_rgb)
        and np.array_equal(got[k].warped_mask, ref[k].warped_mask)
        for k in ref)
    line = (f"phase 10f run_tasks: {len(live)} tasks and 1 full-frame "
            f"fallback at {'x'.join(map(str, CUT))}: bitwise equal to "
            f"BatchRunner's products: {same}; pcg_fixed launches {n} ({smi})")
    say(line)
    if not (same and n > 0 and (1, 0) in got):
        raise AssertionError(line)
    return n


# Phase 11: the remaining entry points, each run as a user types it
# (``arap_flow_tpu_torch.__main__.main``) on the default --device cuda.
SINTEL_H, SINTEL_W = 436, 1024  # MPI-Sintel's frame
SINTEL_SEQ = "alley_1"
SINTEL_PASSES = ("clean", "final")
SINTEL_FRAMES = 2  # frames a pass
SINTEL_OBJECTS = (  # (centre y, x), (radius y, x), (dx, dy) a frame
    ((140, 512), (115, 470), (7, -4)),  # a 230x940 box: wider than any bucket
    ((350, 300), (60, 100), (-6, 5)),
)
# texture_gen's seed in 11d, the first image's family and the checksums
# (texture_sums) of that family's 64x96 render from the first image's key,
# prng.key(seed * 100003), recorded from the JAX package as TEX_JAX_SUMS
# (tests/test_torch_smoke_constants.py)
TEXGEN_SEED = 5
TEXGEN_JAX_FIRST = ("noise", (3133716, 393818292))


def cli(*argv) -> int:
    """One command of ``python -m arap_flow_tpu_torch``, in this process."""
    from arap_flow_tpu_torch.__main__ import main as tool_main

    return tool_main([str(a) for a in argv])


def median_motion_error(u, v, sel, motion) -> float:
    dx, dy = motion
    return float(np.median(np.hypot(u[sel] - dx, v[sel] - dy)))


def phase_generate(smi: str, keep: str) -> dict:
    """11a: ``generate --phases match convert deform bg`` on phase 5's tree
    (kept by phase 5 under `keep`). Returns the run's launches."""
    import torch

    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask
    from arap_flow_tpu_torch.ops.matching import clamp_match_params, zncc_calls
    from arap_flow_tpu_torch.ops.solver import SolverConfig

    inp, ref, out = (os.path.join(keep, d) for d in ("in", "out", "generate"))
    n_pairs = PIPE_FRAMES - 1
    zero_counts()
    t0 = time.perf_counter()
    rc = cli("generate", "--input", inp, "--output", out, "--phases",
             "match", "convert", "deform", "bg")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    cfg = SolverConfig()
    want = (n_pairs * zncc_calls(clamp_match_params(FRAME_H, FRAME_W)[1]),
            n_pairs * cfg.num_anneal * cfg.gn_iters)
    with open(os.path.join(out, "all_files.list")) as f:
        listed = f.read().splitlines()
    missing = [p for t in range(n_pairs) for d, ext in (
        ("Flow", "flo"), ("inpRGB", "png"), ("inpMasks", "png"),
        ("wRGB", "png"), ("wMasks", "png"), ("tmpCnstr", "txt"))
        if not os.path.exists(p := os.path.join(out, d, "seq0",
                                                f"{t:05d}.{ext}"))]
    errs, gaps = [], []
    for t in range(n_pairs):
        name = f"{t:05d}"
        mk = load_mask(os.path.join(inp, "orgMasks", "seq0", name + ".png"))
        u, v = flow_read(os.path.join(out, "Flow", "seq0", name + ".flo"))
        ru, rv = flow_read(os.path.join(ref, "Flow", "seq0", name + ".flo"))
        for k, (_, _, motion) in enumerate(PIPE_OBJECTS):
            errs.append(median_motion_error(u, v, mk == k + 1, motion))
        obj = mk != 0
        gaps.append(float(np.median(np.hypot(u[obj] - ru[obj],
                                             v[obj] - rv[obj]))))
    line = (f"phase 11a generate --phases match convert deform bg on phase "
            f"5's tree: exit {rc}, {secs:.3f} s ({secs / n_pairs:.3f} s a "
            f"pair, full-frame solves); {len(listed)} list lines, missing "
            f"products {missing}; median |flow - t| by pair and object "
            f"{[round(e, 4) for e in errs]} px; median |flow - phase 5's "
            f"batched flow| {[round(g, 4) for g in gaps]} px; launches "
            f"zncc_search {launches['zncc_search']} (predicted {want[0]}), "
            f"pcg_fixed {launches['pcg_fixed']} (predicted {want[1]}) ({smi})")
    say(line)
    if not (rc == 0 and len(listed) == n_pairs and not missing
            and max(errs) < 1.0 and max(gaps) < 0.05
            and (launches["zncc_search"], launches["pcg_fixed"]) == want):
        raise AssertionError(line)
    return launches


def sintel_path(root: str, kind: str, pas: str, i: int, ext: str) -> str:
    base = root if kind == "frames" else os.path.join(root, kind)
    return os.path.join(base, pas, SINTEL_SEQ, f"frame_{i:04d}.{ext}")


def make_sintel_tree(root: str) -> None:
    """An MPI-Sintel-style tree at 1024x436: ROOT/{clean,final}/SEQ/
    frame_XXXX.png, the ARAP masks ROOT/masks/{pass}/SEQ/frame_XXXX.png (0
    on the two objects, 255 elsewhere) and ROOT/cnstr/{pass}/SEQ/
    frame_XXXX.txt: a constraint every 8 px inside each object, moving it
    by its translation. The final pass is the clean one darkened, with
    noise."""
    from arap_flow_tpu_torch.io.constraints import write_constraint_file
    from arap_flow_tpu_torch.io.image import save_image

    H, W = SINTEL_H, SINTEL_W
    texs = [rgb_texture(H, W, 40 + k) for k in range(len(SINTEL_OBJECTS))]
    bg = rgb_texture(H, W, 50) // 3
    yy, xx = np.mgrid[0:H, 0:W]
    ys, xs = np.mgrid[0:H:8, 0:W:8]
    rng = np.random.default_rng(51)
    for i in range(1, SINTEL_FRAMES + 1):
        img = bg.copy()
        mask = np.full((H, W), 255, np.uint8)
        cons = []
        for k, ((cy, cx), (ry, rx), (dx, dy)) in enumerate(SINTEL_OBJECTS):
            cy, cx = cy + dy * (i - 1), cx + dx * (i - 1)
            ob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
            img[ob] = texs[k][(yy[ob] - dy * (i - 1)) % H,
                              (xx[ob] - dx * (i - 1)) % W]
            mask[ob] = 0
            inner = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 < 0.8
            cons += [(x, y, x + dx, y + dy)
                     for y, x in zip(ys[inner], xs[inner])]
        final = np.clip(img * 0.8 + rng.normal(0, 4, img.shape), 0,
                        255).astype(np.uint8)
        for pas, frame in zip(SINTEL_PASSES, (img, final)):
            for kind, arr in (("frames", frame), ("masks", mask)):
                path = sintel_path(root, kind, pas, i, "png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                save_image(path, arr)
            path = sintel_path(root, "cnstr", pas, i, "txt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            write_constraint_file(path, np.array(cons, np.int32))


def phase_run_arap(smi: str, keep: str) -> dict:
    """11b: ``run_arap --input ROOT --passes clean final`` on a Sintel-style
    tree, then the same jobs through ``run_arap --list``. Returns the
    launches of both runs."""
    import torch

    from arap_flow_tpu_torch.io.flo import flow_read
    from arap_flow_tpu_torch.io.image import load_mask

    root = os.path.join(keep, "sintel")
    make_sintel_tree(root)
    zero_counts()
    t0 = time.perf_counter()
    rc = cli("run_arap", "--input", root, "--passes", *SINTEL_PASSES)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    jobs, lines = [], []
    for pas in SINTEL_PASSES:
        for i in range(1, SINTEL_FRAMES + 1):
            ins = [sintel_path(root, k, pas, i, e) for k, e in (
                ("frames", "png"), ("masks", "png"), ("cnstr", "txt"))]
            outs = []
            for d in ("flow_arap", "list_out"):
                stem = os.path.join(root, d, pas, SINTEL_SEQ,
                                    f"frame_{i:04d}")
                outs.append([stem + ".flo", stem + "_wRGB.png",
                             stem + "_wMask.png"])
            os.makedirs(os.path.dirname(outs[1][0]), exist_ok=True)
            jobs.append((ins, outs))
            lines.append(" ".join(ins + outs[1]))
    listfile = os.path.join(root, "jobs.txt")
    with open(listfile, "w") as f:
        f.write("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    rc_list = cli("run_arap", "--list", listfile)
    torch.cuda.synchronize()
    secs_list = time.perf_counter() - t0
    launches = read_counts()
    same = all(_read_bytes(a) == _read_bytes(b)
               for _, (o1, o2) in jobs for a, b in zip(o1, o2))
    errs = []
    for (rgb, mask, _), (o1, _) in jobs:
        u, v = flow_read(o1[0])
        obj = load_mask(mask) == 0
        yy, xx = np.mgrid[0:SINTEL_H, 0:SINTEL_W]
        i = int(os.path.basename(rgb)[6:10])
        for (cy, cx), (ry, rx), (dx, dy) in SINTEL_OBJECTS:
            cy, cx = cy + dy * (i - 1), cx + dx * (i - 1)
            sel = obj & (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0)
            errs.append(median_motion_error(u, v, sel, (dx, dy)))
    n = len(jobs)
    line = (f"phase 11b run_arap on a {SINTEL_W}x{SINTEL_H} Sintel-style "
            f"tree ({n} frames, {'/'.join(SINTEL_PASSES)}; each frame solved "
            f"whole: run_arap does not crop): --input exit {rc} in "
            f"{secs:.3f} s, --list exit {rc_list} in {secs_list:.3f} s; "
            f"products byte-identical: {same}; median |flow - t| by frame "
            f"and object {[round(e, 4) for e in errs]} px; launches "
            f"pcg_fixed {launches['pcg_fixed']} ({smi})")
    say(line)
    if not (rc == 0 and rc_list == 0 and same and max(errs) < 1.0
            and launches["pcg_fixed"] > 0):
        raise AssertionError(line)
    return launches


def phase_run_warp(smi: str, keep: str) -> None:
    """11c: ``run_warp`` over phase 5's output tree (as fd1 of a root) with
    --backend device and host, each product bitwise warp_tool.warp_image's
    on the same files, the two backends' wMasks agreeing on >= 98% of
    pixels."""
    import torch

    from arap_flow_tpu_torch.io.image import load_mask
    from arap_flow_tpu_torch.pipeline.run_warp import scan_jobs
    from arap_flow_tpu_torch.pipeline.warp_tool import warp_image

    dev = torch.device("cuda", 0)
    root = os.path.join(keep, "warp")
    shutil.copytree(os.path.join(keep, "out"), os.path.join(root, "fd1"))
    jobs = scan_jobs(root, [1])
    ref = os.path.join(keep, "warp_ref")
    os.makedirs(ref)
    masks, same = {}, True
    for backend in ("device", "host"):
        rc = cli("run_warp", "--root", root, "--fd", 1, "--backend", backend)
        if rc != 0:
            raise AssertionError(f"phase 11c run_warp --backend {backend} "
                                 f"exited {rc}")
        for j, (rgb, msk, flo, wrgb, wmsk) in enumerate(jobs):
            r_rgb = os.path.join(ref, f"{backend}{j}_w.png")
            r_msk = os.path.join(ref, f"{backend}{j}_m.png")
            warp_image(rgb, msk, flo, r_rgb, r_msk,
                       device=dev if backend == "device" else None,
                       backend=backend)
            same &= (_read_bytes(wrgb) == _read_bytes(r_rgb)
                     and _read_bytes(wmsk) == _read_bytes(r_msk))
            masks.setdefault(backend, []).append(load_mask(wmsk))
    shares = [float((a == b).mean())
              for a, b in zip(masks["device"], masks["host"])]
    line = (f"phase 11c run_warp --backend device and host over phase 5's "
            f"{len(jobs)} flows: products bitwise warp_image's: {same}; "
            f"device and host wMasks agree on {[round(s, 6) for s in shares]}"
            f" of the pixels ({smi})")
    say(line)
    if not (same and len(jobs) == PIPE_FRAMES - 1 and min(shares) >= 0.98):
        raise AssertionError(line)


def start_warp_cli(keep: str):
    """11c: start ``python3 -m arap_flow_tpu_torch warp`` in a subprocess
    on 11b's first clean Sintel frame and its flow (it runs while the
    phases after it do; ``check_warp_cli`` waits for it). Returns (the
    process, its arguments and outputs, the start time)."""
    sintel = os.path.join(keep, "sintel")
    args = [sintel_path(sintel, "frames", "clean", 1, "png"),
            sintel_path(sintel, "masks", "clean", 1, "png"),
            os.path.join(sintel, "flow_arap", "clean", SINTEL_SEQ,
                         "frame_0001.flo")]
    outs = [os.path.join(keep, n) for n in ("sub_w.png", "sub_m.png",
                                            "in_w.png", "in_m.png")]
    proc = subprocess.Popen(
        [sys.executable, "-m", "arap_flow_tpu_torch", "warp", *args,
         *outs[:2]], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, args, outs, time.perf_counter()


def check_warp_cli(smi: str, started) -> None:
    """11c: the subprocess's products bitwise the in-process
    ``warp_image``'s on the same files."""
    import torch

    from arap_flow_tpu_torch.pipeline.warp_tool import warp_image

    proc, args, outs, t0 = started
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 11c python -m arap_flow_tpu_torch warp "
                             f"exited {proc.returncode}:\n{out[-3000:]}")
    warp_image(*args, *outs[2:], device=torch.device("cuda", 0))
    same = (_read_bytes(outs[0]) == _read_bytes(outs[2])
            and _read_bytes(outs[1]) == _read_bytes(outs[3]))
    line = (f"phase 11c python -m arap_flow_tpu_torch warp on a "
            f"{SINTEL_W}x{SINTEL_H} Sintel frame in a subprocess (done "
            f"{secs:.2f} s after its start, beside 11c-11e) bitwise the "
            f"in-process call: {same} ({smi})")
    say(line)
    if not same:
        raise AssertionError(line)


def phase_texture_gen(smi: str, keep: str) -> None:
    """11d: ``texture_gen --num 7 --seed TEXGEN_SEED --size 1280 720`` on
    the card: 7 files; the first one's family JAX's, its 64x96 render's
    checksums JAX's (TEXGEN_JAX_FIRST) within 8a's tolerance, and the file
    bitwise the same key's render on the card."""
    import torch

    from arap_flow_tpu_torch.io.image import load_rgb
    from arap_flow_tpu_torch.ops import textures
    from arap_flow_tpu_torch.utils import prng

    dev = torch.device("cuda", 0)
    out = os.path.join(keep, "textures")
    t0 = time.perf_counter()
    rc = cli("texture_gen", "--output", out, "--num", 7, "--seed",
             TEXGEN_SEED, "--size", 1280, 720)
    secs = time.perf_counter() - t0
    files = sorted(os.listdir(out))
    fam, want = TEXGEN_JAX_FIRST
    key = prng.key(TEXGEN_SEED * 100003)
    got = texture_sums(textures.render(key, fam, 64, 96,
                                       device=dev).cpu().numpy())
    n = 64 * 96 * 3
    first = load_rgb(os.path.join(out, files[0])) if files else None
    same = first is not None and np.array_equal(
        first, textures.render(key, fam, 720, 1280, device=dev).cpu().numpy())
    line = (f"phase 11d texture_gen --num 7 --seed {TEXGEN_SEED} --size 1280 "
            f"720: exit {rc}, {len(files)} files in {secs:.3f} s "
            f"({files[:1]}...); the first one's 64x96 render checksums "
            f"{got}, JAX's {want} (equal: {got == want}); the file bitwise "
            f"the card's render of its key: {same} ({smi})")
    say(line)
    if not (rc == 0 and len(files) == 7 and files[0].endswith(f"_{fam}.png")
            and abs(got[0] - want[0]) <= n // 1000
            and abs(got[1] - want[1]) <= 251 * (n // 1000) and same):
        raise AssertionError(line)


def phase_sintel_zncc(smi: str, keep: str) -> None:
    """11e: the matcher on a sub-batch of 4 Sintel-shaped pairs (11b's
    frames) records the shapes of its zncc_search calls; at each, the
    kernel against the plain version on phase 4's inputs with phase 4's
    gates."""
    import torch

    from arap_flow_tpu_torch.io.image import load_rgb
    from arap_flow_tpu_torch.ops import matching
    from arap_flow_tpu_torch.ops.zncc import zncc_search, zncc_search_plain

    dev = torch.device("cuda", 0)
    sintel = os.path.join(keep, "sintel")
    frames = {(p, i): load_rgb(sintel_path(sintel, "frames", p, i, "png"))
              for p in SINTEL_PASSES for i in (1, 2)}
    pairs = [(frames[(p, 1)], frames[(p, 2)]) for p in SINTEL_PASSES]
    pairs += [(b, a) for a, b in pairs]
    shapes = []

    def recorder(p1, p2, radius, *a, **k):
        shapes.append((p1.shape[0] if p1.dim() == 3 else 1,
                       p2.shape[0] if p2.dim() == 3 else 1,
                       *p1.shape[-2:], int(radius)))
        return zncc_search(p1, p2, radius, *a, **k)

    matching.zncc_search = recorder
    try:
        for h in matching.match_images_dispatch_multi(pairs, radius=100,
                                                      device=dev):
            matching.match_images_fetch(h)
    finally:
        matching.zncc_search = zncc_search
    for N1, N2, H, W, r in shapes:
        a, b = zncc_inputs(N1, N2, H, W, r, seed=H + W + r)
        p1, p2 = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
        ku, kv, ks = zncc_search(p1, p2, r)
        ku2, kv2, ks2 = zncc_search(p1, p2, r)
        pu, pv, ps = zncc_search_plain(p1, p2, r)
        torch.cuda.synchronize()
        repeat = (torch.equal(ku, ku2) and torch.equal(kv, kv2)
                  and torch.equal(ks, ks2))
        err = float((ks - ps).abs().max())
        differ = (ku != pu) | (kv != pv)
        agree = 1.0 - float(differ.float().mean())
        at_k = plain_score_at(p1, p2, r, ku, kv, differ)
        tie = float((at_k[differ] - ps[differ]).abs().max()) if bool(
            differ.any()) else 0.0
        line = (f"phase 11e zncc at the matcher's Sintel shape {N1}->{N2}x"
                f"{H}x{W} r={r}: max|score d| {err:.3g}; argmax agreement "
                f"{agree:.6f}, largest plain score gap where they differ "
                f"{tie:.3g}; bitwise repeat {repeat} ({smi})")
        say(line)
        if not (repeat and err <= 2e-4 and agree >= 0.99 and tie <= 2e-4):
            raise AssertionError(line)
    if len(shapes) != 4 or shapes[-1][2:4] != (SINTEL_H, SINTEL_W):
        raise AssertionError(f"phase 11e: the matcher's searches {shapes}")


# Phase 12: every crop bucket at B = 1 and at the pipeline's largest chunk
# (max_chunk_for: 24 at every bucket), and the two full frames a fallback
# solves alone (at B = 1).
LADDER_FRAMES = ((SINTEL_H, SINTEL_W), (FRAME_H, FRAME_W))
LADDER_REPEAT_ITERS = 40  # the bitwise repeat at B = 24 and the tall check
# B = 1's CONVERGED_ITERS check at every shape, cut (printed): with it the
# whole smoke took 299.5 s on an H100 80GB HBM3 at 700 W, at the edge of
# its 300 s; phase 2 holds the same check at 11 shapes
LADDER_CONVERGED = False


def phase_ladder(smi: str) -> None:
    """12: for each shape the plans (both PCG layouts, the fused kernel;
    none may have 0 active clusters), then the PCG kernel against its plain
    version (1 iteration within 1e-4, two runs bitwise; at B = 1 phase 2's
    converged check where LADDER_CONVERGED), the tall layout within 1e-5
    of the standard one at
    the largest B, and the fused kernel against its plain version at
    1x1x1 within 1e-4 at both B."""
    import torch

    from arap_flow_tpu_torch.models.arap import CROP_BUCKETS
    from arap_flow_tpu_torch.ops import fused_solver as F
    from arap_flow_tpu_torch.ops import pcg as TP
    from arap_flow_tpu_torch.ops.energy import ArapOperands
    from arap_flow_tpu_torch.ops.solver import SolverConfig
    from arap_flow_tpu_torch.pipeline.batch import max_chunk_for

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    unit = SolverConfig(num_anneal=1, gn_iters=1, max_pcg_iters=1,
                        pcg_iters=1.0)
    shapes = [(H, W, max_chunk_for((H, W))) for H, W in CROP_BUCKETS]
    shapes += [(H, W, 1) for H, W in LADDER_FRAMES]
    if not LADDER_CONVERGED:
        say("phase 12 cut: B = 1's converged check skipped (the smoke's "
            "time limit)")
    plans = set()
    worst = {"pcg": 0.0, "tall": 0.0, "fused": 0.0}
    for H, W, Bmax in shapes:
        for B in sorted({1, Bmax}):
            say(plan_line(B, H, W, "phase 12 plan"))
            say(fused_plan_line(B, H, W, "phase 12 fused plan"))
            plans |= {("pcg", TP.card_plan(B, H, W, False, dev)),
                      ("tall", TP.card_plan(B, H, W, True, dev)),
                      ("fused", F.card_plan(B, H, W, dev))}
        ops, args = pcg_problem(Bmax, H, W, seed=H + 3 * W, device=dev)
        batch = stack_operands(ops)
        notes = []
        for B in sorted({1, Bmax}):
            a = tuple(t[:B] for t in args)
            k1 = TP.pcg_fixed(*a, 1, tall=False)
            p1 = TP.pcg_fixed_plain(*a, 1)
            ka = TP.pcg_fixed(*a, LADDER_REPEAT_ITERS, tall=False)
            kb = TP.pcg_fixed(*a, LADDER_REPEAT_ITERS, tall=False)
            torch.cuda.synchronize()
            d1 = float((k1 - p1).abs().max())
            torch.testing.assert_close(k1, p1, rtol=1e-4, atol=1e-4)
            if not torch.equal(ka, kb):
                raise AssertionError(f"phase 12 PCG kernel not bitwise "
                                     f"repeatable at B={B} {H}x{W}")
            worst["pcg"] = max(worst["pcg"], d1)
            note = f"B={B}: PCG 1-iter max|d| {d1:.3g}"
            if B == 1 and LADDER_CONVERGED:
                pn = TP.pcg_fixed_plain(*a, CONVERGED_ITERS)
                _, _, _, res, dn = check_pcg_layout(ops[:1], a, False, p1,
                                                    pn, (1, H, W))
                note += (f", {CONVERGED_ITERS}-iter residual/|b| {res:.3g} "
                         f"max|d| {dn:.3g}")
            if B == Bmax:
                t1 = TP.pcg_fixed(*a, 1, tall=True)
                ta = TP.pcg_fixed(*a, LADDER_REPEAT_ITERS, tall=True)
                dt = max(float((t1 - k1).abs().max()),
                         float((ta - ka).abs().max()))
                if not dt <= 1e-5:
                    raise AssertionError(f"phase 12 tall and standard "
                                         f"layouts differ by {dt} at B={B} "
                                         f"{H}x{W}")
                worst["tall"] = max(worst["tall"], dt)
                note += f", tall vs standard {dt:.3g}"
            sub = ArapOperands(**{f: v[:B] for f, v in vars(batch).items()})
            fk = F.anneal_solve_fused(sub, unit)
            fp = F.anneal_solve_fused_plain(sub, unit)
            df = float((fk - fp).abs().max())
            if not df < 1e-4:
                raise AssertionError(f"phase 12 fused kernel vs plain at "
                                     f"1x1x1, B={B} {H}x{W}: max|dx| {df}")
            worst["fused"] = max(worst["fused"], df)
            notes.append(note + f", fused 1x1x1 max|dx| {df:.3g}")
        say(f"phase 12 {H}x{W}: " + "; ".join(notes))
    kinds = {k: sum(1 for kind, _ in plans if kind == k)
             for k in ("pcg", "tall", "fused")}
    say(f"phase 12 bucket ladder: {len(CROP_BUCKETS)} buckets at B = 1 and "
        f"B = max_chunk_for, {len(LADDER_FRAMES)} full frames at B = 1; "
        f"{len(plans)} distinct plans ({kinds}); largest |d| PCG "
        f"{worst['pcg']:.3g}, tall vs standard {worst['tall']:.3g}, fused "
        f"{worst['fused']:.3g}; {time.perf_counter() - t_phase:.3f} s "
        f"({smi})")


# Phase 13: the endurance run, cut: one size cycle (the 12 sizes at
# ENDURANCE_BLOCK frames each) as the warm cycle and as the measured run,
# at 19x8x400; at most ENDURANCE_MAX_DROP pairs dropped.
ENDURANCE_PAIRS = 48
ENDURANCE_BLOCK = 4
ENDURANCE_MAX_DROP = 2


def phase_endurance(smi: str) -> dict:
    """13: ``tools/endurance.py`` in this process at --pairs
    ENDURANCE_PAIRS --block ENDURANCE_BLOCK (its warm cycle included),
    gated by the tool's gates with at most ENDURANCE_MAX_DROP pairs
    dropped. Returns the launches of the whole run."""
    from arap_flow_tpu_torch.tools import endurance

    zero_counts()
    t0 = time.perf_counter()
    result = endurance.run(ENDURANCE_PAIRS, ENDURANCE_BLOCK,
                           endurance.DEFAULT_SCHEDULE, "cuda")
    secs = time.perf_counter() - t0
    launches = read_counts()
    fails = endurance.failures(result, max_dropped=ENDURANCE_MAX_DROP)
    mem = {k: {f: result[k][f] for f in ("rule", "first_max_mb",
                                         "second_max_mb", "ok")}
           for k in ("rss", "memory_reserved")}
    line = (f"phase 13 endurance (cut: --pairs {ENDURANCE_PAIRS} --block "
            f"{ENDURANCE_BLOCK}, warm cycle {result['warm_pairs']} pairs, "
            f"{result['schedule']}): {secs:.3f} s; "
            f"{result['pairs_per_s']:.4f} pairs/s (second half "
            f"{result['steady_state_pairs_per_s']:.4f}), p50 "
            f"{result['latency_p50_s_per_pair']:.4f} / p95 "
            f"{result['latency_p95_s_per_pair']:.4f} s a pair; dropped "
            f"{result['dropped_pairs']}; {result['accuracy_checked']} pairs "
            f"checked, failures {result['accuracy_failures']}; builds "
            f"{result['builds_during_run']}; plan caches after the warm "
            f"cycle {result['plan_cache_after_warm']}, after the run "
            f"{result['plan_cache_after_run']}; memory {mem}; launches "
            f"{launches} ({smi})")
    say(line)
    say(f"phase 13 PCG launches by B x H x W: "
        f"{result['pcg_launch_shapes']}")
    if launches["pcg_fixed"] <= 0 or launches["zncc_search"] <= 0:
        fails.append(f"a kernel of the path never launched: {launches}")
    if fails:
        raise AssertionError(line + "\n  " + "\n  ".join(fails))
    return launches


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
    native_s = phase_build()
    probs, tasks = make_tasks()
    calls = solve_calls(tasks)
    main_shapes = sorted(set(calls))
    max_err, tall_err, call_ms = phase_kernel(
        [*KERNEL_SHAPES, *main_shapes],
        [PIPE_PCG_SHAPE, *main_shapes, *TIMED_SHAPES])
    ms, plain_ms, tall_ms = call_ms[PIPE_PCG_SHAPE]
    phase_waves(smi)
    tall_launches = phase_solve_batch(smi)
    small_reference_check()
    launches, pair_flows, pair_secs = phase_main_path(smi, probs, tasks,
                                                      calls, call_ms)
    if launches["pcg_fixed"] <= 0:
        raise AssertionError("the deform path never launched pcg_fixed")
    z_err, z_ms, z_plain, z_bound, z_by = phase_zncc()
    # phase 5's trees, which phase 11 reads (removed after phase 11, or at
    # exit)
    keep_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    keep = keep_dir.name
    launches, pipe_digest, pipe_cold = phase_pipeline(smi, args.profile, keep)
    if launches["zncc_search"] <= 0 or launches["pcg_fixed"] <= 0:
        raise AssertionError(f"the pipeline missed a kernel: {launches}")
    f_err, f_ms, f_plain = phase_fused(smi, call_ms)
    f_launches = phase_fused_pair(smi, probs, tasks, calls, pair_flows,
                                  pair_secs, args.profile)
    phase_native(smi, probs, native_s, pair_flows)
    phase_jpeg_pipeline(smi)
    phase_binary_matcher(smi)
    t0 = time.perf_counter()
    phase_textures(smi)
    dmo_launches = phase_dmo(smi)
    if dmo_launches["zncc_search"] <= 0 or dmo_launches["pcg_fixed"] <= 0:
        raise AssertionError(f"dmo_gen missed a kernel: {dmo_launches}")
    phase_subpatch(smi)
    say(f"phase 8 seconds: {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    opt_launches = phase_opt(smi)
    phase_generic(smi)
    inst_launches = phase_instrumented(smi, tasks)
    phase_warmup(smi, pipe_digest, pipe_cold)
    say(f"phase 9 seconds: {time.perf_counter() - t0:.3f}; pcg_fixed launches"
        f" 9a {opt_launches['pcg_fixed']}, 9e {inst_launches}")
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    shard_launches = phase_sharded_pipeline(smi, pipe_digest, dev)
    mesh_launches = phase_mesh_runner(smi, probs, tasks, dev)
    phase_spatial(smi, probs, dev)
    pyr_launches = phase_pyramid(smi, probs, tasks, dev)
    phase_host_deform(smi, probs, dev)
    tasks_launches = phase_run_tasks(smi, probs, tasks, dev)
    say(f"phase 10 seconds: {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    warp_cli = None
    try:
        gen_launches = phase_generate(smi, keep)
        arap_launches = phase_run_arap(smi, keep)
        warp_cli = start_warp_cli(keep)
        phase_run_warp(smi, keep)
        phase_texture_gen(smi, keep)
        phase_sintel_zncc(smi, keep)
        check_warp_cli(smi, warp_cli)
    finally:
        if warp_cli is not None and warp_cli[0].poll() is None:
            warp_cli[0].kill()
            warp_cli[0].wait()
        keep_dir.cleanup()
    say(f"phase 11 seconds: {time.perf_counter() - t0:.3f}")
    phase_ladder(smi)
    t0 = time.perf_counter()
    end_launches = phase_endurance(smi)
    say(f"phase 13 seconds: {time.perf_counter() - t0:.3f}")
    # the kernels' launches on the main paths: phase 5's pipeline, phase
    # 10's sharded pipeline, mesh runner, pyramid and run_tasks, phase 11's
    # generate and run_arap and phase 13's endurance run
    pcg_launches = (launches["pcg_fixed"] + shard_launches["pcg_fixed"]
                    + mesh_launches + pyr_launches + tasks_launches
                    + gen_launches["pcg_fixed"] + arap_launches["pcg_fixed"]
                    + end_launches["pcg_fixed"])
    zncc_launches = (launches["zncc_search"] + shard_launches["zncc_search"]
                     + gen_launches["zncc_search"]
                     + end_launches["zncc_search"])
    p_bound, p_by = pcg_bound(*PIPE_PCG_SHAPE)
    f_bound, f_by = fused_bound(*PIPE_PCG_SHAPE, *FUSED_UNIT)
    pcg_row = {"route": "cuda", "source": "arap_flow_tpu_torch/csrc/pcg.cu",
               "plain_ms": plain_ms, "bound_ms": p_bound, "bound_by": p_by,
               "library_ms": None}
    say(json.dumps({"kernels": [{
        "name": "pcg_fixed", **pcg_row,
        "replaces": "arap_flow_tpu/ops/pallas_pcg.py:247, "
                    "arap_flow_tpu/ops/pallas_pcg.py:516",
        "launches": pcg_launches, "max_abs_err": max_err, "ms": ms,
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
        "launches": zncc_launches, "max_abs_err": z_err,
        "ms": z_ms, "plain_ms": z_plain, "bound_ms": z_bound,
        "bound_by": z_by, "library_ms": None,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
