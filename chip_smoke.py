"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

0. environment: card name and power limit, torch and CUDA versions; TF32
   is switched off for matmuls and cuDNN.
1. build: compiles the CUDA kernels from ``arap_flow_tpu_torch/csrc``.
2. kernel vs plain: ``pcg_fixed`` (CUDA) against ``pcg_fixed_plain`` on the
   same numpy-seeded problems, on the card: 1 iteration to rtol/atol 1e-4;
   80 iterations with the kernel's residual ‖b − JtJ·δ‖ under 2× the plain
   version's and max |Δδ| < 0.05; two kernel runs bitwise equal; µs per
   iteration of both.
3. main path: one 854×480 pair with two segments through the crop path
   (make_task -> BatchRunner -> solve_and_raster_canvas) with the full
   19×8×400 schedule on CUDA; flows written and read back as .flo, checked
   against the segments' analytic rigid motion; launch counts checked.

The last line is the JSON device record; the line before it lists the
kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


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

    path, seconds = _build.build()
    _build.load()
    say(f"phase 1 build: {os.path.relpath(path, ROOT)} in {seconds:.2f} s")
    log = path[: -len(".so")] + ".log"
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    say("  ptxas: " + line.strip())


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


def residual_norm(ops, args, delta):
    import torch

    from arap_flow_tpu_torch.ops import energy as E

    b, _, s, c = args[:4]
    norms = []
    for k, o in enumerate(ops):
        r = b[k] - E.apply_jtj(delta[k], o, s[k], c[k])
        norms.append(float(torch.linalg.vector_norm(r)))
    return max(norms)


def time_ms(fn, args, iters: int, reps: int = 5) -> float:
    """Median milliseconds of one `fn(*args, iters)` call, by CUDA events,
    after one warm-up call."""
    import torch

    fn(*args, iters)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(*args, iters)
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
        k80 = pcg_fixed(*args, 80)
        p80 = pcg_fixed_plain(*args, 80)
        k80b = pcg_fixed(*args, 80)
        torch.cuda.synchronize()
        if not torch.equal(k80, k80b):
            raise AssertionError(f"kernel not bitwise repeatable at {B}x{H}x{W}")
        res_k = residual_norm(ops, args, k80)
        res_p = residual_norm(ops, args, p80)
        d80 = float((k80 - p80).abs().max())
        if not (res_k < 2.0 * res_p and d80 < 0.05):
            raise AssertionError(
                f"80 iterations at {B}x{H}x{W}: residual {res_k} vs plain "
                f"{res_p}, max |d| {d80}")
        line = (f"phase 2 kernel vs plain B={B} {H}x{W}: 1-iter max|d| "
                f"{err1:.3g}; 80-iter residual {res_k:.6g} (plain {res_p:.6g})"
                f", max|d| {d80:.3g}; bitwise repeat ok")
        if (B, H, W) in timed_shapes:
            us_k = time_ms(pcg_fixed, args, 200) * 1000.0 / 200
            us_p = time_ms(pcg_fixed_plain, args, 20, reps=3) * 1000.0 / 20
            line += f"; us/iter kernel {us_k:.2f}, plain {us_p:.2f}"
        say(line)
    call_ms = {}
    for B, H, W in call_shapes:
        _, args = pcg_problem(B, H, W, seed=7, device=dev)
        ms = time_ms(pcg_fixed, args, 400)
        plain_ms = time_ms(pcg_fixed_plain, args, 400, reps=3)
        call_ms[(B, H, W)] = (ms, plain_ms)
        say(f"phase 2 one 400-iteration call at B={B} {H}x{W}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
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


def main() -> int:
    import torch

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
        shapes, [(3, 224, 384), (1, 480, 854)], main_shapes)
    ms, plain_ms = call_ms[main_shapes[0]]
    small_reference_check()
    launches = phase_main_path(smi, probs, tasks, calls, call_ms)
    if launches["pcg_fixed"] <= 0:
        raise AssertionError("the main path never launched pcg_fixed")
    say(json.dumps({"kernels": [{
        "name": "pcg_fixed", "route": "cuda",
        "source": "arap_flow_tpu_torch/csrc/pcg.cu",
        "replaces": "arap_flow_tpu/ops/pallas_pcg.py:247",
        "launches": launches["pcg_fixed"], "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
