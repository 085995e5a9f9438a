"""The benchmark harness: runs one cell of ``BENCHMARK.json`` once.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

A run: set-up (imports, the cell's inputs made from the seed, one warm
job on them with one PCG iteration a solve: every shape, kernel and plan
the window uses), then a window in which jobs
start back to back while ``--seconds`` have not run out, each running to
its end; then the comparison with the plain reference, over a sample of
each job's answers drawn from the seed, that decides ``correct``. With ``--trace 1`` the window runs under ``torch.profiler``
and the run reports the per-layer metrics instead of the end-to-end ones.

Everything that belongs to a configuration, a cell or a metric is found
by name: ``benchmark/configs/<config>.json`` and its entry module
``benchmark/entries/<config>.py``, ``benchmark/workloads/<cell>.json``,
``benchmark/metrics/<metric>.py``. The last line on standard output is the
result, one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import os.path as osp
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = osp.dirname(osp.abspath(__file__))
ROOT = osp.dirname(HERE)
# top-level module names a run may not hold (JAX and the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "arap_flow_tpu")


def cache_env(root: str = ROOT) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    base = osp.join(root, ".bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = osp.join(base, sub)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT):
    """(manifest, cell entry, configuration file, workload file) of a cell."""
    manifest = load_json(osp.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = load_json(osp.join(root, conf["file"]))
    wl = load_json(osp.join(root, "benchmark", "workloads", name + ".json"))
    return manifest, cell, cfg, wl


def metric_reader(name: str):
    """``read(ctx)`` of ``benchmark/metrics/<name>.py``."""
    path = osp.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ('end_to_end' or 'per_layer') this cell
    reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What metric readers read: counts of the window, the program's stage
    seconds and launch counters over it, and the traced device
    operations."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _counters():
    from arap_flow_tpu_torch.ops import pcg, zncc
    from arap_flow_tpu_torch.pipeline import para_gen

    return (dict(para_gen.TIMER.totals), dict(pcg.LAUNCH_SHAPES),
            zncc.LAUNCHES["zncc_search"])


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: str = ROOT, device: str = "cuda",
             require_chip: bool = True, cfg_override: dict | None = None,
             wl_override: dict | None = None) -> tuple[int, dict | None]:
    """One run. Returns (exit code, result dict or None). `device`,
    `require_chip` and the overrides let the tests drive a run on the
    CPU at a cut."""
    manifest, cell, cfg, wl = load_cell(cell_name, root)
    cfg = {**cfg, **(cfg_override or {})}
    wl = {**wl, **(wl_override or {})}
    import torch

    import arap_flow_tpu_torch  # noqa: F401 — the program, found or not

    if require_chip:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < int(cell["chips"]):
            print(f"needs {cell['chips']} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 3, None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    from arap_flow_tpu_torch import _build

    from .entries import common

    entry = importlib.import_module(f"benchmark.entries.{cell['config']}")
    sched = common.schedule(cfg)
    gn_calls = sched[0] * sched[1]  # PCG calls a problem
    work = tempfile.mkdtemp(prefix="bench-")
    try:
        state = entry.prepare(cfg, wl, seed, work, dev)
        warm = entry.run_job(state, "warm", common.WARM)
        sync()
        shutil.rmtree(warm.out, ignore_errors=True)
        setup_s = time.time() - t_start
        builds = [lib for _, lib in _build.BUILDS]
        print(f"setup {setup_s:.3f}s (warm job: {warm.written} of "
              f"{warm.attempted} pairs written; {len(builds)} libraries "
              f"built: {builds})", file=sys.stderr)

        prof = log = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            from . import devtrace as T
            from arap_flow_tpu_torch.pipeline import para_gen

            log = T.StageLog()
            log.attach(para_gen.TIMER)
            # the device's operations; on the CPU (tests) the host's
            prof = profile(activities=[ProfilerActivity.CUDA if on_cuda
                                       else ProfilerActivity.CPU])
            prof.start()
        before = _counters()
        jobs = []
        w0 = time.time_ns()
        while time.time_ns() - w0 < seconds * 1e9:
            j0, n0 = time.time_ns(), _counters()[1]
            job = entry.run_job(state, str(len(jobs)))
            sync()
            j1 = time.time_ns()
            if log is not None:
                log.span(f"{cell['config']} job", j0, j1)
            launched = _diff(_counters()[1], n0)
            print(f"job {len(jobs)}: {(j1 - j0) / 1e9:.3f}s, "
                  f"{job.written} of {job.attempted} pairs, "
                  f"{sum(launched.values())} PCG launches, "
                  f"{sum(b * n for (b, _, _), n in launched.items()) / gn_calls:g}"
                  f" problems, exit code {job.rc}", file=sys.stderr)
            jobs.append(job)
        w1 = time.time_ns()
        after = _counters()
        late = [lib for _, lib in _build.BUILDS][len(builds):]
        if late:
            print(f"libraries built inside the window: {late}",
                  file=sys.stderr)
        if prof is not None:
            t0 = time.time()
            prof.stop()
            log.detach()
            print(f"profiler stopped in {time.time() - t0:.1f}s",
                  file=sys.stderr)
        window_s = (w1 - w0) / 1e9
        attempted = sum(j.attempted for j in jobs)
        written = sum(j.written for j in jobs)
        peak = (torch.cuda.max_memory_allocated(dev) if on_cuda else 0)
        bad = forbidden_modules()
        if bad:
            print(f"modules loaded that the run may not hold: {bad}",
                  file=sys.stderr)
            return 4, None

        ctx = Context(setup_s=setup_s, window_s=window_s, pairs=written,
                      attempted=attempted, jobs=len(jobs),
                      stages=_diff(after[0], before[0]),
                      pcg_shapes=_diff(after[1], before[1]),
                      zncc_launches=after[2] - before[2],
                      frame_hw=(int(wl["height"]), int(wl["width"])),
                      pcg_iters=sched[2], gn_calls=gn_calls,
                      solve_boxes=entry.solve_boxes(state),
                      ops=[], busy_s=None)
        device_info = {"platform": "gpu" if on_cuda else dev.type,
                       "kind": (torch.cuda.get_device_name(dev) if on_cuda
                                else "cpu"),
                       "count": int(cell["chips"]),
                       "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            t0 = time.time()
            ops = [o for o in T.device_ops(prof) if o[2] > w0 and o[1] < w1]
            print(f"{len(ops)} device operations read in "
                  f"{time.time() - t0:.1f}s", file=sys.stderr)
            busy = T.busy_intervals(ops, w0, w1)
            ctx.ops, ctx.busy_s = ops, sum(b - a for a, b in busy) / 1e9
            breakdown = T.breakdown(ops, T.gaps(busy, w0, w1), log)
            device_info.update(busy_s=ctx.busy_s, window_s=window_s)
            del prof
        kind = "per_layer" if trace else "end_to_end"
        metrics = {}
        for m in cell_metrics(manifest, cell_name, kind):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        ctx = None
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()

        t0 = time.time()
        rng = np.random.default_rng([seed, 2])
        samples = [common.draw_sample(rng, entry.n_items(state),
                                      int(wl["sample_pairs"])) for _ in jobs]
        numbers, _ = entry.check(state, jobs, samples, dev)
        # every pair of every job has all its products, and every entry
        # call returned 0
        numbers["pairs_missing"] = attempted - written
        numbers["entry_errors"] = sum(j.rc != 0 for j in jobs)
        limits = {**cfg["limits"], "pairs_missing": 0, "entry_errors": 0}
        compared = {k: {"value": float(numbers[k]), "limit": float(lim)}
                    for k, lim in limits.items()}
        correct = all(c["value"] <= c["limit"] for c in compared.values())
        print(f"reference check {time.time() - t0:.1f}s over "
              f"{len(jobs)} job(s), {sum(map(len, samples))} sampled "
              f"answers; {smi_line()}", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(attempted - written), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # libraries the program compiled in set-up: a run that builds pays
    # for it in setup_s
    result["builds"] = len(builds)
    result["compared"] = compared
    for k, c in compared.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env()
    code, result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                            t_start)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return code
