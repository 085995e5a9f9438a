"""Unified typed configuration (utils/config.py of the JAX package).

Env vars (``ARAP_*``, applied over the keyword overrides; env wins):
- ARAP_SCHEDULE       parity | fast           (solver schedule preset)
- ARAP_BACKEND        auto | plain | cuda     (PCG backend; "fused" is a
                                               SolverConfig opt-in only, as
                                               in the JAX package)
- ARAP_RASTER         device | host           (rasterizer; host is the
                                               reference-exact C++ splat)
- ARAP_MATCHER        native | binary | file  (correspondence source)
- ARAP_W_FIT / ARAP_W_REG                      (energy weights)
- ARAP_ASYNC_IO       0 | 1                   (para_gen's native threaded
                                               writer; default 1)

ARAP_TALL_KERNEL is read by the PCG kernel's wrapper at each call
(ops/pcg.tall_kernel_enabled): set, it runs the stacked-plane layout.

ARAP_TRACE=<dir> is read at each call of para_gen.main_pipeline and
run_arap.main (utils/profiling.entry_call): set, the call records
profiling.TIMER's spans (stage, thread, parent, job/chunk/pair ids, on the
torch.profiler clock) and writes them into <dir> as one Chrome trace,
spans-PID-NS.json. Unset, no span is kept.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from ..ops.energy import ArapWeights
from ..ops.solver import SolverConfig

# the backends ARAP_BACKEND selects
ENV_BACKENDS = ("auto", "plain", "cuda")


@dataclass
class FrameworkConfig:
    solver: SolverConfig = field(default_factory=SolverConfig)
    weights: ArapWeights = field(default_factory=ArapWeights)
    raster: str = "device"  # device | host
    matcher: str = "native"  # native | binary | file
    crop: bool = True  # bbox-crop per-segment solves (exact)
    async_io: bool = True  # native threaded writer for .flo / PNG products
    io_threads: int = 4

    @classmethod
    def from_env(cls, **overrides) -> "FrameworkConfig":
        """Construct from keyword overrides, then apply ARAP_* env overrides."""
        cfg = cls(**overrides)
        sched = os.environ.get("ARAP_SCHEDULE")
        if sched == "fast":
            cfg.solver = cfg.solver._replace(pcg_iters_early=150.0,
                                             anneal_split=12.0)
        elif sched == "parity":
            cfg.solver = cfg.solver._replace(
                pcg_iters_early=0.0, anneal_split=0.0, q_tolerance=0.0,
                rz_tolerance=0.0,
            )
        backend = os.environ.get("ARAP_BACKEND")
        if backend in ENV_BACKENDS:
            cfg.solver = cfg.solver._replace(backend=backend)
        raster = os.environ.get("ARAP_RASTER")
        if raster in ("device", "host"):
            cfg.raster = raster
        matcher = os.environ.get("ARAP_MATCHER")
        if matcher in ("native", "binary", "file"):
            cfg.matcher = matcher
        async_io = os.environ.get("ARAP_ASYNC_IO")
        if async_io in ("0", "1"):
            cfg.async_io = async_io == "1"
        wf = os.environ.get("ARAP_W_FIT")
        wr = os.environ.get("ARAP_W_REG")
        if wf or wr:
            cfg.weights = ArapWeights(
                w_fit=float(wf) if wf else cfg.weights.w_fit,
                w_reg=float(wr) if wr else cfg.weights.w_reg,
            )
        return cfg


def cli_device(name: str) -> torch.device:
    """The device a CLI was asked for; raises when it is a CUDA device and
    CUDA is not available (no silent move to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: CUDA is not available here; pass --device cpu "
            "to run the plain torch path on the CPU")
    return dev
