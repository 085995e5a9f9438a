"""Build and load the CUDA kernels (nvcc -> plain C-ABI .so -> ctypes).

Each source in ``csrc/`` is compiled on first use into its own library in
``_build/``, keyed by a hash of the source and the compiler flags, so an
edited source rebuilds and an unchanged one loads at once. The missing
libraries are compiled together, one nvcc process per source. The build runs
only on a machine with the CUDA toolkit; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import os.path as osp
import shutil
import subprocess
import time

_HERE = osp.dirname(osp.abspath(__file__))
_SRC_DIR = osp.join(_HERE, "csrc")
BUILD_DIR = osp.join(_HERE, "_build")
SOURCES = ("pcg.cu", "zncc.cu", "fused_solver.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = osp.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not osp.exists(cand):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin)")
    return cand


def lib_path(source: str) -> str:
    """Path of the library built from `source` with the current flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(osp.join(_SRC_DIR, source), "rb") as f:
        h.update(source.encode() + b"\0" + f.read())
    stem = osp.splitext(source)[0]
    return osp.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build() -> tuple[list[str], float]:
    """Compile every library that is not built yet, all nvcc processes
    started together; returns (paths of the .so files, seconds spent
    compiling — 0 when all were built). Each compiler report (registers,
    spills) is kept beside its library as a .log."""
    libs = [lib_path(s) for s in SOURCES]
    todo = [(s, lib) for s, lib in zip(SOURCES, libs) if not osp.exists(lib)]
    if not todo:
        return libs, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for src, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, osp.join(_SRC_DIR, src)]
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{osp.basename(lib)}: nvcc exited "
                          f"{proc.returncode}:\n{out}")
            continue
        with open(lib[: -len(".so")] + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0


@functools.cache
def load(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<stem>.cu``, with
    every C function's argument and result types declared."""
    build()
    lib = ctypes.CDLL(lib_path(stem + ".cu"))
    vp, i = ctypes.c_void_p, ctypes.c_int
    if stem == "pcg":
        lib.pcg_error_string.argtypes = [i]
        lib.pcg_error_string.restype = ctypes.c_char_p
        lib.pcg_active_clusters.argtypes = [i] * 7 + [vp]
        lib.pcg_active_clusters.restype = i
        lib.pcg_fixed_f32.argtypes = [vp] * 11 + [i] * 10 + [vp]
        lib.pcg_fixed_f32.restype = i
        lib.pcg_three_pass_nblk.argtypes = [i, i]
        lib.pcg_three_pass_nblk.restype = i
        lib.pcg_three_pass_f32.argtypes = [vp] * 12 + [i] * 4 + [vp]
        lib.pcg_three_pass_f32.restype = i
    elif stem == "fused_solver":
        lib.fused_error_string.argtypes = [i]
        lib.fused_error_string.restype = ctypes.c_char_p
        lib.fused_solve_nchunk.argtypes = [i, i]
        lib.fused_solve_nchunk.restype = i
        lib.fused_solve_blocks.argtypes = [i, i, i]
        lib.fused_solve_blocks.restype = i
        lib.fused_solve_f32.argtypes = [vp] * 14 + [i] * 6 + [vp]
        lib.fused_solve_f32.restype = i
    elif stem == "zncc":
        lib.zncc_error_string.argtypes = [i]
        lib.zncc_error_string.restype = ctypes.c_char_p
        lib.zncc_search_f32.argtypes = [vp] * 7 + [i, i, i, i, i, vp]
        lib.zncc_search_f32.restype = i
    else:
        raise ValueError(f"no kernel library {stem!r}")
    return lib
