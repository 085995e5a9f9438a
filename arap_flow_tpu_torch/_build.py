"""Build and load the CUDA kernels (nvcc -> plain C-ABI .so -> ctypes) and
the native host library (g++ -> .so -> ctypes).

Each source in ``csrc/`` is compiled on first use into its own library in
``_build/``, keyed by a hash of the source and the compiler flags, so an
edited source rebuilds and an unchanged one loads at once. The missing
libraries are compiled together, one nvcc process per source; the shared
headers (``csrc/*.cuh``) are part of every library's key. The CUDA build
runs only on a machine with the CUDA toolkit. The host library
(``native/src/arap_native.cpp``: the exact splat, the .flo codec, the
asynchronous writer, the JPEG codec and the LANCZOS resample) is built
the same way with g++, on any machine. A failed build or load raises;
nothing here runs at import time.
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
# (time.time() when it finished, library file name) of every library this
# process compiled, nvcc's and g++'s: a long run checks that it builds
# nothing after its start (tools/endurance.py)
BUILDS: list[tuple[float, str]] = []


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
    """Path of the library built from `source` with the current flags. The
    key hashes the source and every header in ``csrc/`` (any source may
    include any of them), so editing a shared header rebuilds every
    library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_SRC_DIR) if f.endswith(".cuh"))
    for name in (source, *headers):
        with open(osp.join(_SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
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
        BUILDS.append((time.time(), osp.basename(lib)))
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, time.perf_counter() - t0


NATIVE_SRC = osp.join(_HERE, "native", "src", "arap_native.cpp")
# no fused multiply-adds: the LANCZOS coefficients round each double
# operation as Pillow's (and Python's) arithmetic does
GXX_FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC",
             "-pthread")


def native_lib_path() -> str:
    """Path of the host library built from NATIVE_SRC with GXX_FLAGS."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(NATIVE_SRC, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"libarap_native-{h.hexdigest()[:16]}.so")


def build_native() -> tuple[str, float]:
    """Compile the host library with g++ unless it is built; returns (its
    path, seconds spent compiling — 0 when it was built)."""
    lib = native_lib_path()
    if osp.exists(lib):
        return lib, 0.0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native host library "
                           "cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *GXX_FLAGS, NATIVE_SRC, "-o", tmp],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exited {proc.returncode} building "
                           f"{osp.basename(lib)}:\n{proc.stdout}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    BUILDS.append((time.time(), osp.basename(lib)))
    return lib, time.perf_counter() - t0


@functools.cache
def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the host library, with every C function's
    argument and result types declared."""
    lib = ctypes.CDLL(build_native()[0])
    vp, i, lg, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_char_p
    lib.raster_warp.argtypes = [vp, vp, vp, i, i, vp, vp]
    lib.raster_warp.restype = None
    lib.flo_write_file.argtypes = [cp, vp, i, i]
    lib.flo_write_file.restype = i
    lib.flo_read_file.argtypes = [cp, vp, lg, ctypes.POINTER(i),
                                  ctypes.POINTER(i)]
    lib.flo_read_file.restype = i
    lib.writer_start.argtypes = [i]
    lib.writer_start.restype = None
    lib.writer_submit_flo.argtypes = [cp, vp, i, i]
    lib.writer_submit_flo.restype = None
    lib.writer_submit_bytes.argtypes = [cp, cp, lg]
    lib.writer_submit_bytes.restype = None
    lib.writer_pending.restype = lg
    lib.writer_errors.restype = lg
    lib.writer_drain.restype = None
    lib.writer_stop.restype = None
    lib.jpeg_last_error.restype = cp
    lib.jpeg_info.argtypes = [cp, lg, ctypes.POINTER(i), ctypes.POINTER(i),
                              ctypes.POINTER(i)]
    lib.jpeg_info.restype = i
    lib.jpeg_decode.argtypes = [cp, lg, vp, i, i, i]
    lib.jpeg_decode.restype = i
    lib.jpeg_encode.argtypes = [vp, i, i, i, i]
    lib.jpeg_encode.restype = lg
    lib.jpeg_take.argtypes = [vp]
    lib.jpeg_take.restype = None
    lib.resize_lanczos_window.argtypes = [vp] + [i] * 9 + [vp]
    lib.resize_lanczos_window.restype = i
    return lib


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
        lib.pcg_spread_ctas.argtypes = [i] * 3
        lib.pcg_spread_ctas.restype = i
        lib.pcg_spread_f32.argtypes = [vp] * 9 + [i] * 8 + [vp]
        lib.pcg_spread_f32.restype = i
    elif stem == "fused_solver":
        lib.fused_error_string.argtypes = [i]
        lib.fused_error_string.restype = ctypes.c_char_p
        lib.fused_active_clusters.argtypes = [i] * 5 + [vp]
        lib.fused_active_clusters.restype = i
        lib.fused_solve_f32.argtypes = [vp] * 13 + [i] * 11 + [vp]
        lib.fused_solve_f32.restype = i
    elif stem == "zncc":
        lib.zncc_error_string.argtypes = [i]
        lib.zncc_error_string.restype = ctypes.c_char_p
        lib.zncc_search_splits.argtypes = [i] * 4
        lib.zncc_search_splits.restype = i
        lib.zncc_search_f32.argtypes = [vp] * 8 + [i] * 6 + [vp]
        lib.zncc_search_f32.restype = i
    else:
        raise ValueError(f"no kernel library {stem!r}")
    return lib
