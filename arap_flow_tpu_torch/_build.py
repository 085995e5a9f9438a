"""Build and load the CUDA kernels (nvcc -> plain C-ABI .so -> ctypes).

The library is compiled on first use from the sources in ``csrc/`` into
``_build/``, keyed by a hash of the sources and the compiler flags, so an
edited source rebuilds and an unchanged one loads at once. The build runs
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
SOURCES = ("pcg.cu",)
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


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(osp.join(_SRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> tuple[str, float]:
    """Compile the kernel library if it is not built yet; returns (path of
    the .so, seconds spent compiling — 0 when it was already built). The
    compiler's report (registers, spills) is kept beside it as a .log."""
    lib = osp.join(BUILD_DIR, f"libarap_kernels-{_key()}.so")
    if osp.exists(lib):
        return lib, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(osp.join(_SRC_DIR, s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    with open(lib[: -len(".so")] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C function's
    argument and result types declared."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.pcg_fixed_nblk.argtypes = [i, i]
    lib.pcg_fixed_nblk.restype = i
    lib.pcg_error_string.argtypes = [i]
    lib.pcg_error_string.restype = ctypes.c_char_p
    lib.pcg_fixed_f32.argtypes = [vp] * 12 + [i, i, i, i, vp]
    lib.pcg_fixed_f32.restype = i
    return lib
