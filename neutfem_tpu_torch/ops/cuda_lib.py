"""Build and load the hand-written CUDA kernels of ``neutfem_tpu_torch/csrc``.

The sources have a plain C interface and are compiled with ``nvcc`` into one
shared library for Hopper (``sm_90a``), loaded with ``ctypes``.  The library is
built at first use into ``neutfem_tpu_torch/_build/<hash of sources and flags>/``
(listed in ``.gitignore``), so a fresh checkout builds it once and later
processes reuse it.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["library", "check", "SOURCES", "build_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

SOURCES = ("fused_dir.cu", "thomas.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Filled by the build that produced the loaded library: path, seconds, nvcc log.
build_info: dict = {}

_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # acc, v, dm, l, zs, n, lines, inner, outer_stride, cell_stride, bx0, bx1, si, stream
    "neutfem_fused_dir_f32": [_P] * 5 + [ctypes.c_int] + [_I64] * 4 + [ctypes.c_double] * 3 + [_P],
    "neutfem_fused_dir_f64": [_P] * 5 + [ctypes.c_int] + [_I64] * 4 + [ctypes.c_double] * 3 + [_P],
    # r, d, l, out, n, lines, inner, stream
    "neutfem_thomas_f32": [_P] * 4 + [ctypes.c_int] + [_I64] * 2 + [_P],
    "neutfem_thomas_f64": [_P] * 4 + [ctypes.c_int] + [_I64] * 2 + [_P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _build() -> str:
    """Compile the sources unless a library for exactly these sources exists."""
    paths = [os.path.join(_CSRC, s) for s in SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(_BUILD, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libneutfem_kernels.so")
    if os.path.exists(so):
        build_info.update(path=so, seconds=0.0, log="(cached)")
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    build_info.update(path=so, seconds=time.perf_counter() - t0,
                      log=(proc.stdout + proc.stderr).strip())
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.neutfem_error_string.argtypes = [ctypes.c_int]
        lib.neutfem_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs)."""
    if err != 0:
        msg = library().neutfem_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} ({msg})")
