"""Build and load the hand-written CUDA kernels of ``neutfem_tpu_torch/csrc``.

The sources have a plain C interface and are compiled for Hopper (``sm_90a``)
with one ``nvcc`` process per source, all started together, then linked into
one shared library, loaded with ``ctypes``.  The library is built at first use
into ``neutfem_tpu_torch/_build/<hash of sources and flags>/`` (listed in
``.gitignore``), so a fresh checkout builds it once and later processes reuse
it.  Nothing here runs at import time.
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

SOURCES = ("fused_rows.cu", "fused_z_rows.cu", "thomas_rows.cu", "thomas_wide_rows.cu",
           "fused_ho_rows.cu", "fused_eq_rows.cu", "blockjac_tiled.cu", "cg_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Filled by the build that produced the loaded library: path, seconds, nvcc log.
build_info: dict = {}

_lib = None
_build_error = None  # a failed build, raised again without rebuilding

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_SIGNATURES = {
    # acc, v, dm, l, n, lines, inner, outer_stride, cell_stride, line_major, tl, ch,
    # bx0, bx1, si, stream
    "neutfem_fused_rows_f32": ([_P] * 4 + [ctypes.c_int] + [_I64] * 4 + [ctypes.c_int] * 3
                               + [ctypes.c_double] * 3 + [_P]),
    "neutfem_fused_rows_f64": ([_P] * 4 + [ctypes.c_int] + [_I64] * 4 + [ctypes.c_int] * 3
                               + [ctypes.c_double] * 3 + [_P]),
    # acc, v, dm, l, n, lines, groups, inner, outer_stride, cell_stride, group_stride,
    # line_major, tl, ch, bx0, bx1, si, stream
    "neutfem_fused_rows_batched_f32": ([_P] * 4 + [ctypes.c_int] + [_I64] * 6
                                       + [ctypes.c_int] * 3 + [ctypes.c_double] * 3 + [_P]),
    "neutfem_fused_rows_batched_f64": ([_P] * 4 + [ctypes.c_int] + [_I64] * 6
                                       + [ctypes.c_int] * 3 + [ctypes.c_double] * 3 + [_P]),
    # acc, v, dm, l, n, lines, groups, tl, ch, bx0, bx1, si, stream
    "neutfem_fused_z_rows_f32": ([_P] * 4 + [ctypes.c_int] + [_I64] * 2 + [ctypes.c_int] * 2
                                 + [ctypes.c_double] * 3 + [_P]),
    "neutfem_fused_z_rows_f64": ([_P] * 4 + [ctypes.c_int] + [_I64] * 2 + [ctypes.c_int] * 2
                                 + [ctypes.c_double] * 3 + [_P]),
    # r, d, l, out, n, outer, inner, tl, ch, stream
    "neutfem_thomas_rows_f32": [_P] * 4 + [ctypes.c_int] + [_I64] * 2 + [ctypes.c_int] * 2 + [_P],
    "neutfem_thomas_rows_f64": [_P] * 4 + [ctypes.c_int] + [_I64] * 2 + [ctypes.c_int] * 2 + [_P],
    "neutfem_thomas_wide_rows_f32": ([_P] * 4 + [ctypes.c_int] + [_I64] * 2
                                     + [ctypes.c_int] * 2 + [_P]),
    "neutfem_thomas_wide_rows_f64": ([_P] * 4 + [ctypes.c_int] + [_I64] * 2
                                     + [ctypes.c_int] * 2 + [_P]),
    # acc, v, dm, l, alpha, tab, k1, lpow, n, lines, inner, outer_stride, cell_stride,
    # plane, tl, ch, tg, stream
    "neutfem_fused_ho_rows_f32": ([_P] * 6 + [ctypes.c_int] * 3 + [_I64] * 5
                                  + [ctypes.c_int] * 3 + [_P]),
    "neutfem_fused_ho_rows_f64": ([_P] * 6 + [ctypes.c_int] * 3 + [_I64] * 5
                                  + [ctypes.c_int] * 3 + [_P]),
    # flags, acc, y, sdi, ce, dm, l, u, n, lines, inner, outer_stride, cell_stride,
    # tl, ch, bx0, bx1, si, stream
    "neutfem_fused_eq_rows_f32": ([ctypes.c_int] + [_P] * 7 + [ctypes.c_int] + [_I64] * 4
                                  + [ctypes.c_int] * 2 + [ctypes.c_double] * 3 + [_P]),
    "neutfem_fused_eq_rows_f64": ([ctypes.c_int] + [_P] * 7 + [ctypes.c_int] + [_I64] * 4
                                  + [ctypes.c_int] * 2 + [ctypes.c_double] * 3 + [_P]),
    # form, blk, r, z, part, P, cells, wide, warps, stream
    "neutfem_blockjac_tiled": [ctypes.c_int] + [_P] * 4 + [ctypes.c_int, _I64] + [ctypes.c_int] * 2
    + [_P],
    # x, r, p, q, xo, ro, rr, n, pq, rz, go, stream
    "neutfem_cg_xr_f32": [_P] * 7 + [_I64] + [_P] * 4,
    "neutfem_cg_xr_f64": [_P] * 7 + [_I64] + [_P] * 4,
    # z, p, po, n, pq, rz, rz_new, rr_new, rr, it, go, tol_sq, tol_f64, maxiter,
    # rz_out, rr_out, it_out, go_out, stream
    "neutfem_cg_p_f32": [_P] * 3 + [_I64] + [_P] * 8 + [ctypes.c_int, _I64] + [_P] * 5,
    "neutfem_cg_p_f64": [_P] * 3 + [_I64] + [_P] * 8 + [ctypes.c_int, _I64] + [_P] * 5,
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
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [os.path.join(out_dir, f"{s}.{tag}.o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p] for o, p in zip(objs, paths)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs = [out + err for out, err in (proc.communicate() for proc in procs)]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}: {' '.join(cmd)}\n{log}")
    tmp = f"{so}.{tag}"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed with code {proc.returncode}: {' '.join(link)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file
    for o in objs:
        os.remove(o)
    build_info.update(path=so, seconds=time.perf_counter() - t0,
                      log="\n".join(logs + [proc.stdout + proc.stderr]).strip())
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call; a build that failed
    raises again on every later call, without another nvcc run)."""
    global _lib, _build_error
    if _build_error is not None:
        raise _build_error
    if _lib is None:
        try:
            so = _build()
        except RuntimeError as e:
            _build_error = e
            raise
        lib = ctypes.CDLL(so)
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
