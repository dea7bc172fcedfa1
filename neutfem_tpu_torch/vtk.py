"""ASCII legacy-VTK structured-grid writer (the port's copy of ``neutfem/vtk.py``).

The file layout and field names of the reference exporter
(NeutFEM.cpp:2137-2332): ``DATASET STRUCTURED_GRID`` points from the mesh
breakpoints, then CELL_DATA scalars ``Flux_g*``, ``Flux_total``,
``Flux_adj_g*``, vectors ``Current_g*``, and the cross-section fields ``D_g*,
SigmaR_g*, NuSigF_g*, Chi_g*, KappaSigF_g*, Source_g*, SigS_<from>_to_<to>``.
Host numpy only; numbers are written as ``%.10g``, as the JAX package's
native writer writes them (its optional C++ library is not carried over).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["write_vtk"]


def _write_scalar(f, name: str, values: np.ndarray):
    f.write(f"SCALARS {name} double 1\n")
    f.write("LOOKUP_TABLE default\n")
    np.savetxt(f, np.asarray(values, dtype=np.float64).reshape(-1), fmt="%.10g")


def write_vtk(
    filename: str,
    mesh,
    keff: float,
    flux: Optional[np.ndarray] = None,          # (ng, nz, ny, nx) cell averages
    flux_adj: Optional[np.ndarray] = None,      # (ng, nz, ny, nx)
    current: Optional[np.ndarray] = None,       # (ng, nz, ny, nx, 3) cell-avg vectors
    xs: Optional[Dict[str, np.ndarray]] = None,  # full-grid XS dict
):
    """Write `<filename>.vtk`. Any of flux/flux_adj/current/xs may be None (skipped)."""
    if not filename.endswith(".vtk"):
        filename = filename + ".vtk"
    nx, ny, nz = mesh.nx, mesh.ny, mesh.nz
    xb = mesh.x_breaks
    # inactive axes export a single plane of points (one cell of unit width)
    ny_p = ny + 1 if mesh.dim >= 2 else 2
    nz_p = nz + 1 if mesh.dim == 3 else 2
    yb = mesh.y_breaks if mesh.dim >= 2 else np.array([0.0, 1.0])
    zb = mesh.z_breaks if mesh.dim == 3 else np.array([0.0, 1.0])

    scalar_fields = []
    vector_fields = []
    if flux is not None:
        for g in range(flux.shape[0]):
            scalar_fields.append((f"Flux_g{g}", flux[g]))
        scalar_fields.append(("Flux_total", flux.sum(axis=0)))
    if flux_adj is not None:
        for g in range(flux_adj.shape[0]):
            scalar_fields.append((f"Flux_adj_g{g}", flux_adj[g]))
    if current is not None:
        for g in range(current.shape[0]):
            vector_fields.append((f"Current_g{g}", current[g]))
    if xs is not None:
        for key, prefix in [("D", "D_g"), ("SigR", "SigmaR_g"), ("NSF", "NuSigF_g"),
                            ("Chi", "Chi_g"), ("KSF", "KappaSigF_g"),
                            ("SRC", "Source_g")]:
            arr = xs.get(key)
            if arr is None:
                continue
            for g in range(arr.shape[0]):
                scalar_fields.append((f"{prefix}{g}", arr[g]))
        sigs = xs.get("SigS")
        if sigs is not None:
            ng = sigs.shape[0]
            for gf in range(ng):
                for gt in range(ng):
                    scalar_fields.append((f"SigS_{gf}_to_{gt}", sigs[gt, gf]))

    with open(filename, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write(f"NeutFEM Output - k-eff={keff:.6f}\n")
        f.write("ASCII\n")
        f.write("DATASET STRUCTURED_GRID\n")
        f.write(f"DIMENSIONS {nx + 1} {ny_p} {nz_p}\n")
        f.write(f"POINTS {(nx + 1) * ny_p * nz_p} double\n")
        for z in zb[:nz_p]:
            for y in yb[:ny_p]:
                for x in xb:
                    f.write(f"{x:.10g} {y:.10g} {z:.10g}\n")

        f.write(f"\nCELL_DATA {nx * ny * nz}\n")
        for name, values in scalar_fields:
            _write_scalar(f, name, values)
        for name, values in vector_fields:
            f.write(f"VECTORS {name} double\n")
            np.savetxt(f, np.asarray(values, dtype=np.float64).reshape(-1, 3), fmt="%.10g")
    return filename
