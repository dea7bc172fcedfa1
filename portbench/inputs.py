"""The inputs of one run: the mesh breaks and the per-cell cross sections of a
configuration, with one of the traffic mix's numbered cross-section samples.

A frozen copy of the arithmetic of ``neutfem_tpu_torch.bench.BenchmarkRun``
(``_expand_layout``, ``_build``, ``_baffle_mask``, ``_fill_xs``) as of
814381f, reading the configuration file instead of the program's core data,
so that a later change to the program cannot move the yardstick's inputs.
The program and the plain reference are handed the same arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

__all__ = ["Inputs", "build_inputs", "sample_materials", "sigr_of"]


@dataclasses.dataclass
class Inputs:
    """What both sides get: breaks per axis (2D: ``z_breaks`` is ``[0.0]``,
    which the facade reads as a 2D mesh) and the cross sections
    (ng, nz, ny, nx) / (ng, ng, nz, ny, nx) in float64."""

    dim: int
    x_breaks: np.ndarray
    y_breaks: np.ndarray
    z_breaks: np.ndarray
    xs: Dict[str, np.ndarray]

    @property
    def shape(self):
        return self.xs["D"].shape[1:]


def sigr_of(mat: Dict, ng: int) -> List[float]:
    """Removal: absorption + out-scatter column sum (iaea2d.py:201-202)."""
    return [mat["ABS"][g] + sum(v for gt, gf, v in mat["S"] if gf == g and gt != g)
            for g in range(ng)]


def _expand_layout(rows, n: int) -> np.ndarray:
    """Each layout character as an n x n block of cells."""
    grid = np.array([list(r) for r in rows])
    return np.repeat(np.repeat(grid, n, axis=0), n, axis=1)


def sample_materials(core: Dict, sample: int, rel_sigma: float, clip: float) -> Dict[str, Dict]:
    """The core's materials with every published D, ABS, nonzero NSF and
    scattering entry multiplied by (1 + rel_sigma z), z standard normal cut at
    +-clip, drawn from the sample number in a fixed order (material keys sorted, then
    D, ABS, NSF, S by group).  CHI (a normalised spectrum) is kept.  The
    background of a core whose ``background_is_data`` is false (IAEA-3D's
    numerical void) is kept as published.  Keys: the material characters,
    "." for the background and "baffle" for ZION's steel."""
    rng = np.random.default_rng(int(sample))
    mats = dict(core["materials"])
    mats["."] = core["background"]
    if "baffle" in core:
        mats["baffle"] = core["baffle"]["material"]
    out = {}
    for key in sorted(mats):
        m = mats[key]
        fixed = key == "." and not core.get("background_is_data", True)
        new = {"CHI": list(m["CHI"])}

        def draw(values):
            if fixed or rel_sigma == 0.0:
                return [float(v) for v in values]
            z = np.clip(rng.standard_normal(len(values)), -clip, clip)
            return [float(v) * (1.0 + rel_sigma * float(zi)) for v, zi in zip(values, z)]

        new["D"] = draw(m["D"])
        new["ABS"] = draw(m["ABS"])
        nsf = list(m["NSF"])
        live = [i for i, v in enumerate(nsf) if v != 0.0]
        for i, v in zip(live, draw([nsf[i] for i in live])):
            nsf[i] = v
        new["NSF"] = nsf
        svals = draw([s[2] for s in m["S"]])
        new["S"] = [[s[0], s[1], v] for s, v in zip(m["S"], svals)]
        out[key] = new
    return out


def _baffle_mask(grid: np.ndarray, baffle: Dict, h: float) -> np.ndarray:
    """ZION: the empty cells within one baffle thickness of fuel (nz, ny, nx):
    a square dilation of the fuel mask, one pass per in-plane axis."""
    r = max(1, int(np.ceil(baffle["thickness_cm"] / h)))
    near = np.isin(grid, list(baffle["fuel"]))
    for ax in (1, 2):
        n = grid.shape[ax]
        padded = np.pad(near, [(r, r) if a == ax else (0, 0) for a in range(3)])
        near = np.zeros_like(near)
        for s in range(2 * r + 1):
            near |= np.take(padded, np.arange(s, s + n), axis=ax)
    return (grid == ".") & near


def build_inputs(config: Dict, sample: int, traffic: Dict) -> Inputs:
    """The configuration's full core at its mesh, with cross-section sample
    number ``sample`` of the traffic's ``xs_sample`` amplitude."""
    core = config["core"]
    ng = core["ng"]
    n = config["mesh"]["per_assembly"]
    samp = traffic["xs_sample"]
    mats = sample_materials(core, sample, samp["rel_sigma"], samp["clip"])

    if "planes_in_z_order" in core:
        nz_sub = config["mesh"]["per_plane"]
        types = {k: _expand_layout(v, n) for k, v in core["plane_types"].items()}
        grid = np.stack([types[t] for t in core["planes_in_z_order"] for _ in range(nz_sub)])
        hz = core["pitch_z_cm"] / nz_sub
        z_breaks = np.linspace(0.0, grid.shape[0] * hz, grid.shape[0] + 1)
        dim = 3
    else:
        grid = _expand_layout(core["layout"], n)[None]
        z_breaks = np.array([0.0])
        dim = 2
    nz, ny, nx = grid.shape
    h = core["pitch_cm"] / n
    x_breaks = np.linspace(0.0, nx * h, nx + 1)
    y_breaks = np.linspace(0.0, ny * h, ny + 1)

    xs = {"D": np.zeros((ng, nz, ny, nx)), "SigR": np.zeros((ng, nz, ny, nx)),
          "NSF": np.zeros((ng, nz, ny, nx)), "Chi": np.zeros((ng, nz, ny, nx)),
          "SigS": np.zeros((ng, ng, nz, ny, nx))}

    def put(sel, mat):
        xs["D"][:, sel] = np.array(mat["D"])[:, None]
        xs["SigR"][:, sel] = np.array(sigr_of(mat, ng))[:, None]
        xs["NSF"][:, sel] = np.array(mat["NSF"])[:, None]
        xs["Chi"][:, sel] = np.array(mat["CHI"])[:, None]
        for gt, gf, v in mat["S"]:
            xs["SigS"][gt, gf, sel] = v

    for ch in np.unique(grid):
        sel = grid == ch
        if ch != "." or "baffle" not in core:
            put(sel, mats[ch])
            continue
        baffle = _baffle_mask(grid, core["baffle"], h)  # ZION: steel baffle, else water
        put(baffle, mats["baffle"])
        put(sel & ~baffle, mats["."])
    return Inputs(dim=dim, x_breaks=x_breaks, y_breaks=y_breaks, z_breaks=z_breaks, xs=xs)
