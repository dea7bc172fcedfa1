"""The CPU rehearsal of a cell: ``run.run_cell`` on the CPU at the tiny mesh
the configuration file names (``rehearsal_mesh``; the same core,
discretization, tolerances, traffic and limits), for the tests.  Not a measurement: it prints nothing a
run prints and takes no card.

    python3 -m portbench.rehearse --workload <cell> --seed <n> [--mesh N [NZ]]
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import sys
from typing import Dict, Optional, Sequence

from . import manifest
from .run import _set_environment, run_cell

__all__ = ["rehearse"]

def rehearse(workload: str, seed: int, mesh: Optional[Dict] = None, seconds: float = 0.0,
             control: Optional[str] = None, log=None) -> Dict:
    """One run of ``workload`` on the CPU at ``mesh`` (default: the
    configuration's ``rehearsal_mesh``): a window of ``seconds`` (0: one
    round of the samples).  Returns the result object."""
    import torch

    cell = manifest.load_cell(workload)
    cell = copy.deepcopy(cell)
    cell.config["mesh"] = dict(mesh or cell.config["rehearsal_mesh"])
    _set_environment(cell.config)
    torch.set_num_threads(min(2, torch.get_num_threads()))
    return run_cell(cell, seed, seconds, traced=False, device="cpu", control=control,
                    log=log if log is not None else io.StringIO(), warmup=False)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mesh", type=int, nargs="+", default=None)
    p.add_argument("--control", choices=("bf16",), default=None)
    a = p.parse_args(argv)
    mesh = None
    if a.mesh:
        mesh = {"per_assembly": a.mesh[0], "per_plane": a.mesh[-1]}
    print(json.dumps(rehearse(a.workload, a.seed, mesh, control=a.control, log=sys.stderr)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
