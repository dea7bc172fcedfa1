"""Global numerical configuration for neutfem_tpu_torch.

Mirror of ``neutfem_tpu/config.py`` for PyTorch:

* ``NEUTFEM_X64=1`` (default): solve in ``torch.float64`` — the reference math,
  required for sub-pcm eigenvalue agreement with the JAX package on the CPU.
* ``NEUTFEM_X64=0``: solve in ``torch.float32`` (the benchmark / GPU path).

Matmul-precision law (``neutfem_tpu/config.py`` pins JAX's matmul precision to
"highest"): reduced-precision float32 contractions floor the convergence of
higher-order solves, so TF32 is switched off for both matmuls and cuDNN.  The
RT0 slice does no matmul; the pins hold for whatever later slices add.
"""

from __future__ import annotations

import os

import torch

_X64 = os.environ.get("NEUTFEM_X64", "1") not in ("0", "false", "False")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Working dtype for all solver tensors.
real_dtype = torch.float64 if _X64 else torch.float32
