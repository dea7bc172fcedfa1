"""The JAX package's examples (``examples/``) on the PyTorch port.

* ``quickstart``: a 1D two-group slab, reflective left and vacuum right;
* ``convergence_study``: IAEA-2D under mesh refinement (RT0 1x1, 2x2, 4x4)
  and order refinement (RT1 1x1, 2x2, RT2 1x1);
* ``subcritical_source``: a 2D source-driven subcritical system, its k and
  its amplification factor M.

Each prints the JAX example's lines and returns its numbers from
``main(device="cuda", dtype=None)`` (``dtype`` None: ``config.real_dtype``,
float64 unless ``NEUTFEM_X64=0``), and runs as ``python -m
neutfem_tpu_torch.examples.<name> [--device cpu]``.  Importing one runs
nothing.
"""
