"""Operator layer of neutfem_tpu_torch: context build, matrix-free applies,
and the hand-written CUDA kernels with their plain PyTorch versions."""
