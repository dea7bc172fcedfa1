"""portbench: the benchmark of ``neutfem_tpu_torch`` (the PyTorch / CUDA port).

Run one cell with ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; see README.md.
"""
