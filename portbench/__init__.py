"""portbench: the benchmark of avt_tpu_torch (the PyTorch and CUDA port) on
one NVIDIA H100. Run a cell as

    python3 -m portbench.run --workload <config>.<traffic> --seed N --seconds S --trace 0|1

from the root of a checkout; BENCHMARK.json lists the cells and metrics.
"""
