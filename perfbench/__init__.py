"""The benchmark of nmc_tpu_torch on an NVIDIA H100.

`run.py` runs one cell of BENCHMARK.json. Everything a cell is made of is
found by name: configurations in `configs/`, traffic mixes in `traffic/`,
metric readers in `metrics/`, the limits of the output check in
`checks/`, the runners of the program's engines in `engines/` and their
plain references in `reference/`. The reference imports torch and numpy
only; nothing here imports the JAX package.
"""
