"""The benchmark of the PyTorch/CUDA port (`stereovision_slam_torch`).

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`. Cells, configurations,
drivers and per-layer metrics are files found by name (`workloads/`,
`configs/`, `drivers/`, `metrics/`); `reference/` is the plain reference
that decides `correct`.
"""
