"""The benchmark of onix_torch, the PyTorch and CUDA port of onix.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once and prints one
JSON line. Everything a cell needs is found by name: its configuration
in `configs/`, its traffic in `workloads/`, its kind of run in
`kinds/`, each per-layer metric's reader in `metrics/`. The plain
reference that decides `correct` is in `reference/` and imports
nothing of the program.
"""
