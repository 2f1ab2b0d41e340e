"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

One run of one cell: ``python3 bench_port/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``.  See ``bench_port/README.md``.
"""
