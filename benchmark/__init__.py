"""The benchmark of ``audiodenoiser_torch`` on an NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Everything a cell needs is found by
name: its configuration in ``configs/``, its traffic mix in ``traffic/``
(which names its driver in ``drivers/``), the limits of its correctness
check in ``limits/`` and each per-layer metric's reader in
``layer_metrics/``. The plain reference that decides ``correct`` lives in
``reference/`` and imports nothing of the program.
"""
