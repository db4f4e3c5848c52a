"""Run one cell of ``BENCHMARK.json`` on the H100 and print its result line.

  python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object; the numbers that
decide ``correct`` are also the last lines of standard error, each beside
its limit. ``--control`` runs the cell's control instead of the program,
whose check has to come out false (``benchmark/tests/test_bench_card.py``).
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import main, pin_caches  # noqa: E402

if __name__ == "__main__":
    pin_caches()
    sys.exit(main(t_start=T_START))
