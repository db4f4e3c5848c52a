"""Card-only tests (``cuda`` marker): each cell's control, one precision
below the configuration's, run at the cell's own size with a short window,
has to come out not correct; a sound run of the same window has to come
out correct; and a checkout that holds only ``BENCHMARK.json`` and the
benchmark's files gives no result.

  python -m pytest -o addopts="" -m cuda benchmark/tests/test_bench_card.py
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the H100 only")


def _run(*args, cwd=ROOT):
    p = subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                       capture_output=True, text=True, timeout=900)
    return p, (json.loads(p.stdout.strip().splitlines()[-1]) if p.returncode == 0 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    p, r = _run("--workload", cell, "--seed", "424242", "--seconds", "3", "--control")
    assert p.returncode == 0, p.stderr[-4000:]
    assert r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(card, cell):
    p, r = _run("--workload", cell, "--seed", "434343", "--seconds", "3")
    assert p.returncode == 0, p.stderr[-4000:]
    assert r["correct"] is True, r["checks"]


@pytest.mark.cuda
def test_benchmark_alone_gives_no_result(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p, _ = _run("--workload", CELLS[0], "--seed", "1", "--seconds", "1", cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
