"""The MP-SENet cell on the CPU: its FLOP count against the flop counter,
its readers, and the cell's run at a small traffic (full widths, two
0.5 s clips a batch), whose control reads further from the reference than
the sound run."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, mp_counts  # noqa: E402
from benchmark.reference import mpsenet as ref_mp  # noqa: E402

CELL = "mpsenet2m.dns10s"
CFG = harness.load_json(ROOT / "benchmark/configs/mpsenet2m.json")


@pytest.mark.parametrize("frames,flops", [(321, 167_884_258_962), (641, 356_249_802_002)])
def test_flops_against_the_flop_counter(frames, flops):
    from torch.utils.flop_counter import FlopCounterMode

    p = {n: torch.empty(s, device="meta") for n, s, _ in ref_mp.weight_layout(CFG)}
    mag = torch.empty((1, 201, frames), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_mp.forward(p, CFG, mag, mag)
    assert fc.get_total_flops() == mp_counts.forward_flops(CFG, frames) == flops
    assert mp_counts.clip_flops(CFG, (frames - 1) * 100) == flops
    assert ref_mp.parameter_count(CFG) == CFG["parameters"]


def test_the_attention_readers():
    program = {"phases": ["model", "mp.time_attention", "mp.freq_attention"],
               "device_s": {"model": 1.0, "mp.time_attention": 0.3,
                            "mp.freq_attention": 0.06, "outside": 0.0}}
    record = {"spans": {}, "counters": {}, "device_trace": {"iters": 3, "program": program}}
    assert harness.load_reader("time_attention_ms.mpsenet")(record) == pytest.approx(100.0)
    assert harness.load_reader("freq_attention_ms.mpsenet")(record) == pytest.approx(20.0)
    program["phases"] = ["model"]  # a program without the spans
    assert harness.load_reader("time_attention_ms.mpsenet")(record) is None


def test_the_cell_runs_and_its_control_reads_further():
    found = harness.find_cell(harness.load_spec(), CELL)
    found["traffic"].update(batch=2, clip_seconds=0.5, distinct_batches=2, check_rows=4,
                            warmup=1)
    seed = 2 ** 31 + 977
    sound = harness.run_cell(CELL, seed, 0.3, False, device="cpu", found=found)
    assert set(sound["metrics"]) == {"audio_s_per_s", "setup_s"} and sound["correct"]
    control = harness.run_cell(CELL, seed, 0.3, False, device="cpu", found=found,
                               control=True)
    assert (control["checks"]["rms_rel_err"]["value"]
            > 1.5 * sound["checks"]["rms_rel_err"]["value"])
    traced = harness.run_cell(CELL, seed, 0.3, True, device="cpu", found=found)
    assert set(traced["metrics"]) == {"mfu.audio"}  # the rest read the card's trace


@pytest.mark.parametrize("worst,passes", [(0.20, True), (1.0, False)])
def test_the_check_passes_one_bf16_outlier_and_fails_one_wrong_clip(worst, passes):
    """31 clips at a sound run's median error (0.035) and one more: at 0.20,
    the most a sound clip read on the card under bf16 rounding, the check
    passes; a wrong clip (error 1: a silent answer) fails it alone."""
    from benchmark.drivers import mp_batch

    limits = harness.find_cell(harness.load_spec(), CELL)["limits"]
    err = torch.cat([torch.full((31,), 0.035), torch.tensor([worst])])
    assert mp_batch.rms_check(err, limits).ok is passes
