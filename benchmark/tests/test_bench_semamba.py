"""The SEMamba cell on the CPU: its FLOP count against the flop counter,
the scan's bytes, its readers, and the cell's run at a small traffic (full
widths, two 0.5 s clips a batch), whose control reads further from the
reference than the sound run."""

import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, sm_counts  # noqa: E402
from benchmark.reference import semamba as ref_sm  # noqa: E402

CELL = "semamba2m.dns10s"
CFG = harness.load_json(ROOT / "benchmark/configs/semamba2m.json")


@pytest.mark.parametrize("frames", [41, 81])
def test_flops_against_the_flop_counter(frames, monkeypatch):
    """The flop counter on the reference's forward, on meta tensors, sees
    every linear and convolution; the scan is elementwise work it does not
    see, so it is left out of the run (the stand-in returns its shape) and
    its term, 9 d_inner d_state a token of each of the 16 mixers, is added
    by formula."""
    from torch.utils.flop_counter import FlopCounterMode

    monkeypatch.setattr(ref_sm, "selective_scan", lambda u, delta, a, b, c, d, z: u)
    p = {n: torch.empty(s, device="meta") for n, s, _ in ref_sm.weight_layout(CFG)}
    mag = torch.empty((1, 201, frames), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_sm.forward(p, CFG, mag, mag)
    tokens = frames * sm_counts.bins(CFG)
    scan = 16 * tokens * 9 * 256 * 16
    assert fc.get_total_flops() + scan == sm_counts.forward_flops(CFG, frames)
    assert sm_counts.clip_flops(CFG, (frames - 1) * 100) == sm_counts.forward_flops(CFG, frames)
    assert ref_sm.parameter_count(CFG) == CFG["parameters"] == 2_258_769


def test_a_batch_is_about_29_tflop():
    flops = 32 * sm_counts.clip_flops(CFG, 160_000)
    assert 2.7e13 < flops < 3.1e13
    assert sm_counts.mixer_token_flops(CFG) == 2 * (64 * 512 + 256 * 4 + 256 * 36 + 4 * 256
                                                    + 256 * 64) + 9 * 256 * 16


def test_the_scan_bytes_by_hand():
    """x and z in, y out: 3 x 256 bf16 a token, 1,536 bytes, over 16
    mixers of 32 clips x 1,601 frames x 100 bins."""
    assert sm_counts.mixer_tokens(CFG, 32, 160_000) == 5_123_200
    assert sm_counts.ssm_bytes(CFG, 32, 160_000) == 16 * 5_123_200 * 1536
    assert sm_counts.ssm_bytes({**CFG, "serve_dtype": "float32"}, 32, 160_000) == \
        2 * 16 * 5_123_200 * 1536


def _record():
    program = {"phases": ["model", "sm.time", "sm.time_mixer", "sm.freq", "sm.freq_mixer"],
               "device_s": {"model": 1.2, "sm.time_mixer": 0.24, "sm.freq_mixer": 0.27,
                            "outside": 0.0}}
    by_name = {
        "void (anonymous namespace)::ssm_scan_kernel<__nv_bfloat16>(ScanArgs<__nv_bfloat16>)":
            0.40,
        "void (anonymous namespace)::ssm_conv_kernel<__nv_bfloat16>(ConvArgs<__nv_bfloat16>)":
            0.08,
        "nvjet_hsh_128x64_64x4_1x2_h_bz_coopA_NNT": 0.5,
    }
    return {"spans": {}, "counters": {},
            "kernel_bytes": {"ssm": sm_counts.ssm_bytes(CFG, 32, 160_000)},
            "device_trace": {"iters": 3, "program": program, "by_name": by_name}}


def test_the_readers():
    record = _record()
    assert harness.load_reader("time_mixer_ms.semamba")(record) == pytest.approx(80.0)
    assert harness.load_reader("freq_mixer_ms.semamba")(record) == pytest.approx(90.0)
    bound = 16 * 5_123_200 * 1536 / 3.35e12
    assert harness.load_reader("ssm_roofline.semamba")(record) == pytest.approx(
        100.0 * bound * 3 / 0.48)
    record["device_trace"]["program"]["phases"] = ["model"]  # a program without the spans
    assert harness.load_reader("time_mixer_ms.semamba")(record) is None
    assert harness.load_reader("freq_mixer_ms.semamba")(record) is None
    del record["device_trace"]["by_name"][next(iter(record["device_trace"]["by_name"]))]
    del record["device_trace"]["by_name"][next(iter(record["device_trace"]["by_name"]))]
    assert harness.load_reader("ssm_roofline.semamba")(record) is None  # no ssm kernel ran


def test_no_other_kernel_of_the_port_is_named_like_the_scan():
    """The roofline finds the two entries by name: no other kernel of the
    port's CUDA sources matches ``ssm_*kernel``."""
    pattern = re.compile(r"ssm_\w*kernel")
    found = {}
    for src in (ROOT / "audiodenoiser_torch" / "csrc").glob("*.cu"):
        names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                           src.read_text())
        found[src.name] = [n for n in names if pattern.search(n)]
    assert found.pop("ssm_kernel.cu") == ["ssm_conv_kernel", "ssm_scan_kernel"]
    assert not any(found.values()), found


def test_the_cell_runs_and_its_control_reads_further():
    found = harness.find_cell(harness.load_spec(), CELL)
    found["traffic"].update(batch=2, clip_seconds=0.5, distinct_batches=2, check_rows=4,
                            warmup=1)
    seed = 2 ** 31 + 1979
    sound = harness.run_cell(CELL, seed, 0.3, False, device="cpu", found=found)
    assert set(sound["metrics"]) == {"audio_s_per_s", "setup_s"} and sound["correct"]
    control = harness.run_cell(CELL, seed, 0.3, False, device="cpu", found=found,
                               control=True)
    assert (control["checks"]["rms_rel_err"]["value"]
            > 1.5 * sound["checks"]["rms_rel_err"]["value"])
    traced = harness.run_cell(CELL, seed, 0.3, True, device="cpu", found=found)
    assert set(traced["metrics"]) == {"mfu.audio"}  # the rest read the card's trace


@pytest.mark.parametrize("worst,passes", [(0.135, True), (1.0, False)])
def test_the_check_passes_the_worst_sound_clip_and_fails_one_wrong_clip(worst, passes):
    """31 clips at a sound run's median error (0.070 on the card, bf16) and
    one more: at 0.135, the most a sound clip read there, the check passes;
    a wrong clip (error 1: a silent answer) fails it alone."""
    from benchmark.drivers import mp_batch

    limits = harness.find_cell(harness.load_spec(), CELL)["limits"]
    err = torch.cat([torch.full((31,), 0.070), torch.tensor([worst])])
    assert mp_batch.rms_check(err, limits).ok is passes
