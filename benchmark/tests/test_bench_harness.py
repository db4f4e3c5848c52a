"""The harness on the CPU: the benchmark's files against their format, the
cells found by name, a new cell added by files and an entry alone, the
counts, the result line, imports in a fresh interpreter, and each fault
that a cell can have turning ``correct`` false at a small width."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import counts, harness, inputs  # noqa: E402
from benchmark.reference import unet as ref_unet  # noqa: E402

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = dict(features=[8, 16, 32, 64], bottleneck=128)
# each traffic mix cut to a size the CPU runs in seconds
SMALL_TRAFFIC = {
    "batch": dict(batch=4, distinct_batches=3, check_rows=6),
    "train_step": dict(batch=4, clean_chunks=40, noise_clips=4),
}


def small(cell):
    """A cell's files, found by its name (``<config>.<traffic>``), at a
    small width and traffic."""
    config, traffic = cell.split(".", 1)
    bench = ROOT / "benchmark"
    found = {"config": harness.load_json(bench / "configs" / f"{config}.json"),
             "traffic": harness.load_json(bench / "traffic" / f"{traffic}.json"),
             "limits": harness.load_json(bench / "limits" / f"{cell}.json")}
    found["config"].update(SMALL)
    found["traffic"].update(SMALL_TRAFFIC[found["traffic"]["driver"]])
    return found


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in SPEC["workloads"]:  # every cell reports setup_s, another e2e and a layer metric
        mine = {m["name"] for m in SPEC["end_to_end"] if harness.applies(m, w["name"], set())}
        assert "setup_s" in mine and len(mine) >= 2
        assert any(harness.applies(m, w["name"], mine) for m in SPEC["per_layer"])
    for m in metrics:
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_and_metric_is_found_by_name():
    import importlib

    for w in SPEC["workloads"]:
        found = harness.find_cell(SPEC, w["name"])
        assert found["config"]["name"] == w["config"]
        importlib.import_module(f"benchmark.drivers.{found['traffic']['driver']}")
        assert found["limits"] and all(math.isfinite(v) for v in found["limits"].values())
    for m in SPEC["per_layer"]:
        assert harness.load_reader(m["name"])({"spans": {}, "counters": {}}) is None


def test_the_kernel_rooflines_read_the_profiled_kernels():
    """K1's and K2's device time is told apart by name, a step is a profiled
    batch, and a trace without them reads nothing."""
    cfg = harness.load_json(ROOT / "benchmark/configs/unet31m.json")
    n_bytes = counts.stft_bytes(cfg, 256, 16000)
    bound = counts.bound_seconds(n_bytes)
    by_name = {"void stft_fft_kernel(float const*, float const*)": 4 * 2 * bound,
               "void istft_fft_kernel<true>(float const*, float const*)": 4 * 4 * bound,
               "sm90_xmma_fprop_implicit_gemm_bf16": 1.0}
    record = {"spans": {}, "counters": {},
              "kernel_bytes": {"stft": n_bytes, "istft": n_bytes},
              "device_trace": {"by_name": by_name, "iters": 4, "busy_s": 1.1,
                               "window_s": 1.2}}
    assert harness.load_reader("stft_roofline.audio")(record) == pytest.approx(50.0)
    assert harness.load_reader("istft_roofline.audio")(record) == pytest.approx(25.0)
    del by_name["void stft_fft_kernel(float const*, float const*)"]
    assert harness.load_reader("stft_roofline.audio")(record) is None


def test_a_new_cell_needs_only_files_and_an_entry(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/unet31m.json").read_text())
    cfg.update(SMALL, name="unet_small")
    (tmp_path / "benchmark/configs/unet_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark/traffic/batch256.json").read_text())
    traffic.update(SMALL_TRAFFIC["batch"])
    (tmp_path / "benchmark/traffic/batch4.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark/limits/unet_small.batch4.json").write_text('{"max_rel_err": 0.5}')
    spec["configs"].append({"name": "unet_small", "source": "x", "reduced": ["features"],
                            "file": "benchmark/configs/unet_small.json", "why": "x"})
    spec["workloads"].append({"name": "unet_small.batch4", "config": "unet_small",
                              "traffic": "batch4", "chips": 1, "why": "x"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "unet31m.batch256" in m.get("workloads", []):
            m["workloads"].append("unet_small.batch4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell("unet_small.batch4", 9, 1.0, False, device="cpu", root=tmp_path)
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"} and r["correct"]
    r = harness.run_cell("unet_small.batch4", 9, 1.0, True, device="cpu", root=tmp_path)
    assert set(r["metrics"]) == {"mfu.audio"}  # the rest read the card's trace


@pytest.mark.parametrize("name", ["unet31m", "cmask31m"])
def test_flops_against_the_flop_counter_and_by_hand(name):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = harness.load_json(ROOT / "benchmark/configs" / f"{name}.json")
    weights = {n: torch.empty(s, device="meta") for n, s, _ in inputs.weight_layout(cfg)}
    x = torch.empty((1, cfg["in_channels"], 257, 126), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_unet.forward(weights, cfg, x)
    assert fc.get_total_flops() == counts.clip_flops(cfg, 16000)
    assert counts.clip_flops(cfg, 16000) == {"unet31m": 46_209_660_416,
                                             "cmask31m": 46_288_413_440}[name]
    assert sum(math.prod(s) for _, s, k in inputs.weight_layout(cfg)
               if k in ("conv", "deconv", "bias", "bn_weight", "bn_bias")) == cfg["parameters"]


def test_kernel_bytes_by_hand():
    cfg = harness.load_json(ROOT / "benchmark/configs/unet31m.json")
    # 256 clips of 16,000 float32 samples in; 256 x 257 x 126 complex64 out
    assert counts.stft_bytes(cfg, 256, 16000) == 256 * 16000 * 4 + 256 * 257 * 126 * 8
    assert abs(counts.bound_seconds(counts.stft_bytes(cfg, 256, 16000)) - 24.69e-6) < 0.01e-6


def test_result_line_shape():
    r = harness.run_cell("unet31m.batch256", 3, 0.5, False, device="cpu",
                         found=small("unet31m.batch256"))
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "unet31m.batch256",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


DRIVER_IMPORTS = ["benchmark.harness", "benchmark.devtrace", "benchmark.drivers.batch",
                  "benchmark.drivers.train_step", "audiodenoiser_torch.eval.runner",
                  "audiodenoiser_torch.train.mask", "audiodenoiser_torch.data.pipeline",
                  "audiodenoiser_torch.models", "audiodenoiser_torch.models.int8"]


def _loaded_after(modules):
    code = ("import sys; sys.path.insert(0, %r)\n" % str(ROOT)
            + "".join(f"import {m}\n" for m in modules)
            + "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, check=True)
    return set(p.stdout.split())


def test_a_run_loads_no_jax():
    loaded = _loaded_after(DRIVER_IMPORTS)
    assert "audiodenoiser_torch" in loaded and "benchmark" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after(["benchmark.reference.unet", "benchmark.reference.train",
                            "benchmark.reference.mixer", "benchmark.reference.dsp"])
    assert not loaded & set(harness.FORBIDDEN) and "audiodenoiser_torch" not in loaded


def _altered(monkeypatch):
    """A runner whose answers are altered where they are produced: the
    middle tenth of every clip zeroed."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner

    real = DenoiserRunner.denoise_audio

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs).clone()
        n = out.shape[-1]
        out[..., n * 9 // 20: n * 11 // 20] = 0.0
        return out

    monkeypatch.setattr(DenoiserRunner, "denoise_audio", altered)


def test_an_altered_answer_fails_the_check(monkeypatch):
    cell = "unet31m.batch256"
    sound = harness.run_cell(cell, 4, 1.0, False, device="cpu", found=small(cell))
    _altered(monkeypatch)
    broken = harness.run_cell(cell, 4, 1.0, False, device="cpu", found=small(cell))
    assert not broken["correct"]
    err = broken["checks"]["max_rel_err"]["value"]
    assert err > 3 * sound["checks"]["max_rel_err"]["value"]


def _state_unchanged(monkeypatch):
    from audiodenoiser_torch.train.loop import ClippedAdamW

    monkeypatch.setattr(ClippedAdamW, "step", lambda self: None)


def _half_batch(monkeypatch):
    import audiodenoiser_torch.train.mask as mask

    real = mask.make_mask_steps

    def half(*args, **kwargs):
        step, eval_step = real(*args, **kwargs)
        return (lambda state, noisy, clean: step(state, noisy[: len(noisy) // 2],
                                                 clean[: len(clean) // 2])), eval_step

    monkeypatch.setattr(mask, "make_mask_steps", half)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_a_broken_training_step_fails_the_check(fault, monkeypatch):
    cell = "cmask31m.train16"
    fault(monkeypatch)
    broken = harness.run_cell(cell, 6, 0.5, False, device="cpu", found=small(cell))
    assert not broken["correct"], broken["checks"]
