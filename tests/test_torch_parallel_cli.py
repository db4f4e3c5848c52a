"""``cli.train``, ``cli.test`` and ``cli.serve`` of the port on a
('data', 'model') mesh of two gloo ranks, against the same CLIs run
unmeshed in this process.

The two ranks (``tests/torch_parallel_worker.py``, port only) run every
scenario once, in a module fixture, while this process makes the unmeshed
runs; each test then asserts one scenario. The models are narrow (the
U-Net ``features=(8, 128), bottleneck=256`` in training, width-0.25
exports in evaluation and serving), wide enough at 128 and 256 channels
for channel tensor parallelism to slice them.

Tolerances: training histories rtol 1e-3 per epoch (JAX's own for its
meshed CLI run: reassociated fp32 sums compound over the optimizer's
steps); the exports and the last resume state (weights, EMA, BatchNorm
statistics) 5e-2 relative L2 per tensor, or 4 x lr per element. At these
widths the fp32 gradient lies 1e-4 - 4e-3 from a float64 backward
(``tests/test_torch_parallel.py``) and an AdamW step moves an element by
about lr * sign(g), so at cli.train's default lr 1e-4 six micro-steps left
two summation orders' epoch losses 0.5% apart, a BatchNorm mean 1.2% and
AdamW's second moments 7%: the runs take lr 1e-5; ``cli.test``'s
scores rtol 1e-5; ``cli.serve``'s answers within 1e-5 (relative L2 for
the 16-bit WAV answer, absolute for the float32 stream).
"""

from __future__ import annotations

import io
import json
import os
import threading

import numpy as np
import pytest
import torch

from audiodenoiser_torch.cli import serve as serve_cli
from audiodenoiser_torch.cli import test as test_cli
from audiodenoiser_torch.cli import train as train_cli
from audiodenoiser_torch.data.builders import build_test_dataset
from audiodenoiser_torch.data.wav_io import read_wav, write_wav
from audiodenoiser_torch.models import random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.models.unet import scaled_widths
from audiodenoiser_torch.train import loop
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_torch.train.checkpoints import export_model, load_exported, restore_train_state
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel import collect, spawn

FEATS, BOTTLENECK = scaled_widths(0.25)  # (16, 32, 64, 128), 256


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _export(path, variables, sidecar):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    export_model(path, variables["params"], variables["batch_stats"])
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(sidecar, f)


def _inputs(work) -> dict:
    rng = np.random.default_rng(0)
    npy = work / "npy" / "white"
    npy.mkdir(parents=True)
    for i in range(10):  # 9 training pairs: batches of 4, 4 and a ragged 1
        clean = np.abs(rng.standard_normal((32, 32))).astype(np.float32)
        np.save(npy / f"clean_chunk_{i}.npy", clean)
        np.save(npy / f"noisy_chunk_{i}.npy",
                clean + 0.3 * np.abs(rng.standard_normal((32, 32))).astype(np.float32))
    wavs = work / "wavs"
    (wavs / "clean").mkdir(parents=True)
    (wavs / "noise").mkdir()
    for i, c in enumerate(synth_chunks(3, seed=4)):
        write_wav(str(wavs / "clean" / f"c{i}.wav"), c[:12000], 8000)
    write_wav(str(wavs / "noise" / "n0.wav"),
              (0.3 * rng.standard_normal(8000)).astype(np.float32), 8000)
    build_test_dataset(str(wavs / "clean"), str(wavs / "noise"), str(work / "test_set"),
                       noise_types=("white",), device="cpu")
    widths = dict(features=FEATS, bottleneck=BOTTLENECK)
    _export(str(work / "unet" / "unet_denoiser_white.ckpt"),
            random_flax_variables(3, **widths), {"width_mult": 0.25})
    _export(str(work / "mask" / "mask_denoiser_mixed.ckpt"),
            random_flax_variables(4, in_channels=3, out_channels=2, **widths),
            {"width_mult": 0.25, "mask_bound": 2.0, "residual": True})
    buf = io.BytesIO()
    write_wav(buf, np.clip(0.2 * rng.standard_normal(1500), -1, 1).astype(np.float32), 8000)
    return {"npy_dir": str(work / "npy"), "test_dir": str(work / "test_set"),
            "unet_dir": str(work / "unet"), "mask_dir": str(work / "mask"),
            "wav": buf.getvalue(),
            "stream": np.clip(0.2 * rng.standard_normal(3000), -1, 1).astype(np.float32)}


def _serve_unmeshed(inputs) -> tuple:
    _, server, _ = serve_cli.build_server(serve_cli.parse_args(
        worker.SERVE_FLAGS + ["--saved_models_dir", inputs["mask_dir"]]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        return worker.serve_requests(f"http://127.0.0.1:{server.server_address[1]}",
                                     inputs["wav"], inputs["stream"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_cli")
    inputs = _inputs(work)
    torch.save(inputs, work / "inputs.pt")
    procs = spawn("cli", 2, work)

    # the unmeshed runs while the ranks run
    ref = {}
    out = str(work / "single")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "UNet", loop.UNet)
        worker.narrow_training(loop)
        ref["train"] = train_cli.main(worker.train_argv(inputs, out, "single", "--epochs", "2",
                                                        "--mesh", "off"))
        ref["resume"] = train_cli.main(worker.train_argv(
            inputs, out, "whole", "--epochs", "2", "--mesh", "off", *worker.RESUME_FLAGS))
    ref["test"] = test_cli.main(["--test_data_dir", inputs["test_dir"], "--saved_models_dir",
                                 inputs["unet_dir"], "--output_dir", str(work / "test_single"),
                                 "--noise_types", "white", "--num_audio_examples", "1",
                                 "--precision", "f32", "--device", "cpu", "--mesh", "off"])
    ref["serve"] = _serve_unmeshed(inputs)
    return collect(procs, "cli", work, timeout=300), ref, work


LR = worker.LR  # the runs' learning rate


def _tensors_close(got: dict, want: dict) -> None:
    """Full tensors (gathered from the ranks) within 5e-2 relative L2, or,
    for a tensor that the few AdamW steps alone have moved (a BatchNorm
    bias), each element within 4 x lr: a step whose gradient sign fp32
    does not determine moves an element 2 x lr apart."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if "num_batches" not in k and not k.endswith(("double_conv.0.bias",
                                                       "double_conv.3.bias")):
            gap = float((got[k].float() - v.float()).abs().max())
            assert _rel(got[k], v) < 5e-2 or gap <= 4 * LR, (k, _rel(got[k], v), gap)


def _exports_close(path, ref_path):
    """The same epoch's export (its ``.val.json``), with close weights."""
    epoch = [json.load(open(os.path.splitext(p)[0] + ".val.json"))["epoch"]
             for p in (path, ref_path)]
    assert epoch[0] == epoch[1]
    _tensors_close(state_dict_from_flax(load_exported(path)),
                   state_dict_from_flax(load_exported(ref_path)))


def _histories_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["train"], w["train"], rtol=1e-3)
        np.testing.assert_allclose(g["val"], w["val"], rtol=1e-3)


def test_cli_train_mesh_on_model_parallel_2_matches_single_process(runs):
    """The two ranks' run (1 x 2: every wide layer's channels split) against
    the single-process ``--mesh off`` run: per-epoch losses and the
    exported ``.ckpt``; rank 1 wrote nothing."""
    results, ref, work = runs
    got = results[0]["cli_train"]
    assert got["sliced"] > 0 and results[1]["cli_train"]["history"] == got["history"]
    _histories_close(got["history"], ref["train"]["history"])
    _exports_close(got["best_path"], ref["train"]["best_path"])
    assert sorted(os.listdir(os.path.dirname(got["best_path"]))) == sorted(
        os.listdir(os.path.dirname(ref["train"]["best_path"])))


def test_cli_resume_onto_another_layout(runs):
    """One epoch on 1 x 2, resumed onto 2 x 1 with fsdp (an EMA, an
    accumulated update across the epochs): the single-process two-epoch
    run's history, exports and last resume state."""
    results, ref, _ = runs
    got = results[0]["cli_resume"]
    assert got["fsdp"] > 0
    _histories_close(got["history"], ref["resume"]["history"])
    _exports_close(got["best_path"], ref["resume"]["best_path"])
    _exports_close(got["best_ema_path"], ref["resume"]["best_ema_path"])
    # the last epoch's resume state: the model, its EMA, full AdamW moments
    # with the unmeshed step counts (their values part as the gradients do)
    final = [restore_train_state(os.path.join(os.path.dirname(p), "train_state.pt"))
             for p in (got["best_path"], ref["resume"]["best_path"])]
    _tensors_close(final[0]["model"], final[1]["model"])
    _tensors_close(final[0]["ema"], final[1]["ema"])
    for i, st in final[1]["optimizer"]["adamw"]["state"].items():
        mine = final[0]["optimizer"]["adamw"]["state"][i]
        assert float(mine["step"]) == float(st["step"]) == 3
        assert mine["exp_avg"].shape == st["exp_avg"].shape
    assert final[0]["global_step"] == final[1]["global_step"] == 6


def test_cli_test_mesh_on_scores_as_unmeshed(runs):
    results, ref, work = runs
    got = results[0]["cli_test"]["results"]
    assert results[1]["cli_test"]["results"] == got  # every rank scores; rank 0 writes
    assert got.keys() == ref["test"].keys() == {"white"}
    for k, v in ref["test"]["white"].items():
        assert abs(got["white"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    assert sorted(os.listdir(work / "test")) == sorted(os.listdir(work / "test_single"))
    lines = (work / "test" / "white_metrics.txt").read_text().splitlines()
    want = (work / "test_single" / "white_metrics.txt").read_text().splitlines()
    assert [line.split(":")[0] for line in lines] == [line.split(":")[0] for line in want]


def test_cli_serve_mesh_on_answers_as_unmeshed(runs):
    """Rank 0 served a ``/denoise`` request and a stream session with rank
    1 following, reloaded on both ranks, and served them again."""
    results, ref, _ = runs
    got = results[0]["cli_serve"]
    assert results[1]["cli_serve"] is None
    assert got["sliced"] > 0 and "generation" in got["reloaded"]
    assert got["registered"] == 2  # a runner a generation, numbered alike on both ranks
    want_wav, want_stream = ref["serve"]
    for answer, stream in (got["first"], got["second"]):
        assert _rel(read_wav(io.BytesIO(answer))[0], read_wav(io.BytesIO(want_wav))[0]) < 1e-5
        assert stream.shape == want_stream.shape == (3000,)
        np.testing.assert_allclose(stream, want_stream, rtol=0, atol=1e-5)
