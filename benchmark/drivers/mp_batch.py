"""Offline batch denoising with MP-SENet: ``DenoiserRunner.denoise_audio``
in mode ``mag_pha`` on batches of equal clips, the device queue kept full.

Traffic keys, as ``drivers/batch.py`` reads them: ``batch`` clips of
``clip_seconds``; ``distinct_batches`` batches of noisy speech at
``snr_db`` made on the device and cycled; ``in_flight`` batches queued
ahead at most; ``warmup`` calls in set-up; ``profile_batches`` in the
traced sub-window, profiled with the program's spans
(``spans.with_spans``); ``check_rows`` clips drawn from the seed for the
check.

The weights are the reference's seeded ones (``reference.mpsenet.
seeded_weights``), their BatchNorm statistics set by a calibration batch
through the reference, which ``setup_s`` leaves out. The program is the
port's ``MPSENet`` with those weights in the configuration's serving
dtype, behind ``DenoiserRunner``. The control (``--control``) rounds the
model's two input planes and the output of each dense block and each
conformer to float8 e4m3 and back, through hooks that this driver
registers; the program is not changed.

The check: after the window, the last answer to each distinct batch is
held to the reference's float32 denoising of the same clips; the number
compared is the root mean square of the sampled clips' relative L2
errors (``batch.rel_errors``). One wrong clip of 32 (an error of 1 or
more) puts it at 0.177 or more, past the limit, while the largest error
of a sound clip does not: a clip's error in bf16 depends on the rounding
pattern, and one clip of a sound run (seed 3100000097, on an H100) reads 0.13-0.20
under perturbations of a millionth of its RMS, where the same clip reads
6e-6 in float32. The median, 90th percentile and largest are printed
beside it.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from benchmark import counts, devtrace, inputs, mp_counts, spans
from benchmark.drivers.batch import rel_errors
from benchmark.harness import Check, Outcome
from benchmark.reference import exact_float32
from benchmark.reference import mpsenet as ref_mp

CALIBRATION_CLIPS = 4
CALIBRATION_SECONDS = 1.0
MODEL_KEYS = ("dense_channel", "num_tsconformers", "n_fft", "hop_length", "win_length",
              "sample_rate", "compress_factor", "beta")
FP8_MAX = 448.0  # float8 e4m3's largest finite value


def make_weights(cfg: dict, seed: int, device, cell) -> dict:
    """The reference's seeded float32 weights on ``device``, calibrated on
    noisy speech drawn from a generator of its own, outside ``setup_s``."""
    weights = ref_mp.seeded_weights(cfg, inputs.generator(seed, device), device)
    sr = int(cfg["sample_rate"])
    with cell.outside_setup():
        audio = inputs.noisy_speech(inputs.generator(seed + 1, device), CALIBRATION_CLIPS,
                                    int(CALIBRATION_SECONDS * sr), sr, (0.0, 10.0), device)
        with exact_float32():
            ref_mp.calibrate(weights, cfg, audio)
        if cell.cuda:  # the calibration's memory is not the program's
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return weights


def _fp8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)


def serving_runner(model_cls, cfg: dict, weights: dict, device, control: bool = False):
    """``DenoiserRunner`` over ``model_cls`` (the port's ``MPSENet``) with
    the benchmark's weights in the configuration's serving dtype; with
    ``control`` the model's input planes and each dense block's and
    conformer's output rounded to float8 e4m3."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner

    with torch.device(device):
        model = model_cls(**{k: cfg[k] for k in MODEL_KEYS})
    model.load_state_dict(weights, strict=True)
    model = model.to(dtype=getattr(torch, cfg["serve_dtype"])).eval()
    if control:
        model.dense_encoder.register_forward_pre_hook(lambda m, args: (_fp8(args[0]),))
        blocks = [model.dense_encoder.dense_block, model.mask_decoder.dense_block,
                  model.phase_decoder.dense_block]
        for ts in model.TSConformer:
            blocks += [ts.time_conformer, ts.freq_conformer]
        for block in blocks:
            block.register_forward_hook(lambda m, args, out: _fp8(out))
    return DenoiserRunner(model, device=device)


def rms_check(err: torch.Tensor, limits: dict) -> Check:
    """The check on the sampled clips' relative errors: their root mean
    square against the cell's limit."""
    return Check("rms_rel_err", float(err.float().square().mean().sqrt()),
                 float(limits["rms_rel_err"]))


def run(cell) -> Outcome:
    # the program first: a checkout without MP-SENet fails here, at once
    from audiodenoiser_torch.models.mpsenet import MPSENet

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sr = int(cfg["sample_rate"])
    rows, samples = int(tr["batch"]), int(round(tr["clip_seconds"] * sr))
    gen = inputs.generator(cell.seed, dev)
    weights = make_weights(cfg, cell.seed, dev, cell)
    runner = serving_runner(MPSENet, cfg, weights, dev, control=cell.control)
    cell.mark("weights made, program built")
    batches = [inputs.noisy_speech(gen, rows, samples, sr, tr["snr_db"], dev)
               for _ in range(int(tr["distinct_batches"]))]
    cell.mark("inputs made")
    for i in range(int(tr["warmup"])):
        runner.denoise_audio(batches[i % len(batches)])
    outs = [None] * len(batches)

    def one(i):
        with cell.span("batch"):
            outs[i % len(batches)] = runner.denoise_audio(batches[i % len(batches)])

    fences = deque()
    done = 0
    t0 = cell.begin_window()
    while time.perf_counter() - t0 < cell.seconds:
        if len(fences) >= int(tr["in_flight"]):
            fences.popleft().wait()
        one(done)
        fences.append(devtrace.Fence(dev))
        done += 1
    cell.sync()
    wall = time.perf_counter() - t0
    clips = done * rows
    cell.record["counters"].update(
        window_s=wall, flops=clips * mp_counts.clip_flops(cfg, samples), clips=clips)
    if cell.trace and cell.cuda:
        step = itertools.count(done)
        # each profiled batch is one K1 and one K2 call at the window's shape
        cell.record["kernel_bytes"] = {"stft": counts.stft_bytes(cfg, rows, samples),
                                       "istft": counts.istft_bytes(cfg, rows, samples)}
        spans.with_spans(devtrace.profile)(lambda: one(next(step)),
                                           int(tr["profile_batches"]), cell)
    cell.sync()
    # the sample: clips of the answers the window gave, drawn from the seed
    answered = [k for k in range(len(batches) * rows) if outs[k // rows] is not None]
    pick = np.random.default_rng(cell.seed).choice(
        answered, size=min(int(tr["check_rows"]), len(answered)), replace=False)
    got = torch.stack([outs[k // rows][k % rows] for k in pick]).float()
    noisy = torch.stack([batches[k // rows][k % rows] for k in pick])
    cell.read_peak()
    del runner, outs, batches
    cell.free()
    with exact_float32():
        want = ref_mp.denoise(weights, cfg, noisy)
    err = rel_errors(got, want)
    check = rms_check(err, cell.limits)
    cell.log(f"check rows {len(pick)}: rel L2 rms {check.value:.3e} "
             f"median {float(err.median()):.3e} p90 {float(torch.quantile(err, 0.9)):.3e} "
             f"max {float(err.max()):.3e}")
    return Outcome(e2e={"audio_s_per_s": clips * float(tr["clip_seconds"]) / wall},
                   attempted=clips, failed=0, checks=[check])
