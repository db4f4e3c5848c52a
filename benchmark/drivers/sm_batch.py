"""Offline batch denoising with SEMamba: ``DenoiserRunner.denoise_audio``
in mode ``mag_pha`` on batches of equal clips, the device queue kept full.
``drivers/mp_batch.py``'s loop, check and control with SEMamba and its
reference in MP-SENet's place.

Traffic keys, as ``drivers/batch.py`` reads them: ``batch`` clips of
``clip_seconds``; ``distinct_batches`` batches of noisy speech at
``snr_db`` made on the device and cycled; ``in_flight`` batches queued
ahead at most; ``warmup`` calls in set-up; ``profile_batches`` in the
traced sub-window, profiled with the program's spans
(``spans.with_spans``); ``check_rows`` clips drawn from the seed for the
check.

The weights are the reference's seeded ones (``reference.semamba.
seeded_weights``: mamba_ssm's initial distributions for the scan's
parameters); SEMamba has no BatchNorm, so nothing is calibrated. The
program is the port's ``SEMamba`` with those weights in the
configuration's serving dtype, behind ``DenoiserRunner``. The control
(``--control``) rounds the model's two input planes and the output of each
dense block and each bidirectional Mamba block to float8 e4m3 and back,
through hooks that this driver registers; the program is not changed.

The check: after the window, the last answer to each distinct batch is
held to the reference's float32 denoising of the same clips (its scan one
token at a time, in blocks of 8 clips); the number compared is the root
mean square of the sampled clips' relative L2 errors
(``mp_batch.rms_check`` over ``batch.rel_errors``), against the limit in
``limits/semamba2m.dns10s.json``. Sound runs read 0.059-0.088 on an H100
(the largest clip 0.135), about twice MP-SENet's; the scan's parameters
are not the cause (kept in float32, ``A_log``, ``D`` and ``dt_proj`` leave
a bf16 model's error where it was), the bf16 activations are. The fp8
control reads 0.51-0.64. One wrong clip of 32 (an error of 1) beside 31
sound ones puts the number at 0.19, past the limit.
The median, 90th percentile and largest are printed beside it.
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from benchmark import counts, devtrace, inputs, sm_counts, spans
from benchmark.drivers.batch import rel_errors
from benchmark.drivers.mp_batch import _fp8, rms_check
from benchmark.harness import Outcome
from benchmark.reference import exact_float32
from benchmark.reference import semamba as ref_sm

MODEL_KEYS = ("dense_channel", "num_tfmamba", "d_state", "d_conv", "expand", "n_fft",
              "hop_length", "win_length", "sample_rate", "compress_factor", "beta", "norm_eps")


def serving_runner(model_cls, cfg: dict, weights: dict, device, control: bool = False):
    """``DenoiserRunner`` over ``model_cls`` (the port's ``SEMamba``) with
    the benchmark's weights in the configuration's serving dtype; with
    ``control`` the model's input planes and each dense block's and
    bidirectional Mamba block's output rounded to float8 e4m3."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner

    with torch.device(device):
        model = model_cls(**{k: cfg[k] for k in MODEL_KEYS})
    model.load_state_dict(weights, strict=True)
    model = model.to(dtype=getattr(torch, cfg["serve_dtype"])).eval()
    if control:
        model.dense_encoder.register_forward_pre_hook(lambda m, args: (_fp8(args[0]),))
        blocks = [model.dense_encoder.dense_block, model.mask_decoder.dense_block,
                  model.phase_decoder.dense_block]
        for tf in model.TSMamba:
            blocks += [tf.time_mamba, tf.freq_mamba]
        for block in blocks:
            block.register_forward_hook(lambda m, args, out: _fp8(out))
    return DenoiserRunner(model, device=device)


def run(cell) -> Outcome:
    # the program first: a checkout without SEMamba fails here, at once
    from audiodenoiser_torch.models.semamba import SEMamba

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sr = int(cfg["sample_rate"])
    rows, samples = int(tr["batch"]), int(round(tr["clip_seconds"] * sr))
    gen = inputs.generator(cell.seed, dev)
    weights = ref_sm.seeded_weights(cfg, inputs.generator(cell.seed + 1, dev), dev)
    runner = serving_runner(SEMamba, cfg, weights, dev, control=cell.control)
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
        window_s=wall, flops=clips * sm_counts.clip_flops(cfg, samples), clips=clips)
    if cell.trace and cell.cuda:
        step = itertools.count(done)
        # each profiled batch is one K1 and one K2 call at the window's shape
        cell.record["kernel_bytes"] = {"stft": counts.stft_bytes(cfg, rows, samples),
                                       "istft": counts.istft_bytes(cfg, rows, samples),
                                       "ssm": sm_counts.ssm_bytes(cfg, rows, samples)}
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
        want = ref_sm.denoise(weights, cfg, noisy)
    err = rel_errors(got, want)
    check = rms_check(err, cell.limits)
    cell.log(f"check rows {len(pick)}: rel L2 rms {check.value:.3e} "
             f"median {float(err.median()):.3e} p90 {float(torch.quantile(err, 0.9)):.3e} "
             f"max {float(err.max()):.3e}")
    return Outcome(e2e={"audio_s_per_s": clips * float(tr["clip_seconds"]) / wall},
                   attempted=clips, failed=0, checks=[check])
