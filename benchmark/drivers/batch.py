"""Offline batch denoising: ``DenoiserRunner.denoise_audio`` on batches of
equal clips, the device queue kept full.

Traffic keys: ``batch`` clips of ``clip_seconds``; ``distinct_batches``
batches of noisy speech at ``snr_db`` made on the device and cycled;
``in_flight`` batches queued ahead at most; ``warmup`` calls in set-up;
``profile_batches`` in the traced sub-window; ``check_rows`` clips drawn
from the seed for the check.

The check: after the window, the last answer to each distinct batch is
held to the reference's float32 denoising of the same clips; the number
compared is the largest L2 error of a sampled clip (``rel_errors``).
"""

from __future__ import annotations

import itertools
import time
from collections import deque

import numpy as np
import torch

from benchmark import counts, devtrace, inputs, program
from benchmark.harness import Check, Outcome
from benchmark.reference import exact_float32
from benchmark.reference import unet as ref_unet


def rel_errors(got, want) -> torch.Tensor:
    """Per-clip L2 error of ``got`` against ``want``, over the larger of the
    clip's reference norm and the median clip's: a clip the reference
    leaves almost silent (a magnitude U-Net can clamp every bin to zero)
    is held to the sample's scale, not to its own near-zero one."""
    gaps = torch.stack([(g.float() - w.float()).norm() for g, w in zip(got, want)])
    norms = torch.stack([w.float().norm() for w in want])
    return gaps / torch.maximum(norms, norms.median()).clamp_min(1e-30)


def run(cell) -> Outcome:
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sr = int(cfg["sample_rate"])
    rows, samples = int(tr["batch"]), int(round(tr["clip_seconds"] * sr))
    gen = inputs.generator(cell.seed, dev)
    weights = inputs.make_weights(cfg, cell.seed, dev, cell)
    runner = program.serving_runner(cfg, weights, dev, control=cell.control)
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
        window_s=wall, flops=clips * counts.clip_flops(cfg, samples), clips=clips)
    if cell.trace and cell.cuda:
        step = itertools.count(done)
        # each profiled batch is one K1 and one K2 call at the window's shape
        cell.record["kernel_bytes"] = {"stft": counts.stft_bytes(cfg, rows, samples),
                                       "istft": counts.istft_bytes(cfg, rows, samples)}
        devtrace.profile(lambda: one(next(step)), int(tr["profile_batches"]), cell)
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
        want = ref_unet.denoise(weights, cfg, noisy)
    err = rel_errors(got, want)
    cell.log(f"check rows {len(pick)}: rel L2 median {float(err.median()):.3e} "
             f"max {float(err.max()):.3e}")
    return Outcome(e2e={"audio_s_per_s": clips * float(tr["clip_seconds"]) / wall},
                   attempted=clips, failed=0,
                   checks=[Check("max_rel_err", float(err.max()),
                                 float(cell.limits["max_rel_err"]))])
