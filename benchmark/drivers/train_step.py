"""Mask training as ``cli.train --model complex_mask --pipeline on_device
--noise_type mixed`` runs it: the on-device ``mixed`` mixer, then the bf16
mask step (both STFTs, the model in train mode, the mask, the losses, the
iSTFT, the backward, the global-norm clip and AdamW), one step a batch.

Traffic keys: ``batch``; ``clean_chunks`` chunks of ``chunk_seconds`` and
``noise_clips`` clips of ``noise_clip_seconds`` made on the device;
``snr_db``; the optimizer's ``learning_rate``, ``weight_decay``,
``clip_norm``; the loss's ``si_sdr_weight`` and ``si_sdr_clamp``;
``checked_steps`` that the reference follows, ``warmup_steps`` more before
the window; ``profile_steps`` and ``mixer_calls`` in a traced run.

Set-up builds one training state and drives it through the checked steps
with the window's own call and feed; the window continues the same state.
The check, once the window has closed, follows those steps with the
reference from the same weights and draws. Compared: the first step's
mask as the step's own forward produced it (read by a hook for that step
only; relative L2), and the norm of the parameters' change over the
checked steps by its median leaf, leaving out leaves whose reference
gradient is nought to rounding (``reference.train.moved_leaves``): the
worst leaf's swings with the trajectories' drift over the later steps.
Printed beside them, not compared: each step's loss (its gap over the sum
of the terms' magnitudes; neither the control nor a fault reads the first
step's at three or ten times the sound runs), the worst change leaf, the
first gradient as AdamW took it (its first moment after one step) by its
worst and its median leaf, the cosine gaps of the first gradient and of
the change, and the reference's loss of the last checked step from the
program's own parameters before it, which tells a gap of the step's
arithmetic from the parameters' drift.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import counts, devtrace, inputs, program
from benchmark.harness import Check, Outcome
from benchmark.reference import exact_float32
from benchmark.reference import mixer as ref_mixer
from benchmark.reference import train as ref_train

BETA1 = 0.9


def noise_clips(gen, tr: dict, sample_rate: int, device) -> list:
    """Noise clips of random lengths: white noise under a slow envelope."""
    lo, hi = tr["noise_clip_seconds"]
    clips = []
    for _ in range(int(tr["noise_clips"])):
        r = torch.rand(3, generator=gen, device=device)
        n = int((lo + (hi - lo) * float(r[0])) * sample_rate)
        t = torch.arange(n, device=device) / sample_rate
        env = 0.6 + 0.4 * torch.sin(2 * np.pi * (0.2 + 1.8 * r[1]) * t + 6.0 * r[2])
        clips.append((0.2 * env * torch.randn(n, generator=gen, device=device)).cpu().numpy())
    return clips


def run(cell) -> Outcome:
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.train.loop import TrainState, make_optimizer
    from audiodenoiser_torch.train.mask import make_mask_steps

    cfg, tr, dev = cell.config, cell.traffic, cell.device
    sr = int(cfg["sample_rate"])
    rows, samples = int(tr["batch"]), int(round(tr["chunk_seconds"] * sr))
    gen = inputs.generator(cell.seed, dev)
    weights = inputs.make_weights(cfg, cell.seed, dev, cell)
    clean = inputs.speech_like(gen, int(tr["clean_chunks"]), samples, sr, dev)
    clips = noise_clips(gen, tr, sr, dev)
    cell.mark("weights and data made")
    mixer = OnDeviceMixer(np.zeros((1, samples), np.float32), tr["noise_type"],
                          noise_bank=NoiseBank(clips, target_len=samples, device=dev),
                          snr_db=float(tr["snr_db"]), sample_rate=sr, device=dev)
    mixer.clean = clean  # the chunks stay where they were made
    model = program.build_model(cfg, weights, dev, getattr(torch, cfg["train_dtype"]))
    names = [n for n, _ in model.named_parameters()]
    state = TrainState(model, make_optimizer(model.parameters(), float(tr["learning_rate"]),
                                             float(tr["weight_decay"]),
                                             float(tr["clip_norm"])))
    train_step, _ = make_mask_steps(float(tr["si_sdr_weight"]), float(tr["si_sdr_clamp"]))
    cell.mark("training state built")

    def step():
        draws = mixer.draw(gen, rows)
        noisy, clean_rows = mixer.sample_audio_from(draws)
        return draws, train_step(state, noisy, clean_rows)[1]

    def timed_step():
        with cell.span("step"):
            step()

    checked, losses, heads = [], [], []
    for k in range(int(tr["checked_steps"])):
        if k == int(tr["checked_steps"]) - 1:
            before_last = {n: p.detach().float().clone() for n, p in model.named_parameters()}
        hook = model.register_forward_hook(
            lambda _m, _i, out: heads.append(out.detach().float().clone())) if k == 0 else None
        draws, out = step()
        if hook is not None:
            hook.remove()
        checked.append({key: v.clone() for key, v in draws.items()})
        losses.append(out.total)
        if k == 0:  # the first gradient as AdamW took it: exp_avg = (1 - beta1) g
            moments = state.optimizer.adamw.state
            grad = {n: (moments[p]["exp_avg"] / (1.0 - BETA1) if p in moments
                        else torch.zeros_like(p)).detach().clone()
                    for n, p in model.named_parameters()}
    after = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    cell.mark("checked steps run")
    for _ in range(int(tr["warmup_steps"])):
        step()

    steps = 0
    t0 = cell.begin_window()
    while time.perf_counter() - t0 < cell.seconds:
        timed_step()
        steps += 1
    cell.sync()
    wall = time.perf_counter() - t0
    cell.record["counters"].update(
        window_s=wall, steps=steps,
        flops=steps * counts.train_step_flops(cfg, samples, rows))
    ends = np.cumsum(cell.record["spans"]["step"])
    cell.log("window samples/s by fifth: " + " ".join(
        f"{rows * int(((ends > wall * k / 5) & (ends <= wall * (k + 1) / 5)).sum()) * 5 / wall:.1f}"
        for k in range(5)))
    if cell.trace and cell.cuda:
        devtrace.profile(timed_step, int(tr["profile_steps"]), cell)
        cell.record["mixer_s"] = devtrace.event_seconds(
            lambda: mixer.sample_audio(gen, rows), int(tr["mixer_calls"]), dev)
    losses = [float(x) for x in losses]
    cell.read_peak()
    del state, model, mixer
    cell.free()

    batches = []
    for d in checked:
        c = clean[d["idx"].to(dev)]
        batches.append((ref_mixer.corrupt(c, d, clips, sr, float(tr["snr_db"])), c))
    with exact_float32():
        ref = ref_train.train_steps(weights, names, cfg, tr, batches)
        if cell.control:  # the reference in int8 in the program's place
            low = ref_train.train_steps(weights, names, cfg, tr, batches, precision="int8")
            losses, grad, after, heads = low["loss"], low["grad"], low["params"], [low["mask"]]
        with torch.no_grad():
            drift = float(ref_train.losses({**weights, **before_last}, cfg, tr,
                                           *batches[-1])[0])
    # a mask of another shape (rows left out) is no answer to the batch
    mask_gap = (float((heads[0] - ref["mask"]).norm() / ref["mask"].norm())
                if heads[0].shape == ref["mask"].shape else math.inf)
    loss_gaps = [abs(a - b) / s for a, b, s in zip(losses, ref["loss"], ref["scale"])]
    grad_gaps = ref_train.leaf_gaps(grad, ref["grad"], names)
    moved = ref_train.moved_leaves(ref["grad"], names)
    change = ({n: after[n] - weights[n] for n in moved},
              {n: ref["params"][n] - weights[n] for n in moved})
    change_gaps = ref_train.leaf_gaps(*change, moved)
    change_median = float(np.median(list(change_gaps.values())))
    grad_median = float(np.median(list(grad_gaps.values())))
    # 1 - cosine, whole and median leaf: they see direction, which the gaps of norms
    # do not; printed, not compared (no control or fault reads three times a sound run)
    direction = {
        "first_grad": ref_train.whole_cos_gap(grad, ref["grad"], moved),
        "first_grad_median_leaf": float(np.median(list(
            ref_train.cos_gaps(grad, ref["grad"], moved).values()))),
        "change": ref_train.whole_cos_gap(*change, moved),
        "change_median_leaf": float(np.median(list(
            ref_train.cos_gaps(*change, moved).values()))),
    }
    cell.log(f"check losses {losses} reference {ref['loss']}, gaps {loss_gaps}; the last "
             f"step's reference loss from the program's parameters before it {drift} "
             f"(gap {abs(losses[-1] - drift) / ref['scale'][-1]:.3e}); gradient leaves: "
             f"worst {ref_train.worst(grad_gaps)}, median {grad_median:.3e}; change "
             f"leaves: worst {ref_train.worst(change_gaps)}, median {change_median:.3e}; "
             f"{len(names) - len(moved)} leaves left out of the change; cosine gaps "
             f"{direction}")
    lim = cell.limits
    return Outcome(
        e2e={"train_samples_per_s": steps * rows / wall}, attempted=steps * rows, failed=0,
        checks=[Check("first_mask_gap", mask_gap, float(lim["first_mask_gap"])),
                Check("change_median_leaf_gap", change_median,
                      float(lim["change_median_leaf_gap"]))])
