"""Throughput of the full training step on the GPU, for both families.

One step is what ``fit`` runs per batch on the on-device pipeline.
``run_train_bench``, the magnitude U-Net: the mixer draws a batch of 2 s
chunks, corrupts them with white noise and takes both STFTs (K1), then
``train_step`` runs the U-Net forward in train mode (bf16, K3
upsamplings), the combined loss, the backward, the clip and AdamW.
``run_mask_train_bench``, the complex-mask U-Net of the recommended
deployment: the ``mixed`` mixer (all four corruptions, noise clips from a
seed) draws raw waveforms, then the mask step takes both STFTs (one K1
launch), the bf16 residual ``ComplexMaskUNet`` (bound 8, K3), the mask,
the spectral loss, the iSTFT (K2), the waveform L1 and clamped SI-SDR
terms, the backward (K2's through K1), the clip and AdamW. Weights come
from Flax's initialisers, the clean chunks from a seed; the step rate is
the mean over ``steps`` steps after ``warmup``, ended by one synchronise.

  python -m audiodenoiser_torch.train.bench --batch_size 16 --steps 20 [--model complex_mask]

prints one JSON line naming the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from audiodenoiser_torch.device import DeviceLike, device_name, resolve_device


def synth_chunks(n: int, seed: int = 0, sr: int = 8000) -> np.ndarray:
    """Seeded 2 s "speech-like" chunks: a few harmonics of a random pitch
    under a slow amplitude envelope, plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(2 * sr) / sr
    out = np.zeros((n, 2 * sr), np.float32)
    for i in range(n):
        f0 = rng.uniform(90, 260)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t + rng.uniform(0, 6))
        wave = sum(rng.uniform(0.2, 1.0) / k * np.sin(2 * np.pi * k * f0 * t)
                   for k in range(1, 6))
        out[i] = 0.25 * env * wave + 0.01 * rng.standard_normal(t.size)
    return np.clip(out, -1, 1).astype(np.float32)


def synth_noise_clips(n: int, seed: int = 0, sr: int = 8000) -> list:
    """Seeded noise clips of 1 to 5 s for a ``NoiseBank``: white noise
    under a slow random envelope, some shorter than a 2 s chunk (tiled),
    some longer (a random start per draw)."""
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(n):
        t = np.arange(int(rng.uniform(1.0, 5.0) * sr)) / sr
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
        clips.append((0.2 * env * rng.standard_normal(t.size)).astype(np.float32))
    return clips


def run_train_bench(batch_size: int = 16, steps: int = 20, warmup: int = 3,
                    seed: int = 0, device: DeviceLike = None,
                    profile_iters: int = 0) -> dict:
    """Steps/s and samples/s of mixer + train step; with ``profile_iters``
    > 0 (CUDA only) also a ``device_breakdown`` of that many further steps."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    device = resolve_device(device)
    mixer = OnDeviceMixer(synth_chunks(64, seed), "white", device=device)
    state = create_train_state(seed, UNet(dtype=torch.bfloat16, pallas_deconv=True),
                               device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def step():
        noisy, clean = mixer.sample(gen, batch_size)
        return train_step(state, noisy, clean)[1]

    return _time_steps(step, "training samples/s (on-device mixer + bf16 train step, "
                       "full-width UNet with K3)", batch_size, steps, warmup, device,
                       profile_iters)


def run_mask_train_bench(batch_size: int = 16, steps: int = 20, warmup: int = 3,
                         seed: int = 0, device: DeviceLike = None,
                         profile_iters: int = 0) -> dict:
    """Steps/s and samples/s of the ``mixed`` mixer + one bf16 mask train
    step (the full-width residual ``ComplexMaskUNet`` with K3, bound 8,
    SI-SDR weight 0.5, clamp 30 dB); ``profile_iters`` as in
    ``run_train_bench``."""
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    device = resolve_device(device)
    bank = NoiseBank(synth_noise_clips(8, seed + 1), device=device)
    mixer = OnDeviceMixer(synth_chunks(64, seed), "mixed", noise_bank=bank, device=device)
    model = ComplexMaskUNet(dtype=torch.bfloat16, pallas_deconv=True, mask_bound=8.0,
                            residual=True, zero_out_init=True)
    state = create_mask_train_state(seed, model, device=device)
    train_step, _ = make_mask_steps(0.5, 30.0)
    gen = torch.Generator(device=device).manual_seed(seed)

    def step():
        noisy, clean = mixer.sample_audio(gen, batch_size)
        return train_step(state, noisy, clean)[1]

    return _time_steps(step, "mask training samples/s (mixed on-device mixer + bf16 mask "
                       "train step, full-width residual ComplexMaskUNet with K1, K2, K3)",
                       batch_size, steps, warmup, device, profile_iters)


def _time_steps(step, metric: str, batch_size: int, steps: int, warmup: int,
                device: torch.device, profile_iters: int) -> dict:
    """The step rate of ``step`` (which returns its losses) after
    ``warmup`` steps, and on the card its peak memory and, with
    ``profile_iters``, a ``device_breakdown`` of that many further steps."""
    from audiodenoiser_torch.eval.bench import card_info, device_breakdown

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        step()
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        losses = step()
    sync()
    dt = (time.perf_counter() - t0) / steps
    result = {
        "metric": metric,
        "value": batch_size / dt,
        "unit": "samples/s",
        "steps_per_sec": 1.0 / dt,
        "step_ms": dt * 1e3,
        "batch_size": batch_size,
        "steps": steps,
        "last_loss": float(losses.total),
        "device": device_name(device),
        "card": card_info() if device.type == "cuda" else "cpu",
    }
    if device.type == "cuda":
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        if profile_iters:
            result["profile"] = device_breakdown(step, profile_iters, device, top=400)
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--profile_iters", type=int, default=0)
    p.add_argument("--model", choices=["unet", "complex_mask"], default="unet")
    args = p.parse_args(argv)
    bench = run_mask_train_bench if args.model == "complex_mask" else run_train_bench
    out = bench(args.batch_size, args.steps, profile_iters=args.profile_iters)
    if "profile" in out:
        out["profile"]["top"] = out["profile"]["top"][:15]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
