"""Throughput of the full training step on the GPU.

One step is what ``fit`` runs per batch on the on-device pipeline: the
mixer draws a batch of 2 s chunks, corrupts them with white noise and
takes both STFTs (K1), then ``train_step`` runs the U-Net forward in train
mode (bf16, K3 upsamplings), the combined loss, the backward, the clip
and AdamW. Weights come from Flax's initialisers, the clean chunks from a
seed; the step rate is the mean over ``steps`` steps after ``warmup``,
ended by one synchronise.

  python -m audiodenoiser_torch.train.bench --batch_size 16 --steps 20

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


def run_train_bench(batch_size: int = 16, steps: int = 20, warmup: int = 3,
                    seed: int = 0, device: DeviceLike = None,
                    profile_iters: int = 0) -> dict:
    """Steps/s and samples/s of mixer + train step; with ``profile_iters``
    > 0 (CUDA only) also a ``device_breakdown`` of that many further steps."""
    from audiodenoiser_torch.data.pipeline import OnDeviceMixer
    from audiodenoiser_torch.eval.bench import card_info, device_breakdown
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    device = resolve_device(device)
    mixer = OnDeviceMixer(synth_chunks(64, seed), "white", device=device)
    state = create_train_state(seed, UNet(dtype=torch.bfloat16, pallas_deconv=True),
                               device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step():
        noisy, clean = mixer.sample(gen, batch_size)
        return train_step(state, noisy, clean)[1]

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
        "metric": "training samples/s (on-device mixer + bf16 train step, "
                  "full-width UNet with K3)",
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
    args = p.parse_args(argv)
    out = run_train_bench(args.batch_size, args.steps, profile_iters=args.profile_iters)
    if "profile" in out:
        out["profile"]["top"] = out["profile"]["top"][:15]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
