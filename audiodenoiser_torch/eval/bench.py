"""Throughput of the fused STFT -> BN-folded U-Net -> iSTFT path on the GPU.

Counterpart of ``audiodenoiser_tpu.eval.bench.run_bench`` in
``noisy_phase`` mode: 2 s clips at 8 kHz through the full-width
31,042,369-parameter U-Net in bf16, pipelined (the device queue kept full,
one synchronise at the end), reported as spectrogram frames per second
with ``frames = 1 + samples // hop`` per clip. Weights are seeded random
weights with non-trivial BatchNorm statistics, carried across from the
Flax tree layout by ``models.convert``.

  python -m audiodenoiser_torch.eval.bench --batch_size 256 [--pallas_deconv]
  python -m audiodenoiser_torch.eval.bench --mode complex_mask

prints one JSON line naming the card and its power limit. With
``--pallas_deconv`` the U-Net is the live-BN bf16 one, unfolded, whose
four upsamplings run through the K3 kernel, as the JAX bench's option of
that name runs its Pallas deconv. ``--mode complex_mask`` runs the
BN-folded bf16 ``ComplexMaskUNet`` (31,043,586 parameters, mask bound 2)
in ``complex_mask`` mode: the same STFT and iSTFT kernels, a 3-channel
input and a 2-channel tanh mask.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from audiodenoiser_torch.device import DeviceLike, device_name, resolve_device


def card_info() -> str:
    """The first card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    return out.strip().splitlines()[0]


def build_runner(seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None, pallas_deconv: bool = False,
                 mode: str = "noisy_phase"):
    """A runner over the full-width folded U-Net with seeded random weights
    (with ``pallas_deconv``: the live-BN U-Net with K3, unfolded; with
    ``mode="complex_mask"``: the folded ``ComplexMaskUNet``)."""
    from audiodenoiser_torch.eval.runner import MODES, DenoiserRunner
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        UNet,
        fold_for_inference,
        load_flax_variables,
        random_flax_variables,
    )

    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    device = resolve_device(device)
    if mode == "complex_mask":
        model = ComplexMaskUNet(dtype=dtype, pallas_deconv=pallas_deconv)
        variables = random_flax_variables(seed, in_channels=3, out_channels=2)
    else:
        model = UNet(dtype=dtype, pallas_deconv=pallas_deconv)
        variables = random_flax_variables(seed)
    load_flax_variables(model, variables)
    if pallas_deconv:  # the kernel lives in the module a fold would replace
        return DenoiserRunner(model.eval(), device=device)
    return DenoiserRunner(fold_for_inference(model.eval(), dtype), device=device)


def device_breakdown(fn, iters: int, device: torch.device, top: int = 8) -> dict:
    """Run ``fn`` ``iters`` times under ``torch.profiler`` and sum device
    time by kernel name: per-call ms of the ``top`` kernels, the device's
    busy time and its idle share of the wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for e in prof.key_averages():
        # a user annotation (e.g. "Optimizer.step#AdamW.step") spans the
        # kernels under it: counting it too would count them twice
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / iters
    busy_ms = sum(kernels.values())
    if busy_ms == 0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "top": [{"kernel": k[:90], "ms": v, "share": v / busy_ms}
                for k, v in ranked[:top]],
    }


def run_bench(batch_size: int = 256, clip_seconds: float = 2.0, iters: int = 20,
              warmup: int = 3, pipelined: bool = True, seed: int = 0,
              device: DeviceLike = None, profile_iters: int = 0,
              pallas_deconv: bool = False, mode: str = "noisy_phase") -> dict:
    """Frames/s of the fused path in ``mode``; with ``profile_iters`` > 0
    (CUDA only) also a ``device_breakdown`` of that many further batches."""
    device = resolve_device(device)
    runner = build_runner(seed, device=device, pallas_deconv=pallas_deconv, mode=mode)
    sr, hop = 8000, runner.hop
    n_samples = int(sr * clip_seconds)
    rng = np.random.default_rng(seed)
    audio = torch.from_numpy(np.clip(
        rng.standard_normal((batch_size, n_samples)) * 0.2, -1, 1
    ).astype(np.float32)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        runner.denoise_audio(audio)
    sync()
    t0 = time.perf_counter()
    if pipelined:
        outs = [runner.denoise_audio(audio) for _ in range(iters)]
        sync()
        del outs
    else:  # per-batch latency: a barrier every iteration
        for _ in range(iters):
            runner.denoise_audio(audio)
            sync()
    dt = time.perf_counter() - t0
    frames = batch_size * (1 + n_samples // hop) * iters
    net = ("ComplexMaskUNet" if mode == "complex_mask" else "UNet") + (
        " live-BN bf16 with the K3 deconv" if pallas_deconv else " BN-folded bf16")
    result = {
        "metric": f"spectrogram_frames_per_sec (STFT->{net}->iSTFT, {mode})",
        "value": frames / dt,
        "unit": "frames/s",
        "batch_size": batch_size,
        "clip_seconds": clip_seconds,
        "iters": iters,
        "pipelined": pipelined,
        "pallas_deconv": pallas_deconv,
        "mode": mode,
        "batch_ms": dt / iters * 1e3,
        "device": device_name(device),
        "card": card_info() if device.type == "cuda" else "cpu",
    }
    if profile_iters and device.type == "cuda":
        result["profile"] = device_breakdown(lambda: runner.denoise_audio(audio),
                                             profile_iters, device)
    return result


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--clip_seconds", type=float, default=2.0)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--latency", action="store_true",
                   help="synchronise after every batch instead of pipelining")
    p.add_argument("--pallas_deconv", action="store_true",
                   help="the live-BN U-Net with the K3 deconv kernel, unfolded")
    p.add_argument("--mode", choices=["noisy_phase", "complex_mask"], default="noisy_phase",
                   help="complex_mask: the folded ComplexMaskUNet in its own mode")
    args = p.parse_args(argv)
    print(json.dumps(run_bench(args.batch_size, args.clip_seconds, args.iters,
                               pipelined=not args.latency,
                               pallas_deconv=args.pallas_deconv, mode=args.mode)))


if __name__ == "__main__":
    main()
