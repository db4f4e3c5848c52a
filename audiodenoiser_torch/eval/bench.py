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
  python -m audiodenoiser_torch.eval.bench --width_mult 0.25 [--no-fold]
  python -m audiodenoiser_torch.eval.bench --mode int8

prints one JSON line naming the card and its power limit, with the other
legs beside the batch numbers (each can be left out): the training leg
(``run_train_bench``: the full-width bf16 U-Net's train step at batch 256
on fixed crops, ``train_samples_per_sec``, ``train_step_ms``,
``train_tflops_per_sec`` from ``FlopCounterMode``, peak memory and the
device's idle share), the compact student at ``width_mult`` 0.25 in the
run's mode (``student_frames_per_sec``, only beside a full-width
headline), and the stream benches: a WOLA session
at 8 kHz and at 16 kHz (``stream16k_*``; 1 s packets, its realtime
factor, wall ms a packet and device ms a window step), and pools of 8 and
64 lockstep streams (``stream_pool{,64}_*``: aggregate realtime factor,
ms a tick), at the run's ``--width_mult``; beside a full-width headline
the JAX bench's variant legs: the s2d stem and the s2d stem with a
16-channel refinement path in the run's mode and fold
(``s2d_frames_per_sec``, ``s2d_skip16_frames_per_sec``), the s2d training
leg (``s2d_train_*``) and int8 compute (``int8_frames_per_sec``, with its
peak memory); ``--no_s2d`` and ``--no_int8`` leave them out. ``--width_mult`` scales the
U-Net's channels (``models.unet.scaled_widths``); ``--no-fold`` serves the
live-BN bf16 model instead of the folded one. With
``--pallas_deconv`` the U-Net is the live-BN bf16 one, unfolded, whose
four upsamplings run through the K3 kernel, as the JAX bench's option of
that name runs its Pallas deconv. ``--mode complex_mask`` runs the
BN-folded bf16 ``ComplexMaskUNet`` (31,043,586 parameters, mask bound 2)
in ``complex_mask`` mode: the same STFT and iSTFT kernels, a 3-channel
input and a 2-channel tanh mask. ``--mode int8`` runs ``Int8UNet``
(``models.int8``: BN folded, int8 weights and activations, int32 products
through ``torch._int_mm``) in ``noisy_phase`` mode.
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
                 mode: str = "noisy_phase", width_mult: float = 1.0, fold: bool = True,
                 s2d: bool = False, s2d_skip: int = 0, attn: bool = False):
    """A runner over the folded U-Net at ``width_mult`` with seeded random
    weights (with ``pallas_deconv`` or ``fold=False``: the live-BN U-Net,
    unfolded, with K3 for ``pallas_deconv``; with ``mode="complex_mask"``:
    the ``ComplexMaskUNet``; with ``mode="int8"``: ``Int8UNet`` in
    ``noisy_phase`` mode). ``s2d``, ``s2d_skip`` and ``attn`` build the
    variant (``s2d_stem``, ``s2d_skip``, ``attn_bottleneck``)."""
    from audiodenoiser_torch.eval.runner import MODES, DenoiserRunner
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        UNet,
        fold_for_inference,
        load_flax_variables,
        prepare_int8,
        random_flax_variables,
        width_kwargs,
    )

    if mode not in (*MODES, "int8"):
        raise ValueError(f"mode must be one of {(*MODES, 'int8')}, got {mode!r}")
    device = resolve_device(device)
    widths = width_kwargs(width_mult)
    variant = dict(s2d_stem=s2d, s2d_skip=s2d_skip, attn_bottleneck=attn)
    if mode == "complex_mask":
        model = ComplexMaskUNet(dtype=dtype, pallas_deconv=pallas_deconv, **widths, **variant)
        variables = random_flax_variables(seed, **widths, in_channels=3, out_channels=2,
                                          **variant)
    else:
        model = UNet(dtype=dtype, pallas_deconv=pallas_deconv, **widths, **variant)
        variables = random_flax_variables(seed, **widths, **variant)
    load_flax_variables(model, variables)
    if mode == "int8":
        return DenoiserRunner(prepare_int8(model.eval().to(device)), device=device)
    if pallas_deconv or not fold:  # K3 lives in the module a fold would replace
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
              pallas_deconv: bool = False, mode: str = "noisy_phase",
              width_mult: float = 1.0, fold: bool = True, s2d: bool = False,
              s2d_skip: int = 0, attn: bool = False) -> dict:
    """Frames/s of the fused path in ``mode`` at ``width_mult`` and variant
    (``build_runner``), with the peak memory of the timed batches on the
    card; with ``profile_iters`` > 0 (CUDA only) also a
    ``device_breakdown`` of that many further batches."""
    device = resolve_device(device)
    fold = fold and not pallas_deconv and mode != "int8"
    runner = build_runner(seed, device=device, pallas_deconv=pallas_deconv, mode=mode,
                          width_mult=width_mult, fold=fold, s2d=s2d, s2d_skip=s2d_skip,
                          attn=attn)
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
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
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
        " int8 compute" if mode == "int8"
        else " live-BN bf16 with the K3 deconv" if pallas_deconv
        else " BN-folded bf16" if fold else " live-BN bf16")
    if width_mult != 1.0:
        net += f" at width {width_mult:g}"
    if s2d:
        net += " with the s2d stem" + (f" and s2d_skip {s2d_skip}" if s2d_skip else "")
    if attn:
        net += " with the attention bottleneck"
    result = {
        "metric": f"spectrogram_frames_per_sec (STFT->{net}->iSTFT, {mode})",
        "value": frames / dt,
        "unit": "frames/s",
        "batch_size": batch_size,
        "clip_seconds": clip_seconds,
        "iters": iters,
        "pipelined": pipelined,
        "pallas_deconv": pallas_deconv,
        "fold": fold,
        "width_mult": width_mult,
        "s2d": s2d,
        "s2d_skip": s2d_skip if s2d else 0,
        "attn": attn,
        "mode": mode,
        "batch_ms": dt / iters * 1e3,
        "device": device_name(device),
        "card": card_info() if device.type == "cuda" else "cpu",
    }
    if device.type == "cuda":
        result["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    if profile_iters and device.type == "cuda":
        result["profile"] = device_breakdown(lambda: runner.denoise_audio(audio),
                                             profile_iters, device)
    return result


def run_train_bench(batch_size: int = 256, iters: int = 10, warmup: int = 2,
                    seed: int = 0, device: DeviceLike = None,
                    profile_iters: int = 0, s2d: bool = False) -> dict:
    """The training leg of the JAX bench: the full-width bf16 U-Net's
    ``train_step`` (forward, combined loss, backward, clip, AdamW) on fixed
    |N(0, 1)| (256, 64) crops with clean = 0.8 x noisy, ``iters`` steps
    after ``warmup``, one synchronise at the end: ``train_samples_per_sec``,
    ``train_step_ms``, ``train_tflops_per_sec`` (the operations of one
    warm-up step as ``FlopCounterMode`` counts them) and on the card the
    peak memory of the timed steps; with ``profile_iters`` (CUDA only) the
    device's busy time and idle share over that many further steps. With
    ``s2d`` the U-Net has the s2d stem and the keys start ``s2d_train_``."""
    from torch.utils.flop_counter import FlopCounterMode

    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    device = resolve_device(device)
    state = create_train_state(seed, UNet(dtype=torch.bfloat16, s2d_stem=s2d), device=device)
    rng = np.random.default_rng(seed)
    noisy = torch.from_numpy(np.abs(rng.standard_normal((batch_size, 1, 256, 64)))
                             .astype(np.float32)).to(device)
    clean = noisy * 0.8

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def step():
        return train_step(state, noisy, clean)[1]

    with FlopCounterMode(display=False) as counter:
        step()
    flops = counter.get_total_flops()
    for _ in range(warmup - 1):
        step()
    sync()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        losses = step()
    sync()
    dt = time.perf_counter() - t0
    pre = "s2d_train" if s2d else "train"
    out = {f"{pre}_samples_per_sec": batch_size * iters / dt,
           f"{pre}_step_ms": dt / iters * 1e3,
           f"{pre}_batch_size": batch_size,
           f"{pre}_last_loss": float(losses.total)}
    if flops:
        out[f"{pre}_tflops_per_sec"] = flops * iters / dt / 1e12
    if device.type == "cuda":
        out[f"{pre}_peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        if profile_iters:
            prof = device_breakdown(step, profile_iters, device)
            out[f"{pre}_device_busy_ms"] = prof["device_busy_ms"]
            out[f"{pre}_idle_share"] = prof.get("idle_share", "not measured")
            out[f"{pre}_profile_wall_ms"] = prof["wall_ms"]
            out[f"{pre}_profile_top"] = prof.get("top", [])
    return out


def _stream_audio(rng, n: int) -> np.ndarray:
    return np.clip(0.2 * rng.standard_normal(n), -1, 1).astype(np.float32)


def run_stream_bench(packet_seconds: float = 1.0, total_seconds: float = 10.0,
                     sample_rate: int = 8000, prefix: str = "stream", seed: int = 0,
                     device: DeviceLike = None, profile_iters: int = 0) -> dict:
    """A WOLA session (chunk one packet) over the full-width folded bf16
    U-Net: ``{prefix}_realtime_factor`` (seconds of audio a wall second,
    ``total_seconds`` pushed in ``packet_seconds`` packets and flushed),
    ``{prefix}_packet_ms`` (wall ms a packet) and
    ``{prefix}_step_compute_ms`` (30 window steps chained on the device,
    one synchronise: the time a step); with ``profile_iters`` (CUDA only)
    ``{prefix}_step_profile``, a ``device_breakdown`` of that many steps."""
    from audiodenoiser_torch.eval.streaming import StreamingDenoiser

    device = resolve_device(device)
    runner = build_runner(seed, device=device)
    chunk = int(packet_seconds * sample_rate)
    chunk -= chunk % 2  # WOLA needs an even chunk
    streamer = StreamingDenoiser(runner, chunk_samples=chunk, sample_rate=sample_rate)
    sess = streamer.session()
    rng = np.random.default_rng(seed)
    packet = _stream_audio(rng, chunk)
    sess.process(packet)  # warm-up: the first packet builds the kernels
    n = max(1, int(total_seconds / packet_seconds))
    t0 = time.perf_counter()
    for _ in range(n):
        sess.process(packet)
    sess.flush()
    dt = time.perf_counter() - t0
    out = {f"{prefix}_realtime_factor": n * packet_seconds / dt,
           f"{prefix}_packet_ms": dt / n * 1e3}
    hop = torch.from_numpy(_stream_audio(rng, streamer.hop)).to(device)
    with torch.inference_mode():
        state, o = streamer.step(streamer.initial_state(), hop)
        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
        sync()
        k = 30
        t0 = time.perf_counter()
        for _ in range(k):  # each step takes the state the last one left
            state, o = streamer.step(state, hop)
        sync()
        out[f"{prefix}_step_compute_ms"] = (time.perf_counter() - t0) / k * 1e3
        if profile_iters and device.type == "cuda":
            out[f"{prefix}_step_profile"] = device_breakdown(
                lambda: streamer.step(state, hop), profile_iters, device)
    return out


def run_multistream_bench(streams: int = 8, chunk: int = 16000, ticks: int = 10,
                          sample_rate: int = 8000, prefix: str = "stream_pool",
                          seed: int = 0, device: DeviceLike = None,
                          profile_iters: int = 0, width_mult: float = 1.0) -> dict:
    """``streams`` lockstep streams in one ``MultiStreamWola`` of that
    capacity over the folded bf16 U-Net at ``width_mult``, one hop each a tick:
    ``{prefix}_aggregate_rtf`` (seconds of audio a wall second over all
    streams) and ``{prefix}_tick_ms``; with ``profile_iters`` (CUDA only)
    ``{prefix}_tick_profile``, a ``device_breakdown`` of that many ticks."""
    from audiodenoiser_torch.eval.streaming import MultiStreamWola

    device = resolve_device(device)
    runner = build_runner(seed, device=device, width_mult=width_mult)
    pool = MultiStreamWola(runner, capacity=streams, chunk_samples=chunk,
                           sample_rate=sample_rate)
    rng = np.random.default_rng(seed)
    feed = {pool.open(): _stream_audio(rng, pool.hop) for _ in range(streams)}
    for _ in range(3):
        pool.process(feed)  # warm-up
    t0 = time.perf_counter()
    for _ in range(ticks):
        pool.process(feed)  # ends in a copy of the outputs to the host
    dt = (time.perf_counter() - t0) / ticks
    out = {f"{prefix}_streams": streams,
           f"{prefix}_aggregate_rtf": streams * pool.hop / sample_rate / dt,
           f"{prefix}_tick_ms": dt * 1e3}
    if profile_iters and device.type == "cuda":
        out[f"{prefix}_tick_profile"] = device_breakdown(lambda: pool.process(feed),
                                                         profile_iters, device)
    return out


def stream_benches(no_stream: bool = False, no_stream16k: bool = False,
                   no_pool: bool = False, no_pool64: bool = False,
                   device: DeviceLike = None, profile_iters: int = 0,
                   width_mult: float = 1.0) -> dict:
    """The stream benches that are not left out, as ``main`` runs them:
    the sessions at full width, the pools at ``width_mult``, as in the JAX
    bench."""
    kw = dict(device=device, profile_iters=profile_iters)
    out = {}
    if not no_stream:
        out.update(run_stream_bench(**kw))
    if not no_stream16k:
        out.update(run_stream_bench(sample_rate=16000, prefix="stream16k", **kw))
    if not no_pool:
        out.update(run_multistream_bench(width_mult=width_mult, **kw))
    if not no_pool64:
        out.update(run_multistream_bench(streams=64, ticks=5, prefix="stream_pool64",
                                         width_mult=width_mult, **kw))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--clip_seconds", type=float, default=2.0)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--latency", action="store_true",
                   help="synchronise after every batch instead of pipelining")
    p.add_argument("--pallas_deconv", action="store_true",
                   help="the live-BN U-Net with the K3 deconv kernel, unfolded")
    p.add_argument("--mode", choices=["noisy_phase", "complex_mask", "int8"],
                   default="noisy_phase",
                   help="complex_mask: the folded ComplexMaskUNet in its own mode; int8: "
                   "Int8UNet (int8 compute) in noisy_phase mode")
    p.add_argument("--no_stream", action="store_true",
                   help="leave out the 8 kHz stream bench")
    p.add_argument("--no_stream16k", action="store_true",
                   help="leave out the 16 kHz stream bench")
    p.add_argument("--no_pool", action="store_true",
                   help="leave out the 8-stream pool bench")
    p.add_argument("--no_pool64", action="store_true",
                   help="leave out the 64-stream pool bench")
    p.add_argument("--no_train", action="store_true", help="leave out the training leg")
    p.add_argument("--train_batch_size", type=int, default=256)
    p.add_argument("--no_student", action="store_true",
                   help="leave out the compact student (width 0.25) beside the headline")
    p.add_argument("--no_s2d", action="store_true",
                   help="leave out the s2d stem legs (s2d, s2d_skip 16, the s2d training leg)")
    p.add_argument("--no_int8", action="store_true", help="leave out the int8 compute leg")
    p.add_argument("--width_mult", type=float, default=1.0,
                   help="bench a width-scaled compact student instead of the 31M U-Net")
    p.add_argument("--fold", action=argparse.BooleanOptionalAction, default=True,
                   help="fold eval-mode BatchNorm into the convs (the serving path); "
                   "--no-fold measures the live-BN model")
    args = p.parse_args(argv)
    result = run_bench(args.batch_size, args.clip_seconds, args.iters,
                       pipelined=not args.latency, pallas_deconv=args.pallas_deconv,
                       mode=args.mode, width_mult=args.width_mult, fold=args.fold)
    if not args.no_train:
        result.update(run_train_bench(args.train_batch_size, profile_iters=3))
    result.update(stream_benches(args.no_stream, args.no_stream16k, args.no_pool,
                                 args.no_pool64, width_mult=args.width_mult))
    if not args.no_student and args.width_mult == 1.0:
        student = run_bench(args.batch_size, args.clip_seconds, max(5, args.iters // 2),
                            pipelined=not args.latency, mode=args.mode, width_mult=0.25)
        result["student_width_mult"] = 0.25
        result["student_frames_per_sec"] = student["value"]
    if not args.no_s2d and args.width_mult == 1.0:
        # int8 compute covers the plain U-Net only: its s2d legs run bf16
        mode = "noisy_phase" if args.mode == "int8" else args.mode
        for key, skip in (("s2d_frames_per_sec", 0), ("s2d_skip16_frames_per_sec", 16)):
            leg = run_bench(args.batch_size, args.clip_seconds, max(5, args.iters // 2),
                            pipelined=not args.latency, mode=mode, fold=args.fold,
                            s2d=True, s2d_skip=skip)
            result[key] = leg["value"]
        if not args.no_train:
            result.update(run_train_bench(args.train_batch_size, s2d=True))
    if not args.no_int8 and args.width_mult == 1.0:
        leg = run_bench(args.batch_size, args.clip_seconds, max(5, args.iters // 2),
                        pipelined=not args.latency, mode="int8")
        result["int8_frames_per_sec"] = leg["value"]
        if "peak_memory_gib" in leg:
            result["int8_peak_memory_gib"] = leg["peak_memory_gib"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
