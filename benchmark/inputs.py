"""Weights and audio made from the run's seed, on the device, in a few
large calls. Both sides of the check (the program and the reference) are
handed the same tensors.

Weights follow the reference model's state_dict names
(jimonld2000/AudioDenoiser ``code/model.py``): ``downconv{k}.conv.
double_conv.{0,1,3,4}``, ``bottleneck.double_conv.*``, ``upconv{k}.up``,
``upconv{k}.conv.double_conv.*``, ``out``. Kernels are He-scaled;
BatchNorm has non-trivial scales and shifts, and its running statistics
are those of a calibration batch of the configuration's own inputs
(noisy speech through the reference in float32), as a trained network's
are, so that eval-mode activations stay of order one through the full
depth and a mask head is not driven into its bound; the head is nonzero,
so neither the fold nor the mask is a pass-through.
"""

from __future__ import annotations

import contextlib
import math

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def weight_layout(config: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every state_dict entry of the configuration's
    U-Net, in order."""
    feats, bottleneck = list(config["features"]), int(config["bottleneck"])
    k = int(config["kernel_size"])
    out: list = []

    def double(prefix, cin, cout):
        for ci, bi, c in ((0, 1, cin), (3, 4, cout)):
            out.append((f"{prefix}.double_conv.{ci}.weight", (cout, c, k, k), "conv"))
            out.append((f"{prefix}.double_conv.{ci}.bias", (cout,), "bias"))
            for stat in ("weight", "bias", "running_mean", "running_var"):
                out.append((f"{prefix}.double_conv.{bi}.{stat}", (cout,), f"bn_{stat}"))
            out.append((f"{prefix}.double_conv.{bi}.num_batches_tracked", (), "count"))

    cin = int(config["in_channels"])
    for i, f in enumerate(feats, start=1):
        double(f"downconv{i}.conv", cin, f)
        cin = f
    double("bottleneck", cin, bottleneck)
    cin = bottleneck
    d = int(config["deconv_kernel"])
    for i, f in enumerate(reversed(feats), start=1):
        out.append((f"upconv{i}.up.weight", (cin, f, d, d), "deconv"))
        out.append((f"upconv{i}.up.bias", (f,), "bias"))
        double(f"upconv{i}.conv", 2 * f, f)
        cin = f
    out.append(("out.weight", (int(config["out_channels"]), cin, 1, 1), "conv"))
    out.append(("out.bias", (int(config["out_channels"]),), "bias"))
    return out


def make_weights(config: dict, seed: int, device, cell=None) -> dict[str, torch.Tensor]:
    """The configuration's seeded float32 weights on ``device``: one normal
    draw for all of them, cut and scaled per entry. Given the run's
    ``cell``, the calibration (the reference's forward) is left out of its
    ``setup_s``."""
    layout = weight_layout(config)
    total = sum(math.prod(s) for _, s, kind in layout if kind != "count")
    draw = torch.randn(total, generator=generator(seed, device), device=device)
    out, pos = {}, 0
    for name, shape, kind in layout:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        x = draw[pos:pos + n].view(shape)
        pos += n
        if kind == "conv":
            x = x * math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
        elif kind == "deconv":
            x = x * math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
        elif kind == "bias":
            x = 0.1 * x
        elif kind == "bn_weight":
            x = 1.0 + 0.2 * x
        elif kind == "bn_bias":
            x = 0.3 * x
        elif kind == "bn_running_mean":  # until the calibration sets them
            x = torch.zeros_like(x)
        elif kind == "bn_running_var":
            x = torch.ones_like(x)
        out[name] = x.clone()
    with contextlib.nullcontext() if cell is None else cell.outside_setup():
        _calibrate(config, out, seed, device)
    return out


CALIBRATION_CLIPS = 16


def _calibrate(config: dict, weights: dict, seed: int, device) -> None:
    """Set every BatchNorm's running statistics, in place, to the batch
    statistics of ``CALIBRATION_CLIPS`` 2 s clips of noisy speech (0-10 dB)
    drawn from a generator of their own."""
    from benchmark.reference import exact_float32
    from benchmark.reference import dsp
    from benchmark.reference import unet as ref_unet

    sr, n_fft, hop = (int(config[k]) for k in ("sample_rate", "n_fft", "hop_length"))
    gen = generator(seed + 1, device)
    audio = noisy_speech(gen, CALIBRATION_CLIPS, 2 * sr, sr, (0.0, 10.0), device)
    with torch.no_grad(), exact_float32():
        mag, phase = dsp.magphase(dsp.stft(audio, n_fft, hop))
        x = (mag[:, None] if config["mode"] == "noisy_phase"
             else torch.stack([mag, phase.real, phase.imag], dim=1))
        ref_unet.forward(weights, config, x, train="calibrate")
    if torch.device(device).type == "cuda":  # the calibration's memory is not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def speech_like(gen: torch.Generator, rows: int, samples: int, sample_rate: int,
                device, block: int = 1024) -> torch.Tensor:
    """(rows, samples) float32 "speech-like" clips: five harmonics of a
    pitch in 90-260 Hz under a slow amplitude envelope, plus a little
    noise, made in blocks of ``block`` rows."""
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    out = torch.empty((rows, samples), device=device)
    two_pi = 2.0 * math.pi
    for s in range(0, rows, block):
        b = min(block, rows - s)
        r = torch.rand((b, 16), generator=gen, device=device)
        f0 = 90.0 + 170.0 * r[:, :1]
        env = 0.5 + 0.5 * torch.sin(two_pi * (1.0 + 3.0 * r[:, 1:2]) * t + 6.0 * r[:, 2:3])
        wave = torch.zeros((b, samples), device=device)
        for h in range(1, 6):
            amp = (0.2 + 0.8 * r[:, 2 + h:3 + h]) / h
            wave += amp * torch.sin(two_pi * h * f0 * t + 6.0 * r[:, 8 + h:9 + h])
        noise = torch.randn((b, samples), generator=gen, device=device)
        out[s:s + b] = (0.25 * env * wave + 0.01 * noise).clamp(-1.0, 1.0)
    return out


def add_white_noise(gen: torch.Generator, clean: torch.Tensor,
                    snr_db: tuple[float, float]) -> torch.Tensor:
    """``clean`` plus white noise at a per-row SNR drawn in ``snr_db``, clipped."""
    lo, hi = snr_db
    snr = lo + (hi - lo) * torch.rand((clean.shape[0], 1), generator=gen,
                                      device=clean.device)
    noise = torch.randn(clean.shape, generator=gen, device=clean.device)
    c_rms = clean.square().mean(-1, keepdim=True).sqrt()
    n_rms = noise.square().mean(-1, keepdim=True).sqrt()
    return (clean + noise * (c_rms / 10.0 ** (snr / 20.0)) / n_rms).clamp(-1.0, 1.0)


def noisy_speech(gen: torch.Generator, rows: int, samples: int, sample_rate: int,
                 snr_db, device) -> torch.Tensor:
    return add_white_noise(gen, speech_like(gen, rows, samples, sample_rate, device),
                           tuple(snr_db))
