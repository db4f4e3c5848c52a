"""Phase reconstruction from magnitude spectrograms (port of
``dsp/griffin_lim.py``).

Two modes, as in the JAX package:

- ``"correct"``: Griffin-Lim, the target magnitude re-imposed after each
  iSTFT -> STFT round trip, optionally with momentum (librosa's
  ``griffinlim``);
- ``"reference"``: the reference project's loop, which rebuilds the
  spectrogram from the round trip's own magnitude and never re-imposes the
  target.

The loop is a plain Python loop of ``n_iter`` round trips and one final
iSTFT. The initial phase is uniform on [0, 2*pi) in the magnitude's shape,
drawn from ``generator`` or passed in as ``theta``, so that a test can give
the port the JAX package's own draw. ``precision="kernel"`` takes every
transform through K1 and K2 (``2 * n_iter + 1`` launches a call on the
card); ``"fft"`` through their plain ``torch.fft`` versions.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from audiodenoiser_torch.dsp.stft import istft, stft

MODES = ("correct", "reference")


def initial_phase(shape, generator: Optional[torch.Generator] = None,
                  device=None) -> torch.Tensor:
    """Uniform phase on [0, 2*pi), float32, drawn from ``generator`` on its
    own device and placed on ``device``."""
    draw_on = device if generator is None else generator.device
    theta = torch.rand(shape, generator=generator, device=draw_on) * (2.0 * math.pi)
    return theta.to(device)


def griffin_lim(
    magnitude: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    n_fft: Optional[int] = None,
    hop_length: int = 128,
    n_iter: int = 50,
    mode: str = "correct",
    momentum: float = 0.0,
    length: Optional[int] = None,
    theta: Optional[torch.Tensor] = None,
    precision: str = "fft",
) -> torch.Tensor:
    """Reconstruct audio (..., samples) from ``magnitude`` (..., freq, time).

    ``theta`` is the initial phase; without it one is drawn from
    ``generator`` on the magnitude's device."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    n_fft = 2 * (magnitude.shape[-2] - 1) if n_fft is None else n_fft
    mag = magnitude.to(torch.float32)
    if theta is None:
        theta = initial_phase(mag.shape, generator, mag.device)
    theta = torch.as_tensor(theta, dtype=torch.float32).to(mag.device)
    if theta.shape != mag.shape:
        raise ValueError(f"theta shape {tuple(theta.shape)} != magnitude "
                         f"shape {tuple(mag.shape)}")
    target = mag.to(torch.complex64)
    cur = prev = target * torch.exp(1j * theta)
    tiny = torch.finfo(torch.float32).tiny
    kw = dict(hop_length=hop_length, n_fft=n_fft, center=True, precision=precision)
    for _ in range(n_iter):
        accel = cur + momentum * (cur - prev) if momentum > 0.0 else cur
        audio = istft(accel, **kw)
        rebuilt = stft(audio, n_fft=n_fft, hop_length=hop_length, center=True,
                       precision=precision)
        if mode == "correct":
            nxt = target * (rebuilt / rebuilt.abs().clamp_min(tiny))
        else:
            nxt = rebuilt
        cur, prev = nxt, cur
    return istft(cur, length=length, **kw)
