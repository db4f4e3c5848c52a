"""The four noise corruptions, batched torch ops (port of ``dsp/noise.py``).

- **white**: standard-normal noise scaled so the mixture hits ``snr_db``;
- **urban**: a real noise clip tiled or randomly snipped to length, then
  SNR-scaled;
- **reverb**: the JUCE (Pedalboard) reverb as its exact impulse response,
  computed once on the host with a scipy ``lfilter`` cascade and applied as
  an FFT convolution;
- **noise_cancellation**: with p=0.8 per 2 s block, add ``-0.8 x clean``
  over the first 8 000 samples of the block.

All outputs are clipped to [-1, 1]. Random draws come from an explicit
``torch.Generator``, or are passed in (``noise=``, ``start=``, ``gate=``),
so that a test can give the port the JAX package's own draws.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch

SNR_DB = 8.0
BLOCK = 16000  # 2 s at 8 kHz: the reference's cancellation block
HALF_BLOCK = 8000

# JUCE Reverb constants (juce_Reverb.h, wrapped by pedalboard.Reverb)
_COMB_TUNINGS_44K = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
_ALLPASS_TUNINGS_44K = (556, 441, 341, 225)
_FIXED_GAIN = 0.015
_WET_SCALE = 3.0
_DRY_SCALE = 2.0
_ROOM_SCALE = 0.28
_ROOM_OFFSET = 0.7
_DAMP_SCALE = 0.4

SnrLike = Union[float, torch.Tensor]


def snr_scale(clean: torch.Tensor, noise: torch.Tensor,
              snr_db: SnrLike = SNR_DB) -> torch.Tensor:
    """Scale ``noise`` so that mixing with ``clean`` gives ``snr_db`` dB
    (RMS per example over the last axis, the reference's arithmetic)."""
    clean_rms = torch.sqrt(clean.square().mean(-1, keepdim=True) + 1e-12)
    noise_rms = torch.sqrt(noise.square().mean(-1, keepdim=True) + 1e-12)
    snr_linear = 10.0 ** (torch.as_tensor(snr_db, dtype=clean.dtype,
                                          device=clean.device) / 20.0)
    scaled = noise * ((clean_rms / snr_linear) / noise_rms)
    return torch.where(noise_rms > 1e-9, scaled, torch.zeros_like(noise))


def white(clean: torch.Tensor, snr_db: SnrLike = SNR_DB,
          generator: Optional[torch.Generator] = None,
          noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """White-noise corruption at ``snr_db``; ``noise`` is the standard-normal
    draw, else drawn from ``generator``."""
    if noise is None:
        noise = torch.randn(clean.shape, generator=generator, device=clean.device,
                            dtype=clean.dtype)
    return torch.clamp(clean + snr_scale(clean, noise.to(clean), snr_db), -1.0, 1.0)


def match_length(noise: torch.Tensor, target_len: int,
                 generator: Optional[torch.Generator] = None,
                 start: Optional[int] = None) -> torch.Tensor:
    """Tile (if short) or snip (if long, from ``start`` or a random start
    in ``[0, n - target_len)``) ``noise`` to ``target_len`` samples."""
    n = noise.shape[-1]
    if n == target_len:
        return noise
    if n < target_len:
        reps = -(-target_len // n)
        return noise.repeat(*([1] * (noise.dim() - 1)), reps)[..., :target_len]
    if start is None:
        start = int(torch.randint(0, n - target_len, (), generator=generator))
    return noise[..., start:start + target_len]


def urban(clean: torch.Tensor, noise_clip: torch.Tensor, snr_db: SnrLike = SNR_DB,
          generator: Optional[torch.Generator] = None,
          start: Optional[int] = None) -> torch.Tensor:
    """Urban-noise corruption: length-matched real noise at ``snr_db``."""
    noise = match_length(noise_clip, clean.shape[-1], generator, start)
    noise = noise.expand(clean.shape).to(clean)
    return torch.clamp(clean + snr_scale(clean, noise, snr_db), -1.0, 1.0)


def noise_cancellation(clean: torch.Tensor, generator: Optional[torch.Generator] = None,
                       gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Destructive interference: per 16 000-sample block, with probability
    0.8 (``gate``, shape (..., n_blocks)), the first min(8 000, block)
    samples get ``-0.8 x clean`` added."""
    length = clean.shape[-1]
    n_blocks = -(-length // BLOCK)
    if gate is None:
        gate = torch.rand((*clean.shape[:-1], n_blocks), generator=generator,
                          device=clean.device) < 0.8
    pos = torch.arange(length, device=clean.device)
    active = gate.to(clean)[..., pos // BLOCK]
    mask = active * ((pos % BLOCK) < HALF_BLOCK).to(clean)
    return torch.clamp(clean + mask * (-0.8) * clean, -1.0, 1.0)


@functools.lru_cache(maxsize=16)
def reverb_impulse_response(sample_rate: int, length: int, room_size: float = 0.9,
                            damping: float = 0.9, wet_level: float = 0.33,
                            width: float = 1.0) -> np.ndarray:
    """Exact wet-path impulse response of the JUCE/Pedalboard mono reverb:
    8 parallel damped feedback combs ``z^-D (1 - d z^-1) / (1 - d z^-1 -
    f (1-d) z^-D)`` into 4 series allpasses ``(1.5 z^-D - 1) / (1 - 0.5
    z^-D)``, run on a unit impulse with scipy and cached."""
    from scipy.signal import lfilter

    feedback = room_size * _ROOM_SCALE + _ROOM_OFFSET
    damp = damping * _DAMP_SCALE
    wet1 = 0.5 * (wet_level * _WET_SCALE) * (1.0 + width)

    x = np.zeros(length, dtype=np.float64)
    x[0] = _FIXED_GAIN  # input gain folds into the IR

    comb_sum = np.zeros(length, dtype=np.float64)
    for tuning in _COMB_TUNINGS_44K:
        d_len = int(sample_rate) * tuning // 44100
        b = np.zeros(d_len + 2)
        b[d_len] = 1.0
        b[d_len + 1] = -damp
        a = np.zeros(d_len + 1)
        a[0] = 1.0
        a[1] = -damp
        a[d_len] = -feedback * (1.0 - damp)
        comb_sum += lfilter(b, a, x)

    out = comb_sum
    for tuning in _ALLPASS_TUNINGS_44K:
        d_len = int(sample_rate) * tuning // 44100
        b = np.zeros(d_len + 1)
        b[0] = -1.0
        b[d_len] = 1.5
        a = np.zeros(d_len + 1)
        a[0] = 1.0
        a[d_len] = -0.5
        out = lfilter(b, a, out)

    return (out * wet1).astype(np.float32)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def reverb(clean: torch.Tensor, sample_rate: int = 8000, room_size: float = 0.9,
           damping: float = 0.9, wet_level: float = 0.33,
           dry_level: float = 0.4) -> torch.Tensor:
    """Pedalboard-style reverb: ``dry * clean + clean (*) IR``, clipped."""
    length = clean.shape[-1]
    ir = torch.from_numpy(reverb_impulse_response(sample_rate, length, room_size,
                                                  damping, wet_level)).to(clean.device)
    fft_len = _next_pow2(2 * length - 1)
    spec = torch.fft.rfft(clean, n=fft_len, dim=-1) * torch.fft.rfft(ir, n=fft_len)
    wet = torch.fft.irfft(spec, n=fft_len, dim=-1)[..., :length]
    return torch.clamp(dry_level * _DRY_SCALE * clean + wet, -1.0, 1.0)


def add_noise(clean: torch.Tensor, noise_type: str,
              noise_clip: Optional[torch.Tensor] = None, snr_db: float = SNR_DB,
              sample_rate: int = 8000, reverb_wet_level: float = 0.33,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dispatch over the four corruptions."""
    if noise_type == "white":
        return white(clean, snr_db, generator)
    if noise_type == "urban":
        if noise_clip is None or noise_clip.shape[-1] == 0:
            noise_clip = torch.zeros_like(clean)
        return urban(clean, noise_clip, snr_db, generator)
    if noise_type == "reverb":
        return reverb(clean, sample_rate, wet_level=reverb_wet_level)
    if noise_type == "noise_cancellation":
        return noise_cancellation(clean, generator)
    raise ValueError(f"unknown noise type {noise_type!r}")
