"""Mel filterbank + mel spectrogram with torchaudio's semantics (port of
``dsp/mel.py``).

The reference mel loss builds ``torchaudio.transforms.MelSpectrogram(
sample_rate=8000, n_fft=63, hop_length=16, n_mels=64)``: HTK mel scale,
``norm=None``, ``f_min=0``, ``f_max=sr/2``, a periodic Hann window of
``n_fft``, ``center=True`` with **reflect** padding, ``power=2.0``. The
filterbank is a numpy copy of the JAX package's. ``n_mels=64`` over only
``n_fft//2+1 = 32`` bins leaves many all-zero filters, kept on purpose:
it is the loss surface the reference trained against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from audiodenoiser_torch.dsp.stft import _on, stft


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, norm: str | None = None) -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels), float32."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def mel_spectrogram(x: torch.Tensor, sample_rate: int = 8000, n_fft: int = 63,
                    hop_length: int = 16, n_mels: int = 64,
                    power: float = 2.0) -> torch.Tensor:
    """Mel spectrogram of waveform ``x`` (..., samples) -> (..., n_mels, frames)."""
    spec = stft(x, n_fft=n_fft, hop_length=hop_length, window="hann",
                center=True, pad_mode="reflect")
    p = spec.abs() ** power  # (..., n_freqs, frames)
    fb_np = mel_filterbank(n_fft // 2 + 1, 0.0, sample_rate / 2.0, n_mels, sample_rate)
    fb = _on(fb_np, x.device).reshape(fb_np.shape)
    return torch.einsum("...ft,fm->...mt", p, fb)
