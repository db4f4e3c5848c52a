"""STFT and iSTFT of the deployments, through ``torch.stft``/``torch.istft``:
a periodic Hann window, centre padding with zeros (librosa's
``pad_mode='constant'``), one-sided spectra."""

from __future__ import annotations

import torch


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, device=device)


def stft(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, samples) -> complex (B, n_fft//2 + 1, 1 + samples//hop)."""
    return torch.stft(audio.float(), n_fft, hop, window=_window(n_fft, audio.device),
                      center=True, pad_mode="constant", return_complex=True)


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """complex (B, F, T) -> (B, length). The imaginary parts of the DC and
    Nyquist bins are dropped first: a real signal has none, and not every
    C2R transform ignores them."""
    spec = spec.clone()
    spec[:, 0] = spec[:, 0].real.to(spec.dtype)
    spec[:, -1] = spec[:, -1].real.to(spec.dtype)
    return torch.istft(spec, n_fft, hop, window=_window(n_fft, spec.device), center=True,
                       length=length)


def magphase(spec: torch.Tensor):
    """Magnitude and unit phase; a zero bin has phase 1."""
    mag = spec.abs()
    tiny = torch.finfo(torch.float32).tiny
    phase = torch.where(mag > tiny, spec / mag.clamp_min(tiny),
                        torch.ones((), dtype=spec.dtype, device=spec.device))
    return mag, phase
