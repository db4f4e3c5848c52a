"""The combined "perceptual" spectral loss (port of ``losses/spectral.py``).

A 0.4/0.4/0.2 blend of

1. multi-scale STFT L1: the spectrogram is collapsed to a pseudo-waveform
   by averaging over the frequency axis (the T frames become a T-sample
   signal), then L1 of STFT magnitudes at fft sizes 63/32/16, hops
   16/8/4, with a rectangular window and constant centre padding,
   averaged over the scales;
2. mel L1: the same collapse, then a torchaudio-style mel spectrogram
   (sr 8000, n_fft 63, hop 16, 64 deliberately degenerate mels);
3. plain L1 over the spectrogram pair.

The quirks are kept on purpose: they define the loss surface the
reference trained against. Inputs are the port's (B, 1, F, T); (B, F, T)
and unbatched (F, T) are also accepted. The FFTs are ``torch.fft``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.dsp.mel import mel_spectrogram

FFT_SIZES = (63, 32, 16)
HOP_LENGTHS = (16, 8, 4)
W_STFT = 0.4
W_MEL = 0.4
W_L1 = 0.2


class CombinedLossOutput(NamedTuple):
    """The reference's 4-tuple: (total, stft, mel, l1)."""

    total: torch.Tensor
    stft: torch.Tensor
    mel: torch.Tensor
    l1: torch.Tensor


def _pseudo_waveform(spec: torch.Tensor) -> torch.Tensor:
    """Collapse a spectrogram to (B, T) by averaging over frequency."""
    if spec.dim() == 4:  # (B, C, F, T)
        if spec.shape[1] != 1:
            raise ValueError(f"expected singleton channel, got {tuple(spec.shape)}")
        return spec[:, 0].mean(dim=-2)
    if spec.dim() == 3:  # (B, F, T)
        return spec.mean(dim=-2)
    if spec.dim() == 2:  # (F, T) unbatched
        return spec.mean(dim=-2)[None, :]
    raise ValueError(f"unsupported spectrogram rank {spec.dim()}")


def multi_scale_stft_loss(pred: torch.Tensor, target: torch.Tensor,
                          fft_sizes: Sequence[int] = FFT_SIZES,
                          hop_lengths: Sequence[int] = HOP_LENGTHS) -> torch.Tensor:
    p = _pseudo_waveform(pred)
    t = _pseudo_waveform(target)
    loss = 0.0
    for n_fft, hop in zip(fft_sizes, hop_lengths):
        pm = stft_lib.stft(p, n_fft, hop, window="ones", center=True,
                           pad_mode="constant").abs()
        tm = stft_lib.stft(t, n_fft, hop, window="ones", center=True,
                           pad_mode="constant").abs()
        loss = loss + (pm - tm).abs().mean()
    return loss / len(fft_sizes)


def mel_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = _pseudo_waveform(pred)
    t = _pseudo_waveform(target)
    pm = mel_spectrogram(p, sample_rate=8000, n_fft=63, hop_length=16, n_mels=64)
    tm = mel_spectrogram(t, sample_rate=8000, n_fft=63, hop_length=16, n_mels=64)
    return (pm - tm).abs().mean()


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).abs().mean()


def combined_perceptual_loss(pred: torch.Tensor,
                             target: torch.Tensor) -> CombinedLossOutput:
    """0.4 * stft + 0.4 * mel + 0.2 * l1."""
    s = multi_scale_stft_loss(pred, target)
    m = mel_loss(pred, target)
    l1 = l1_loss(pred, target)
    return CombinedLossOutput(W_STFT * s + W_MEL * m + W_L1 * l1, s, m, l1)
