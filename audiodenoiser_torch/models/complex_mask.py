"""Complex-ratio-mask U-Net (port of ``models/complex_mask.py``).

The magnitude U-Net regresses a clean magnitude and reuses the noisy
phase. This variant predicts a bounded complex ratio mask over the noisy
STFT, so magnitude and phase are both corrected and the waveform comes
back through one iSTFT:

    features  (N, F, T, 3) = [|S|, Re(S)/|S|, Im(S)/|S|]
    mask      (N, F, T, 2) = (Mr, Mi) = K*tanh(out), plus (1, 0) if residual
    S_hat     = (Mr + i*Mi) * S

``spectrogram_features`` and ``apply_mask`` keep the JAX package's
channel-last layout. The model, like ``UNet``, takes and returns logical
NCHW, (N, 3, F, T) -> (N, 2, F, T); a permute of the channel-last
features is that tensor in channels_last memory, so no copy is made.

As in Flax, the backbone casts its head's output back to the input's
dtype (float32) before the mask transform, so in bf16 the tanh and the
bound run in float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.models.unet import UNet


@functools.lru_cache(maxsize=16)
def _identity_mask(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The identity mask (1, 0) as a (2, 1, 1) tensor, made once per dtype
    and device: a copy from the host at every forward waits for the device
    and cannot be captured in a CUDA graph (``train.step_graph``). A normal
    tensor even when first asked for under inference_mode."""
    with torch.inference_mode(False):
        return torch.tensor([1.0, 0.0], dtype=dtype, device=device)[:, None, None]


def mask_head(out: torch.Tensor, bound: float, residual: bool) -> torch.Tensor:
    """(N, 2, F, T) head output -> the bounded mask ``K*tanh(out)``, plus
    the identity mask (1, 0) when ``residual``."""
    mask = bound * torch.tanh(out)
    if residual:
        mask = mask + _identity_mask(mask.dtype, mask.device)
    return mask


class ComplexMaskUNet(UNet):
    """U-Net emitting a bounded complex ratio mask: 3 input channels, 2
    output channels. ``residual=True`` re-parametrises the mask as identity
    plus a bounded deviation, ``M = (1, 0) + K*tanh(out)``."""

    def __init__(self, mask_bound: float = 2.0, residual: bool = False, **kwargs):
        kwargs.setdefault("in_channels", 3)
        kwargs.setdefault("out_channels", 2)
        super().__init__(**kwargs)
        self.mask_bound = float(mask_bound)
        self.residual = bool(residual)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mask_head(super().forward(x), self.mask_bound, self.residual)


def spectrogram_features(spec: torch.Tensor) -> torch.Tensor:
    """Complex STFT (..., F, T) -> (..., F, T, 3) [mag, cos, sin] features;
    a zero-magnitude bin has phase 1 (``dsp.stft.magphase``)."""
    mag, phase = stft_lib.magphase(spec)
    return torch.stack([mag, phase.real, phase.imag], dim=-1)


def apply_mask(mask: torch.Tensor, spec: torch.Tensor) -> torch.Tensor:
    """(..., F, T, 2) mask x complex spec (..., F, T) -> masked complex spec."""
    return torch.complex(mask[..., 0].float(), mask[..., 1].float()) * spec


def mask_spectrogram(model, spec: torch.Tensor) -> torch.Tensor:
    """Complex (N, F, T) spectrogram -> ``model``'s masked spectrogram:
    features, one forward in channels_last memory, the mask applied."""
    feats = spectrogram_features(spec).permute(0, 3, 1, 2)  # (N, 3, F, T) NHWC
    mask = model(feats).float().permute(0, 2, 3, 1)          # (N, F, T, 2)
    return apply_mask(mask, spec)


def denoise_waveform(model, audio: torch.Tensor, n_fft: int = 512,
                     hop_length: int = 128) -> torch.Tensor:
    """Fused STFT -> mask -> iSTFT of (N, samples) or (samples,) audio,
    through the ``torch.fft`` transforms as the JAX function's ``"fft"``
    path (``eval.runner.DenoiserRunner`` is the kernel path).

    The input is zero-padded to a hop multiple before the STFT and the
    output cut back to its length: the iSTFT of a centre STFT covers only
    ``floor(n/hop)*hop`` samples."""
    if audio.dim() == 1:
        return denoise_waveform(model, audio[None], n_fft, hop_length)[0]
    n = audio.shape[-1]
    rem = (-n) % hop_length
    if rem:
        audio = F.pad(audio, (0, rem))
    spec = stft_lib.stft(audio, n_fft, hop_length, center=True)
    out = mask_spectrogram(model, spec)
    return stft_lib.istft(out, hop_length, n_fft=n_fft, center=True,
                          length=audio.shape[-1])[..., :n]
