"""The fused denoise path: STFT -> U-Net -> noisy-phase iSTFT (port of
``eval/runner.py``, ``noisy_phase`` mode).

``DenoiserRunner.denoise_audio`` pads the clip to a hop multiple, takes
the centre-padded STFT through the K1 kernel, splits it with
``magphase``, runs the model on the magnitude, clamps at zero, multiplies
by the noisy phase and inverts through the K2 kernel. On a CUDA device
the kernels launch; on the CPU their plain versions run.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.models.folded import FoldedUNet, fold_for_inference
from audiodenoiser_torch.models.unet import UNet

# reconstruction modes of the JAX runner that this port has not reached,
# with the ROADMAP item that ports each
UNPORTED_MODES = {
    "griffin_lim": "ROADMAP A.7 (Griffin-Lim reconstruction)",
    "reference_gl": "ROADMAP A.7 (Griffin-Lim reconstruction)",
    "complex_mask": "ROADMAP A.8 (complex-mask family)",
}


def identity_bypass(out: torch.Tensor, orig: torch.Tensor,
                    thresh_db: float) -> torch.Tensor:
    """Return ``orig`` verbatim for clips whose change energy
    ``10*log10(||out-orig||^2 / ||orig||^2)`` is below ``-thresh_db``:
    clips the model itself judged clean pass through bit-exactly."""
    diff = torch.sum(torch.square(out - orig), dim=-1)
    ref = torch.sum(torch.square(orig), dim=-1)
    change_db = 10.0 * torch.log10(diff / (ref + 1e-12) + 1e-20)
    return torch.where((change_db < -thresh_db)[..., None], orig, out)


def load_model_for_noise(noise_type: str, saved_models_dir: str = "./saved_models",
                         dtype: torch.dtype = torch.bfloat16,
                         device: DeviceLike = None) -> FoldedUNet:
    """Load the reference ``unet_denoiser_{noise_type}.pth`` state_dict and
    fold it for inference on ``device``. (The JAX package's ``.ckpt``
    msgpack exports are not read yet: ROADMAP A.9.)"""
    device = resolve_device(device)
    path = os.path.join(saved_models_dir, f"unet_denoiser_{noise_type}.pth")
    if not os.path.exists(path):
        raise FileNotFoundError(f"Model file not found: {path}")
    model = UNet()
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                          strict=True)
    print(f"Loaded model for noise type '{noise_type}' from: {path}")
    return fold_for_inference(model.eval(), dtype).to(device)


class DenoiserRunner:
    """Spectrogram and waveform denoising through ``model`` on ``device``.

    ``model`` maps (N, 1, F, T) magnitudes to (N, 1, F, T); it is moved to
    ``device``. The STFT and iSTFT always take the kernel path.
    """

    def __init__(self, model: nn.Module, n_fft: int = 512, hop_length: int = 128,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_fft = n_fft
        self.hop = hop_length

    @torch.inference_mode()
    def denoise_spectrogram(self, noisy_mag: torch.Tensor) -> torch.Tensor:
        """(N, F, T) magnitudes -> (N, F, T) denoised magnitudes."""
        x = torch.as_tensor(noisy_mag, dtype=torch.float32).to(self.device)
        return self.model(x[:, None])[:, 0].float()

    @torch.inference_mode()
    def denoise_audio(self, audio, mode: str = "noisy_phase", center: bool = True,
                      bypass_db: Optional[float] = None) -> torch.Tensor:
        """(..., samples) noisy audio -> denoised audio of the same shape,
        on the runner's device.

        The clip is zero-padded to a hop multiple first: the iSTFT of a
        centre-padded STFT reconstructs only ``floor(n/hop)*hop`` samples.
        ``bypass_db`` enables :func:`identity_bypass`.
        """
        if mode in UNPORTED_MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet: {UNPORTED_MODES[mode]}")
        if mode != "noisy_phase":
            raise ValueError(f"unknown mode {mode!r}")
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        orig = audio
        n = audio.shape[-1]
        rem = (-n) % self.hop
        if rem and center:
            audio = F.pad(audio, (0, rem))
        out = self._noisy_phase(audio, center)
        if rem and center:
            out = out[..., :n]
        if bypass_db is not None:
            out = identity_bypass(out, orig, bypass_db)
        return out

    def _noisy_phase(self, audio: torch.Tensor, center: bool) -> torch.Tensor:
        lead, n = audio.shape[:-1], audio.shape[-1]
        spec = stft_lib.stft(audio.reshape(-1, n), self.n_fft, self.hop,
                             center=center, precision="kernel")
        mag, phase = stft_lib.magphase(spec)
        # magnitudes are non-negative
        den = self.model(mag[:, None])[:, 0].float().clamp_min(0.0)
        rec = den * phase
        out = stft_lib.istft(rec, self.hop, n_fft=self.n_fft, center=center,
                             length=n, precision="kernel")
        return out.reshape(*lead, n)
