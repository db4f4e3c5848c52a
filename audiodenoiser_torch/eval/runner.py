"""The fused denoise paths (port of ``eval/runner.py``).

``DenoiserRunner.denoise_audio`` pads the clip to a hop multiple and takes
the centre-padded STFT through the K1 kernel, then, by mode:

- ``noisy_phase`` (a magnitude U-Net): ``magphase``, the model on the
  magnitude, a clamp at zero, the noisy phase back on;
- ``complex_mask`` (a ``ComplexMaskUNet``): ``[mag, cos, sin]`` features,
  the model's bounded complex mask times the noisy spectrogram;

and inverts through the K2 kernel. On a CUDA device the kernels launch; on
the CPU their plain versions run. A runner serves the one mode its model
computes.

``load_model_for_noise`` / ``load_model_from_path`` read the JAX
package's ``{stem}_{noise}.ckpt`` exports with their ``.json`` sidecars,
and the reference's ``unet_denoiser_{noise}.pth``, and fold the model for
inference.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet, mask_spectrogram
from audiodenoiser_torch.models.convert import load_flax_variables
from audiodenoiser_torch.models.folded import FoldedUNet, fold_for_inference
from audiodenoiser_torch.models.unet import UNet, width_kwargs
from audiodenoiser_torch.train.checkpoints import load_exported

MODES = ("noisy_phase", "complex_mask")
# reconstruction modes of the JAX runner that this port has not reached,
# with the ROADMAP item that ports each
UNPORTED_MODES = {
    "griffin_lim": "ROADMAP A.7 (Griffin-Lim reconstruction)",
    "reference_gl": "ROADMAP A.7 (Griffin-Lim reconstruction)",
}
# sidecar options of UNet variants the port has not reached
UNPORTED_SIDECAR = ("s2d_stem", "s2d_skip", "attn_bottleneck")


def identity_bypass(out: torch.Tensor, orig: torch.Tensor,
                    thresh_db: float) -> torch.Tensor:
    """Return ``orig`` verbatim for clips whose change energy
    ``10*log10(||out-orig||^2 / ||orig||^2)`` is below ``-thresh_db``:
    clips the model itself judged clean pass through bit-exactly."""
    diff = torch.sum(torch.square(out - orig), dim=-1)
    ref = torch.sum(torch.square(orig), dim=-1)
    change_db = 10.0 * torch.log10(diff / (ref + 1e-12) + 1e-20)
    return torch.where((change_db < -thresh_db)[..., None], orig, out)


def load_model_from_path(path: str, dtype: torch.dtype = torch.bfloat16,
                         device: DeviceLike = None,
                         stem: str = "mask_denoiser") -> FoldedUNet:
    """Load a ``.ckpt`` export by path and fold it for inference on
    ``device``. Its ``.json`` sidecar, when there is one, rebuilds the
    architecture: ``width_mult``, and for ``stem="mask_denoiser"`` the
    mask head's ``mask_bound`` (default 2.0) and ``residual``."""
    device = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Model file not found: {path}")
    meta = {}
    sidecar = os.path.splitext(path)[0] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    asked = [k for k in UNPORTED_SIDECAR if meta.get(k)]
    if asked:
        raise NotImplementedError(
            f"{sidecar} asks for {', '.join(asked)}: these U-Net variants are not "
            "ported yet (ROADMAP A.10)")
    kwargs = width_kwargs(float(meta.get("width_mult", 1.0)))
    if stem == "mask_denoiser":
        model = ComplexMaskUNet(mask_bound=float(meta.get("mask_bound", 2.0)),
                                residual=bool(meta.get("residual", False)), **kwargs)
    else:
        model = UNet(**kwargs)
    load_flax_variables(model, load_exported(path))
    print(f"Loaded model from: {path}")
    return fold_for_inference(model.eval(), dtype).to(device)


def load_model_for_noise(noise_type: str, saved_models_dir: str = "./saved_models",
                         dtype: torch.dtype = torch.bfloat16,
                         device: DeviceLike = None,
                         stem: str = "unet_denoiser") -> FoldedUNet:
    """Load the model for ``noise_type`` and fold it for inference on
    ``device``, picking files in the JAX package's order:
    ``{stem}_{noise_type}.ckpt`` if it exists, else (for the magnitude
    U-Net, ``stem="unet_denoiser"``) the reference
    ``unet_denoiser_{noise_type}.pth``. Use ``stem="mask_denoiser"`` for
    the complex-mask family."""
    device = resolve_device(device)
    path = os.path.join(saved_models_dir, f"{stem}_{noise_type}.ckpt")
    pth_path = os.path.join(saved_models_dir, f"unet_denoiser_{noise_type}.pth")
    if os.path.exists(path) or stem != "unet_denoiser" or not os.path.exists(pth_path):
        return load_model_from_path(path, dtype, device, stem)
    model = UNet()
    model.load_state_dict(torch.load(pth_path, map_location="cpu", weights_only=True),
                          strict=True)
    print(f"Loaded model for noise type '{noise_type}' from: {pth_path}")
    return fold_for_inference(model.eval(), dtype).to(device)


class DenoiserRunner:
    """Spectrogram and waveform denoising through ``model`` on ``device``.

    ``model`` is moved to ``device``. A magnitude model maps (N, 1, F, T)
    to (N, 1, F, T) and serves ``noisy_phase``; a complex-mask model (one
    with a ``mask_bound``) maps (N, 3, F, T) features to an (N, 2, F, T)
    mask and serves ``complex_mask``. The STFT and iSTFT always take the
    kernel path.
    """

    def __init__(self, model: nn.Module, n_fft: int = 512, hop_length: int = 128,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.n_fft = n_fft
        self.hop = hop_length
        masked = getattr(model, "mask_bound", None) is not None
        self.mode = "complex_mask" if masked else "noisy_phase"

    @torch.inference_mode()
    def denoise_spectrogram(self, noisy_mag: torch.Tensor) -> torch.Tensor:
        """(N, F, T) magnitudes -> (N, F, T) denoised magnitudes."""
        if self.mode != "noisy_phase":
            raise ValueError("denoise_spectrogram needs a magnitude model")
        x = torch.as_tensor(noisy_mag, dtype=torch.float32).to(self.device)
        return self.model(x[:, None])[:, 0].float()

    @torch.inference_mode()
    def denoise_audio(self, audio, mode: Optional[str] = None, center: bool = True,
                      bypass_db: Optional[float] = None) -> torch.Tensor:
        """(..., samples) noisy audio -> denoised audio of the same shape,
        on the runner's device. ``mode`` defaults to the runner's own.

        The clip is zero-padded to a hop multiple first: the iSTFT of a
        centre-padded STFT reconstructs only ``floor(n/hop)*hop`` samples.
        ``bypass_db`` enables :func:`identity_bypass`.
        """
        mode = self.mode if mode is None else mode
        if mode in UNPORTED_MODES:
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet: {UNPORTED_MODES[mode]}")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if mode != self.mode:
            raise NotImplementedError(
                f"mode {mode!r} needs a {'complex-mask' if mode == 'complex_mask' else 'magnitude'}"
                f" model; this runner's model serves {self.mode!r}")
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        orig = audio
        n = audio.shape[-1]
        rem = (-n) % self.hop
        if rem and center:
            audio = F.pad(audio, (0, rem))
        out = self._reconstruct(audio, center)
        if rem and center:
            out = out[..., :n]
        if bypass_db is not None:
            out = identity_bypass(out, orig, bypass_db)
        return out

    def _reconstruct(self, audio: torch.Tensor, center: bool) -> torch.Tensor:
        lead, n = audio.shape[:-1], audio.shape[-1]
        spec = stft_lib.stft(audio.reshape(-1, n), self.n_fft, self.hop,
                             center=center, precision="kernel")
        if self.mode == "complex_mask":
            rec = mask_spectrogram(self.model, spec)
        else:
            mag, phase = stft_lib.magphase(spec)
            # magnitudes are non-negative
            den = self.model(mag[:, None])[:, 0].float().clamp_min(0.0)
            rec = den * phase
        out = stft_lib.istft(rec, self.hop, n_fft=self.n_fft, center=center,
                             length=n, precision="kernel")
        return out.reshape(*lead, n)
