"""Training steps for the complex-ratio-mask family (port of ``train/mask.py``).

The steps take raw (noisy, clean) (B, samples) waveform pairs from
``OnDeviceMixer.sample_audio``: the STFTs, the features, the mask and the
losses all run inside the step, so the model trains against exactly the
spectra it sees at inference (``center=True``, as the runner's
``complex_mask`` mode).

Loss, as in the JAX package: the combined perceptual loss on |S_hat|
against |S_clean|, plus ``WAVEFORM_L1_WEIGHT`` times the L1 of the
reconstructed waveform, minus ``si_sdr_weight`` times the batch's mean
SI-SDR over ``SI_SDR_SCALE`` dB, each clip's SI-SDR saturated at
``si_sdr_clamp`` dB (a clip already past it adds no gradient).

On the card both STFTs are one K1 launch, the reconstruction is K2, and
K2's gradient is one more K1 launch (``ops.cuda.istft_with_grad``); the
iSTFT and SI-SDR run in float32 whatever the model's dtype.

Not ported yet: the teacher and the distillation terms (ROADMAP A.10).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.device import DeviceLike
from audiodenoiser_torch.eval.metrics import si_sdr
from audiodenoiser_torch.losses import CombinedLossOutput, combined_perceptual_loss
from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet, mask_spectrogram
from audiodenoiser_torch.train.loop import (
    SeedLike,
    TrainState,
    apply_update,
    create_train_state,
)

WAVEFORM_L1_WEIGHT = 0.5
# -SI-SDR enters the total as si_sdr_weight * (-si_sdr_db / SI_SDR_SCALE):
# SI-SDR is O(10) dB where the spectral total is O(0.1)
SI_SDR_SCALE = 20.0
N_FFT = 512
HOP = 128


def create_mask_train_state(seed: SeedLike = 0, model: Optional[nn.Module] = None,
                            learning_rate: float = 1e-4, variables: Optional[dict] = None,
                            device: DeviceLike = None, **opt_kwargs) -> TrainState:
    """A ``ComplexMaskUNet`` (full width, bound 2 by default) with its
    optimizer on ``device``, the card unless told otherwise; weights from
    a Flax-layout ``variables`` tree or Flax's initialisers from ``seed``.
    ``opt_kwargs`` (``schedule``, ``warmup_steps``, ``total_steps``,
    ``grad_accum``) go to ``make_optimizer``, so the training flags reach
    this family too."""
    model = ComplexMaskUNet() if model is None else model
    return create_train_state(seed, model, learning_rate=learning_rate,
                              variables=variables, device=device, **opt_kwargs)


def _mask_losses(model: nn.Module, noisy_audio: torch.Tensor, clean_audio: torch.Tensor,
                 si_sdr_weight: float, si_sdr_clamp: Optional[float]) -> CombinedLossOutput:
    """The losses of one batch, ``total`` being the objective; the model's
    mode (train or eval) is the caller's."""
    b = noisy_audio.shape[0]
    with torch.no_grad():  # the input spectra need no gradient: one K1 launch
        spec = stft_lib.stft(torch.cat([noisy_audio, clean_audio]), N_FFT, HOP,
                             center=True, precision="kernel")
    spec, clean_mag = spec[:b], spec[b:].abs()
    s_hat = mask_spectrogram(model, spec)
    losses = combined_perceptual_loss(s_hat.abs()[:, None], clean_mag[:, None])
    y_hat = stft_lib.istft(s_hat, HOP, n_fft=N_FFT, center=True,
                           length=clean_audio.shape[-1], precision="kernel")
    total = losses.total + WAVEFORM_L1_WEIGHT * (y_hat - clean_audio).abs().mean()
    if si_sdr_weight:
        sdr = si_sdr(y_hat.float(), clean_audio.float())
        if si_sdr_clamp is not None:
            sdr = torch.clamp(sdr, max=si_sdr_clamp)
        total = total - si_sdr_weight * sdr.mean() / SI_SDR_SCALE
    return losses._replace(total=total)


def make_mask_steps(si_sdr_weight: float = 0.0, si_sdr_clamp: Optional[float] = None,
                    teacher=None, distill_weight: float = 0.0,
                    distill_feat_weight: float = 0.0):
    """``(train_step, eval_step)`` of the mask family with this -SI-SDR
    weight and clamp (``None``: unclamped). Both report the total the
    optimizer sees, so ``fit``'s best-validation export tracks the
    objective. The teacher and distillation arguments are not ported
    (ROADMAP A.10) and raise when set."""
    asked = [name for name, v in (("teacher", teacher is not None),
                                  ("distill_weight", distill_weight),
                                  ("distill_feat_weight", distill_feat_weight)) if v]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: distillation is not ported yet (ROADMAP A.10)")

    def train_step(state: TrainState, noisy_audio: torch.Tensor, clean_audio: torch.Tensor):
        """One update in place; returns ``(state, losses)``."""
        losses = _mask_losses(state.model.train(), noisy_audio, clean_audio,
                              si_sdr_weight, si_sdr_clamp)
        return apply_update(state, losses)

    @torch.no_grad()
    def eval_step(state: TrainState, noisy_audio: torch.Tensor,
                  clean_audio: torch.Tensor) -> CombinedLossOutput:
        """Eval-mode forward (running BN statistics, no update) and the losses."""
        return _mask_losses(state.model.eval(), noisy_audio, clean_audio,
                            si_sdr_weight, si_sdr_clamp)

    return train_step, eval_step


# the spectral-only steps (si_sdr_weight 0), as the JAX package's defaults
mask_train_step, mask_eval_step = make_mask_steps(0.0)
