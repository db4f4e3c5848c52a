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

With a frozen teacher (knowledge distillation for a compact student,
``cli.train --distill_from``), two more terms enter before the SI-SDR one:
``distill_weight`` times the L1 between the student's and the teacher's
masked spectra over their real and imaginary parts, and
``distill_feat_weight`` times the attention-transfer distance at
``FEATURE_TAPS`` (the bottleneck ``DoubleConv``'s output, read through a
forward hook that lives for one call; with ``attn_bottleneck`` that is
before the attention block, as JAX taps the module named ``bottleneck``).
The two maps must have one size: an s2d student against a plain teacher
is refused, not resized. The teacher runs in eval mode under
``no_grad`` on the student's features, so a distilled step still takes
both STFTs in one K1 launch.

On the card both STFTs are one K1 launch, the reconstruction is K2, and
K2's gradient is one more K1 launch (``ops.cuda.istft_with_grad``); the
iSTFT and SI-SDR run in float32 whatever the model's dtype. From the
second call on, the train step replays all of that, backward, clip and
AdamW included, as one captured CUDA graph (``train.step_graph``), except
where its docstring says why not.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.device import DeviceLike
from audiodenoiser_torch.eval.metrics import si_sdr
from audiodenoiser_torch.losses import CombinedLossOutput, combined_perceptual_loss
from audiodenoiser_torch.models.complex_mask import (
    ComplexMaskUNet,
    apply_mask,
    spectrogram_features,
)
from audiodenoiser_torch.train.loop import (
    SeedLike,
    TrainState,
    apply_update,
    create_train_state,
)
from audiodenoiser_torch.train.step_graph import GraphedStep
from audiodenoiser_torch.utils.profiling import FORWARD, LOSS, span

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


FEATURE_TAPS = ("bottleneck",)


def _attention_map(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) features -> their (B, H, W) spatial attention map: the
    mean channel energy in float32, L2-normalised over the plane (attention
    transfer, Zagoruyko & Komodakis 2017). It has no channel axis, so a
    width-scaled student and its full-width teacher compare directly."""
    a = x.float().square().mean(dim=1)
    return a / (torch.linalg.vector_norm(a, dim=(-2, -1), keepdim=True) + 1e-8)


@contextlib.contextmanager
def _tapped(model: nn.Module, capture: bool):
    """Inside the block, the outputs of ``model``'s ``FEATURE_TAPS``
    submodules, in order, append to the yielded list (nothing without
    ``capture``). The hooks go when the block ends, so no exported, EMA or
    served model carries one; under remat a block's recompute in the
    backward does not call its ``forward``, so each tap fires once a call."""
    feats, handles = [], []
    if capture:
        handles = [getattr(model, name).register_forward_hook(
            lambda _mod, _inp, out: feats.append(out)) for name in FEATURE_TAPS]
    try:
        yield feats
    finally:
        for h in handles:
            h.remove()


def _mask_losses(model: nn.Module, noisy_audio: torch.Tensor, clean_audio: torch.Tensor,
                 si_sdr_weight: float, si_sdr_clamp: Optional[float],
                 teacher: Optional[nn.Module] = None, distill_weight: float = 0.0,
                 distill_feat_weight: float = 0.0) -> CombinedLossOutput:
    """The losses of one batch, ``total`` being the objective; the model's
    mode (train or eval) is the caller's, the teacher's is eval."""
    b = noisy_audio.shape[0]
    with span(FORWARD):
        with torch.no_grad():  # the input spectra need no gradient: one K1 launch
            spec = stft_lib.stft(torch.cat([noisy_audio, clean_audio]), N_FFT, HOP,
                                 center=True, precision="kernel")
        spec, clean_mag = spec[:b], spec[b:].abs()
        feats = spectrogram_features(spec).permute(0, 3, 1, 2)  # (N, 3, F, T) NHWC
        distill = teacher is not None and bool(distill_weight or distill_feat_weight)
        capture = distill and distill_feat_weight > 0
        with _tapped(model, capture) as s_feats:
            mask = model(feats)
        s_hat = apply_mask(mask.float().permute(0, 2, 3, 1), spec)
    with span(LOSS):
        losses = combined_perceptual_loss(s_hat.abs()[:, None], clean_mag[:, None])
        y_hat = stft_lib.istft(s_hat, HOP, n_fft=N_FFT, center=True,
                               length=clean_audio.shape[-1], precision="kernel")
        total = losses.total + WAVEFORM_L1_WEIGHT * (y_hat - clean_audio).abs().mean()
        if distill:
            # the frozen teacher on the same features; no_grad, not
            # inference_mode: its tensors meet the student's in the backward
            with torch.no_grad(), _tapped(teacher, capture) as t_feats:
                t_mask = teacher.eval()(feats)
            if distill_weight:
                t_hat = apply_mask(t_mask.float().permute(0, 2, 3, 1), spec)
                gap = ((s_hat.real - t_hat.real).abs() + (s_hat.imag - t_hat.imag).abs()).mean()
                total = total + distill_weight * gap
            if distill_feat_weight:
                for s, t in zip(s_feats, t_feats):
                    if s.shape[-2:] != t.shape[-2:]:
                        raise ValueError(
                            f"the student's bottleneck is {tuple(s.shape[-2:])} and the "
                            f"teacher's {tuple(t.shape[-2:])}: the feature term needs one size "
                            "(an s2d model's bottleneck is half a plain one's)")
                feat = sum((_attention_map(s) - _attention_map(t)).square().sum(dim=(-2, -1))
                           .mean() for s, t in zip(s_feats, t_feats)) / max(len(s_feats), 1)
                total = total + distill_feat_weight * feat
        if si_sdr_weight:
            sdr = si_sdr(y_hat.float(), clean_audio.float())
            if si_sdr_clamp is not None:
                sdr = torch.clamp(sdr, max=si_sdr_clamp)
            total = total - si_sdr_weight * sdr.mean() / SI_SDR_SCALE
        return losses._replace(total=total)


def make_mask_steps(si_sdr_weight: float = 0.0, si_sdr_clamp: Optional[float] = None,
                    teacher: Optional[nn.Module] = None, distill_weight: float = 0.0,
                    distill_feat_weight: float = 0.0):
    """``(train_step, eval_step)`` of the mask family with this -SI-SDR
    weight and clamp (``None``: unclamped). Both report the total the
    optimizer sees, so ``fit``'s best-validation export tracks the
    objective, the teacher's terms included.

    ``teacher``: a mask model, run frozen (eval mode, no gradient), whose
    masked spectrum the student matches with ``distill_weight`` and whose
    bottleneck attention map it matches with ``distill_feat_weight``: the
    port's counterpart of the JAX steps' ``(apply_fn, variables)``.

    On the card the train step replays one CUDA graph where it can
    (``train.step_graph.GraphedStep``; ``.step`` is the eager step)."""

    def losses_of(model, noisy_audio, clean_audio):
        return _mask_losses(model, noisy_audio, clean_audio, si_sdr_weight, si_sdr_clamp,
                            teacher, distill_weight, distill_feat_weight)

    def train_step(state: TrainState, noisy_audio: torch.Tensor, clean_audio: torch.Tensor):
        """One update in place; returns ``(state, losses)``."""
        return apply_update(state, losses_of(state.model.train(), noisy_audio, clean_audio))

    @torch.no_grad()
    def eval_step(state: TrainState, noisy_audio: torch.Tensor,
                  clean_audio: torch.Tensor) -> CombinedLossOutput:
        """Eval-mode forward (running BN statistics, no update) and the losses."""
        return losses_of(state.model.eval(), noisy_audio, clean_audio)

    return GraphedStep(train_step, teacher), eval_step


# the spectral-only steps (si_sdr_weight 0), as the JAX package's defaults
mask_train_step, mask_eval_step = make_mask_steps(0.0)
