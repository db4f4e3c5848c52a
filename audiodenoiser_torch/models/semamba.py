"""SEMamba: MP-SENet's generator with bidirectional Mamba in place of the
TS-Conformers.

R. Chao, W.-H. Cheng, M. La Quatra, S. M. Siniscalchi, C.-H. H. Yang,
S.-W. Fu, Y. Tsao, "An Investigation of Incorporating Mamba for Speech
Enhancement", IEEE SLT 2024 (arXiv:2405.06573), at the published
configuration (``recipes/SEMamba_advanced/SEMamba_advanced.yaml``): 16 kHz,
n_fft 400, hop 100, 64 channels, four TF-Mamba blocks, d_state 16, d_conv
4, expand 4, 2,258,769 parameters. ``state_dict`` names follow the
published generator's module tree (``dense_encoder``,
``TSMamba.{i}.{time,freq}_mamba.{forward,backward}_blocks.0.{norm,mixer}``,
``TSMamba.{i}.tlinear`` / ``flinear``, ``mask_decoder``,
``phase_decoder``), so its checkpoints load as they are
(``mpsenet.load_state``). PCS post-processing, optional in the paper, is
left out.

``SEMamba`` has ``MPSENet``'s signature and outputs: (mag, pha), each
(B, F, T), to the denoised compressed magnitude and phase. The dense
encoder, the mask and phase decoders, the compression and the learnable
sigmoid are MP-SENet's classes and code (``models.mpsenet``), unchanged.
Each TF-Mamba block (``TFMambaBlock``) runs a bidirectional Mamba along
time over (B*F', T, C), then one along frequency over (B*T, F', C); each
direction is mamba_ssm's ``Block`` with one layer, ``y = Mamba(RMSNorm(x))
+ x``, the backward one on the reversed sequence; the two directions are
concatenated to 2C and merged by a ``ConvTranspose1d(2C, C, 1)`` inside
the half's residual.

The Mamba mixer (``Mamba``, mamba_ssm's Mamba-1 ``Mamba`` module):
``in_proj`` C -> 2 * 4C without bias, split into x and z; the causal
depthwise conv (k = 4, bias) and SiLU: u; ``x_proj`` 4C -> dt_rank + 32
(dt, B, C); ``delta = softplus(dt_proj(dt))``; the selective scan with
``A = -exp(A_log)``, ``D`` and the ``silu(z)`` gate; ``out_proj`` 4C -> C
without bias. The conv and the scan go through ``ops.cuda.ssm_conv`` and
``ops.cuda.ssm_scan``: the hand-written kernels on the card, the plain
versions on the CPU. The backward direction passes ``reverse`` to both
(an anti-causal conv, the scan from the last token down): every other step
is per token, so the published flips are not made.

The model computes in the dtype of its weights (``model.to(torch.bfloat16)``
to serve in bf16): the RMSNorms are ``F.rms_norm`` in float32, rounded once;
the conv and the scan compute in float32 (the scan's state never leaves
the kernel's registers) and round once; the compression, the learnable
sigmoid, the mask product and ``atan2`` run in float32, and both outputs
are float32. The card's routes have no gradient: the model serves under
``torch.inference_mode()``.

Inside ``eval.runner``'s ``adt.model`` span the forward marks its phases
(``utils.profiling``): ``adt.mp.encoder`` and ``adt.mp.decoders`` around
MP-SENet's shared code, ``adt.sm.time`` around each time half of a block
(``adt.sm.time_mixer`` around each of its two Mamba mixers) and
``adt.sm.freq`` (``adt.sm.freq_mixer``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.models.mpsenet import DenseEncoder, MaskDecoder, PhaseDecoder
from audiodenoiser_torch.ops.cuda import ssm_conv, ssm_scan
from audiodenoiser_torch.utils.profiling import (
    MP_DECODERS,
    MP_ENCODER,
    SM_FREQ,
    SM_FREQ_MIXER,
    SM_TIME,
    SM_TIME_MIXER,
    span,
)


class RMSNorm(nn.Module):
    """mamba_ssm's ``RMSNorm(dim, eps)``: a scale and no bias, computed by
    ``F.rms_norm`` in float32 and rounded once to the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), x.shape[-1:], self.weight.float(), self.eps).to(x.dtype)


class Mamba(nn.Module):
    """mamba_ssm's Mamba-1 mixer over (N, L, d_model), channel-last, under
    the published parameter names (``A_log`` and ``D`` first, then
    ``in_proj``, ``conv1d``, ``x_proj``, ``dt_proj``, ``out_proj``), inside
    the span ``mixer_span``."""

    def __init__(self, d_model: int, mixer_span: str, d_state: int = 16, d_conv: int = 4,
                 expand: int = 4):
        super().__init__()
        d_inner, dt_rank = expand * d_model, math.ceil(d_model / 16)
        self.mixer_span = mixer_span
        self.in_proj = nn.Linear(d_model, 2 * d_inner, bias=False)
        self.conv1d = nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner, padding=d_conv - 1)
        self.x_proj = nn.Linear(d_inner, dt_rank + 2 * d_state, bias=False)
        self.dt_proj = nn.Linear(dt_rank, d_inner)
        a = torch.arange(1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1)
        self.A_log = nn.Parameter(torch.log(a))
        self.D = nn.Parameter(torch.ones(d_inner))
        self.out_proj = nn.Linear(d_inner, d_model, bias=False)

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        with span(self.mixer_span):
            xz = F.linear(x, self.in_proj.weight)
            u = ssm_conv(xz, self.conv1d.weight, self.conv1d.bias, reverse)
            x_dbl = F.linear(u, self.x_proj.weight)
            y = ssm_scan(u, xz, x_dbl, self.dt_proj.weight, self.dt_proj.bias, self.A_log,
                         self.D, reverse)
            return F.linear(y, self.out_proj.weight)


class Block(nn.Module):
    """mamba_ssm's ``Block`` as one layer uses it: ``mixer(norm(x)) + x``."""

    def __init__(self, dim: int, mixer_span: str, norm_eps: float, **mixer):
        super().__init__()
        self.mixer = Mamba(dim, mixer_span, **mixer)
        self.norm = RMSNorm(dim, norm_eps)

    def forward(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        return self.mixer(self.norm(x), reverse) + x


class MambaBlock(nn.Module):
    """A bidirectional Mamba over (N, L, C) -> (N, L, 2C): the forward
    direction's block, then the backward one's, concatenated. The
    published code runs the backward block on ``flip(x)`` and flips its
    answer back; here it runs with ``reverse``, which computes the same."""

    def __init__(self, dim: int, mixer_span: str, norm_eps: float, **mixer):
        super().__init__()
        self.forward_blocks = nn.ModuleList([Block(dim, mixer_span, norm_eps, **mixer)])
        self.backward_blocks = nn.ModuleList([Block(dim, mixer_span, norm_eps, **mixer)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y_fwd, y_bwd = x, x
        for layer in self.forward_blocks:
            y_fwd = layer(y_fwd)
        for layer in self.backward_blocks:
            y_bwd = layer(y_bwd, reverse=True)
        return torch.cat([y_fwd, y_bwd], dim=-1)


def _merge(linear: nn.ConvTranspose1d, y: torch.Tensor) -> torch.Tensor:
    """``ConvTranspose1d(2C, C, 1)`` on the channel-last (N, L, 2C)."""
    return F.linear(y, linear.weight[..., 0].t(), linear.bias)


class TFMambaBlock(nn.Module):
    """A bidirectional Mamba along time over (B*F', T, C), then one along
    frequency over (B*T, F', C), each merged back to C inside the block's
    residual."""

    def __init__(self, dim: int, norm_eps: float, **mixer):
        super().__init__()
        self.time_mamba = MambaBlock(dim, SM_TIME_MIXER, norm_eps, **mixer)
        self.freq_mamba = MambaBlock(dim, SM_FREQ_MIXER, norm_eps, **mixer)
        self.tlinear = nn.ConvTranspose1d(2 * dim, dim, 1)
        self.flinear = nn.ConvTranspose1d(2 * dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, f = x.shape
        with span(SM_TIME):
            x = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
            x = _merge(self.tlinear, self.time_mamba(x)) + x
        with span(SM_FREQ):
            x = x.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
            x = _merge(self.flinear, self.freq_mamba(x)) + x
        return x.view(b, t, f, c).permute(0, 3, 1, 2)


class SEMamba(nn.Module):
    """(mag, pha), each (B, n_fft // 2 + 1, T) -> (mag_hat, pha_hat), float32,
    as ``MPSENet``. The defaults are the published recipe's; the STFT sizes
    and the sample rate are kept on the model for the runner."""

    def __init__(self, dense_channel: int = 64, num_tfmamba: int = 4, d_state: int = 16,
                 d_conv: int = 4, expand: int = 4, n_fft: int = 400, hop_length: int = 100,
                 win_length: int = 400, sample_rate: int = 16000, compress_factor: float = 0.3,
                 beta: float = 2.0, norm_eps: float = 1e-5):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = int(n_fft), int(hop_length), int(win_length)
        self.sample_rate = int(sample_rate)
        self.compress_factor = float(compress_factor)
        self._mixer = dict(d_state=int(d_state), d_conv=int(d_conv), expand=int(expand))
        self.norm_eps = float(norm_eps)
        c = int(dense_channel)
        self.dense_encoder = DenseEncoder(c)
        self.TSMamba = nn.ModuleList(TFMambaBlock(c, self.norm_eps, **self._mixer)
                                     for _ in range(num_tfmamba))
        self.mask_decoder = MaskDecoder(c, self.n_fft // 2 + 1, beta)
        self.phase_decoder = PhaseDecoder(c)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the weights."""
        return self.dense_encoder.dense_conv_1[0].weight.dtype

    def config(self) -> dict:
        """The constructor's arguments, as a sidecar keeps them."""
        return dict(dense_channel=self.dense_encoder.dense_conv_1[0].out_channels,
                    num_tfmamba=len(self.TSMamba), **self._mixer, n_fft=self.n_fft,
                    hop_length=self.hop_length, win_length=self.win_length,
                    sample_rate=self.sample_rate, compress_factor=self.compress_factor,
                    beta=self.mask_decoder.lsigmoid.beta, norm_eps=self.norm_eps)

    def forward(self, mag: torch.Tensor, pha: torch.Tensor):
        with span(MP_ENCODER):
            mag_c = mag.float().pow(self.compress_factor)
            x = torch.stack([mag_c, pha.float()], dim=1).transpose(2, 3).to(self.dtype)
            x = self.dense_encoder(x)
        for block in self.TSMamba:
            x = block(x)
        with span(MP_DECODERS):
            mag_hat = mag_c * self.mask_decoder(x)
            pha_hat = self.phase_decoder(x)
        return mag_hat, pha_hat
