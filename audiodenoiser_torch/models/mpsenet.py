"""MP-SENet: parallel denoising of magnitude and phase spectra.

Y.-X. Lu, Y. Ai, Z.-H. Ling, "MP-SENet: A Speech Enhancement Model with
Parallel Denoising of Magnitude and Phase Spectra", Interspeech 2023
(arXiv:2305.13686), at the published configuration: 16 kHz, n_fft 400,
hop 100, 64 channels, four TS-Conformer blocks, 2,048,849 parameters.
``state_dict`` names follow the published generator's module tree
(``dense_encoder``, ``TSConformer.{i}.time_conformer`` /
``freq_conformer``, ``mask_decoder``, ``phase_decoder``), so its
checkpoints load as they are.

``MPSENet`` maps the noisy magnitude and phase, (B, F, T) each with
F = n_fft // 2 + 1, to the denoised compressed magnitude and the denoised
phase:

- input planes ``[mag ** 0.3, pha]``, laid out (B, 2, T, F);
- a dense encoder: a 1x1 conv, a dense block of four dilated (3, 3) convs
  along time, and a (1, 3) stride-(1, 2) conv along frequency (201 -> 100
  bins), each followed by InstanceNorm (affine) and PReLU;
- four TS-Conformer blocks: a conformer along time over the (B*F, T, C)
  sequences, then one along frequency over (B*T, F, C), each with the
  block's own residual around it;
- a mask decoder (dense block, transposed conv back to 201 bins, 1x1
  head, per-bin learnable sigmoid ``beta * sigmoid(slope_f * y)``) whose
  mask scales the compressed noisy magnitude, and a phase decoder (dense
  block, transposed conv, two 1x1 heads r and i, ``atan2(i, r)``).

Each conformer is a macaron FFN, 4-head self-attention without positional
encoding (``scaled_dot_product_attention``: no score tensor is
materialised), a conv module (GLU, depthwise k=31, BatchNorm1d on its
running statistics, SiLU) and a final LayerNorm. The published code feeds
(B*F, T, C) to a sequence-first ``nn.MultiheadAttention``; here attention
runs along the axis the paper names (time, then frequency).

The model computes in the dtype of its weights (``model.to(torch.bfloat16)``
to serve in bf16): LayerNorm, InstanceNorm and BatchNorm accumulate their
statistics in float32 inside PyTorch's kernels; the compression, the
learnable sigmoid, the mask product and ``atan2`` run in float32, and both
outputs are float32.

Inside ``eval.runner``'s ``adt.model`` span the forward marks its phases
(``utils.profiling``): ``adt.mp.encoder``, ``adt.mp.time`` around each
time half of a block (``adt.mp.time_attention`` around its attention),
``adt.mp.freq`` (``adt.mp.freq_attention``) and ``adt.mp.decoders``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.utils.profiling import (
    MP_DECODERS,
    MP_ENCODER,
    MP_FREQ,
    MP_FREQ_ATTENTION,
    MP_TIME,
    MP_TIME_ATTENTION,
    span,
)

def _cip(cin: int, cout: int, kernel=(1, 1), stride=(1, 1), dilation=(1, 1),
         padding=(0, 0), transpose: bool = False) -> nn.Sequential:
    """Conv2d (or ConvTranspose2d) -> InstanceNorm2d(affine) -> PReLU(cout)."""
    conv = (nn.ConvTranspose2d(cin, cout, kernel, stride) if transpose
            else nn.Conv2d(cin, cout, kernel, stride, padding, dilation))
    return nn.Sequential(conv, nn.InstanceNorm2d(cout, affine=True), nn.PReLU(cout))


class DenseBlock(nn.Module):
    """Four CIP layers; layer i sees ``cat(y_{i-1}, ..., y_0, x)`` through a
    (3, 3) conv of dilation (2**i, 1), "same" padding; returns y_3."""

    def __init__(self, channels: int, depth: int = 4):
        super().__init__()
        self.dense_block = nn.ModuleList(
            _cip(channels * (i + 1), channels, (3, 3), dilation=(2 ** i, 1),
                 padding=(2 ** i, 1)) for i in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        for i, layer in enumerate(self.dense_block):
            x = layer(skip)
            if i + 1 < len(self.dense_block):
                skip = torch.cat([x, skip], dim=1)
        return x


class DenseEncoder(nn.Module):
    def __init__(self, channels: int, in_channels: int = 2):
        super().__init__()
        self.dense_conv_1 = _cip(in_channels, channels)
        self.dense_block = DenseBlock(channels)
        self.dense_conv_2 = _cip(channels, channels, (1, 3), stride=(1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_conv_2(self.dense_block(self.dense_conv_1(x)))


class FeedForwardModule(nn.Module):
    """LayerNorm -> Linear(C, 4C) -> SiLU -> Linear(4C, C). Indices are the
    published ``ffm`` Sequential's; its dropouts, 3 and 5, are identities."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.ffm = nn.Sequential(nn.LayerNorm(dim), nn.Linear(dim, dim * mult), nn.SiLU(),
                                 nn.Identity(), nn.Linear(dim * mult, dim), nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffm(x)


class MultiheadAttention(nn.Module):
    """Batch-first self-attention over (N, L, C): an in-projection C -> 3C
    with bias, ``n_head`` heads through ``scaled_dot_product_attention``
    (scale 1/sqrt(head dim)), an out-projection with bias. Parameter names
    are ``nn.MultiheadAttention``'s."""

    def __init__(self, dim: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, length, dim = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(n, length, 3, self.n_head, dim // self.n_head).permute(2, 0, 3, 1, 4)
        y = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(y.transpose(1, 2).reshape(n, length, dim))


class AttentionModule(nn.Module):
    def __init__(self, dim: int, n_head: int, attn_span: str):
        super().__init__()
        self.attn = MultiheadAttention(dim, n_head)
        self.layernorm = nn.LayerNorm(dim)
        self.attn_span = attn_span

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layernorm(x)
        with span(self.attn_span):
            return self.attn(x)


class ConformerConvModule(nn.Module):
    """LayerNorm -> pointwise C -> 4C -> GLU -> depthwise k=31 -> BatchNorm1d
    -> SiLU -> pointwise 2C -> C, over (N, L, C). The pointwise convs run
    as matmuls on the channel-last sequence; only the depthwise conv and
    the BatchNorm see the (N, 2C, L) layout. Indices 0-9 are the published
    ``ccm`` Sequential's (1 and 8 its Rearranges, 3 the GLU, 6 the SiLU, 9
    its dropout)."""

    def __init__(self, dim: int, expansion: int = 2, kernel_size: int = 31):
        super().__init__()
        inner = dim * expansion
        self.ccm = nn.Sequential(
            nn.LayerNorm(dim), nn.Identity(), nn.Conv1d(dim, inner * 2, 1), nn.GLU(dim=1),
            nn.Conv1d(inner, inner, kernel_size, padding=(kernel_size - 1) // 2, groups=inner),
            nn.BatchNorm1d(inner), nn.SiLU(), nn.Conv1d(inner, dim, 1), nn.Identity(),
            nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ln, pw1, dw, bn, pw2 = (self.ccm[i] for i in (0, 2, 4, 5, 7))
        y = F.glu(F.linear(ln(x), pw1.weight[..., 0], pw1.bias), dim=-1)
        y = F.silu(bn(dw(y.transpose(1, 2))))
        return F.linear(y.transpose(1, 2), pw2.weight[..., 0], pw2.bias)


class ConformerBlock(nn.Module):
    """x + FFN/2, + MHSA, + conv module, + FFN/2, then LayerNorm."""

    def __init__(self, dim: int, attn_span: str, n_head: int = 4, kernel_size: int = 31):
        super().__init__()
        self.ffm1 = FeedForwardModule(dim)
        self.attn = AttentionModule(dim, n_head, attn_span)
        self.ccm = ConformerConvModule(dim, kernel_size=kernel_size)
        self.ffm2 = FeedForwardModule(dim)
        self.post_ln = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ffm1(x)
        x = x + self.attn(x)
        x = x + self.ccm(x)
        x = x + 0.5 * self.ffm2(x)
        return self.post_ln(x)


class TSConformerBlock(nn.Module):
    """A conformer along time over (B*F, T, C), then one along frequency
    over (B*T, F, C), each inside the block's residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.time_conformer = ConformerBlock(dim, MP_TIME_ATTENTION)
        self.freq_conformer = ConformerBlock(dim, MP_FREQ_ATTENTION)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, f = x.shape
        with span(MP_TIME):
            x = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
            x = self.time_conformer(x) + x
        with span(MP_FREQ):
            x = x.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
            x = self.freq_conformer(x) + x
        return x.view(b, t, f, c).permute(0, 3, 1, 2)


class LearnableSigmoid2d(nn.Module):
    """``beta * sigmoid(slope_f * x)`` with one slope per frequency bin."""

    def __init__(self, in_features: int, beta: float):
        super().__init__()
        self.beta = float(beta)
        self.slope = nn.Parameter(torch.ones(in_features, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, F, T) -> (B, F, T), in float32."""
        return self.beta * torch.sigmoid(self.slope.float() * x.float())


class MaskDecoder(nn.Module):
    def __init__(self, channels: int, n_freq: int, beta: float):
        super().__init__()
        self.dense_block = DenseBlock(channels)
        self.mask_conv = nn.Sequential(
            nn.ConvTranspose2d(channels, channels, (1, 3), (1, 2)),
            nn.Conv2d(channels, 1, (1, 1)), nn.InstanceNorm2d(1, affine=True), nn.PReLU(1),
            nn.Conv2d(1, 1, (1, 1)))
        self.lsigmoid = LearnableSigmoid2d(n_freq, beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F') -> the (B, F, T) mask in float32."""
        y = self.mask_conv(self.dense_block(x))[:, 0]  # (B, T, F)
        return self.lsigmoid(y.transpose(1, 2))


class PhaseDecoder(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.dense_block = DenseBlock(channels)
        self.phase_conv = _cip(channels, channels, (1, 3), stride=(1, 2), transpose=True)
        self.phase_conv_r = nn.Conv2d(channels, 1, (1, 1))
        self.phase_conv_i = nn.Conv2d(channels, 1, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T, F') -> the (B, F, T) phase in float32."""
        x = self.phase_conv(self.dense_block(x))
        r, i = self.phase_conv_r(x)[:, 0].float(), self.phase_conv_i(x)[:, 0].float()
        return torch.atan2(i, r).transpose(1, 2)


class MPSENet(nn.Module):
    """(mag, pha), each (B, n_fft // 2 + 1, T) -> (mag_hat, pha_hat), float32:
    ``mag_hat`` the denoised magnitude in the compressed domain
    (``mag ** compress_factor`` times the mask), ``pha_hat`` in (-pi, pi].
    The defaults are the published ``config.json``'s; the STFT sizes and the
    sample rate are kept on the model for the runner."""

    def __init__(self, dense_channel: int = 64, num_tsconformers: int = 4, n_fft: int = 400,
                 hop_length: int = 100, win_length: int = 400, sample_rate: int = 16000,
                 compress_factor: float = 0.3, beta: float = 2.0):
        super().__init__()
        self.n_fft, self.hop_length, self.win_length = int(n_fft), int(hop_length), int(win_length)
        self.sample_rate = int(sample_rate)
        self.compress_factor = float(compress_factor)
        c = int(dense_channel)
        self.dense_encoder = DenseEncoder(c)
        self.TSConformer = nn.ModuleList(TSConformerBlock(c) for _ in range(num_tsconformers))
        self.mask_decoder = MaskDecoder(c, self.n_fft // 2 + 1, beta)
        self.phase_decoder = PhaseDecoder(c)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the weights."""
        return self.dense_encoder.dense_conv_1[0].weight.dtype

    def config(self) -> dict:
        """The constructor's arguments, as a sidecar keeps them."""
        return dict(dense_channel=self.dense_encoder.dense_conv_1[0].out_channels,
                    num_tsconformers=len(self.TSConformer), n_fft=self.n_fft,
                    hop_length=self.hop_length, win_length=self.win_length,
                    sample_rate=self.sample_rate, compress_factor=self.compress_factor,
                    beta=self.mask_decoder.lsigmoid.beta)

    def forward(self, mag: torch.Tensor, pha: torch.Tensor):
        with span(MP_ENCODER):
            mag_c = mag.float().pow(self.compress_factor)
            x = torch.stack([mag_c, pha.float()], dim=1).transpose(2, 3).to(self.dtype)
            x = self.dense_encoder(x)
        for block in self.TSConformer:
            x = block(x)
        with span(MP_DECODERS):
            mag_hat = mag_c * self.mask_decoder(x)
            pha_hat = self.phase_decoder(x)
        return mag_hat, pha_hat


def mag_pha(spec: torch.Tensor, n_fft: int, win_length: int):
    """The published ``mag_pha_stft`` before compression: a complex
    (B, F, T) STFT of real clips, centre-padded by reflection, ->
    magnitude ``sqrt(re^2 + im^2 + 1e-9)`` and phase
    ``atan2(im + 1e-10, re + 1e-5)``.

    The imaginary parts that are exactly 0 in exact arithmetic are set to
    0 first: the DC and Nyquist bins' (a real signal's), and frame 0's
    where n_fft and the window's padding are even (the reflected frame is
    symmetric about its centre, as is the Hann window, so its spectrum is
    real). Left to rounding, their sign would decide between +pi and -pi
    at every bin of negative real part, and the network takes the phase as
    it is."""
    im = spec.imag.clone()
    im[:, 0] = 0
    if n_fft % 2 == 0:
        im[:, -1] = 0
        if (n_fft - win_length) % 2 == 0:
            im[..., 0] = 0
    re = spec.real
    return torch.sqrt(re * re + im * im + 1e-9), torch.atan2(im + 1e-10, re + 1e-5)


def load_state(model: MPSENet, state: dict) -> MPSENet:
    """Load a state_dict, or the published checkpoint's ``{"generator":
    state_dict}``, strictly."""
    if "generator" in state and isinstance(state["generator"], dict):
        state = state["generator"]
    model.load_state_dict(state, strict=True)
    return model
