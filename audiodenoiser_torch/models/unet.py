"""Spectrogram U-Net with live BatchNorm (port of ``models/unet.py``, plain
configuration, with its ``dtype``, ``pallas_deconv`` and ``remat`` options).

A 4-level encoder/decoder of [Conv3x3 -> BatchNorm -> ReLU] x 2 blocks,
conv-before-maxpool downsampling, k2/s2 ConvTranspose upsampling with an
asymmetric zero pad back to the skip's size, a skip-first concat, and a
raw 1x1 conv head: 31,042,369 parameters at the default widths.

Submodules carry the reference model's state_dict names
(``downconv{k}.conv.double_conv.{0,1,3,4}``, ``bottleneck.double_conv.*``,
``upconv{k}.up``, ``upconv{k}.conv.double_conv.*``, ``out``), so a
reference ``unet_denoiser_{noise}.pth`` loads with ``strict=True``, with
or without ``pallas_deconv``. The layout is logical NCHW, (batch, 1, freq,
time); activations are channels_last (NHWC) in memory, the layout of
cuDNN's Hopper convolutions and of the K3 kernel.

Mixed precision follows Flax: parameters stay float32; convolutions
compute in ``dtype`` (input, kernel and bias cast to it); BatchNorm
computes in float32 and the ReLU's output is cast back to ``dtype``; the
result is cast to the input's dtype.

``remat=True`` (Flax's ``nn.remat(DoubleConv)``) keeps no activation inside
a ``DoubleConv`` for the backward and recomputes the block there instead
(``torch.utils.checkpoint``, non-reentrant). The recompute leaves the
BatchNorm running statistics and ``num_batches_tracked`` alone, as JAX's
functional remat does, so they move once a step either way.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from audiodenoiser_torch.ops.cuda.deconv import conv_transpose_2x2


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (Flax ``nn.Conv(dtype)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)``.

    Train mode normalises with the biased batch variance, as
    ``nn.BatchNorm2d`` does, but folds the biased variance into the running
    statistics, ``ra = 0.9*ra + 0.1*batch`` (``nn.BatchNorm2d`` folds the
    unbiased one). Statistics are float32 (Welford's form, where Flax uses
    ``E[x^2] - E[x]^2``: the two differ by rounding). Eval mode is torch's.
    Output is float32 (at least). ``recomputing`` is set while remat runs the
    forward a second time in the backward: the statistics are not folded
    again then.
    """

    recomputing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return super().forward(x)
        if self.recomputing:
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean)
            self.running_var.mul_(1.0 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class DoubleConv(nn.Module):
    """[Conv3x3(pad 1) -> BatchNorm -> ReLU -> cast] x 2. Flax's BatchNorm
    ``momentum=0.9`` keeps 0.9 of the running value: torch's 0.1."""

    def __init__(self, in_ch: int, out_ch: int, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.double_conv = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1),
            BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
            Conv2d(out_ch, out_ch, 3, padding=1),
            BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
        )

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        seq = self.double_conv
        x = seq[2](seq[1](seq[0](x))).to(dtype)
        return seq[5](seq[4](seq[3](x))).to(dtype)

    @contextlib.contextmanager
    def _recompute(self):
        norms = (self.double_conv[1], self.double_conv[4])
        for bn in norms:
            bn.recomputing = True
        try:
            yield
        finally:
            for bn in norms:
                bn.recomputing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            # nothing in the block draws random numbers: no RNG state to keep
            return checkpoint(self._block, x, use_reentrant=False, preserve_rng_state=False,
                              context_fn=lambda: (contextlib.nullcontext(), self._recompute()))
        return self._block(x)


class Down(nn.Module):
    """DoubleConv, then 2x2 max-pool; returns (skip, pooled)."""

    def __init__(self, in_ch: int, out_ch: int, remat: bool = False):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch, remat)

    def forward(self, x: torch.Tensor):
        skip = self.conv(x)
        return skip, F.max_pool2d(skip, 2)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """``ConvTranspose2d(k=2, s=2)`` in its input's dtype; with ``kernel``
    set it runs through the K3 CUDA kernel (``ops.cuda.deconv``) with the
    same parameters, else through ``F.conv_transpose2d``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: bool = False):
        super().__init__(in_ch, out_ch, 2, stride=2)
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel:
            return conv_transpose_2x2(x.contiguous(memory_format=torch.channels_last),
                                      self.weight, self.bias)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  stride=2)


class Up(nn.Module):
    """ConvTranspose(k2, s2) -> pad to the skip -> concat(skip, up) -> DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: bool = False, remat: bool = False):
        super().__init__()
        self.up = ConvTranspose2x2(in_ch, out_ch, kernel)
        self.conv = DoubleConv(2 * out_ch, out_ch, remat)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([skip, pad_to_match(self.up(x), skip)], dim=1))


def pad_to_match(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Zero-pad H/W of ``x`` (NCHW) up to ``target``'s, the odd row or
    column at the bottom/right. ``F.pad`` takes the last dim first."""
    dy = target.shape[-2] - x.shape[-2]
    dx = target.shape[-1] - x.shape[-1]
    if dy == 0 and dx == 0:
        return x
    return F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class UNet(nn.Module):
    """4-level magnitude-spectrogram U-Net: (N, 1, F, T) -> (N, 1, F, T).

    Fully convolutional: accepts any (freq, time) of at least 16 on each
    side, including the whole-clip eval shape (257, T). ``dtype`` is the
    compute dtype; ``pallas_deconv`` (the JAX option's name) routes the
    four upsamplings through the K3 kernel; ``remat`` recomputes each
    ``DoubleConv`` in the backward (K3, in ``Up``, runs once). ``zero_out_init`` starts the
    1x1 head's kernel at zero (``train.loop.init_flax_like`` keeps it so),
    which makes a fresh residual mask head an exact pass-through.
    """

    def __init__(self, features: Sequence[int] = (64, 128, 256, 512),
                 bottleneck: int = 1024, in_channels: int = 1,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 pallas_deconv: bool = False, zero_out_init: bool = False,
                 remat: bool = False):
        super().__init__()
        self.features = tuple(features)
        self.bottleneck_width = bottleneck
        self.dtype = dtype
        self.pallas_deconv = pallas_deconv
        self.zero_out_init = zero_out_init
        self.remat = remat
        cin = in_channels
        for k, f in enumerate(self.features, start=1):
            self.add_module(f"downconv{k}", Down(cin, f, remat))
            cin = f
        self.bottleneck = DoubleConv(cin, bottleneck, remat)
        cin = bottleneck
        for k, f in enumerate(reversed(self.features), start=1):
            self.add_module(f"upconv{k}", Up(cin, f, pallas_deconv, remat))
            cin = f
        self.out = Conv2d(cin, out_channels, 1)
        if zero_out_init:
            nn.init.zeros_(self.out.weight)
        # channels_last kernels make the convolutions keep channels_last
        # activations (a 1-channel input alone cannot say which it is)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        skips = []
        for k in range(1, len(self.features) + 1):
            skip, x = getattr(self, f"downconv{k}")(x)
            skips.append(skip)
        x = self.bottleneck(x)
        for k, skip in enumerate(reversed(skips), start=1):
            x = getattr(self, f"upconv{k}")(x, skip)
        return self.out(x).to(in_dtype)


def scaled_widths(width_mult: float = 1.0) -> tuple[tuple[int, ...], int]:
    """Channel widths of a width-scaled U-Net: 1.0 is the reference
    (64..512, bottleneck 1024); each width rounds to a multiple of 8, at
    least 8 (0.5 -> 7.8M parameters, 0.25 -> 2.0M)."""
    if width_mult <= 0:
        raise ValueError(f"width_mult must be positive, got {width_mult}")

    def _scale(c: int) -> int:
        return max(8, int(round(c * width_mult / 8)) * 8)

    return tuple(_scale(c) for c in (64, 128, 256, 512)), _scale(1024)


def width_kwargs(width_mult: float) -> dict:
    """``UNet`` constructor kwargs for a width multiplier ({} at 1.0)."""
    if width_mult == 1.0:
        return {}
    feats, bottleneck = scaled_widths(width_mult)
    return {"features": feats, "bottleneck": bottleneck}


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
