"""Spectrogram U-Net with live BatchNorm (port of ``models/unet.py``, plain
configuration).

A 4-level encoder/decoder of [Conv3x3 -> BatchNorm -> ReLU] x 2 blocks,
conv-before-maxpool downsampling, k2/s2 ConvTranspose upsampling with an
asymmetric zero pad back to the skip's size, a skip-first concat, and a
raw 1x1 conv head: 31,042,369 parameters at the default widths.

Submodules carry the reference model's state_dict names
(``downconv{k}.conv.double_conv.{0,1,3,4}``, ``bottleneck.double_conv.*``,
``upconv{k}.up``, ``upconv{k}.conv.double_conv.*``, ``out``), so a
reference ``unet_denoiser_{noise}.pth`` loads with ``strict=True``. The
layout is NCHW: (batch, 1, freq, time).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class DoubleConv(nn.Module):
    """[Conv3x3(pad 1) -> BatchNorm -> ReLU] x 2. Flax's BatchNorm
    ``momentum=0.9`` keeps 0.9 of the running value: torch's 0.1."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 3, padding=1),
            nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
            nn.Conv2d(out_ch, out_ch, 3, padding=1),
            nn.BatchNorm2d(out_ch, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Down(nn.Module):
    """DoubleConv, then 2x2 max-pool; returns (skip, pooled)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = DoubleConv(in_ch, out_ch)

    def forward(self, x: torch.Tensor):
        skip = self.conv(x)
        return skip, F.max_pool2d(skip, 2)


class Up(nn.Module):
    """ConvTranspose(k2, s2) -> pad to the skip -> concat(skip, up) -> DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_ch, out_ch, 2, stride=2)
        self.conv = DoubleConv(2 * out_ch, out_ch)

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
    side, including the whole-clip eval shape (257, T).
    """

    def __init__(self, features: Sequence[int] = (64, 128, 256, 512),
                 bottleneck: int = 1024, in_channels: int = 1,
                 out_channels: int = 1):
        super().__init__()
        self.features = tuple(features)
        self.bottleneck_width = bottleneck
        cin = in_channels
        for k, f in enumerate(self.features, start=1):
            self.add_module(f"downconv{k}", Down(cin, f))
            cin = f
        self.bottleneck = DoubleConv(cin, bottleneck)
        cin = bottleneck
        for k, f in enumerate(reversed(self.features), start=1):
            self.add_module(f"upconv{k}", Up(cin, f))
            cin = f
        self.out = nn.Conv2d(cin, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for k in range(1, len(self.features) + 1):
            skip, x = getattr(self, f"downconv{k}")(x)
            skips.append(skip)
        x = self.bottleneck(x)
        for k, skip in enumerate(reversed(skips), start=1):
            x = getattr(self, f"upconv{k}")(x, skip)
        return self.out(x)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
