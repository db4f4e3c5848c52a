"""Noise-type router (port of ``models/router.py``): a small CNN that
predicts a clip's corruption from its noisy magnitude spectrogram, so that
the four specialists become a self-routing mixture (``eval.ensemble``).

``log1p -> [Conv3x3 s2 -> GroupNorm -> ReLU] x 4 -> global average pool
-> Dense``: fully convolutional, so one set of weights scores the (256, 64)
training crop and whole (257, T) clips alike. Input (B, 1, F, T) linear
magnitudes, output (B, 4) float32 logits in ``NOISE_CLASSES`` order.

The arithmetic is Flax's, step by step:

- ``padding="SAME"`` at stride 2 pads each axis by its parity: (0, 1) for
  an even length, (1, 1) for an odd one (``Conv2d(padding=1)`` would pad
  (1, 1) always and shift every output of an even input by one sample);
- ``log1p`` in float32, cast to ``dtype``; the convolution in ``dtype``
  with float32 parameters cast to it;
- GroupNorm (8 groups, epsilon 1e-6) in float32 on the ``dtype`` input,
  the variance as ``E[x^2] - E[x]^2`` clipped at 0 (Flax's fast
  variance), then ReLU and a cast back to ``dtype``;
- the pool is a mean in ``dtype`` (bf16 rounds it), the head float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

# label order: OnDeviceMixer's per-example corruption draw, the reference's
# NOISE_TYPES
NOISE_CLASSES = ("white", "urban", "reverb", "noise_cancellation")


def same_pads(n: int, kernel: int = 3, stride: int = 2) -> tuple[int, int]:
    """(low, high) padding of XLA's ``SAME`` for one axis of length ``n``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def group_norm(x: torch.Tensor, groups: int, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Flax ``GroupNorm`` over (B, C, H, W) in float32: per-group mean and
    fast variance, ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    x = x.float()
    b, c = x.shape[:2]
    g = x.reshape(b, groups, -1)
    mu = g.mean(-1)
    var = torch.clamp((g * g).mean(-1) - mu * mu, min=0.0)
    mu = mu.repeat_interleave(c // groups, dim=1)[:, :, None, None]
    var = var.repeat_interleave(c // groups, dim=1)[:, :, None, None]
    mul = torch.rsqrt(var + eps) * scale.float()[None, :, None, None]
    return (x - mu) * mul + bias.float()[None, :, None, None]


class NoiseClassifier(nn.Module):
    """log1p -> [Conv3x3 s2 -> GroupNorm -> ReLU] x 4 -> GAP -> Dense.

    The default widths (16, 32, 64, 128) hold 98,148 parameters."""

    def __init__(self, num_classes: int = len(NOISE_CLASSES),
                 widths: Sequence[int] = (16, 32, 64, 128), groups: int = 8,
                 dtype: torch.dtype = torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.widths = tuple(widths)
        self.groups = groups
        self.dtype = dtype
        self.eps = eps
        cins = (1, *self.widths[:-1])
        self.convs = nn.ModuleList(nn.Conv2d(ci, w, 3, stride=2)
                                   for ci, w in zip(cins, self.widths))
        self.gns = nn.ModuleList(nn.GroupNorm(groups, w, eps=eps) for w in self.widths)
        self.head = nn.Linear(self.widths[-1], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, F, T) linear magnitudes -> (B, num_classes) float32 logits."""
        x = torch.log1p(x.float()).to(self.dtype)
        for conv, gn in zip(self.convs, self.gns):
            (top, bottom), (left, right) = same_pads(x.shape[2]), same_pads(x.shape[3])
            x = F.pad(x, (left, right, top, bottom))
            x = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype), stride=2)
            x = group_norm(x, self.groups, gn.weight, gn.bias, self.eps)
            x = F.relu(x).to(self.dtype)
        x = x.mean(dim=(2, 3))  # in dtype: shape-agnostic over (F, T)
        return self.head(x.float())
