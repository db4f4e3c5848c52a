"""Spectrogram U-Net with live BatchNorm (port of ``models/unet.py``, with
its ``dtype``, ``pallas_deconv``, ``remat``, ``s2d_stem``, ``s2d_skip`` and
``attn_bottleneck`` options).

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

``s2d_stem`` packs each 2x2 input block into channels (``space_to_depth``,
JAX's phase-major channel order), so the whole pyramid runs at half
resolution, and the 1x1 head emits four times its channels for
``depth_to_space``. An odd input is padded at the bottom and right first
and the output cropped back. ``s2d_skip`` K adds the full-resolution
refinement path: a BN-free Conv3x3 -> ReLU on the padded input
(``s2d_skip_conv``), concatenated after the unpacked head's K channels,
and a final Conv3x3 (``s2d_refine``). ``attn_bottleneck`` runs one pre-LN
multi-head self-attention block (``BottleneckAttention``) on the
bottleneck's pixels.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from audiodenoiser_torch.ops.cuda.deconv import conv_transpose_2x2
from audiodenoiser_torch.parallel.layers import copy_to_model, gather_channels, synced_batch_norm


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (Flax ``nn.Conv(dtype)``).
    ``tp`` (set by ``parallel.mesh``) makes it column-parallel: it holds an
    output-channel slice and its input's cotangent is all-reduced over the
    model group."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.tp)
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
    again then. With ``data_group`` (set by ``parallel.mesh``) train mode
    takes the statistics of the data group's global batch
    (``parallel.layers.synced_batch_norm``).
    """

    recomputing = False
    data_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            return super().forward(x)
        if self.data_group is not None:
            y, mean, var = synced_batch_norm(x, self.weight, self.bias, self.eps,
                                             self.data_group)
            if not self.recomputing:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(m * mean)
                    self.running_var.mul_(1.0 - m).add_(m * var)
                    self.num_batches_tracked.add_(1)
            return y
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
        x = gather_channels(seq[2](seq[1](seq[0](x))), seq[0].tp).to(dtype)
        return gather_channels(seq[5](seq[4](seq[3](x))), seq[3].tp).to(dtype)

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
    same parameters, else through ``F.conv_transpose2d``. ``tp`` as
    ``Conv2d``'s; ``repack`` (set under fsdp, whose gathered weight may
    change without a version bump) makes K3 pack its weight every call."""

    tp = None
    repack = False

    def __init__(self, in_ch: int, out_ch: int, kernel: bool = False):
        super().__init__(in_ch, out_ch, 2, stride=2)
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_model(x, self.tp)
        if self.kernel:
            weight = self.weight.view_as(self.weight) if self.repack else self.weight
            return conv_transpose_2x2(x.contiguous(memory_format=torch.channels_last),
                                      weight, self.bias)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                                  stride=2)


class Up(nn.Module):
    """ConvTranspose(k2, s2) -> pad to the skip -> concat(skip, up) -> DoubleConv."""

    def __init__(self, in_ch: int, out_ch: int, kernel: bool = False, remat: bool = False):
        super().__init__()
        self.up = ConvTranspose2x2(in_ch, out_ch, kernel)
        self.conv = DoubleConv(2 * out_ch, out_ch, remat)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = gather_channels(self.up(x), self.up.tp)
        return self.conv(torch.cat([skip, pad_to_match(up, skip)], dim=1))


def pad_to_match(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Zero-pad H/W of ``x`` (NCHW) up to ``target``'s, the odd row or
    column at the bottom/right. ``F.pad`` takes the last dim first."""
    dy = target.shape[-2] - x.shape[-2]
    dx = target.shape[-1] - x.shape[-1]
    if dy == 0 and dx == 0:
        return x
    return F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), each 2x2 block into channels in
    JAX's order: pixel (2p+a, 2q+b) of channel c lands in channel
    (a*2 + b)*C + c (``F.pixel_unshuffle`` packs c*4 + a*2 + b instead).
    H and W must be even. The result is in ``channels_last`` memory."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2).contiguous(memory_format=torch.channels_last)


def depth_to_space(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """(B, 4C, H, W) -> (B, C, 2H, 2W), the inverse of ``space_to_depth``."""
    b, _, h, w = x.shape
    x = x.reshape(b, 2, 2, out_channels, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, out_channels, 2 * h, 2 * w).contiguous(
        memory_format=torch.channels_last)


def _sincos_2d(h: int, w: int, dim: int) -> np.ndarray:
    """The fixed 2-D sin/cos positional encoding (h, w, dim), float32,
    computed in float64: the first half of the channels encodes the row,
    the second the column (JAX ``models/unet.py::_sincos_2d``)."""
    half = dim // 2

    def enc(n, d):
        pos = np.arange(n, dtype=np.float64)[:, None]
        i = np.arange(d // 2, dtype=np.float64)[None, :]
        ang = pos / np.power(10000.0, 2.0 * i / d)
        return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)

    eh = enc(h, half)
    ew = enc(w, dim - half)
    pe = np.concatenate([np.broadcast_to(eh[:, None, :], (h, w, half)),
                         np.broadcast_to(ew[None, :, :], (h, w, dim - half))], axis=-1)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _positions(h: int, w: int, dim: int, device: torch.device) -> torch.Tensor:
    """``_sincos_2d`` as an (h*w, dim) float32 tensor on ``device``, one per
    shape. A normal tensor even when first asked for under inference_mode:
    a training step may use it next."""
    with torch.inference_mode(False):
        return torch.from_numpy(_sincos_2d(h, w, dim).reshape(h * w, dim)).to(device)


class Dense(nn.Linear):
    """``nn.Linear`` computing in its input's dtype, the product rounded
    before the bias is added, as Flax's ``DenseGeneral(dtype)``."""

    zero_init = False  # Flax's zeros kernel initialiser (``init_flax_like``)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.to(x.dtype).t()) + self.bias.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """Flax ``nn.LayerNorm(epsilon=1e-6, dtype=float32)``: statistics in
    float32 with the fast variance ``E[x^2] - E[x]^2`` (clamped at 0), then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class BottleneckAttention(nn.Module):
    """One pre-LN multi-head self-attention block over the bottleneck's
    pixels, with a residual (JAX ``models/unet.py::BottleneckAttention``):
    ``tok = (LayerNorm(y) + pe)`` in the compute dtype, 4 heads of
    ``max(64, c // 4) / 4`` features, an output projection back to c
    (zero-initialised, so a fresh block is a no-op), ``y + attn``.

    The compute dtype is the input's. As Flax does, the query is scaled by
    1/sqrt(head dim) in that dtype and the softmax's result is cast to it;
    the products are explicit matmuls, so fp32 follows Flax's arithmetic.
    """

    def __init__(self, channels: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        qkv = max(64, channels // 4)
        self.ln = LayerNorm(channels)
        self.query = Dense(channels, qkv)
        self.key = Dense(channels, qkv)
        self.value = Dense(channels, qkv)
        self.out = Dense(qkv, channels)
        self.out.zero_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        dtype = x.dtype
        y = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        tok = (self.ln(y) + _positions(h, w, c, x.device)).to(dtype)

        def heads(t):  # (b, n, heads*d) -> (b, heads, n, d)
            return t.reshape(b, h * w, self.heads, -1).transpose(1, 2)

        q, k, v = heads(self.query(tok)), heads(self.key(tok)), heads(self.value(tok))
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=torch.float32).to(dtype)
        weights = torch.softmax(torch.matmul(q, k.transpose(-2, -1)), dim=-1).to(dtype)
        attn = torch.matmul(weights, v).transpose(1, 2).reshape(b, h * w, -1)
        out = (y + self.out(attn)).to(dtype)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class UNet(nn.Module):
    """4-level magnitude-spectrogram U-Net: (N, 1, F, T) -> (N, 1, F, T).

    Fully convolutional: accepts any (freq, time) of at least 16 on each
    side (32 with ``s2d_stem``), including the whole-clip eval shape
    (257, T). ``dtype`` is the compute dtype; ``pallas_deconv`` (the JAX
    option's name) routes the four upsamplings through the K3 kernel;
    ``remat`` recomputes each ``DoubleConv`` in the backward (K3, in
    ``Up``, runs once). ``zero_out_init`` starts the last conv's kernel at
    zero (``head``: the 1x1 ``out``, or ``s2d_refine`` with the refinement
    path; ``train.loop.init_flax_like`` keeps it so), which makes a fresh
    residual mask head an exact pass-through. ``s2d_stem``, ``s2d_skip``
    and ``attn_bottleneck`` are the JAX variants (module docstring).
    """

    def __init__(self, features: Sequence[int] = (64, 128, 256, 512),
                 bottleneck: int = 1024, in_channels: int = 1,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 pallas_deconv: bool = False, zero_out_init: bool = False,
                 remat: bool = False, attn_bottleneck: bool = False,
                 s2d_stem: bool = False, s2d_skip: int = 0):
        super().__init__()
        self.features = tuple(features)
        self.bottleneck_width = bottleneck
        self.out_channels = out_channels
        self.dtype = dtype
        self.pallas_deconv = pallas_deconv
        self.zero_out_init = zero_out_init
        self.remat = remat
        self.attn_bottleneck = attn_bottleneck
        self.s2d_stem = s2d_stem
        self.s2d_skip = int(s2d_skip) if s2d_stem else 0
        cin = 4 * in_channels if s2d_stem else in_channels
        for k, f in enumerate(self.features, start=1):
            self.add_module(f"downconv{k}", Down(cin, f, remat))
            cin = f
        self.bottleneck = DoubleConv(cin, bottleneck, remat)
        if attn_bottleneck:
            self.bottleneck_attn = BottleneckAttention(bottleneck)
        cin = bottleneck
        for k, f in enumerate(reversed(self.features), start=1):
            self.add_module(f"upconv{k}", Up(cin, f, pallas_deconv, remat))
            cin = f
        head = self.s2d_skip or out_channels
        self.out = Conv2d(cin, 4 * head if s2d_stem else head, 1)
        if self.s2d_skip:
            self.s2d_skip_conv = Conv2d(in_channels, self.s2d_skip, 3, padding=1)
            self.s2d_refine = Conv2d(2 * self.s2d_skip, out_channels, 3, padding=1)
        if zero_out_init:
            nn.init.zeros_(self.head.weight)
        # channels_last kernels make the convolutions keep channels_last
        # activations (a 1-channel input alone cannot say which it is)
        self.to(memory_format=torch.channels_last)

    @property
    def head(self) -> nn.Conv2d:
        """The last conv, which ``zero_out_init`` starts at zero."""
        return self.s2d_refine if self.s2d_skip else self.out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        if self.s2d_stem:
            in_h, in_w = x.shape[-2:]
            if in_h % 2 or in_w % 2:  # odd eval shapes, e.g. (257, T) whole clips
                x = F.pad(x, (0, in_w % 2, 0, in_h % 2))
            x_full = x
            x = space_to_depth(x)
        skips = []
        for k in range(1, len(self.features) + 1):
            skip, x = getattr(self, f"downconv{k}")(x)
            skips.append(skip)
        x = self.bottleneck(x)
        if self.attn_bottleneck:
            x = self.bottleneck_attn(x)
        for k, skip in enumerate(reversed(skips), start=1):
            x = getattr(self, f"upconv{k}")(x, skip)
        x = self.out(x)
        if self.s2d_stem:
            if self.s2d_skip:
                # the refine conv sees the padded input; the crop comes after it
                fr = F.relu(self.s2d_skip_conv(x_full))
                x = self.s2d_refine(torch.cat([depth_to_space(x, self.s2d_skip), fr], dim=1))
            else:
                x = depth_to_space(x, self.out_channels)
            x = x[..., :in_h, :in_w]
        return x.to(in_dtype)


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
