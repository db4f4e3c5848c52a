"""Int8 compute for U-Net inference (port of ``models/int8.py``).

The convolutions themselves run in int8 (int8 x int8 -> int32), not only
the stored weights:

1. every [Conv -> eval BatchNorm] pair is folded into one float32 conv
   (``models.folded._fold_conv_bn``);
2. each kernel, the deconvolutions' and ``out``'s included, is quantized
   to symmetric int8 per output channel, scale ``absmax / 127``;
3. each conv and deconv input is quantized on the fly by one per-tensor
   scale, ``max|x| / 127`` floored at float32's ``tiny``, so no
   calibration pass is needed;
4. the products accumulate in int32 (``torch._int_mm``), then are
   rescaled to float32 by ``s_x * s_w[cout]``, the bias added and, inside
   a ``DoubleConv``, the ReLU applied.

Activations between layers are float32 in NHWC memory. A 3x3 conv is one
matrix product over an int8 im2col of the padded input (an ``as_strided``
view copied once, as 8-byte words where the channels allow, in slices of
at most ``IM2COL_BYTES``: never unfolded in float32); a 2x2 stride-2 deconv is one product with ``4*Cout`` columns
scattered to the four sub-pixels; ``out`` is a product over the pixels.
``torch._int_mm`` wants more than 16 rows and column counts that are
multiples of 8 on the card, so the stem's K of 9 is zero-padded to 16 and
``out``'s single column to 8 (zeros change no sum). The same products run
on the CPU, where they are exact too.

Because the activation scale is per tensor, a clip's answer depends on its
batch mates, as in the JAX package. ``Int8UNet`` takes and returns (N, 1,
F, T) like ``UNet`` and drops into ``eval.runner.DenoiserRunner`` in
``noisy_phase`` mode; it is inference only.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.models.folded import _fold_conv_bn
from audiodenoiser_torch.models.unet import UNet

IM2COL_BYTES = 1 << 30  # the largest int8 im2col slice one product takes
_TINY = torch.finfo(torch.float32).tiny


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` correctly rounded on every device: CUDA's division by a
    Python number multiplies by its reciprocal, which is up to an ulp off
    (as XLA's jit of the JAX package's ``/ 127.0``), so divide by a tensor."""
    return t / torch.full_like(t, 127.0)


def quantize_kernel(kernel: torch.Tensor, cout_dim: int):
    """Symmetric per-output-channel int8 of a float32 kernel: ``(q8,
    scale)``, ``scale = absmax / 127`` (1 where a channel is all zero) and
    ``q8 = clip(round(kernel / scale), -127, 127)``, as JAX's
    ``_quantize_kernel``; ``cout_dim`` is the output-channel axis."""
    dims = [d for d in range(kernel.dim()) if d != cout_dim]
    absmax = kernel.abs().amax(dim=dims)
    scale = torch.where(absmax > 0, _div127(absmax), torch.ones_like(absmax))
    shape = [1] * kernel.dim()
    shape[cout_dim] = -1
    q8 = torch.clamp(torch.round(kernel / scale.reshape(shape)), -127, 127).to(torch.int8)
    return q8, scale


def quant_act(x: torch.Tensor):
    """Dynamic per-tensor int8 of float32 ``x``: ``(xq, s)`` with ``s =
    max(max|x| / 127, tiny)`` and ``xq = clip(round(x / s), -127, 127)``
    (``max|x|`` read as ``max(-min x, max x)``, with no temporary)."""
    lo, hi = torch.aminmax(x)
    s = torch.clamp_min(_div127(torch.maximum(-lo, hi)), _TINY)
    return torch.div(x, s).round_().clamp_(-127, 127).to(torch.int8), s


def _im2col(xp: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The 3x3 patches of a padded NHWC int8 tensor (B, h+2, w+2, C) as
    (B*h*w, 9*C) rows in (ky, kx, c) order: one strided copy, done on a
    view of the channels as 8-, 4- or 2-byte words where C allows, so the
    copy moves words instead of bytes."""
    b, _, _, c = xp.shape
    word = next(t for t, n in ((torch.int64, 8), (torch.int32, 4), (torch.int16, 2),
                               (torch.int8, 1)) if c % n == 0)
    v = xp.view(word)
    sb, sh, sw, _ = v.stride()
    patches = v.as_strided((b, h, w, 3, 3, v.shape[-1]), (sb, sh, sw, sh, sw, 1))
    return patches.reshape(b * h * w, -1).view(torch.int8)


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a`` (M, K) int8 times ``w`` (N, K) int8 transposed -> (M, N) int32;
    K and N are multiples of 8. Fewer than 17 rows are zero-padded."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 32 - m))
    return torch._int_mm(a, w.t())[:m]


class QuantizedLayer(nn.Module):
    """One int8 layer: ``weight`` (N_pad, K_pad) int8 in the row order of
    its im2col, per-column float32 ``scale`` and ``bias`` (N real columns).
    ``kind`` is ``"conv3"`` (3x3 SAME), ``"conv1"`` (1x1) or ``"deconv"``
    (2x2 stride 2, N = 4*cout in (a, b, cout) order)."""

    def __init__(self, kind: str, weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, cin: int, cout: int):
        super().__init__()
        self.kind, self.cin, self.cout = kind, cin, cout
        n, k = weight.shape
        padded = torch.zeros(_round_up(n, 8), _round_up(k, 8), dtype=torch.int8,
                             device=weight.device)
        padded[:n, :k] = weight
        self.register_buffer("weight", padded)
        self.register_buffer("scale", scale.detach().float().clone())
        self.register_buffer("bias", bias.detach().float().clone())

    def accumulate(self, x: torch.Tensor):
        """NHWC float32 (B, H, W, cin) -> ``(acc, s_x)``: the int32 products
        (B, H, W, N) of the quantized input with the int8 kernel, and the
        input's scale."""
        xq, sx = quant_act(x)
        b, h, w, c = xq.shape
        n_cols, k_pad = self.scale.shape[0], self.weight.shape[1]
        if self.kind != "conv3":
            cols = xq.reshape(b * h * w, c)
            if k_pad != c:
                cols = F.pad(cols, (0, k_pad - c))
            return _int_mm(cols, self.weight)[:, :n_cols].reshape(b, h, w, n_cols), sx
        acc = torch.empty(b, h, w, n_cols, dtype=torch.int32, device=x.device)
        xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
        step = max(1, IM2COL_BYTES // (h * w * k_pad))
        for b0 in range(0, b, step):
            cols = _im2col(xp[b0:b0 + step], h, w)
            nb = cols.shape[0] // (h * w)
            if k_pad != 9 * c:
                cols = F.pad(cols, (0, k_pad - 9 * c))
            acc[b0:b0 + nb] = _int_mm(cols, self.weight)[:, :n_cols].reshape(nb, h, w, n_cols)
        return acc, sx

    def forward(self, x: torch.Tensor, relu: bool = False) -> torch.Tensor:
        """NHWC float32 (B, H, W, cin) -> NHWC float32 (B, H', W', cout):
        the int32 products rescaled by ``s_x * scale``, the bias added."""
        acc, sx = self.accumulate(x)
        out = acc.float().mul_(sx * self.scale).add_(self.bias)
        if relu:
            out.relu_()
        if self.kind == "deconv":  # (B, H, W, a, b, cout) -> (B, 2H, 2W, cout)
            b, h, w, _ = out.shape
            out = out.reshape(b, h, w, 2, 2, self.cout).permute(0, 1, 3, 2, 4, 5)
            out = out.reshape(b, 2 * h, 2 * w, self.cout)
        return out


def _conv_layer(kernel: torch.Tensor, bias: torch.Tensor) -> QuantizedLayer:
    """A float32 OIHW conv kernel (3x3 or 1x1) and its bias, quantized."""
    q8, scale = quantize_kernel(kernel, 0)
    cout, cin, kh, _ = kernel.shape
    weight = q8.permute(0, 2, 3, 1).reshape(cout, kh * kh * cin)  # (ky, kx, c) columns
    return QuantizedLayer("conv3" if kh == 3 else "conv1", weight, scale, bias, cin, cout)


def _deconv_layer(kernel: torch.Tensor, bias: torch.Tensor) -> QuantizedLayer:
    """A float32 (Cin, Cout, 2, 2) transposed-conv kernel and its bias,
    quantized per Cout (the orientation of ``models.convert``'s deconv
    mapping flips no channel, so the scales are JAX's)."""
    q8, scale = quantize_kernel(kernel, 1)
    cin, cout = kernel.shape[:2]
    weight = q8.permute(2, 3, 1, 0).reshape(4 * cout, cin)  # rows (a, b, cout)
    return QuantizedLayer("deconv", weight, scale.repeat(4), bias.repeat(4), cin, cout)


def _pad_to_match(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """NHWC zero pad of H/W up to ``target``'s, the odd row or column at the
    bottom/right (``models.unet.pad_to_match`` in NHWC)."""
    dy = target.shape[1] - x.shape[1]
    dx = target.shape[2] - x.shape[2]
    if dy == 0 and dx == 0:
        return x
    return F.pad(x, (0, 0, dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class Int8UNet(nn.Module):
    """The U-Net's dataflow with each conv and deconv in int8 compute.
    Inference only (a module in train mode raises ValueError); built by
    :func:`prepare_int8`. Input and output are (N, C, F, T), the output in
    the input's dtype."""

    def __init__(self, layers: dict, features: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.features = tuple(features)
        self.layers = nn.ModuleDict(layers)

    def _double(self, h: torch.Tensor, name: str) -> torch.Tensor:
        h = self.layers[f"{name}_conv0"](h, relu=True)
        return self.layers[f"{name}_conv1"](h, relu=True)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise ValueError("Int8UNet is inference-only")
        in_dtype = x.dtype
        h = x.float().permute(0, 2, 3, 1).contiguous()
        skips = []
        for i in range(len(self.features)):
            h = self._double(h, f"down{i}")
            skips.append(h)
            h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
        h = self._double(h, "bottleneck")
        for i, skip in enumerate(reversed(skips)):
            h = _pad_to_match(self.layers[f"up{i}_deconv"](h), skip)
            h = self._double(torch.cat([skip, h], dim=-1), f"up{i}_conv")
        h = self.layers["out"](h)
        return h.permute(0, 3, 1, 2).to(in_dtype)


def prepare_int8(model: UNet) -> Int8UNet:
    """Fold every DoubleConv's BatchNorm into a float32 kernel and quantize
    every kernel to per-channel int8 (JAX ``prepare_int8``); the result is
    in eval mode on ``model``'s device. Covers the plain U-Net, as JAX's
    ``Int8UNet`` does."""
    if model.s2d_stem or model.attn_bottleneck or getattr(model, "mask_bound", None):
        raise NotImplementedError("int8 compute covers the plain magnitude U-Net, as the "
                                  "JAX package's Int8UNet does")
    layers = {}

    def fold_double(name: str, block) -> None:
        seq = block.double_conv
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            layers[f"{name}_conv{j}"] = _conv_layer(*_fold_conv_bn(seq[ci], seq[bi]))

    with torch.no_grad():
        for i in range(len(model.features)):
            fold_double(f"down{i}", getattr(model, f"downconv{i + 1}").conv)
            up = getattr(model, f"upconv{i + 1}")
            layers[f"up{i}_deconv"] = _deconv_layer(up.up.weight.float(), up.up.bias.float())
            fold_double(f"up{i}_conv", up.conv)
        fold_double("bottleneck", model.bottleneck)
        layers["out"] = _conv_layer(model.out.weight.float(), model.out.bias.float())
    return Int8UNet(layers, model.features).eval()
