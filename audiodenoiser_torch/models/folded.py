"""BatchNorm-folded U-Net for inference (port of ``models/folded.py``).

Eval-mode BatchNorm is a per-channel affine map, so each [Conv -> BN]
pair collapses into one convolution: ``k' = k * gamma/sqrt(var+eps)`` and
``b' = (b - mean) * gamma/sqrt(var+eps) + beta``. As in the JAX package
the fold runs in float32, the kernels are then cast to the compute dtype
and the biases stay float32, cast into the conv epilogue at call time.
Convolutions and deconvolutions go to cuDNN (``F.conv2d`` /
``F.conv_transpose2d``), as the JAX folded graph leaves them to XLA.

A folded ``ComplexMaskUNet`` keeps its mask head (``mask_bound``,
``mask_residual``). The head runs in float32 on the output cast back to
the input's dtype, as the live ``ComplexMaskUNet`` runs it; the JAX
package's folded shim runs it in the compute dtype, so in bf16 the two
differ by about one bf16 rounding of the mask.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.models.complex_mask import mask_head
from audiodenoiser_torch.models.unet import UNet, pad_to_match


class _Conv(nn.Module):
    """One folded convolution: kernel in the compute dtype, bias float32."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor,
                 transpose: bool = False):
        super().__init__()
        self.register_buffer("weight", weight.contiguous(memory_format=torch.channels_last))
        self.register_buffer("bias", bias)
        self.transpose = transpose

    def forward(self, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        b = self.bias.to(x.dtype)
        if self.transpose:
            return F.conv_transpose2d(x, self.weight, b, stride=2)
        y = F.conv2d(x, self.weight, b, padding=self.weight.shape[-1] // 2)
        return F.relu(y) if relu else y


def _fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    """[Conv -> eval BatchNorm] -> (kernel', bias') in float32."""
    mult = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
    kernel = conv.weight.float() * mult[:, None, None, None]
    bias = (conv.bias.float() - bn.running_mean.float()) * mult + bn.bias.float()
    return kernel, bias


class FoldedUNet(nn.Module):
    """The U-Net's dataflow with every [Conv -> BN -> ReLU] folded to
    conv(+bias) -> ReLU. Inference only; built by :func:`fold_for_inference`.
    Input and output are (N, C, F, T) in the caller's dtype; the graph
    computes in ``dtype`` with activations and kernels in ``channels_last``
    memory (NHWC, the layout of cuDNN's Hopper convolution kernels: in NCHW
    every convolution paid a transpose in and one out). With ``mask_bound``
    set, the output goes through the complex-mask head."""

    def __init__(self, convs: dict, features: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16,
                 mask_bound: Optional[float] = None, mask_residual: bool = False):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        self.mask_bound = mask_bound
        self.mask_residual = mask_residual
        self.convs = nn.ModuleDict(convs)

    def _double(self, h: torch.Tensor, name: str) -> torch.Tensor:
        return self.convs[f"{name}_conv1"](self.convs[f"{name}_conv0"](h))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        h = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        skips = []
        for i in range(len(self.features)):
            h = self._double(h, f"down{i}")
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = self._double(h, "bottleneck")
        for i, skip in enumerate(reversed(skips)):
            h = pad_to_match(self.convs[f"up{i}_deconv"](h), skip)
            h = self._double(torch.cat([skip, h], dim=1), f"up{i}_conv")
        out = self.convs["out"](h, relu=False).to(in_dtype)
        if self.mask_bound is not None:
            out = mask_head(out, self.mask_bound, self.mask_residual)
        return out


def fold_for_inference(model: UNet,
                       dtype: torch.dtype = torch.bfloat16) -> FoldedUNet:
    """Fold every DoubleConv's eval BatchNorm and pre-cast kernels to
    ``dtype``; the result lives on ``model``'s device. A
    ``ComplexMaskUNet`` keeps its mask head."""
    convs = {}

    def fold_double(name: str, block) -> None:
        seq = block.double_conv
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            k, b = _fold_conv_bn(seq[ci], seq[bi])
            convs[f"{name}_conv{j}"] = _Conv(k.to(dtype), b)

    def plain(layer: nn.Module, transpose: bool = False) -> _Conv:
        return _Conv(layer.weight.detach().to(dtype),
                     layer.bias.detach().float(), transpose)

    n = len(model.features)
    with torch.no_grad():
        for i in range(n):
            fold_double(f"down{i}", getattr(model, f"downconv{i + 1}").conv)
            up = getattr(model, f"upconv{i + 1}")
            convs[f"up{i}_deconv"] = plain(up.up, transpose=True)
            fold_double(f"up{i}_conv", up.conv)
        fold_double("bottleneck", model.bottleneck)
        convs["out"] = plain(model.out)
    return FoldedUNet(convs, model.features, dtype,
                      mask_bound=getattr(model, "mask_bound", None),
                      mask_residual=bool(getattr(model, "residual", False))).eval()
