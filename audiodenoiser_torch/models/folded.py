"""BatchNorm-folded U-Net for inference (port of ``models/folded.py``).

Eval-mode BatchNorm is a per-channel affine map, so each [Conv -> BN]
pair collapses into one convolution: ``k' = k * gamma/sqrt(var+eps)`` and
``b' = (b - mean) * gamma/sqrt(var+eps) + beta``. As in the JAX package
the fold runs in float32, the kernels are then cast to the compute dtype
and the biases stay float32, cast into the conv epilogue at call time.
Convolutions and deconvolutions go to cuDNN (``F.conv2d`` /
``F.conv_transpose2d``), as the JAX folded graph leaves them to XLA. On
the card in bf16 or fp16 each ReLU'd convolution adds its bias and takes
its ReLU in cuDNN's fused epilogue (``torch.cudnn_convolution_relu``), on
the fp32 accumulator before the one rounding to the output's dtype: the
plain path rounds the conv output, adds the bias in a second pass and
clamps in a third, so the two differ by about one ulp of that dtype.

The variants fold the same way. The s2d stem's first conv and the
unpacked head are ordinary convolutions; the refinement path's
``s2d_skip_conv`` and ``s2d_refine`` have no BatchNorm and are carried
over as the deconvolutions and ``out`` are. The attention block cannot be
folded: a copy of it runs unfolded on the folded activations, in the
fold's dtype, as JAX runs its ``BottleneckAttention`` there.

A folded ``ComplexMaskUNet`` keeps its mask head (``mask_bound``,
``mask_residual``). The head runs in float32 on the output cast back to
the input's dtype, as the live ``ComplexMaskUNet`` runs it; the JAX
package's folded shim runs it in the compute dtype, so in bf16 the two
differ by about one bf16 rounding of the mask.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.models.complex_mask import mask_head
from audiodenoiser_torch.models.unet import UNet, depth_to_space, pad_to_match, space_to_depth
from audiodenoiser_torch.parallel.layers import gather_channels


class _Conv(nn.Module):
    """One folded convolution: kernel in the compute dtype, bias float32.
    With ``tp`` (``parallel.mesh``) it holds an output-channel slice and
    gathers the slices after its ReLU. Its calls are counted by route in
    ``_Conv.fused_launches`` and ``_Conv.plain_launches``
    (``ops.cuda.variant_launches(_Conv)``)."""

    tp = None
    variants = ("fused", "plain")
    fused_launches = plain_launches = 0

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor,
                 transpose: bool = False):
        super().__init__()
        self.register_buffer("weight", weight.contiguous(memory_format=torch.channels_last))
        self.register_buffer("bias", bias)
        self.transpose = transpose

    def forward(self, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        # the fused op reads its bias in the input's dtype: handed the
        # float32 bias it read garbage on the card, so both routes cast it
        b = self.bias.to(x.dtype)
        pad = self.weight.shape[-1] // 2
        if relu and not self.transpose and fused_route(x):
            _Conv.fused_launches += 1
            y = torch.cudnn_convolution_relu(x, self.weight, b, (1, 1), (pad, pad), (1, 1), 1)
        else:
            _Conv.plain_launches += 1
            if self.transpose:
                y = F.conv_transpose2d(x, self.weight, b, stride=2)
            else:
                y = F.conv2d(x, self.weight, b, padding=pad)
                y = F.relu(y) if relu else y
        return gather_channels(y, self.tp)


def fused_route(x: torch.Tensor) -> bool:
    """Whether a ReLU'd folded convolution of ``x`` takes cuDNN's fused
    conv + bias + ReLU: a CUDA tensor in bf16 or fp16 with cuDNN on. The
    CPU and fp32 keep conv(+bias) then ReLU. No shape is kept plain: on an
    H100 at 700 W the fused call was the faster at every ReLU'd shape of the
    menu measured, batch 1-256 and 1-1024 input channels (a 256-clip
    batch's 18, ``chip_smoke.py``: 0.35-2.64 against 0.47-4.86 ms a call,
    19.2 against 36.0 ms in all, the 1-channel stem 2.26 against 4.61; its
    first calls 0.19 against 0.10 s), and slower only at one output channel
    (0.57 against 0.48 ms at 64 clips), which only the un-ReLU'd head has."""
    return (x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)
            and torch.backends.cudnn.enabled)


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
    set, the output goes through the complex-mask head. ``s2d_stem``,
    ``s2d_skip`` and ``attn`` (the unfolded attention block, or None) are
    the U-Net's variants."""

    def __init__(self, convs: dict, features: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16,
                 mask_bound: Optional[float] = None, mask_residual: bool = False,
                 s2d_stem: bool = False, s2d_skip: int = 0, out_channels: int = 1,
                 attn: Optional[nn.Module] = None):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        self.mask_bound = mask_bound
        self.mask_residual = mask_residual
        self.s2d_stem = s2d_stem
        self.s2d_skip = s2d_skip
        self.out_channels = out_channels
        self.attn = attn
        self.convs = nn.ModuleDict(convs)

    def _double(self, h: torch.Tensor, name: str) -> torch.Tensor:
        return self.convs[f"{name}_conv1"](self.convs[f"{name}_conv0"](h))

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_dtype = x.dtype
        h = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        if self.s2d_stem:
            in_h, in_w = h.shape[-2:]
            if in_h % 2 or in_w % 2:
                h = F.pad(h, (0, in_w % 2, 0, in_h % 2))
            x_full = h
            h = space_to_depth(h)
        skips = []
        for i in range(len(self.features)):
            h = self._double(h, f"down{i}")
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = self._double(h, "bottleneck")
        if self.attn is not None:
            h = self.attn(h)
        for i, skip in enumerate(reversed(skips)):
            h = pad_to_match(self.convs[f"up{i}_deconv"](h), skip)
            h = self._double(torch.cat([skip, h], dim=1), f"up{i}_conv")
        h = self.convs["out"](h, relu=False)
        if self.s2d_stem:
            if self.s2d_skip:
                fr = self.convs["s2d_skip_conv"](x_full)
                h = self.convs["s2d_refine"](
                    torch.cat([depth_to_space(h, self.s2d_skip), fr], dim=1), relu=False)
            else:
                h = depth_to_space(h, self.out_channels)
            h = h[..., :in_h, :in_w]
        out = h.to(in_dtype)
        if self.mask_bound is not None:
            out = mask_head(out, self.mask_bound, self.mask_residual)
        return out


def fold_for_inference(model: UNet,
                       dtype: torch.dtype = torch.bfloat16) -> FoldedUNet:
    """Fold every DoubleConv's eval BatchNorm and pre-cast kernels to
    ``dtype``; the result lives on ``model``'s device. A
    ``ComplexMaskUNet`` keeps its mask head, a variant its stem, refinement
    path and attention block."""
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
        if model.s2d_skip:
            convs["s2d_skip_conv"] = plain(model.s2d_skip_conv)
            convs["s2d_refine"] = plain(model.s2d_refine)
    attn = copy.deepcopy(model.bottleneck_attn) if model.attn_bottleneck else None
    return FoldedUNet(convs, model.features, dtype,
                      mask_bound=getattr(model, "mask_bound", None),
                      mask_residual=bool(getattr(model, "residual", False)),
                      s2d_stem=model.s2d_stem, s2d_skip=model.s2d_skip,
                      out_channels=model.out_channels, attn=attn).eval()
