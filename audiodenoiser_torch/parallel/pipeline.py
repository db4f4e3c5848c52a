"""Pipeline parallelism: the U-Net cut into stages, one a device (port of
``parallel/pipeline.py``).

The U-Net's block sequence (down0..down{L-1}, bottleneck, up0..up{L-1},
out) is split into contiguous stages (``make_stages``: ``np.array_split``
over the blocks, as JAX's), stage *i*'s weights living only on
``devices[i]``. A microbatch runs through the chain with its skip tuple:
an encoder block's output is consumed by the mirror decoder block, which
may sit stages later, so the skips travel down the chain with the
activation.

A stage is built from the port's own ``Down``, ``DoubleConv`` and ``Up``
modules under the submodule names of ``models.unet.UNet`` (``downconv{k}``,
``bottleneck``, ``upconv{k}``, ``out``), so a U-Net state dict splits
across stages by key prefix (``split_variables``) and the pipelined
forward computes what the whole U-Net computes. The upsamplings are
cuDNN's transposed convolutions, as JAX's stages use ``nn.ConvTranspose``
and not the Pallas kernel. JAX's block names (``down0``, ``up2``) stay in
each stage's ``downs``/``ups``; ``module_name`` maps them to the port's.

``PipelinedDenoiser`` issues microbatch *m*'s stage *i* right after
microbatch *m-1*'s: CUDA's asynchronous launches overlap the stages of
consecutive microbatches on their cards, as JAX's asynchronous dispatch
does. ``devices`` may repeat a device (every stage on ``cuda:0``, or on
the CPU).
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.models.unet import Conv2d, DoubleConv, Down, Up


def module_name(block: str) -> str:
    """The port's submodule of one of JAX's blocks: ``down{i}`` ->
    ``downconv{i+1}``, ``up{i}`` -> ``upconv{i+1}``; ``bottleneck`` and
    ``out`` keep their names."""
    if block.startswith("down"):
        return f"downconv{int(block[4:]) + 1}"
    if block.startswith("up"):
        return f"upconv{int(block[2:]) + 1}"
    return block


def _block_sequence(features: Sequence[int], bottleneck: int, out_channels: int):
    seq = [("down", f"down{i}", f) for i, f in enumerate(features)]
    seq.append(("bottleneck", "bottleneck", bottleneck))
    seq += [("up", f"up{i}", f) for i, f in enumerate(reversed(list(features)))]
    seq.append(("out", "out", out_channels))
    return seq


def _input_widths(features: Sequence[int], bottleneck: int, in_channels: int) -> list[int]:
    """The input channels of each block of ``_block_sequence``."""
    feats = list(features)
    return [in_channels, *feats[:-1], feats[-1], bottleneck, *reversed(feats[1:]), feats[0]]


class _Stage(nn.Module):
    """A contiguous chunk of the U-Net block sequence.

    ``downs``/``ups`` are (JAX block name, features), ``bottleneck_width``
    and ``out_channels`` the widths of those blocks when the stage holds
    them (else None): JAX's ``_Stage`` fields (``spec`` gives the four, the
    submodule ``bottleneck`` taking JAX's field name). ``forward(x, skips)``
    returns the activation in ``dtype`` and the skip tuple after this
    stage's blocks.
    """

    def __init__(self, blocks: Sequence[tuple], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = tuple(blocks)  # (kind, JAX name, in channels, out channels)
        self.dtype = dtype
        for kind, name, cin, f in self.blocks:
            if kind == "down":
                module = Down(cin, f)
            elif kind == "bottleneck":
                module = DoubleConv(cin, f)
            elif kind == "up":
                module = Up(cin, f)
            else:
                module = Conv2d(cin, f, 1)
            self.add_module(module_name(name), module)
        self.to(memory_format=torch.channels_last)

    @property
    def downs(self) -> tuple:
        return tuple((n, f) for k, n, _, f in self.blocks if k == "down")

    @property
    def ups(self) -> tuple:
        return tuple((n, f) for k, n, _, f in self.blocks if k == "up")

    @property
    def bottleneck_width(self) -> Optional[int]:
        return next((f for k, _, _, f in self.blocks if k == "bottleneck"), None)

    @property
    def out_channels(self) -> Optional[int]:
        return next((f for k, _, _, f in self.blocks if k == "out"), None)

    @property
    def spec(self) -> tuple:
        """JAX's ``(downs, bottleneck, ups, out_channels)``."""
        return self.downs, self.bottleneck_width, self.ups, self.out_channels

    def n_passed(self, n_skips: int) -> int:
        """How many of ``n_skips`` incoming skips leave this stage untouched
        (the bottom of the stack, below every skip its ups pop)."""
        return n_skips - max(0, len(self.ups) - len(self.downs))

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor] = ()):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        skips = list(skips)
        for kind, name, _, _ in self.blocks:
            module = getattr(self, module_name(name))
            if kind == "down":
                skip, x = module(x)
                skips.append(skip)
            elif kind == "up":
                x = module(x, skips.pop())
            else:
                x = module(x)
        return x, tuple(skips)


def make_stages(n_stages: int, features: Sequence[int] = (64, 128, 256, 512),
                bottleneck: int = 1024, out_channels: int = 1,
                dtype: torch.dtype = torch.float32, in_channels: int = 1) -> list[_Stage]:
    """Split the U-Net block sequence into ``n_stages`` contiguous stages
    (JAX's ``np.array_split`` over the blocks); ``in_channels`` is the
    first block's input width, which Flax infers and torch needs."""
    seq = _block_sequence(features, bottleneck, out_channels)
    if not 1 <= n_stages <= len(seq):
        raise ValueError(f"n_stages must be in [1, {len(seq)}]")
    widths = _input_widths(features, bottleneck, in_channels)
    return [_Stage([(*seq[i][:2], widths[i], seq[i][2]) for i in chunk], dtype=dtype)
            for chunk in np.array_split(np.arange(len(seq)), n_stages)]


def split_variables(state_dict: Mapping[str, torch.Tensor],
                    stages: Sequence[_Stage]) -> list[dict]:
    """Key-slice a full U-Net state dict into one state dict a stage."""
    out = []
    for stage in stages:
        prefixes = tuple(module_name(name) + "." for _, name, _, _ in stage.blocks)
        out.append({k: v for k, v in state_dict.items() if k.startswith(prefixes)})
    return out


def default_devices() -> list[torch.device]:
    """Every visible card (``resolve_device`` raises without one)."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def place_stages(state_dict: Mapping[str, torch.Tensor], stages: Sequence[_Stage],
                 devices: Sequence[torch.device]) -> None:
    """Load each stage's slice of ``state_dict`` (strict) and move the stage
    to its device."""
    for stage, part, dev in zip(stages, split_variables(state_dict, stages), devices):
        stage.load_state_dict(part, strict=True)
        stage.to(dev)


@contextlib.contextmanager
def recomputing(stage: nn.Module):
    """Train-mode BatchNorm of ``stage`` normalises with the batch's
    statistics and leaves its running statistics alone inside the block
    (a recompute: the forward that ran first folded them)."""
    norms = [m for m in stage.modules() if hasattr(m, "recomputing")]
    for bn in norms:
        bn.recomputing = True
    try:
        yield
    finally:
        for bn in norms:
            bn.recomputing = False


class PipelinedDenoiser:
    """Stage-per-device pipelined U-Net forward (inference, eval-mode
    BatchNorm).

    Args:
      model: a live-BN ``UNet`` or its state dict (parameters and running
        statistics).
      devices: one device a stage (default: every visible card, capped at
        the block count); stage *i*'s weights live only on ``devices[i]``.
      features/bottleneck/out_channels/dtype/in_channels: the U-Net.
    """

    def __init__(self, model: Union[nn.Module, Mapping[str, torch.Tensor]],
                 devices: Optional[Sequence[DeviceLike]] = None,
                 features: Sequence[int] = (64, 128, 256, 512), bottleneck: int = 1024,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 in_channels: int = 1):
        state_dict = model.state_dict() if isinstance(model, nn.Module) else model
        if devices is None:
            devices = default_devices()
        n = min(len(devices), len(_block_sequence(features, bottleneck, out_channels)))
        self.devices = [resolve_device(d) for d in list(devices)[:n]]
        self.stages = make_stages(n, features, bottleneck, out_channels, dtype, in_channels)
        place_stages(state_dict, self.stages, self.devices)
        for stage in self.stages:
            stage.eval()

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor, microbatches: int = 4) -> torch.Tensor:
        """(B, C, F, T) -> (B, out_channels, F, T) in ``x``'s dtype, on the
        last stage's device; ``microbatches`` splits the batch so stage *i*
        of one microbatch overlaps stage *i+1* of the previous."""
        x = torch.as_tensor(x)
        in_dtype = x.dtype
        b = x.shape[0]
        m = max(1, min(microbatches, b))
        bounds = np.linspace(0, b, m + 1).astype(int)
        outs = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            if lo == hi:
                continue
            a, skips = x[lo:hi], ()
            for stage, dev in zip(self.stages, self.devices):
                a = a.to(dev, non_blocking=True)
                skips = tuple(s.to(dev, non_blocking=True) for s in skips)
                a, skips = stage(a, skips)
            outs.append(a)
        return torch.cat(outs, dim=0).to(in_dtype)
