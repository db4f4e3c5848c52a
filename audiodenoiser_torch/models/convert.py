"""Carry Flax U-Net variables across to the port's ``UNet`` state_dict.

``state_dict_from_flax`` follows the layout rules of the JAX package's
torch export (``train/torch_export.py``) in code of its own, since the
port imports nothing of the JAX package:

  Flax variable             -> state_dict name
  down{k-1}/conv{0|1}       -> downconv{k}.conv.double_conv.{0|3}
  down{k-1}/bn{0|1}         -> downconv{k}.conv.double_conv.{1|4}
  bottleneck/*              -> bottleneck.double_conv.*
  up{k-1}_deconv            -> upconv{k}.up
  up{k-1}_conv/*            -> upconv{k}.conv.double_conv.*
  out                       -> out

A Conv kernel goes from HWIO to OIHW. A Flax ConvTranspose kernel is
spatially flipped against torch's adjoint convention: the flip is undone
with ``k[::-1, ::-1]`` before the kernel goes to (Cin, Cout, kh, kw).
BatchNorm gains the ``num_batches_tracked`` that a strict load expects.
The channel counts come from the kernels, so a complex-mask tree (a
3-channel first conv, a 2-channel head) converts the same way.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch
from torch import nn


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(p: Mapping[str, Any], out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _deconv(p: Mapping[str, Any], out: dict, prefix: str) -> None:
    k = np.asarray(p["kernel"])[::-1, ::-1]  # undo the adjoint spatial flip
    out[f"{prefix}.weight"] = _t(k.transpose(2, 3, 0, 1))
    out[f"{prefix}.bias"] = _t(p["bias"])


def _bn(p: Mapping[str, Any], s: Mapping[str, Any], out: dict, prefix: str) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(s["mean"])
    out[f"{prefix}.running_var"] = _t(s["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


def _double(p, s, out: dict, prefix: str) -> None:
    for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
        _conv(p[f"conv{i}"], out, f"{prefix}.double_conv.{ci}")
        _bn(p[f"bn{i}"], s[f"bn{i}"], out, f"{prefix}.double_conv.{bi}")


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a Flax ``UNet`` (numpy arrays) ->
    a state_dict that the port's ``UNet`` of the same widths loads with
    ``strict=True``."""
    params, stats = variables["params"], variables["batch_stats"]
    levels = sum(1 for k in params if k.startswith("down"))
    out: dict = {}
    for k in range(1, levels + 1):
        _double(params[f"down{k - 1}"], stats[f"down{k - 1}"], out,
                f"downconv{k}.conv")
    _double(params["bottleneck"], stats["bottleneck"], out, "bottleneck")
    for k in range(1, levels + 1):
        _deconv(params[f"up{k - 1}_deconv"], out, f"upconv{k}.up")
        _double(params[f"up{k - 1}_conv"], stats[f"up{k - 1}_conv"], out,
                f"upconv{k}.conv")
    _conv(params["out"], out, "out")
    return out


def load_flax_variables(model: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load an export's ``{"params", "batch_stats"}`` numpy tree (Flax
    layout, as ``train.checkpoints.load_exported`` returns it) into the
    port's ``UNet`` or ``ComplexMaskUNet`` of the same widths and channel
    counts, strictly: a tree of another architecture raises."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def random_flax_variables(seed: int = 0,
                          features: Sequence[int] = (64, 128, 256, 512),
                          bottleneck: int = 1024, in_channels: int = 1,
                          out_channels: int = 1) -> dict:
    """Seeded random variables in the Flax ``UNet`` tree layout (HWIO
    kernels; BatchNorm ``scale``/``bias`` and ``mean``/``var``), with
    non-trivial BN statistics so that a fold is load-bearing. He-scaled
    kernels keep activations of order one through the full depth.
    ``in_channels`` and ``out_channels`` (default 1 and 1, the magnitude
    U-Net) size the first conv and the 1x1 head: 3 and 2 give the tree of
    a ``ComplexMaskUNet``."""
    rng = np.random.default_rng(seed)

    def conv(kh: int, cin: int, cout: int) -> dict:
        std = np.sqrt(2.0 / (kh * kh * cin))
        return {"kernel": (std * rng.standard_normal((kh, kh, cin, cout))).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(cout)).astype(np.float32)}

    def double(cin: int, cout: int):
        p, s = {}, {}
        for i, c in enumerate((cin, cout)):
            p[f"conv{i}"] = conv(3, c, cout)
            p[f"bn{i}"] = {
                "scale": (1.0 + 0.2 * rng.standard_normal(cout)).astype(np.float32),
                "bias": (0.3 * rng.standard_normal(cout)).astype(np.float32),
            }
            s[f"bn{i}"] = {
                "mean": (0.3 * rng.standard_normal(cout)).astype(np.float32),
                "var": (0.5 + np.abs(rng.standard_normal(cout))).astype(np.float32),
            }
        return p, s

    params, stats = {}, {}
    cin = in_channels
    for i, f in enumerate(features):
        params[f"down{i}"], stats[f"down{i}"] = double(cin, f)
        cin = f
    params["bottleneck"], stats["bottleneck"] = double(cin, bottleneck)
    cin = bottleneck
    for i, f in enumerate(reversed(tuple(features))):
        params[f"up{i}_deconv"] = conv(2, cin, f)
        params[f"up{i}_conv"], stats[f"up{i}_conv"] = double(2 * f, f)
        cin = f
    params["out"] = conv(1, cin, out_channels)
    return {"params": params, "batch_stats": stats}
