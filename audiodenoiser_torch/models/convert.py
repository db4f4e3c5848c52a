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
  s2d_skip_conv, s2d_refine -> s2d_skip_conv, s2d_refine
  bottleneck_attn/ln        -> bottleneck_attn.ln (scale -> weight)
  bottleneck_attn/mhsa/{query,key,value,out} -> bottleneck_attn.{query,key,value,out}

A Conv kernel goes from HWIO to OIHW. The attention's DenseGeneral
kernels, (c, heads, d) for query, key and value and (heads, d, c) for
``out``, flatten their head axes into the (out, in) weight of a
``Linear``; the (heads, d) biases flatten alike. A Flax ConvTranspose kernel is
spatially flipped against torch's adjoint convention: the flip is undone
with ``k[::-1, ::-1]`` before the kernel goes to (Cin, Cout, kh, kw).
BatchNorm gains the ``num_batches_tracked`` that a strict load expects.
The channel counts come from the kernels, so a complex-mask tree (a
3-channel first conv, a 2-channel head) converts the same way.
``flax_from_state_dict`` is the inverse: the tree that the JAX package's
``export_model`` writes, from a trained model's state_dict.
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


_ATTN = ("query", "key", "value", "out")


def _attention(p: Mapping[str, Any], out: dict, prefix: str) -> None:
    out[f"{prefix}.ln.weight"] = _t(p["ln"]["scale"])
    out[f"{prefix}.ln.bias"] = _t(p["ln"]["bias"])
    for name in _ATTN:
        k = np.asarray(p["mhsa"][name]["kernel"])
        if name == "out":  # (heads, d, c)
            w = k.reshape(-1, k.shape[-1]).T
        else:  # (c, heads, d)
            w = k.reshape(k.shape[0], -1).T
        out[f"{prefix}.{name}.weight"] = _t(w)
        out[f"{prefix}.{name}.bias"] = _t(np.asarray(p["mhsa"][name]["bias"]).reshape(-1))


def state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of a Flax ``UNet`` (numpy arrays), any
    of its variants -> a state_dict that the port's ``UNet`` of the same
    widths and switches loads with ``strict=True``."""
    params, stats = variables["params"], variables["batch_stats"]
    levels = sum(1 for k in params if k.startswith("down"))
    out: dict = {}
    for k in range(1, levels + 1):
        _double(params[f"down{k - 1}"], stats[f"down{k - 1}"], out,
                f"downconv{k}.conv")
    _double(params["bottleneck"], stats["bottleneck"], out, "bottleneck")
    if "bottleneck_attn" in params:
        _attention(params["bottleneck_attn"], out, "bottleneck_attn")
    for k in range(1, levels + 1):
        _deconv(params[f"up{k - 1}_deconv"], out, f"upconv{k}.up")
        _double(params[f"up{k - 1}_conv"], stats[f"up{k - 1}_conv"], out,
                f"upconv{k}.conv")
    for name in ("out", "s2d_skip_conv", "s2d_refine"):
        if name in params:
            _conv(params[name], out, name)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _conv_inv(sd, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)),
            "bias": _np(sd[f"{prefix}.bias"]).copy()}


def _deconv_inv(sd, prefix: str) -> dict:
    k = _np(sd[f"{prefix}.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]  # redo the flip
    return {"kernel": np.ascontiguousarray(k), "bias": _np(sd[f"{prefix}.bias"]).copy()}


def _double_inv(sd, prefix: str):
    p, s = {}, {}
    for i, (ci, bi) in enumerate(((0, 1), (3, 4))):
        p[f"conv{i}"] = _conv_inv(sd, f"{prefix}.double_conv.{ci}")
        bn = f"{prefix}.double_conv.{bi}"
        p[f"bn{i}"] = {"scale": _np(sd[f"{bn}.weight"]).copy(),
                       "bias": _np(sd[f"{bn}.bias"]).copy()}
        s[f"bn{i}"] = {"mean": _np(sd[f"{bn}.running_mean"]).copy(),
                       "var": _np(sd[f"{bn}.running_var"]).copy()}
    return p, s


def _attention_inv(sd, prefix: str, heads: int = 4) -> dict:
    p = {"ln": {"scale": _np(sd[f"{prefix}.ln.weight"]).copy(),
                "bias": _np(sd[f"{prefix}.ln.bias"]).copy()}, "mhsa": {}}
    for name in _ATTN:
        w = _np(sd[f"{prefix}.{name}.weight"])
        b = _np(sd[f"{prefix}.{name}.bias"]).copy()
        if name == "out":
            k = w.T.reshape(heads, -1, w.shape[0])
        else:
            k = w.T.reshape(w.shape[1], heads, -1)
            b = b.reshape(heads, -1)
        p["mhsa"][name] = {"kernel": np.ascontiguousarray(k), "bias": b}
    return p


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``UNet`` / ``ComplexMaskUNet`` state_dict (any device) ->
    ``{"params", "batch_stats"}`` of float32 numpy arrays in the Flax tree
    layout, the inverse of ``state_dict_from_flax`` (``num_batches_tracked``
    has no Flax counterpart and is dropped)."""
    levels = sum(1 for k in state_dict if k.startswith("downconv") and k.endswith(
        ".conv.double_conv.0.weight"))
    params, stats = {}, {}
    for k in range(1, levels + 1):
        params[f"down{k - 1}"], stats[f"down{k - 1}"] = _double_inv(
            state_dict, f"downconv{k}.conv")
    params["bottleneck"], stats["bottleneck"] = _double_inv(state_dict, "bottleneck")
    if "bottleneck_attn.ln.weight" in state_dict:
        params["bottleneck_attn"] = _attention_inv(state_dict, "bottleneck_attn")
    for k in range(1, levels + 1):
        params[f"up{k - 1}_deconv"] = _deconv_inv(state_dict, f"upconv{k}.up")
        params[f"up{k - 1}_conv"], stats[f"up{k - 1}_conv"] = _double_inv(
            state_dict, f"upconv{k}.conv")
    for name in ("out", "s2d_skip_conv", "s2d_refine"):
        if f"{name}.weight" in state_dict:
            params[name] = _conv_inv(state_dict, name)
    return {"params": params, "batch_stats": stats}


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
                          out_channels: int = 1, s2d_stem: bool = False,
                          s2d_skip: int = 0, attn_bottleneck: bool = False) -> dict:
    """Seeded random variables in the Flax ``UNet`` tree layout (HWIO
    kernels; BatchNorm ``scale``/``bias`` and ``mean``/``var``), with
    non-trivial BN statistics so that a fold is load-bearing. He-scaled
    kernels keep activations of order one through the full depth.
    ``in_channels`` and ``out_channels`` (default 1 and 1, the magnitude
    U-Net) size the first conv and the head: 3 and 2 give the tree of a
    ``ComplexMaskUNet``. ``s2d_stem``, ``s2d_skip`` and ``attn_bottleneck``
    give the variants' trees; the attention's output projection is
    nonzero (Flax starts it at zero, which makes the block a no-op), its
    LayerNorm non-trivial. The plain tree's draws do not change with the
    switches off."""
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

    def f32(std, shape):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    params, stats = {}, {}
    cin = 4 * in_channels if s2d_stem else in_channels
    for i, f in enumerate(features):
        params[f"down{i}"], stats[f"down{i}"] = double(cin, f)
        cin = f
    params["bottleneck"], stats["bottleneck"] = double(cin, bottleneck)
    cin = bottleneck
    for i, f in enumerate(reversed(tuple(features))):
        params[f"up{i}_deconv"] = conv(2, cin, f)
        params[f"up{i}_conv"], stats[f"up{i}_conv"] = double(2 * f, f)
        cin = f
    skip = s2d_skip if s2d_stem else 0
    head = skip or out_channels
    params["out"] = conv(1, cin, 4 * head if s2d_stem else head)
    if skip:
        params["s2d_skip_conv"] = conv(3, in_channels, skip)
        params["s2d_refine"] = conv(3, 2 * skip, out_channels)
    if attn_bottleneck:
        c, qkv, heads = bottleneck, max(64, bottleneck // 4), 4
        mhsa = {name: {"kernel": f32(np.sqrt(1.0 / c), (c, heads, qkv // heads)),
                       "bias": f32(0.1, (heads, qkv // heads))}
                for name in ("query", "key", "value")}
        mhsa["out"] = {"kernel": f32(np.sqrt(1.0 / qkv), (heads, qkv // heads, c)),
                       "bias": f32(0.1, c)}
        params["bottleneck_attn"] = {
            "ln": {"scale": (1.0 + f32(0.2, c)).astype(np.float32), "bias": f32(0.3, c)},
            "mhsa": mhsa}
    return {"params": params, "batch_stats": stats}


# the noise router (models/router.py): conv{i}/{kernel,bias} ->
# convs.{i}.{weight,bias}, gn{i}/{scale,bias} -> gns.{i}.{weight,bias},
# head/{kernel,bias} -> head.{weight,bias} with the Dense kernel transposed


def router_state_dict_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The ``params`` tree of a Flax ``NoiseClassifier`` (numpy arrays) ->
    a state_dict that the port's ``NoiseClassifier`` of the same widths
    loads with ``strict=True``."""
    out: dict = {}
    for i in range(sum(1 for k in params if k.startswith("conv"))):
        _conv(params[f"conv{i}"], out, f"convs.{i}")
        out[f"gns.{i}.weight"] = _t(params[f"gn{i}"]["scale"])
        out[f"gns.{i}.bias"] = _t(params[f"gn{i}"]["bias"])
    out["head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    out["head.bias"] = _t(params["head"]["bias"])
    return out


def router_flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port's ``NoiseClassifier`` state_dict (any device) -> the Flax
    ``params`` tree of float32 numpy arrays, the inverse of
    ``router_state_dict_from_flax``."""
    params: dict = {}
    for i in range(sum(1 for k in state_dict if k.startswith("convs.") and k.endswith(".weight"))):
        params[f"conv{i}"] = _conv_inv(state_dict, f"convs.{i}")
        params[f"gn{i}"] = {"scale": _np(state_dict[f"gns.{i}.weight"]).copy(),
                            "bias": _np(state_dict[f"gns.{i}.bias"]).copy()}
    params["head"] = {"kernel": np.ascontiguousarray(_np(state_dict["head.weight"]).T),
                      "bias": _np(state_dict["head.bias"]).copy()}
    return params


def random_router_flax_variables(seed: int = 0, widths: Sequence[int] = (16, 32, 64, 128),
                                 num_classes: int = 4) -> dict:
    """Seeded random ``{"params": ...}`` of a Flax ``NoiseClassifier``:
    He-scaled HWIO kernels, non-trivial GroupNorm scales and biases, a
    LeCun-scaled head."""
    rng = np.random.default_rng(seed)

    def f32(std, shape):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    params, cin = {}, 1
    for i, w in enumerate(widths):
        params[f"conv{i}"] = {"kernel": f32(np.sqrt(2.0 / (9 * cin)), (3, 3, cin, w)),
                              "bias": f32(0.1, w)}
        params[f"gn{i}"] = {"scale": (1.0 + f32(0.2, w)).astype(np.float32),
                            "bias": f32(0.3, w)}
        cin = w
    params["head"] = {"kernel": f32(np.sqrt(1.0 / cin), (cin, num_classes)),
                      "bias": f32(0.1, num_classes)}
    return {"params": params}
