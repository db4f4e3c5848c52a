"""Model exports (port of ``train/checkpoints.py``, export part).

- ``export_model`` / ``load_exported``: the JAX package's single-file
  ``.ckpt`` export, Flax's msgpack of ``{"params", "batch_stats"}`` in the
  Flax tree layout, optionally with int8 kernels (``"format": "int8-v1"``).
  The port reads and writes it with its own codec (``msgpack_codec``), so
  the bytes it writes are the ones Flax writes and reads back.
- ``save_train_state`` / ``restore_train_state`` / ``saved_keys``: the
  resume state of ``train.loop.fit``. The JAX package keeps it in an orbax
  directory; the port has no orbax, so it is one ``torch.save`` of a dict
  of tensors and plain values, written atomically and read back with
  ``weights_only=True``.
- ``record_best_val`` / ``best_val_floor`` keep the ``.val.json`` sidecar
  beside an export.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from audiodenoiser_torch.train import msgpack_codec

INT8_FORMAT = "int8-v1"
_QKEY = "__q8__"


def _map_leaves(fn, tree: Any) -> Any:
    """``fn`` on every leaf of a tree of dicts, keys in sorted order as
    ``jax.tree_util.tree_map`` leaves them; a quantized leaf
    (``{"__q8__", "scale"}``) counts as one leaf."""
    if isinstance(tree, dict) and _QKEY not in tree:
        return {k: _map_leaves(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def quantize_tree(params: Any) -> Any:
    """Every 4-D float kernel to symmetric per-output-channel int8
    ``{"__q8__": int8, "scale": f32[cout]}``; other leaves to float32
    (``audiodenoiser_tpu/train/quantize.py::quantize_tree``)."""

    def q(leaf):
        arr = np.asarray(leaf)
        if arr.ndim != 4 or arr.dtype.kind != "f":
            return np.asarray(arr, np.float32)
        absmax = np.abs(arr).reshape(-1, arr.shape[-1]).max(axis=0)
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q8 = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        return {_QKEY: q8, "scale": scale}

    return _map_leaves(q, params)


def dequantize_tree(tree: Any) -> Any:
    """Inverse of :func:`quantize_tree`: ``int8 * scale`` in float32."""

    def dq(leaf):
        if isinstance(leaf, dict):
            return leaf[_QKEY].astype(np.float32) * np.asarray(leaf["scale"], np.float32)
        return leaf

    return _map_leaves(dq, tree)


def export_model(path: str, params: Any, batch_stats: Any,
                 quantize: bool = False) -> None:
    """Single-file msgpack export of Flax-layout trees (dicts with numpy
    array leaves), written atomically; ``quantize=True`` stores the conv
    kernels as per-channel int8 (about 4x smaller)."""
    if quantize:
        # the JAX export passes both trees through tree_map: sorted keys
        payload = {"format": INT8_FORMAT, "params": quantize_tree(params),
                   "batch_stats": _map_leaves(lambda x: x, batch_stats)}
    else:
        payload = {"params": params, "batch_stats": batch_stats}
    data = msgpack_codec.serialize(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_exported(path: str) -> dict:
    """Read a ``.ckpt`` export: ``{"params", "batch_stats"}`` of numpy
    arrays, int8 payloads dequantized."""
    with open(path, "rb") as f:
        raw = msgpack_codec.restore(f.read())
    if isinstance(raw, dict) and raw.get("format") == INT8_FORMAT:
        raw = {"params": dequantize_tree(raw["params"]),
               "batch_stats": raw["batch_stats"]}
    return raw


def save_train_state(path: str, state: dict) -> None:
    """``torch.save`` of the resume state ``state`` (tensors on any device,
    numbers, strings, lists, dicts), through a temporary file and
    ``os.replace``, so that a crash leaves the previous state whole."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, device=None) -> dict:
    """The resume state written by ``save_train_state``, its tensors on
    ``device`` (where they were saved when None)."""
    return torch.load(path, map_location=device, weights_only=True)


def saved_keys(path: str) -> set[str]:
    """Top-level keys of a saved resume state (``ema`` and
    ``best_ema_val`` only in a state written with an EMA)."""
    return set(restore_train_state(path, "cpu"))


def record_best_val(ckpt_path: str, val_loss: float, epoch: int) -> None:
    """Write the ``.val.json`` sidecar beside a best-model export."""
    with open(os.path.splitext(ckpt_path)[0] + ".val.json", "w") as f:
        json.dump({"val_loss": val_loss, "epoch": epoch}, f)


def best_val_floor(ckpt_path: str, current: float) -> float:
    """min(current, the ``.val.json``-recorded loss)."""
    meta = os.path.splitext(ckpt_path)[0] + ".val.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return min(current, float(json.load(f)["val_loss"]))
    return current
