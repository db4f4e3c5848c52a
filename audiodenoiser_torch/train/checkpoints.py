"""Best-model export (port of ``train/checkpoints.py``, export part).

``export_model`` writes the model's state_dict as a ``.pth`` file: the
reference's own format (``torch.save(state_dict)``), which
``eval.runner.load_model_for_noise`` loads. ``record_best_val`` /
``best_val_floor`` keep the ``.val.json`` sidecar beside an export. The
JAX package's msgpack ``.ckpt`` export and its resume state are not
ported yet (ROADMAP A.12).
"""

from __future__ import annotations

import json
import os

import torch
from torch import nn


def export_model(path: str, model: nn.Module) -> None:
    """Atomic ``torch.save`` of ``model``'s state_dict, on the CPU."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


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
