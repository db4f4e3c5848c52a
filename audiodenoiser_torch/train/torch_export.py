"""``.ckpt`` exports to reference-layout ``.pth`` files (port of
``train/torch_export.py``).

``save_pth`` writes what the reference's eval script loads
(``torch.load(..., weights_only=True)`` of a ``UNet().state_dict()``): the
Flax tree of an export mapped through ``models.convert.state_dict_from_flax``
(HWIO -> OIHW kernels, the transposed-conv flip undone, a zero
``num_batches_tracked`` for each BatchNorm), in float32 on the CPU.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from audiodenoiser_torch.models.convert import state_dict_from_flax


def save_pth(variables: Mapping[str, Any], path: str) -> None:
    """``{"params", "batch_stats"}`` (numpy, Flax layout) -> ``path``."""
    torch.save(state_dict_from_flax(variables), path)
