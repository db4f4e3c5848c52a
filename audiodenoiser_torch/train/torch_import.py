"""Reference ``.pth`` checkpoints to the Flax tree of an export (port of
``train/torch_import.py``).

``load_pth`` reads a ``torch.save``d state_dict with ``weights_only=True``
(no code runs) and maps it through ``models.convert.flax_from_state_dict``:
the inverse layout rules of ``save_pth``. ``convert_state_dict`` takes the
dict itself, its values tensors or numpy arrays, as JAX's does; keys the
tree has no place for (``num_batches_tracked``) are ignored.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from audiodenoiser_torch.models.convert import flax_from_state_dict


def convert_state_dict(sd: Mapping[str, Any]) -> dict:
    """A U-Net state_dict -> ``{"params", "batch_stats"}`` of float32 numpy."""
    return flax_from_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})


def load_pth(path: str) -> dict:
    """Load a reference-layout ``.pth`` (weights only) and convert it."""
    return convert_state_dict(torch.load(path, map_location="cpu", weights_only=True))
