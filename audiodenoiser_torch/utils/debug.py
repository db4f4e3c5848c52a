"""Numerical guards (port of ``utils/debug.py``)."""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch


def _leaves(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """``(key path, leaf)`` of a tree of dicts, lists and tuples, the path
    written as ``jax.tree_util.keystr`` writes it: ``['a'][0]``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def assert_tree_finite(tree: Any, name: str = "tree") -> None:
    """Host-side check that every floating-point leaf (tensor, array or
    number) of ``tree`` is finite; integer and boolean leaves pass. Raises
    ``FloatingPointError`` naming the key paths of the first five that
    are not. Each tensor is read back to the host: a check for epoch
    boundaries, not for inside a step."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            finite = not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            finite = arr.dtype.kind != "f" or bool(np.all(np.isfinite(arr)))
        if not finite:
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:5]}")
