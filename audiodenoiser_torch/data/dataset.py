"""Spectrogram-pair dataset over ``.npy`` files + host batching (port of
``data/dataset.py``).

Pairs ``clean_*`` / ``noisy_*`` files by sorted listing, keeps the
reference loader's float16 round trip and its (256, 64) pad-or-truncate,
and yields the reference's own (1, F, T) float32 items (the JAX package
yields NHWC). ``split_train_val`` is the JAX package's deterministic
90/10 split, the same numpy permutation.
"""

from __future__ import annotations

import os
import queue as queue_mod
import threading
from typing import Iterator, Sequence

import numpy as np

from audiodenoiser_torch.data.chunking import pad_or_truncate


class SpectrogramPairs:
    def __init__(self, data_dir: str, target_size: tuple[int, int] = (256, 64),
                 subset_fraction: float = 1.0, seed: int = 0,
                 float16_roundtrip: bool = True):
        self.target_size = target_size
        self.float16_roundtrip = float16_roundtrip
        files = os.listdir(data_dir)
        clean = sorted(os.path.join(data_dir, f) for f in files
                       if f.startswith("clean") and f.endswith(".npy"))
        noisy = sorted(os.path.join(data_dir, f) for f in files
                       if f.startswith("noisy") and f.endswith(".npy"))
        if len(clean) != len(noisy):
            raise ValueError(f"Mismatch in {data_dir}: {len(clean)} clean, "
                             f"{len(noisy)} noisy")
        pairs = list(zip(noisy, clean))
        if subset_fraction < 1.0:
            keep = max(1, int(len(pairs) * subset_fraction))
            idx = np.random.default_rng(seed).permutation(len(pairs))[:keep]
            pairs = [pairs[i] for i in sorted(idx)]
        self.pairs = pairs

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        noisy_path, clean_path = self.pairs[idx]
        noisy, clean = np.load(noisy_path), np.load(clean_path)
        if self.float16_roundtrip:  # the reference loader's lossy cast, kept
            noisy, clean = noisy.astype(np.float16), clean.astype(np.float16)
        noisy = pad_or_truncate(noisy.astype(np.float32), self.target_size)
        clean = pad_or_truncate(clean.astype(np.float32), self.target_size)
        return noisy[None], clean[None]  # (1, F, T)


def split_train_val(n: int, val_ratio: float = 0.1,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic 90/10 index split."""
    val_size = int(n * val_ratio)
    perm = np.random.default_rng(seed).permutation(n)
    return perm[val_size:], perm[:val_size]


def batches(dataset: SpectrogramPairs, indices: Sequence[int], batch_size: int,
            shuffle: bool, seed: int = 0, drop_last: bool = False,
            prefetch: int = 2) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stacked (noisy, clean) (B, 1, F, T) batches, loaded by one
    background thread; the trailing partial batch is yielded unless
    ``drop_last``."""
    idx = np.asarray(indices)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    stop = object()

    def worker():
        try:
            for s in range(0, len(idx), batch_size):
                chunk = idx[s : s + batch_size]
                if len(chunk) < batch_size and drop_last:
                    break
                items = [dataset[int(i)] for i in chunk]
                q.put((np.stack([a for a, _ in items]), np.stack([b for _, b in items])))
            q.put(stop)
        except BaseException as e:  # surface loader failures to the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
