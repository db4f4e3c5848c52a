"""Host-side chunking and shape utilities (numpy copies of the JAX
package's ``data/chunking.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def frame_audio(audio: np.ndarray, chunk_samples: int = 16000,
                hop_samples: Optional[int] = None) -> np.ndarray:
    """Non-overlapping (by default) fixed chunks, (n_chunks, chunk_samples);
    the trailing remainder is dropped."""
    if hop_samples is None:
        hop_samples = chunk_samples
    n = 0 if len(audio) < chunk_samples else 1 + (len(audio) - chunk_samples) // hop_samples
    if n == 0:
        return np.zeros((0, chunk_samples), dtype=audio.dtype)
    idx = np.arange(n)[:, None] * hop_samples + np.arange(chunk_samples)[None, :]
    return audio[idx]


def match_audio_length(noise: np.ndarray, target_len: int,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Tile-or-snip to exactly ``target_len``."""
    rng = np.random.default_rng() if rng is None else rng
    if len(noise) == target_len:
        return noise.copy()
    if len(noise) < target_len:
        reps = int(np.ceil(target_len / len(noise)))
        return np.tile(noise, reps)[:target_len]
    start = int(rng.integers(0, len(noise) - target_len))
    return noise[start : start + target_len]


def pad_or_truncate(data: np.ndarray,
                    target_size: tuple[int, int] = (256, 64)) -> np.ndarray:
    """Zero-pad at the end / truncate each of the last two axes (the
    reference's lossy (256, 64) training crop)."""
    th, tw = target_size
    h, w = data.shape[-2], data.shape[-1]
    pad = [(0, 0)] * (data.ndim - 2)
    if h < th:
        data = np.pad(data, pad + [(0, th - h), (0, 0)], mode="constant")
    elif h > th:
        data = data[..., :th, :]
    if w < tw:
        data = np.pad(data, pad + [(0, 0), (0, tw - w)], mode="constant")
    elif w > tw:
        data = data[..., :, :tw]
    return data
