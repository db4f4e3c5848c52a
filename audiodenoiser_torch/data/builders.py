"""Clean-chunk loading for training (port of ``data/builders.py``, the
``load_clean_chunks`` part, scipy path).

The JAX package prefers its native C++ loader (``data/native.py``) and
falls back to scipy; the port has the scipy path only (the native loader
is ROADMAP A.6). The ``.npy`` dataset builders are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from audiodenoiser_torch.data.chunking import frame_audio
from audiodenoiser_torch.data.wav_io import read_wav


def load_clean_chunks(clean_files: Sequence[str], sample_rate: int,
                      chunk_samples: int) -> np.ndarray:
    """Decode, resample and chunk clean files: (n_chunks, chunk_samples) f32."""
    all_chunks = []
    for cf in clean_files:
        y, _ = read_wav(cf, sample_rate=sample_rate)
        chunks = frame_audio(y, chunk_samples, chunk_samples)
        if len(chunks):
            all_chunks.append(chunks)
    if not all_chunks:
        return np.zeros((0, chunk_samples), dtype=np.float32)
    return np.concatenate(all_chunks, axis=0)
