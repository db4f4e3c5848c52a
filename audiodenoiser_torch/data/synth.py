"""Seeded synthetic audio, for checks that need clips without a dataset:
no clean or noise wavs ship with the package.

``synth_chunks`` makes 2 s "speech-like" chunks, ``synth_noise_clips``
noise clips of 1 to 5 s for a ``data.pipeline.NoiseBank``. Each draws from
``numpy.random.default_rng(seed)``, so a seed gives the same clips on
every machine.
"""

from __future__ import annotations

import numpy as np


def synth_chunks(n: int, seed: int = 0, sr: int = 8000) -> np.ndarray:
    """Seeded 2 s "speech-like" chunks: a few harmonics of a random pitch
    under a slow amplitude envelope, plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(2 * sr) / sr
    out = np.zeros((n, 2 * sr), np.float32)
    for i in range(n):
        f0 = rng.uniform(90, 260)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1, 4) * t + rng.uniform(0, 6))
        wave = sum(rng.uniform(0.2, 1.0) / k * np.sin(2 * np.pi * k * f0 * t)
                   for k in range(1, 6))
        out[i] = 0.25 * env * wave + 0.01 * rng.standard_normal(t.size)
    return np.clip(out, -1, 1).astype(np.float32)


def synth_noise_clips(n: int, seed: int = 0, sr: int = 8000) -> list:
    """Seeded noise clips of 1 to 5 s for a ``NoiseBank``: white noise
    under a slow random envelope, some shorter than a 2 s chunk (tiled),
    some longer (a random start per draw)."""
    rng = np.random.default_rng(seed)
    clips = []
    for _ in range(n):
        t = np.arange(int(rng.uniform(1.0, 5.0) * sr)) / sr
        env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.2, 2.0) * t)
        clips.append((0.2 * env * rng.standard_normal(t.size)).astype(np.float32))
    return clips
