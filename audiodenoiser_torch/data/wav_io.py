"""WAV decode/encode + resampling on the host (port of ``data/wav_io.py``).

Decoding uses ``scipy.io.wavfile`` with librosa's int->float
normalisation, resampling a polyphase Kaiser filter
(``scipy.signal.resample_poly``), writing 16-bit PCM.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def _to_float32(data: np.ndarray) -> np.ndarray:
    """int16/32 scale by 2^(bits-1), uint8 centred at 128."""
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    raise ValueError(f"unsupported wav dtype {data.dtype}")


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return y
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def read_wav(path, sample_rate: Optional[int] = None,
             mono: bool = True) -> tuple[np.ndarray, int]:
    """Load a wav (a path or a binary file object) as float32 in [-1, 1],
    downmixed by channel mean and resampled to ``sample_rate``."""
    sr, data = wavfile.read(path)
    y = _to_float32(np.asarray(data))
    if mono and y.ndim == 2:
        y = y.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        y = resample(y, sr, sample_rate)
        sr = sample_rate
    return np.ascontiguousarray(y, dtype=np.float32), sr


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Write 16-bit PCM to a path or a binary file object."""
    a = np.asarray(audio, dtype=np.float32)
    pcm = np.clip(a * 32768.0, -32768, 32767).astype(np.int16)
    wavfile.write(path, sample_rate, pcm)


def load_wav_list(dirname: str) -> list[str]:
    """Sorted .wav paths in a directory."""
    return sorted(os.path.join(dirname, f) for f in os.listdir(dirname)
                  if f.lower().endswith(".wav"))
