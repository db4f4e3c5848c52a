"""Window functions (numpy; windows are built once and cached on device).

A copy of ``audiodenoiser_tpu.dsp.window``: librosa's periodic Hann window
and ``pad_center``.
"""

from __future__ import annotations

import numpy as np


def hann_window(win_length: int, periodic: bool = True, dtype=np.float32) -> np.ndarray:
    """Periodic (fftbins=True) Hann window, identical to
    ``scipy.signal.get_window('hann', n, fftbins=True)`` and
    ``torch.hann_window(n, periodic=True)``."""
    if win_length == 1:
        return np.ones(1, dtype=dtype)
    denom = win_length if periodic else win_length - 1
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)
    return w.astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa ``util.pad_center``)."""
    n = len(window)
    if n > size:
        raise ValueError(f"window length {n} exceeds target size {size}")
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))
