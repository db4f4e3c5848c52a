"""Batched STFT / iSTFT with librosa semantics (port of ``dsp/stft.py``).

Semantics are those of ``audiodenoiser_tpu.dsp.stft``:

- periodic Hann analysis window, centre-padded to ``n_fft`` when
  ``win_length < n_fft``;
- ``center=True`` pads ``n_fft//2`` samples on both sides with zeros
  (librosa's ``pad_mode='constant'``; ``torch.stft`` would reflect);
- iSTFT: windowed overlap-add divided by the summed squared-window
  envelope (bins where it underflows are left undivided), then ``n_fft//2``
  trimmed from both ends when ``center=True``, then padded or cut to
  ``length``.

``precision="fft"`` runs the kernels' plain ``torch.fft`` versions,
``ops.cuda.stft_plain`` / ``istft_plain``, on any device.
``precision="matmul"`` is JAX's real-DFT-basis STFT: the windowed frames
times cosine and sine bases in ``torch.matmul`` (JAX computes it outside
any Pallas kernel); its iSTFT, as JAX's, is the FFT path.
``precision="kernel"`` is the counterpart of JAX's ``"pallas"``: the
transforms go through ``ops.cuda.stft_kernel`` / ``istft_kernel``, which
launch the CUDA kernels for CUDA tensors and take the same plain versions
for CPU tensors. The envelope division and the trim stay outside the
kernels. With autograd on, the kernel iSTFT goes through
``ops.cuda.istft_with_grad``, whose backward is the STFT kernel; the
kernel STFT has no gradient and refuses an input that needs one.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from audiodenoiser_torch.dsp.window import hann_window, pad_center

WindowSpec = Union[str, np.ndarray, None]
PRECISIONS = ("fft", "kernel", "matmul")


def _resolve_window(window: WindowSpec, win_length: int, n_fft: int) -> np.ndarray:
    if window is None or (isinstance(window, str) and window == "ones"):
        w = np.ones(win_length, dtype=np.float32)
    elif isinstance(window, str):
        if window != "hann":
            raise ValueError(f"unsupported window {window!r}")
        w = hann_window(win_length)
    else:
        w = np.asarray(window, dtype=np.float32)
        if w.shape != (win_length,):
            raise ValueError(f"window shape {w.shape} != ({win_length},)")
    return pad_center(w, n_fft).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_array(key: bytes, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode (the
    # serving paths): a training step's autograd saves these for backward
    with torch.inference_mode(False):
        return torch.from_numpy(np.frombuffer(key, np.float32).copy()).to(device)


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, uploaded once per content."""
    return _device_array(np.ascontiguousarray(arr, np.float32).tobytes(),
                         torch.device(device))


@functools.lru_cache(maxsize=32)
def _rdft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real DFT bases (n_fft, n_fft//2 + 1): cos and sin of -2*pi*n*k/n_fft."""
    n = np.arange(n_fft)
    k = np.arange(n_fft // 2 + 1)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def num_frames(length: int, n_fft: int, hop_length: int, center: bool = True) -> int:
    """Number of STFT frames librosa produces for a signal of ``length``."""
    if center:
        # odd n_fft loses one sample of pad on each side
        return 1 + (length + 2 * (n_fft // 2) - n_fft) // hop_length
    if length < n_fft:
        raise ValueError(f"signal length {length} < n_fft {n_fft} with center=False")
    return 1 + (length - n_fft) // hop_length


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Overlapping frames (..., samples) -> (..., n_frames, n_fft), a view."""
    if x.shape[-1] < n_fft:
        raise ValueError(f"signal too short to frame: {x.shape[-1]} < {n_fft}")
    return x.unfold(-1, n_fft, hop_length)


def _pad_signal(x: torch.Tensor, n_fft: int, pad_mode: str) -> torch.Tensor:
    p = n_fft // 2
    if pad_mode == "constant":
        return F.pad(x, (p, p))
    if pad_mode == "reflect":
        lead = x.shape[:-1]
        y = F.pad(x.reshape(-1, 1, x.shape[-1]), (p, p), mode="reflect")
        return y.reshape(*lead, y.shape[-1])
    raise ValueError(f"unsupported pad_mode {pad_mode!r}")


def stft(
    x: torch.Tensor,
    n_fft: int = 512,
    hop_length: int = 128,
    win_length: Optional[int] = None,
    window: WindowSpec = "hann",
    center: bool = True,
    pad_mode: str = "constant",
    precision: str = "fft",
) -> torch.Tensor:
    """Short-time Fourier transform of ``x`` (..., samples).

    Returns complex64 of shape (..., n_fft//2 + 1, n_frames).
    """
    _check_precision(precision)
    win_length = n_fft if win_length is None else win_length
    w = _on(_resolve_window(window, win_length, n_fft), x.device)
    x = x.to(torch.float32)
    if center:
        x = _pad_signal(x, n_fft, pad_mode)
    lead = x.shape[:-1]
    if precision == "matmul":
        cos_b, sin_b = (_on(b, x.device).view(n_fft, -1) for b in _rdft_basis(n_fft))
        fw = frame_signal(x, n_fft, hop_length) * w
        return torch.complex(fw @ cos_b, fw @ sin_b).transpose(-1, -2)
    xb = x.reshape(-1, x.shape[-1])
    from audiodenoiser_torch.ops.cuda import stft_kernel, stft_plain

    transform = stft_kernel if precision == "kernel" else stft_plain
    spec = transform(xb.contiguous(), w, n_fft, hop_length)
    return spec.reshape(*lead, *spec.shape[-2:])


def magnitude(spec: torch.Tensor) -> torch.Tensor:
    return spec.abs()


def magphase(spec: torch.Tensor):
    """librosa.magphase: (magnitude, unit-phase complex).

    Zero-magnitude bins get phase 1, so magnitude * phase always
    reconstructs the input.
    """
    mag = spec.abs()
    tiny = torch.finfo(torch.float32).tiny
    phase = torch.where(
        mag > tiny,
        spec / mag.clamp_min(tiny),
        torch.ones((), dtype=spec.dtype, device=spec.device),
    )
    return mag, phase


@functools.lru_cache(maxsize=64)
def _wss_envelope(
    n_fft: int, hop_length: int, n_frames: int, win_key: bytes, win_length: int
) -> np.ndarray:
    """Inverse of the summed squared-window envelope (librosa
    ``window_sumsquare``), in float64, 1 where the envelope underflows."""
    w = np.frombuffer(win_key, dtype=np.float32)
    out_len = n_fft + hop_length * (n_frames - 1)
    wsq = w.astype(np.float64) ** 2
    env = np.zeros(out_len, dtype=np.float64)
    for t in range(n_frames):
        env[t * hop_length : t * hop_length + n_fft] += wsq
    tiny = np.finfo(np.float32).tiny
    inv = np.where(env > tiny, 1.0 / np.maximum(env, tiny), 1.0)
    return inv.astype(np.float32)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (..., n_frames, n_fft) -> (..., (n_frames-1)*hop + n_fft).

    Scatter-free when ``hop | n_fft``: each frame is split into
    ``R = n_fft//hop`` hop-blocks and the R shifted block-streams are
    summed; otherwise one ``index_add_``.
    """
    t, n_fft = frames.shape[-2], frames.shape[-1]
    lead = frames.shape[:-2]
    out_len = (t - 1) * hop_length + n_fft
    fb = frames.reshape(-1, t, n_fft)
    if n_fft % hop_length == 0:
        r = n_fft // hop_length
        blocks = fb.reshape(-1, t, r, hop_length)
        acc = fb.new_zeros((fb.shape[0], t - 1 + r, hop_length))
        for i in range(r):
            acc[:, i : i + t] += blocks[:, :, i]
        return acc.reshape(*lead, out_len)
    idx = (torch.arange(t, device=frames.device)[:, None] * hop_length
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    out = fb.new_zeros((fb.shape[0], out_len))
    out.index_add_(1, idx, fb.reshape(fb.shape[0], -1))
    return out.reshape(*lead, out_len)


def istft(
    spec: torch.Tensor,
    hop_length: int = 128,
    win_length: Optional[int] = None,
    n_fft: Optional[int] = None,
    window: WindowSpec = "hann",
    center: bool = True,
    length: Optional[int] = None,
    precision: str = "fft",
) -> torch.Tensor:
    """Inverse STFT of ``spec`` (..., freq, time) -> (..., samples)."""
    _check_precision(precision)
    n_fft = 2 * (spec.shape[-2] - 1) if n_fft is None else n_fft
    win_length = n_fft if win_length is None else win_length
    w_np = _resolve_window(window, win_length, n_fft)
    w = _on(w_np, spec.device)
    lead = spec.shape[:-2]
    sb = spec.reshape(-1, *spec.shape[-2:]).to(torch.complex64)
    from audiodenoiser_torch.ops.cuda import istft_kernel, istft_plain, istft_with_grad

    if precision == "kernel":
        transform = istft_with_grad if torch.is_grad_enabled() else istft_kernel
    else:
        transform = istft_plain
    parts = torch.view_as_real(sb)
    y = transform(parts[..., 0], parts[..., 1], w, n_fft, hop_length)
    n_frames = spec.shape[-1]
    inv_env = _on(
        _wss_envelope(n_fft, hop_length, n_frames, w_np.tobytes(), win_length),
        spec.device,
    )
    y = y * inv_env
    if center:
        y = y[..., n_fft // 2 : y.shape[-1] - n_fft // 2]
    if length is not None:
        cur = y.shape[-1]
        if cur > length:
            y = y[..., :length]
        elif cur < length:
            y = F.pad(y, (0, length - cur))
    return y.reshape(*lead, y.shape[-1])
