"""K1: fused framing + window + real-DFT STFT (``csrc/stft_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.stft_pallas``. The
wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from audiodenoiser_torch.dsp.stft import frame_signal
from audiodenoiser_torch.ops.cuda import build

_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper


def stft_plain(x: torch.Tensor, window: torch.Tensor, n_fft: int = 512,
               hop_length: int = 128) -> torch.Tensor:
    """unfold + window + ``torch.fft.rfft``: (B, L) -> complex (B, F, T)."""
    frames = frame_signal(x, n_fft, hop_length) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def _check(x: torch.Tensor, window: torch.Tensor, n_fft: int,
           hop_length: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected (batch, samples), got {tuple(x.shape)}")
    if x.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError("stft_kernel takes float32 signal and window")
    if window.shape != (n_fft,):
        raise ValueError(f"window shape {tuple(window.shape)} != ({n_fft},)")
    if window.device != x.device:
        raise ValueError("signal and window lie on different devices")
    if hop_length < 1 or n_fft < 2:
        raise ValueError(f"bad n_fft={n_fft} / hop_length={hop_length}")
    if x.shape[-1] < n_fft:
        raise ValueError(f"signal too short to frame: {x.shape[-1]} < {n_fft}")


def stft_kernel(x: torch.Tensor, window: torch.Tensor, n_fft: int = 512,
                hop_length: int = 128) -> torch.Tensor:
    """STFT of pre-padded rows: (B, L) f32 -> complex64 (B, n_fft//2+1, T).

    ``T = 1 + (L - n_fft) // hop_length``; centre padding is the caller's
    (``dsp.stft.stft``). ``result.real`` / ``.imag`` are the ``(re, im)``
    pair that ``stft_pallas`` returns.
    """
    _check(x, window, n_fft, hop_length)
    if x.device.type == "cpu":
        return stft_plain(x, window, n_fft, hop_length)
    if x.device.type != "cuda":
        raise ValueError(f"stft_kernel runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and window.is_contiguous()):
        raise ValueError("stft_kernel takes contiguous signal and window")
    batch, length = x.shape
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch {batch} outside the kernel's grid (1..65535)")
    lib = build.load("stft_kernel")
    if lib.stft_launch.argtypes is None:
        lib.stft_smem_bytes.argtypes = [ctypes.c_int]
        lib.stft_smem_bytes.restype = ctypes.c_size_t
        lib.stft_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        )
        lib.stft_launch.restype = ctypes.c_int
    if lib.stft_smem_bytes(n_fft) > _SMEM_LIMIT:
        raise ValueError(f"n_fft={n_fft} needs more shared memory than a block has")
    n_frames = 1 + (length - n_fft) // hop_length
    spec = torch.empty((batch, n_fft // 2 + 1, n_frames), dtype=torch.complex64,
                       device=x.device)
    parts = torch.view_as_real(spec)  # (B, F, T, 2): real and imaginary lanes
    sb, sk, st, _ = parts.stride()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.stft_launch(
            x.data_ptr(), window.data_ptr(), parts.data_ptr(),
            parts.data_ptr() + 4, batch, length, n_fft, hop_length,
            sb, sk, st, stream,
        )
    if rc != 0:
        raise RuntimeError(f"stft_kernel launch failed with CUDA error {rc}")
    stft_kernel.launches += 1
    return spec


stft_kernel.launches = 0
