"""K4: overlap-add of windowed frames (``csrc/overlap_add_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.overlap_add_pallas``, a
standalone op as it is there: no path of either package calls it. The
wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; any other device raises.
"""

from __future__ import annotations

import ctypes

import torch

from audiodenoiser_torch.dsp.stft import overlap_add
from audiodenoiser_torch.ops.cuda import build


def _check_rank(frames: torch.Tensor) -> None:
    if frames.dim() != 3:
        raise ValueError(f"expected (batch, frames, n_fft), got {tuple(frames.shape)}")


def overlap_add_plain(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """``dsp.stft.overlap_add`` of (B, T, n_fft) frames: (B, (T-1)*hop + n_fft)."""
    _check_rank(frames)
    return overlap_add(frames, hop_length)


def overlap_add_kernel(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (B, T, n_fft) float32 frames, already windowed, at any
    ``hop_length``: (B, (T-1)*hop + n_fft) float32."""
    _check_rank(frames)
    if frames.dtype != torch.float32:
        raise TypeError(f"overlap_add_kernel takes float32 frames, not {frames.dtype}")
    if hop_length < 1:
        raise ValueError(f"bad hop_length={hop_length}")
    if frames.device.type == "cpu":
        return overlap_add_plain(frames, hop_length)
    if frames.device.type != "cuda":
        raise ValueError(f"overlap_add_kernel runs on cuda or cpu, not {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("overlap_add_kernel takes contiguous frames")
    batch, n_frames, n_fft = frames.shape
    if not 1 <= batch <= 65535 or n_frames < 1 or n_fft < 1:
        raise ValueError(f"frames {tuple(frames.shape)} outside the kernel's grid "
                         "(batch 1..65535, at least one frame)")
    out_len = (n_frames - 1) * hop_length + n_fft
    if out_len >= 2 ** 31:
        raise ValueError(f"output of {out_len} samples a row exceeds the kernel's int range")
    lib = build.load("overlap_add_kernel")
    if lib.overlap_add_launch.argtypes is None:
        lib.overlap_add_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.overlap_add_launch.restype = ctypes.c_int
    out = torch.empty((batch, out_len), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = lib.overlap_add_launch(frames.data_ptr(), out.data_ptr(), batch,
                                    n_frames, n_fft, hop_length, stream)
    if rc != 0:
        raise RuntimeError(f"overlap_add_kernel launch failed with CUDA error {rc}")
    overlap_add_kernel.launches += 1
    return out


overlap_add_kernel.launches = 0
