"""K4: overlap-add of windowed frames (``csrc/overlap_add_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.overlap_add_pallas``, a
standalone op as it is there: no path of either package calls it. The
wrapper launches the CUDA kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; any other device raises.

Frames are float32 or bfloat16 and the result has their dtype, as B4's
does. Both versions sum in float32 and round once; B4 sums in the frames'
dtype, one rounding per added frame, so in bf16 the two agree within
``ceil(n_fft / hop) + 1`` bf16 roundings (unit roundoff 2**-9) of the sum of
the added magnitudes, and in float32 within float32 rounding.
"""

from __future__ import annotations

import ctypes

import torch

from audiodenoiser_torch.dsp.stft import overlap_add
from audiodenoiser_torch.ops.cuda import build


_DTYPES = (torch.float32, torch.bfloat16)


def _check(frames: torch.Tensor) -> None:
    if frames.dim() != 3:
        raise ValueError(f"expected (batch, frames, n_fft), got {tuple(frames.shape)}")
    if frames.dtype not in _DTYPES:
        raise TypeError(f"overlap-add takes float32 or bfloat16 frames, not {frames.dtype}")


def overlap_add_plain(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """``dsp.stft.overlap_add`` of (B, T, n_fft) frames in float32, rounded
    once to the frames' dtype: (B, (T-1)*hop + n_fft)."""
    _check(frames)
    return overlap_add(frames.float(), hop_length).to(frames.dtype)


def overlap_add_kernel(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add (B, T, n_fft) float32 or bfloat16 frames, already
    windowed, at any ``hop_length``: (B, (T-1)*hop + n_fft) in their dtype."""
    _check(frames)
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
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.overlap_add_launch.restype = ctypes.c_int
    out = torch.empty((batch, out_len), dtype=frames.dtype, device=frames.device)
    is_bf16 = frames.dtype == torch.bfloat16
    with build.on_device(frames.device):
        stream = build.stream_handle(frames.device)
        rc = lib.overlap_add_launch(frames.data_ptr(), out.data_ptr(), int(is_bf16), batch,
                                    n_frames, n_fft, hop_length, stream)
    if rc != 0:
        raise RuntimeError(f"overlap_add_kernel launch failed with CUDA error {rc}")
    build.count_launch(overlap_add_kernel, "bf16" if is_bf16 else "f32")
    return out


overlap_add_kernel.variants = ("f32", "bf16")
overlap_add_kernel.launches = overlap_add_kernel.f32_launches = 0
overlap_add_kernel.bf16_launches = 0
