"""K2: fused inverse real DFT + window + overlap-add (``csrc/istft_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.istft_pallas``: returns
the raw overlap-add signal; the squared-window envelope and the centre
trim stay in ``dsp.stft.istft``. The wrapper launches the CUDA kernel for
CUDA tensors and takes the plain PyTorch version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from audiodenoiser_torch.dsp.stft import overlap_add
from audiodenoiser_torch.ops.cuda import build
from audiodenoiser_torch.ops.cuda.stft import _SMEM_LIMIT


def istft_plain(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                n_fft: int = 512, hop_length: int = 128) -> torch.Tensor:
    """``torch.fft.irfft`` + window + ``overlap_add``: (B, F, T) -> (B, L)."""
    spec = torch.complex(re, im).transpose(-1, -2)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    return overlap_add(frames, hop_length)


def _check(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
           n_fft: int, hop_length: int) -> None:
    if re.dim() != 3 or re.shape != im.shape:
        raise ValueError(
            f"expected re/im of one (batch, freq, time) shape, got "
            f"{tuple(re.shape)} / {tuple(im.shape)}")
    if re.shape[1] != n_fft // 2 + 1:
        raise ValueError(f"freq dim {re.shape[1]} != n_fft//2+1 ({n_fft // 2 + 1})")
    if {re.dtype, im.dtype, window.dtype} != {torch.float32}:
        raise TypeError("istft_kernel takes float32 re, im and window")
    if window.shape != (n_fft,):
        raise ValueError(f"window shape {tuple(window.shape)} != ({n_fft},)")
    if not (re.device == im.device == window.device):
        raise ValueError("re, im and window lie on different devices")
    if hop_length < 1:
        raise ValueError(f"bad hop_length={hop_length}")


def istft_kernel(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                 n_fft: int = 512, hop_length: int = 128) -> torch.Tensor:
    """Windowed overlap-add of the inverse-DFT frames: (B, (T-1)*hop + n_fft).

    ``re`` and ``im`` may be the strided real and imaginary views of one
    complex tensor (``torch.view_as_real(spec)[..., 0]`` and ``[..., 1]``);
    they must share their strides.
    """
    _check(re, im, window, n_fft, hop_length)
    if re.device.type == "cpu":
        return istft_plain(re, im, window, n_fft, hop_length)
    if re.device.type != "cuda":
        raise ValueError(f"istft_kernel runs on cuda or cpu, not {re.device}")
    if re.stride() != im.stride() or min(re.stride()) < 1:
        raise ValueError("re and im must share positive strides")
    if not window.is_contiguous():
        raise ValueError("istft_kernel takes a contiguous window")
    batch, _, n_frames = re.shape
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch {batch} outside the kernel's grid (1..65535)")
    lib = build.load("istft_kernel")
    if lib.istft_launch.argtypes is None:
        lib.istft_smem_bytes.argtypes = [ctypes.c_int]
        lib.istft_smem_bytes.restype = ctypes.c_size_t
        lib.istft_block_frames.argtypes = []
        lib.istft_block_frames.restype = ctypes.c_int
        lib.istft_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        )
        lib.istft_launch.restype = ctypes.c_int
    if (n_fft - 1) // hop_length >= lib.istft_block_frames():
        raise ValueError(
            f"hop_length={hop_length} too small for n_fft={n_fft}: a segment "
            f"would need more than {lib.istft_block_frames() - 1} halo frames")
    if lib.istft_smem_bytes(n_fft) > _SMEM_LIMIT:
        raise ValueError(f"n_fft={n_fft} needs more shared memory than a block has")
    out = torch.empty((batch, (n_frames - 1) * hop_length + n_fft),
                      dtype=torch.float32, device=re.device)
    sb, sk, st = re.stride()
    with build.on_device(re.device):
        stream = build.stream_handle(re.device)
        rc = lib.istft_launch(
            re.data_ptr(), im.data_ptr(), window.data_ptr(), out.data_ptr(),
            batch, n_frames, n_fft, hop_length, sb, sk, st, stream,
        )
    if rc != 0:
        raise RuntimeError(f"istft_kernel launch failed with CUDA error {rc}")
    istft_kernel.launches += 1
    return out


istft_kernel.launches = 0
