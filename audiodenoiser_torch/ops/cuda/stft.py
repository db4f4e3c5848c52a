"""K1: fused framing + window + real-DFT STFT (``csrc/stft_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.stft_pallas``. The
wrapper launches a CUDA kernel for a CUDA tensor and takes the plain
PyTorch version for a CPU tensor; any other device raises. The library has
two entries, chosen by shape alone: ``stft_fft`` (a shared-memory FFT) for a
power-of-two ``n_fft``, ``stft_direct`` (the direct DFT) for any other.
Each has its own launch counter beside ``stft_kernel.launches``:
``stft_kernel.fft_launches`` and ``stft_kernel.direct_launches``.

``stft_kernel`` has no gradient: on an input that requires one, with
autograd on, it raises on every device rather than return a result cut
off from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from audiodenoiser_torch.dsp.stft import frame_signal
from audiodenoiser_torch.ops.cuda import build

_SMEM_LIMIT = 232448  # bytes of shared memory a block may use on Hopper
_MAX_LOG_TT = 3        # at most 8 frames per block of the FFT entry
_twiddles: dict[tuple, torch.Tensor] = {}


def stft_entry(n_fft: int) -> str:
    """The kernel entry for this ``n_fft``: "fft" for a power of two,
    "direct" for any other."""
    return "fft" if n_fft >= 2 and n_fft & (n_fft - 1) == 0 else "direct"


def frames_per_block_log2(batch: int, n_frames: int, sm_count: int = 132) -> int:
    """log2 of the frames a block of the FFT entry owns: the largest power
    of two up to 8 that still gives every SM two blocks, else 1 frame (a
    2 s stream window, B=1 and T=126, runs as 126 blocks)."""
    log_tt = _MAX_LOG_TT
    while log_tt > 0 and batch * -(-n_frames >> log_tt) < 2 * sm_count:
        log_tt -= 1
    return log_tt


def twiddle_table(n_fft: int, device: torch.device) -> torch.Tensor:
    """exp(-2 pi i k / n_fft), k < n_fft, as complex64: computed in float64
    and rounded once, cached per (n_fft, device)."""
    device = torch.device(device)
    key = (n_fft, device.type, device.index)
    tab = _twiddles.get(key)
    if tab is None:
        k = torch.arange(n_fft, dtype=torch.float64)
        tab = torch.polar(torch.ones_like(k), -2 * torch.pi * k / n_fft)
        tab = tab.to(torch.complex64).to(device)
        _twiddles[key] = tab
    return tab


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


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would record ``name``: its CUDA kernel writes
    through a raw pointer and has no backward, so a result would come back
    cut off from the graph on the card (and attached on the CPU)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no gradient: only the iSTFT is differentiable, through "
            "dsp.stft.istft(precision='kernel') (ROADMAP A.8); detach the input or "
            "run under torch.no_grad()")


def stft_kernel(x: torch.Tensor, window: torch.Tensor, n_fft: int = 512,
                hop_length: int = 128) -> torch.Tensor:
    """STFT of pre-padded rows: (B, L) f32 -> complex64 (B, n_fft//2+1, T).

    ``T = 1 + (L - n_fft) // hop_length``; centre padding is the caller's
    (``dsp.stft.stft``). ``result.real`` / ``.imag`` are the ``(re, im)``
    pair that ``stft_pallas`` returns.
    """
    _check(x, window, n_fft, hop_length)
    refuse_grad("stft_kernel", x, window)
    if x.device.type == "cpu":
        return stft_plain(x, window, n_fft, hop_length)
    if x.device.type != "cuda":
        raise ValueError(f"stft_kernel runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and window.is_contiguous()):
        raise ValueError("stft_kernel takes contiguous signal and window")
    batch, length = x.shape
    if not 1 <= batch <= 65535:
        raise ValueError(f"batch {batch} outside the kernel's grid (1..65535)")
    lib = _load()
    n_frames = 1 + (length - n_fft) // hop_length
    spec = torch.empty((batch, n_fft // 2 + 1, n_frames), dtype=torch.complex64,
                       device=x.device)
    entry = stft_entry(n_fft)
    with build.on_device(x.device):
        stream = build.stream_handle(x.device)
        if entry == "fft":
            log_tt = frames_per_block_log2(batch, n_frames, build.sm_count(x.device))
            # fewer frames a block where a long frame or hop needs it
            while lib.stft_fft_smem_bytes(n_fft, hop_length, 1 << log_tt) > _SMEM_LIMIT:
                if log_tt == 0:
                    raise ValueError(f"n_fft={n_fft}, hop={hop_length} needs more shared "
                                     "memory than a block has")
                log_tt -= 1
            sb, sk, st = spec.stride()  # in complex elements
            rc = lib.stft_fft_launch(
                x.data_ptr(), window.data_ptr(), twiddle_table(n_fft, x.device).data_ptr(),
                spec.data_ptr(), batch, length, n_fft, hop_length, log_tt, sb, sk, st, stream)
        else:
            if lib.stft_direct_smem_bytes(n_fft) > _SMEM_LIMIT:
                raise ValueError(f"n_fft={n_fft} needs more shared memory than a block has")
            parts = torch.view_as_real(spec)  # (B, F, T, 2): real and imaginary lanes
            sb, sk, st, _ = parts.stride()
            rc = lib.stft_direct_launch(
                x.data_ptr(), window.data_ptr(), parts.data_ptr(),
                parts.data_ptr() + 4, batch, length, n_fft, hop_length,
                sb, sk, st, stream)
    if rc != 0:
        raise RuntimeError(f"stft_kernel ({entry}) launch failed with CUDA error {rc}")
    build.count_launch(stft_kernel, entry)
    return spec


def _load() -> ctypes.CDLL:
    lib = build.load("stft_kernel")
    if lib.stft_fft_launch.argtypes is None:
        lib.stft_fft_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.stft_fft_smem_bytes.restype = ctypes.c_size_t
        lib.stft_fft_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        lib.stft_fft_launch.restype = ctypes.c_int
        lib.stft_direct_smem_bytes.argtypes = [ctypes.c_int]
        lib.stft_direct_smem_bytes.restype = ctypes.c_size_t
        lib.stft_direct_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        lib.stft_direct_launch.restype = ctypes.c_int
    return lib


stft_kernel.variants = ("fft", "direct")
stft_kernel.launches = stft_kernel.fft_launches = stft_kernel.direct_launches = 0
