"""K2: fused inverse real DFT + window + overlap-add (``csrc/istft_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.istft_pallas``: returns
the raw overlap-add signal; the squared-window envelope and the centre
trim stay in ``dsp.stft.istft``. The wrapper launches a CUDA kernel for
CUDA tensors and takes the plain PyTorch version for CPU tensors; any other
device raises. The library has two entries, chosen by shape alone:
``istft_fft`` (a shared-memory inverse FFT) for a power-of-two ``n_fft``,
``istft_direct`` (the direct inverse DFT) for any other. Each has its own
launch counter beside ``istft_kernel.launches``: ``istft_kernel.fft_launches``
and ``istft_kernel.direct_launches``.

``istft_with_grad`` is K2 with a gradient (``_ISTFT``), whose backward is
K1. ``istft_kernel`` itself has none: called directly on an input that
requires a gradient, with autograd on, it raises on every device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from audiodenoiser_torch.dsp.stft import overlap_add
from audiodenoiser_torch.ops.cuda import build
from audiodenoiser_torch.ops.cuda.stft import (
    _SMEM_LIMIT,
    refuse_grad,
    stft_entry,
    stft_kernel,
    twiddle_table,
)

_MAX_LOG_TT = 4  # at most 16 frames a block, halo included


def istft_entry(n_fft: int) -> str:
    """The kernel entry for this ``n_fft``: "fft" for a power of two,
    "direct" for any other (the same rule as K1's)."""
    return stft_entry(n_fft)


def halo_frames(n_fft: int, hop_length: int) -> int:
    """Frames that start before an output segment and spill into it."""
    return (n_fft - 1) // hop_length


def frames_per_block_log2(batch: int, n_frames: int, n_fft: int, hop_length: int,
                          sm_count: int = 132) -> int:
    """log2 of the frames TT a block of the FFT entry computes, its segment's
    TT - H and the H halo frames: 16 where blocks of 16 still give every SM
    two, else 8 (a 2 s stream window, B=1 and T=126, runs 26 blocks of 8
    frames at 512/128), and never H or fewer. Raises ValueError when H >= 16."""
    halo = halo_frames(n_fft, hop_length)
    least = halo.bit_length()  # the smallest log2 with 2**log2 > halo
    if least > _MAX_LOG_TT:
        raise ValueError(
            f"hop_length={hop_length} too small for n_fft={n_fft}: a segment would need "
            f"{halo} halo frames, more than {(1 << _MAX_LOG_TT) - 1}")
    out_len = (n_frames - 1) * hop_length + n_fft
    seg = ((1 << _MAX_LOG_TT) - halo) * hop_length
    if batch * -(-out_len // seg) >= 2 * sm_count:
        return _MAX_LOG_TT
    return max(_MAX_LOG_TT - 1, least)


def istft_plain(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                n_fft: int = 512, hop_length: int = 128) -> torch.Tensor:
    """``torch.fft.irfft`` + window + ``overlap_add``: (B, F, T) -> (B, L).

    The imaginary parts of the DC bin and, for an even ``n_fft``, of the
    Nyquist bin are dropped first, as irfft on the CPU, B2's bases and K2
    drop them: cuFFT's C2R takes its input as Hermitian and does not ignore
    them at every ``n_fft``."""
    im = im.clone()
    im[:, 0] = 0
    if n_fft % 2 == 0:
        im[:, -1] = 0
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


def _interleaved(re: torch.Tensor, im: torch.Tensor) -> bool:
    """True when re and im are the real and imaginary lanes of one complex64
    tensor: a bin is then one aligned 8-byte load."""
    sb, sk, st = re.stride()
    return (im.data_ptr() == re.data_ptr() + 4 and re.data_ptr() % 8 == 0
            and st == 2 and sk % 2 == 0 and sb % 2 == 0)


def fft_launch(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor, out: torch.Tensor,
               n_fft: int, hop_length: int, log_tt: int) -> None:
    """One launch of the FFT entry at 2**log_tt frames a block into ``out``
    (arguments as ``istft_kernel`` has checked them); counts nothing."""
    lib = _load()
    batch, _, n_frames = re.shape
    sb, sk, st = re.stride()
    with build.on_device(re.device):
        rc = lib.istft_fft_launch(
            re.data_ptr(), im.data_ptr(), window.data_ptr(),
            twiddle_table(n_fft, re.device).data_ptr(), out.data_ptr(), batch, n_frames,
            n_fft, hop_length, log_tt, int(_interleaved(re, im)), sb, sk, st,
            build.stream_handle(re.device))
    if rc != 0:
        raise RuntimeError(f"istft_kernel (fft) launch failed with CUDA error {rc}")


def istft_kernel(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                 n_fft: int = 512, hop_length: int = 128) -> torch.Tensor:
    """Windowed overlap-add of the inverse-DFT frames: (B, (T-1)*hop + n_fft).

    ``re`` and ``im`` may be the strided real and imaginary views of one
    complex tensor (``torch.view_as_real(spec)[..., 0]`` and ``[..., 1]``);
    they must share their strides.
    """
    _check(re, im, window, n_fft, hop_length)
    refuse_grad("istft_kernel", re, im, window)
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
    lib = _load()
    entry = istft_entry(n_fft)
    out = torch.empty((batch, (n_frames - 1) * hop_length + n_fft),
                      dtype=torch.float32, device=re.device)
    if entry == "fft":
        log_tt = frames_per_block_log2(batch, n_frames, n_fft, hop_length,
                                       build.sm_count(re.device))
        least = halo_frames(n_fft, hop_length).bit_length()
        # fewer frames a block where a long frame needs it
        while lib.istft_fft_smem_bytes(n_fft, log_tt) > _SMEM_LIMIT:
            if log_tt == least:
                raise ValueError(f"n_fft={n_fft}, hop={hop_length} needs more shared "
                                 "memory than a block has")
            log_tt -= 1
        fft_launch(re, im, window, out, n_fft, hop_length, log_tt)
    else:
        if halo_frames(n_fft, hop_length) >= lib.istft_direct_block_frames():
            raise ValueError(
                f"hop_length={hop_length} too small for n_fft={n_fft}: a segment "
                f"would need more than {lib.istft_direct_block_frames() - 1} halo frames")
        if lib.istft_direct_smem_bytes(n_fft) > _SMEM_LIMIT:
            raise ValueError(f"n_fft={n_fft} needs more shared memory than a block has")
        sb, sk, st = re.stride()
        with build.on_device(re.device):
            rc = lib.istft_direct_launch(
                re.data_ptr(), im.data_ptr(), window.data_ptr(), out.data_ptr(),
                batch, n_frames, n_fft, hop_length, sb, sk, st,
                build.stream_handle(re.device))
        if rc != 0:
            raise RuntimeError(f"istft_kernel (direct) launch failed with CUDA error {rc}")
    build.count_launch(istft_kernel, entry)
    return out


@functools.lru_cache(maxsize=16)
def _bin_weights(n_fft: int, device: torch.device) -> torch.Tensor:
    """c_k / n_fft for the n_fft//2 + 1 bins of a real inverse DFT: c_k is 1
    at DC and, for an even n_fft, at the Nyquist bin, 2 elsewhere. Made once
    per (n_fft, device): setting its entries copies from the host, which a
    CUDA graph's capture refuses (``train.step_graph``)."""
    c = torch.full((n_fft // 2 + 1,), 2.0, dtype=torch.float32, device=device)
    c[0] = 1.0
    if n_fft % 2 == 0:
        c[-1] = 1.0
    return c / n_fft


class _ISTFT(torch.autograd.Function):
    """K2 with its gradient. The adjoint of [inverse real DFT -> window ->
    overlap-add] is [frame -> window -> real DFT], K1 at ``center=False``,
    scaled per bin by ``c_k / n_fft``. The imaginary DC/Nyquist parts,
    which the forward ignores, get a gradient of exactly 0."""

    @staticmethod
    def forward(ctx, re, im, window, n_fft, hop_length):
        ctx.save_for_backward(window)
        ctx.n_fft, ctx.hop_length = n_fft, hop_length
        return istft_kernel(re, im, window, n_fft, hop_length)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (window,) = ctx.saved_tensors
        n_fft = ctx.n_fft
        # the incoming gradient may be strided or expanded; K1 takes rows
        spec = stft_kernel(grad.float().contiguous(), window, n_fft, ctx.hop_length)
        parts = torch.view_as_real(spec) * _bin_weights(n_fft, grad.device)[:, None, None]
        parts[:, 0, :, 1].zero_()
        if n_fft % 2 == 0:
            parts[:, -1, :, 1].zero_()
        return parts[..., 0], parts[..., 1], None, None, None


def istft_with_grad(re: torch.Tensor, im: torch.Tensor, window: torch.Tensor,
                    n_fft: int = 512, hop_length: int = 128) -> torch.Tensor:
    """``istft_kernel`` that autograd differentiates with respect to ``re``
    and ``im``: K2 forward, K1 backward on the card, their plain versions
    on the CPU."""
    return _ISTFT.apply(re, im, window, n_fft, hop_length)


def _load() -> ctypes.CDLL:
    lib = build.load("istft_kernel")
    if lib.istft_fft_launch.argtypes is None:
        lib.istft_fft_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.istft_fft_smem_bytes.restype = ctypes.c_size_t
        lib.istft_fft_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        lib.istft_fft_launch.restype = ctypes.c_int
        lib.istft_direct_smem_bytes.argtypes = [ctypes.c_int]
        lib.istft_direct_smem_bytes.restype = ctypes.c_size_t
        lib.istft_direct_block_frames.argtypes = []
        lib.istft_direct_block_frames.restype = ctypes.c_int
        lib.istft_direct_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
        lib.istft_direct_launch.restype = ctypes.c_int
    return lib


istft_kernel.variants = ("fft", "direct")
istft_kernel.launches = istft_kernel.fft_launches = istft_kernel.direct_launches = 0
