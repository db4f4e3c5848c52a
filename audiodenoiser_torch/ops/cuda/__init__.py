"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

from audiodenoiser_torch.ops.cuda.deconv import (
    conv_transpose_2x2,
    conv_transpose_2x2_plain,
    deconv_kernel,
)
from audiodenoiser_torch.ops.cuda.istft import istft_kernel, istft_plain
from audiodenoiser_torch.ops.cuda.overlap_add import overlap_add_kernel, overlap_add_plain
from audiodenoiser_torch.ops.cuda.stft import stft_kernel, stft_plain

KERNELS = (stft_kernel, istft_kernel, deconv_kernel, overlap_add_kernel)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = ["stft_kernel", "stft_plain", "istft_kernel", "istft_plain",
           "deconv_kernel", "conv_transpose_2x2", "conv_transpose_2x2_plain",
           "overlap_add_kernel", "overlap_add_plain", "KERNELS", "reset_launch_counts"]
