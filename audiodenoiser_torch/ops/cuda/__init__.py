"""Hand-written CUDA kernels, each beside its plain PyTorch version."""

from audiodenoiser_torch.ops.cuda.conv_module import conv_module_kernel, conv_module_plain
from audiodenoiser_torch.ops.cuda.deconv import (
    conv_transpose_2x2,
    conv_transpose_2x2_plain,
    deconv_kernel,
)
from audiodenoiser_torch.ops.cuda.istft import istft_kernel, istft_plain, istft_with_grad
from audiodenoiser_torch.ops.cuda.layer_norm import layer_norm_kernel, layer_norm_plain
from audiodenoiser_torch.ops.cuda.overlap_add import overlap_add_kernel, overlap_add_plain
from audiodenoiser_torch.ops.cuda.stft import stft_kernel, stft_plain

KERNELS = (stft_kernel, istft_kernel, deconv_kernel, overlap_add_kernel, layer_norm_kernel,
           conv_module_kernel)


def variant_launches(kernel) -> dict[str, int]:
    """Launches of each variant of a kernel's library, by variant name."""
    return {v: getattr(kernel, f"{v}_launches") for v in getattr(kernel, "variants", ())}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        for v in getattr(k, "variants", ()):
            setattr(k, f"{v}_launches", 0)


__all__ = ["stft_kernel", "stft_plain", "istft_kernel", "istft_plain", "istft_with_grad",
           "deconv_kernel", "conv_transpose_2x2", "conv_transpose_2x2_plain",
           "overlap_add_kernel", "overlap_add_plain", "layer_norm_kernel", "layer_norm_plain",
           "conv_module_kernel", "conv_module_plain", "KERNELS", "reset_launch_counts",
           "variant_launches"]
