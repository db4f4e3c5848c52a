"""Row LayerNorm (``csrc/layer_norm_kernel.cu``): MP-SENet's conformer norms.

It replaces no TPU kernel: MP-SENet exists only in the port. It was added
because PyTorch's row LayerNorm took 26.7% of a batch of the 10 s MP-SENet
cell at about 7% of HBM bandwidth. ``layer_norm_kernel`` normalises the last
axis as ``F.layer_norm`` does (biased variance, ``eps`` inside the square
root, then ``* weight + bias``). On a CPU tensor it takes the plain version,
``layer_norm_plain``, which repeats the kernel's arithmetic: an upcast to
float32, a two-pass mean and variance, the affine transform in float32 and
one rounding to the input's dtype. On a CUDA tensor it launches the kernel,
or raises on what the kernel does not take: a dtype other than float32 and
bfloat16 (weight and bias in the input's dtype), a last axis that is not a
multiple of 8 in [8, 512], a non-contiguous or misaligned tensor, and an
input that needs a gradient (the kernel has none; MP-SENet serves under
``torch.inference_mode``). No mean or rstd is returned.

Calls are counted by route: ``layer_norm_kernel.launches`` counts both,
``kernel_launches`` and ``plain_launches`` each (``ops.cuda.variant_launches``).
"""

from __future__ import annotations

import ctypes

import torch

from audiodenoiser_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_WIDTH = 512


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of the last axis in at least float32, rounded once to
    ``x``'s dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    rstd = torch.rsqrt(d.square().mean(-1, keepdim=True) + eps)
    return (d * rstd * weight.to(acc) + bias.to(acc)).to(x.dtype)


def _check_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm_kernel takes float32 or bfloat16, not {x.dtype}")
    if weight.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"layer_norm_kernel takes weight and bias in the input's dtype "
                        f"{x.dtype}, not {weight.dtype} and {bias.dtype}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("layer_norm_kernel takes weight and bias on the input's device")
    c = x.shape[-1]
    if c % 8 or not 8 <= c <= MAX_WIDTH:
        raise ValueError(f"layer_norm_kernel takes a last axis that is a multiple of 8 in "
                         f"[8, {MAX_WIDTH}], not {c}")
    for name, t in (("input", x), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"layer_norm_kernel takes a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"layer_norm_kernel takes a 16-byte aligned {name}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise RuntimeError("layer_norm_kernel has no gradient: call it under "
                           "torch.no_grad() or torch.inference_mode()")


def layer_norm_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm of ``x``'s last axis with ``weight`` and ``bias`` of its
    length: the kernel on the card, ``layer_norm_plain`` on the CPU."""
    if x.dim() < 1 or weight.shape != (x.shape[-1],) or bias.shape != weight.shape:
        raise ValueError(f"layer_norm_kernel: input {tuple(x.shape)} against weight "
                         f"{tuple(weight.shape)} and bias {tuple(bias.shape)}")
    if x.device.type == "cpu":
        build.count_launch(layer_norm_kernel, "plain")
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_kernel runs on cuda or cpu, not {x.device}")
    _check_cuda(x, weight, bias)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return out
    lib = build.load("layer_norm_kernel")
    if lib.layer_norm_launch.argtypes is None:
        lib.layer_norm_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.layer_norm_launch.restype = ctypes.c_int
    with build.on_device(x.device):
        rc = lib.layer_norm_launch(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                   out.data_ptr(), int(x.dtype == torch.bfloat16), rows,
                                   x.shape[-1], float(eps), build.sm_count(x.device),
                                   build.stream_handle(x.device))
    if rc != 0:
        raise RuntimeError(f"layer_norm_kernel launch failed with CUDA error {rc}")
    build.count_launch(layer_norm_kernel, "kernel")
    return out


layer_norm_kernel.variants = ("kernel", "plain")
layer_norm_kernel.launches = layer_norm_kernel.kernel_launches = 0
layer_norm_kernel.plain_launches = 0
