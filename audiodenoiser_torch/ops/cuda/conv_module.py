"""Conv-module middle (``csrc/conv_module_kernel.cu``): MP-SENet's GLU,
depthwise conv (k = 31), BatchNorm on its running statistics and SiLU in
one channel-last pass.

It replaces no TPU kernel: MP-SENet exists only in the port. It was added
because PyTorch's generic depthwise conv took 15.4% of a batch of the 10 s
MP-SENet cell at about 6% of HBM bandwidth, between five more passes (the
GLU, two transposed copies, BatchNorm, SiLU). ``conv_module_kernel`` maps
the first pointwise conv's output ``h``, (N, L, 2C), to (N, L, C)::

    g   = h[..., :C] * sigmoid(h[..., C:])
    d   = dw_bias + sum_k dw_weight[:, 0, k] * g[:, l + k - 15]   (g = 0 outside [0, L))
    out = silu((d - bn_mean) * bn_weight / sqrt(bn_var + eps) + bn_bias)

On a CPU tensor it takes the plain version, ``conv_module_plain``: the
published sequence (``F.glu``, ``F.conv1d`` with C groups and padding 15,
``F.batch_norm`` on the running statistics, ``F.silu``) on an upcast to
float32, rounded once to the input's dtype. The kernel computes the same
function with the BatchNorm folded into its taps, and takes the sigmoids'
exp2 and reciprocal from the card's special-function units (within 2 and 1
float32 ulps). On a CUDA tensor it launches the kernel, or raises on what
the kernel does not take: a dtype other than float32 and bfloat16,
parameters in another dtype or on another device, a channel count C that is
not a multiple of 8, a kernel size other than 31, a non-contiguous or
misaligned tensor, more positions than the kernel's int32 indices reach,
and an input that needs a gradient (the kernel has none; MP-SENet serves
under ``torch.inference_mode``). The fold is worked out at each call from
the parameters given, so nothing is cached.

Calls are counted by route: ``conv_module_kernel.launches`` counts both,
``kernel_launches`` and ``plain_launches`` each (``ops.cuda.variant_launches``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiodenoiser_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)
_TAPS = 31


def conv_module_plain(h: torch.Tensor, dw_weight: torch.Tensor, dw_bias: torch.Tensor,
                      bn_weight: torch.Tensor, bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                      bn_var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The published sequence in at least float32 on the (N, C, L) layout,
    rounded once to ``h``'s dtype: (..., L, 2C) -> (..., L, C), contiguous."""
    acc = torch.promote_types(h.dtype, torch.float32)
    w, b, bn_w, bn_b, mean, var = (t.to(acc) for t in (dw_weight, dw_bias, bn_weight, bn_bias,
                                                       bn_mean, bn_var))
    g = F.glu(h.reshape(-1, *h.shape[-2:]).to(acc), dim=-1).transpose(1, 2)
    y = F.conv1d(g, w, b, padding=(_TAPS - 1) // 2, groups=w.shape[0])
    y = F.silu(F.batch_norm(y, mean, var, bn_w, bn_b, False, 0.0, eps))
    return y.transpose(1, 2).to(h.dtype).contiguous().reshape(h.shape[:-1] + (w.shape[0],))


def _check_cuda(h: torch.Tensor, params: dict) -> None:
    if h.dtype not in _DTYPES:
        raise TypeError(f"conv_module_kernel takes float32 or bfloat16, not {h.dtype}")
    for name, t in params.items():
        if t.dtype != h.dtype:
            raise TypeError(f"conv_module_kernel takes {name} in the input's dtype {h.dtype}, "
                            f"not {t.dtype}")
        if t.device != h.device:
            raise ValueError(f"conv_module_kernel takes {name} on the input's device")
    c = h.shape[-1] // 2
    if c % 8:
        raise ValueError(f"conv_module_kernel takes a channel count that is a multiple of 8, "
                         f"not {c}")
    for name, t in (("input", h), *params.items()):
        if not t.is_contiguous():
            raise ValueError(f"conv_module_kernel takes a contiguous {name}")
    if h.data_ptr() % 16:
        raise ValueError("conv_module_kernel takes a 16-byte aligned input")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, *params.values())):
        raise RuntimeError("conv_module_kernel has no gradient: call it under "
                           "torch.no_grad() or torch.inference_mode()")


def conv_module_kernel(h: torch.Tensor, dw_weight: torch.Tensor, dw_bias: torch.Tensor,
                       bn_weight: torch.Tensor, bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                       bn_var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """GLU, depthwise conv (``dw_weight`` (C, 1, 31), padding 15), BatchNorm
    on its running statistics and SiLU of ``h`` (..., L, 2C): the kernel on
    the card, ``conv_module_plain`` on the CPU."""
    c = h.shape[-1] // 2 if h.dim() >= 2 else -1
    if (h.dim() < 2 or h.shape[-1] != 2 * c or dw_weight.shape != (c, 1, _TAPS)
            or any(t.shape != (c,) for t in (dw_bias, bn_weight, bn_bias, bn_mean, bn_var))):
        raise ValueError(f"conv_module_kernel: input {tuple(h.shape)} against depthwise weight "
                         f"{tuple(dw_weight.shape)} (C, 1, {_TAPS}) and (C,) vectors")
    args = (dw_weight, dw_bias, bn_weight, bn_bias, bn_mean, bn_var)
    if h.device.type == "cpu":
        build.count_launch(conv_module_kernel, "plain")
        return conv_module_plain(h, *args, eps)
    if h.device.type != "cuda":
        raise ValueError(f"conv_module_kernel runs on cuda or cpu, not {h.device}")
    length = h.shape[-2]
    n = h.numel() // (length * 2 * c) if h.numel() else 0
    _check_cuda(h, dict(zip(("dw_weight", "dw_bias", "bn_weight", "bn_bias", "bn_mean",
                             "bn_var"), args)))
    out = h.new_empty(h.shape[:-1] + (c,))
    if n == 0:
        return out
    lib = build.load("conv_module_kernel")
    if lib.conv_module_launch.argtypes is None:
        lib.conv_module_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                         ctypes.c_void_p])
        lib.conv_module_launch.restype = ctypes.c_int
    with build.on_device(h.device):
        rc = lib.conv_module_launch(h.data_ptr(), *(t.data_ptr() for t in args), out.data_ptr(),
                                    int(h.dtype == torch.bfloat16), n, length, c, float(eps),
                                    build.sm_count(h.device), build.stream_handle(h.device))
    if rc != 0:
        raise RuntimeError(f"conv_module_kernel launch failed with CUDA error {rc}")
    build.count_launch(conv_module_kernel, "kernel")
    return out


conv_module_kernel.variants = ("kernel", "plain")
conv_module_kernel.launches = conv_module_kernel.kernel_launches = 0
conv_module_kernel.plain_launches = 0
