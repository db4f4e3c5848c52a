"""K3: 2x2 stride-2 transposed convolution (``csrc/deconv_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.conv_transpose_2x2``:
``out[b, :, 2i+di, 2j+dj] = x[b, :, i, j] @ W[:, :, di, dj] + bias`` with
the torch ``ConvTranspose2d`` weight layout (Cin, Cout, 2, 2), whose taps
need no flip (``models.convert`` undid Flax's). The bias is added in fp32
and the result rounded to ``x.dtype`` once, as B3 does.

- ``conv_transpose_2x2_plain``: the plain PyTorch version (four einsums
  with the taps, the fp32 bias, one cast, a pixel-shuffle interleave).
- ``deconv_kernel``: launches a CUDA kernel for a CUDA tensor, takes the
  plain version for a CPU tensor, raises on any other device. The library
  has three variants, chosen by ``deconv_variant`` from dtype, shape and
  alignment alone: "wgmma" (TMA + wgmma, bf16 with Cin and Cout multiples
  of 8, as at every U-Net layer), "wmma" (other bf16 shapes) and "fma"
  (float32). Each counts its launches in ``deconv_kernel.<variant>_launches``
  beside ``deconv_kernel.launches``. The packed weight and the fp32 bias are
  cached on the parameter and made anew only when its ``_version`` (an
  optimizer step), storage or the compute dtype changes, and every call
  inside a CUDA graph's capture.
- ``conv_transpose_2x2``: the autograd Function the U-Net calls. Its
  forward is ``deconv_kernel``; its backward is B3's ``_bwd`` arithmetic in
  fp32 (dx a stride-2 convolution, dW a correlation, db a sum), which the
  JAX package also leaves to the framework.

Tensors are logical NCHW and physically channels_last (NHWC), the layout
the kernel reads and writes without a transpose.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiodenoiser_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)


def conv_transpose_2x2_plain(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor) -> torch.Tensor:
    """(B, Cin, H, W) -> (B, Cout, 2H, 2W) in ``x.dtype``, channels_last."""
    b, _, h, w = x.shape
    cout = weight.shape[1]
    taps = weight.to(x.dtype).float()  # the kernel multiplies in x's dtype
    xf = x.float()
    ys = [torch.einsum("bchw,co->bhwo", xf, taps[:, :, di, dj])
          for di in (0, 1) for dj in (0, 1)]
    y = torch.stack(ys, dim=3).reshape(b, h, w, 2, 2, cout) + bias.float()
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, cout)
    return y.to(x.dtype).permute(0, 3, 1, 2)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (2, 2):
        raise ValueError(f"expected NCHW x and (Cin, Cout, 2, 2) weight, got "
                         f"{tuple(x.shape)} / {tuple(weight.shape)}")
    if weight.shape[0] != x.shape[1] or bias.shape != (weight.shape[1],):
        raise ValueError(f"channels disagree: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"deconv_kernel takes float32 or bfloat16, not {x.dtype}")
    if not (x.device == weight.device == bias.device):
        raise ValueError("x, weight and bias lie on different devices")


def deconv_variant(dtype: torch.dtype, cin: int, cout: int, x_ptr: int = 0) -> str:
    """The kernel variant for these operands: "fma" for float32, "wgmma"
    for bf16 whose rows TMA can address (Cin and Cout multiples of 8, x
    16-byte aligned), "wmma" for any other bf16."""
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if cin % 8 == 0 and cout % 8 == 0 and x_ptr % 16 == 0 else "wmma"


def _cached(t: torch.Tensor, tag: tuple, make) -> torch.Tensor:
    """``make()``, kept on ``t`` until t's version, storage or ``tag``
    changes (an in-place optimizer step bumps ``t._version``). An inference
    tensor keeps no version counter, so its operand is made each call; so
    is one made inside a CUDA graph's capture, since a replay checks no
    version (``train.step_graph``)."""
    if t.is_inference() or (t.is_cuda and torch.cuda.is_current_stream_capturing()):
        return make()
    cache = t.__dict__.setdefault("_deconv_cache", {})
    key = (t._version, t.data_ptr())
    hit = cache.get(tag)
    if hit is None or hit[0] != key:
        hit = (key, make())
        cache[tag] = hit
    return hit[1]


def packed_weight(weight: torch.Tensor, dtype: torch.dtype, k_major: bool) -> torch.Tensor:
    """The (Cin, Cout, 2, 2) weight as a GEMM operand in ``dtype``, column or
    row (di*2+dj)*Cout + co: (4*Cout, Cin) when ``k_major`` (the wgmma
    variant's B), else (Cin, 4*Cout). Cached on the weight."""
    def make():
        w = weight.detach()
        w = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]) if k_major else \
            w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)
        return w.to(dtype).contiguous()
    return _cached(weight, ("weight", dtype, k_major), make)


def bias_f32(bias: torch.Tensor) -> torch.Tensor:
    """The bias as contiguous float32, cached on the bias."""
    return _cached(bias, ("bias",), lambda: bias.detach().float().contiguous())


def deconv_kernel(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """ConvTranspose(k=2, s=2): (B, Cin, H, W) -> (B, Cout, 2H, 2W).

    On CUDA ``x`` must be channels_last contiguous; the result is
    channels_last in ``x.dtype``.
    """
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return conv_transpose_2x2_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"deconv_kernel runs on cuda or cpu, not {x.device}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("deconv_kernel takes a channels_last contiguous x")
    batch, cin, h, w = x.shape
    cout = weight.shape[1]
    out = torch.empty((batch, cout, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    variant = deconv_variant(x.dtype, cin, cout, x.data_ptr())
    wmat = packed_weight(weight, x.dtype, k_major=variant == "wgmma")
    b32 = bias_f32(bias)
    lib = _load()
    with build.on_device(x.device):
        stream = build.stream_handle(x.device)
        if variant == "wgmma":
            rc = lib.deconv2x2_wgmma_launch(
                x.data_ptr(), wmat.data_ptr(), b32.data_ptr(), out.data_ptr(),
                batch, h, w, cin, cout, stream)
        else:
            rc = lib.deconv2x2_launch(
                x.data_ptr(), wmat.data_ptr(), b32.data_ptr(), out.data_ptr(),
                int(variant == "wmma"), batch, h, w, cin, cout, stream)
    if rc != 0:
        raise RuntimeError(f"deconv_kernel ({variant}) launch failed with CUDA error {rc}")
    build.count_launch(deconv_kernel, variant)
    return out


def _load() -> ctypes.CDLL:
    lib = build.load("deconv_kernel")
    if lib.deconv2x2_launch.argtypes is None:
        lib.deconv2x2_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.deconv2x2_launch.restype = ctypes.c_int
        lib.deconv2x2_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.deconv2x2_wgmma_launch.restype = ctypes.c_int
    return lib


deconv_kernel.variants = ("wgmma", "wmma", "fma")
deconv_kernel.launches = deconv_kernel.wgmma_launches = 0
deconv_kernel.wmma_launches = deconv_kernel.fma_launches = 0


class _ConvTranspose2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return deconv_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g32 = g.float()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # dx[b,ci,i,j] = sum g[b,co,2i+di,2j+dj] W[ci,co,di,dj]: a stride-2
            # convolution whose (out, in) channels are W's (Cin, Cout)
            dx = F.conv2d(g32, weight.float(), stride=2).to(x.dtype)
        if ctx.needs_input_grad[1]:
            b, cin, h, w = x.shape
            cout = weight.shape[1]
            xf = x.float().permute(0, 2, 3, 1).reshape(-1, cin)
            gf = (g32.permute(0, 2, 3, 1).reshape(b, h, 2, w, 2, cout)
                  .permute(0, 1, 3, 2, 4, 5).reshape(-1, 4 * cout))
            dw = ((xf.t() @ gf).reshape(cin, 2, 2, cout).permute(0, 3, 1, 2)
                  .to(weight.dtype))
        if ctx.needs_input_grad[2]:
            db = g32.sum((0, 2, 3)).to(ctx.bias_dtype)
        return dx, dw, db


def conv_transpose_2x2(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Differentiable K3: forward through ``deconv_kernel``, backward in fp32."""
    return _ConvTranspose2x2.apply(x, weight, bias)
