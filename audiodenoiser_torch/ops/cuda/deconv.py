"""K3: 2x2 stride-2 transposed convolution (``csrc/deconv_kernel.cu``).

The counterpart of ``audiodenoiser_tpu.ops.pallas.conv_transpose_2x2``:
``out[b, :, 2i+di, 2j+dj] = x[b, :, i, j] @ W[:, :, di, dj] + bias`` with
the torch ``ConvTranspose2d`` weight layout (Cin, Cout, 2, 2), whose taps
need no flip (``models.convert`` undid Flax's). The bias is added in fp32
and the result rounded to ``x.dtype`` once, as B3 does.

- ``conv_transpose_2x2_plain``: the plain PyTorch version (four einsums
  with the taps, the fp32 bias, one cast, a pixel-shuffle interleave).
- ``deconv_kernel``: launches the CUDA kernel for a CUDA tensor, takes
  the plain version for a CPU tensor, raises on any other device.
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
    # (Cin, Cout, 2, 2) -> (Cin, 2, 2, Cout): GEMM column (di*2+dj)*Cout + co
    wmat = weight.detach().permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    wmat = wmat.to(x.dtype).contiguous()
    b32 = bias.detach().float().contiguous()
    lib = build.load("deconv_kernel")
    if lib.deconv2x2_launch.argtypes is None:
        lib.deconv2x2_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.deconv2x2_launch.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.deconv2x2_launch(
            x.data_ptr(), wmat.data_ptr(), b32.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), batch, h, w, cin, cout, stream,
        )
    if rc != 0:
        raise RuntimeError(f"deconv_kernel launch failed with CUDA error {rc}")
    deconv_kernel.launches += 1
    return out


deconv_kernel.launches = 0


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
