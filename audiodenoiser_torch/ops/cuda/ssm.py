"""The Mamba-1 mixer's causal conv and selective scan (``csrc/ssm_kernel.cu``):
SEMamba's TF-Mamba blocks (d_state 16, d_conv 4, dt_rank 4).

It replaces no TPU kernel: SEMamba exists only in the port, and no PyTorch
operation computes a selective scan. Two entries, both channel-last and
both with ``reverse`` for the backward direction of a bidirectional block
(the published one flips the sequence, runs the mixer and flips the answer
back; every other step is per token, so the conv takes its taps
anti-causally and the scan runs from L - 1 down to 0, and no flipped copy
is made):

- ``ssm_conv(xz, weight, bias, reverse)``: ``xz`` (..., L, 2D), in_proj's
  output; its first half x, read in place, through the depthwise k = 4
  conv with bias (causal: ``u[t] = b + sum_k w[k] x[t + k - 3]``;
  reverse: ``x[t + 3 - k]``), then SiLU: ``u`` (..., L, D);
- ``ssm_scan(u, xz, x_dbl, dt_weight, dt_bias, A_log, D, reverse)``:
  ``delta = softplus(dt_proj(x_dbl[..., :4]))``, the states
  ``h_t = exp(delta_t A) h_{t-1} + delta_t B_t u_t`` with
  ``A = -exp(A_log)`` and float32 state, ``y_t = C_t h_t + D u_t`` times
  ``silu(z_t)`` (z the second half of ``xz``): ``y`` (..., L, D).

On a CPU tensor each takes its plain version (``ssm_conv_plain``,
``ssm_scan_plain``): float32 arithmetic, one rounding to the input's
dtype; the scan steps through the sequence one token at a time and never
holds the (..., L, D, 16) tensor. On a CUDA tensor each launches its
kernel, or raises on what the kernel does not take: a dtype other than
float32 and bfloat16, parameters in another dtype or on another device, D
not a multiple of 8, a kernel size other than 4, a state size other than
16 or a dt rank other than 4, a non-contiguous or misaligned tensor, and an
input that needs a gradient (the kernels have none; SEMamba serves under
``torch.inference_mode``). The plain versions take any kernel size, state
size and dt rank, as the shapes of their arguments give them.

Launches of both entries are counted together on ``ssm_kernel``, by route:
``ssm_kernel.launches`` counts all, ``kernel_launches`` and
``plain_launches`` each (``ops.cuda.variant_launches``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audiodenoiser_torch.ops.cuda import build

_DTYPES = (torch.float32, torch.bfloat16)
D_STATE = 16
DT_RANK = 4
D_CONV = 4
PLAIN_STATES = 1 << 22  # at most this many states of ssm_scan_plain's factors held at once


class _Counters:
    """The launch counters of one kernel library with several entries,
    under the library's name."""

    variants = ("kernel", "plain")

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = self.kernel_launches = self.plain_launches = 0


ssm_kernel = _Counters("ssm_kernel")


def ssm_conv_plain(xz: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """The conv entry in at least float32, rounded once to ``xz``'s dtype:
    (..., L, 2D) -> (..., L, D), contiguous; any kernel size K (weight
    (D, 1, K))."""
    acc = torch.promote_types(xz.dtype, torch.float32)
    d, length, k = xz.shape[-1] // 2, xz.shape[-2], weight.shape[-1]
    x = xz[..., :d].reshape(-1, length, d).to(acc).transpose(1, 2)
    w = weight.reshape(d, 1, k).to(acc)
    if reverse:  # u[t] = b + sum_k w[k] x[t + K - 1 - k]: the flipped taps, anti-causal
        y = F.conv1d(x, w.flip(-1), bias.to(acc), padding=k - 1, groups=d)[..., k - 1:]
    else:
        y = F.conv1d(x, w, bias.to(acc), padding=k - 1, groups=d)[..., :length]
    return F.silu(y).transpose(1, 2).to(xz.dtype).contiguous().reshape(xz.shape[:-1] + (d,))


def ssm_scan_plain(u: torch.Tensor, xz: torch.Tensor, x_dbl: torch.Tensor,
                   dt_weight: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
                   D: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """The scan entry in at least float32, one token a step (from L - 1
    down with ``reverse``), rounded once to ``u``'s dtype: (..., L, D) ->
    (..., L, D), contiguous; any state size and dt rank (``A_log`` (D, S),
    ``dt_weight`` (D, R), ``x_dbl`` (..., L, R + 2S))."""
    acc = torch.promote_types(u.dtype, torch.float32)
    d, length = u.shape[-1], u.shape[-2]
    rank, states = dt_weight.shape[1], A_log.shape[1]
    uf = u.reshape(-1, length, d).to(acc)
    z = xz[..., d:].reshape(-1, length, d).to(acc)
    dt, b, c = x_dbl.reshape(-1, length, x_dbl.shape[-1]).to(acc).split(
        [rank, states, states], dim=-1)
    delta = F.softplus(F.linear(dt, dt_weight.to(acc), dt_bias.to(acc)))
    a = -torch.exp(A_log.to(acc))
    h = uf.new_zeros(uf.shape[0], d, states)
    y = torch.empty_like(uf)
    # the factors of a chunk of tokens at once, at most PLAIN_STATES states
    chunk = max(1, PLAIN_STATES // (uf.shape[0] * d * states))
    order = range(length - 1, -1, -1) if reverse else range(length)
    for first in range(0, length, chunk):
        ts = torch.tensor(order[first:first + chunk], device=u.device)
        decay = torch.exp(delta[:, ts, :, None] * a)
        push = (delta[:, ts] * uf[:, ts])[..., None] * b[:, ts, None, :]
        for i, t in enumerate(ts.tolist()):
            h = torch.addcmul(push[:, i], decay[:, i], h)
            y[:, t] = torch.bmm(h, c[:, t, :, None])[..., 0]
    y = (y + uf * D.to(acc)) * F.silu(z)
    return y.to(u.dtype).reshape(u.shape)


def _check_cuda(entry: str, tensors: dict, aligned: tuple) -> None:
    first = next(iter(tensors.values()))
    if first.dtype not in _DTYPES:
        raise TypeError(f"{entry} takes float32 or bfloat16, not {first.dtype}")
    for name, t in tensors.items():
        if t.dtype != first.dtype:
            raise TypeError(f"{entry} takes {name} in the input's dtype {first.dtype}, "
                            f"not {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{entry} takes {name} on the input's device")
        if not t.is_contiguous():
            raise ValueError(f"{entry} takes a contiguous {name}")
    for name in aligned:
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{entry} takes a 16-byte aligned {name}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise RuntimeError(f"{entry} has no gradient: call it under torch.no_grad() or "
                           "torch.inference_mode()")


def _rows(x: torch.Tensor) -> int:
    return x.numel() // (x.shape[-2] * x.shape[-1]) if x.numel() else 0


def _lib():
    lib = build.load("ssm_kernel")
    if lib.ssm_conv_launch.argtypes is None:
        lib.ssm_conv_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ssm_conv_launch.restype = ctypes.c_int
        lib.ssm_scan_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        lib.ssm_scan_launch.restype = ctypes.c_int
    return lib


def _launched(entry: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed with CUDA error {rc}")
    build.count_launch(ssm_kernel, "kernel")


def ssm_conv(xz: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """SiLU of the depthwise k = 4 conv of ``xz[..., :D]`` (causal, or
    anti-causal with ``reverse``), ``weight`` (D, 1, 4) and ``bias`` (D,):
    the kernel on the card, ``ssm_conv_plain`` on the CPU."""
    d = xz.shape[-1] // 2 if xz.dim() >= 2 else -1
    if (xz.dim() < 2 or xz.shape[-1] != 2 * d or weight.dim() != 3
            or weight.shape[:2] != (d, 1) or bias.shape != (d,)):
        raise ValueError(f"ssm_conv: input {tuple(xz.shape)} (..., L, 2D) against weight "
                         f"{tuple(weight.shape)} (D, 1, K) and bias {tuple(bias.shape)}")
    if xz.device.type == "cpu":
        build.count_launch(ssm_kernel, "plain")
        return ssm_conv_plain(xz, weight, bias, reverse)
    if xz.device.type != "cuda":
        raise ValueError(f"ssm_conv runs on cuda or cpu, not {xz.device}")
    _check_cuda("ssm_conv", {"input": xz, "weight": weight, "bias": bias}, ("input",))
    if d % 8 or weight.shape[-1] != D_CONV:
        raise ValueError(f"ssm_conv takes D a multiple of 8 and K = {D_CONV}, not D = {d} and "
                         f"K = {weight.shape[-1]}")
    u = xz.new_empty(xz.shape[:-1] + (d,))
    n = _rows(xz)
    if n == 0:
        return u
    with build.on_device(xz.device):
        rc = _lib().ssm_conv_launch(xz.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                    u.data_ptr(), int(xz.dtype == torch.bfloat16), n,
                                    xz.shape[-2], d, int(bool(reverse)),
                                    build.stream_handle(xz.device))
    _launched("ssm_conv", rc)
    return u


def ssm_scan(u: torch.Tensor, xz: torch.Tensor, x_dbl: torch.Tensor, dt_weight: torch.Tensor,
             dt_bias: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
             reverse: bool = False) -> torch.Tensor:
    """The selective scan of ``u`` (..., L, D) with ``x_dbl`` (..., L, 36)
    (dt, B, C), gated by ``silu(xz[..., D:])``: the kernel on the card,
    ``ssm_scan_plain`` on the CPU."""
    d = u.shape[-1] if u.dim() >= 2 else -1
    rank = dt_weight.shape[-1] if dt_weight.dim() == 2 else -1
    states = A_log.shape[-1] if A_log.dim() == 2 else -1
    if (u.dim() < 2 or xz.shape != u.shape[:-1] + (2 * d,)
            or x_dbl.shape != u.shape[:-1] + (rank + 2 * states,)
            or dt_weight.shape != (d, rank) or dt_bias.shape != (d,)
            or A_log.shape != (d, states) or D.shape != (d,)):
        raise ValueError(
            f"ssm_scan: u {tuple(u.shape)} (..., L, D), xz {tuple(xz.shape)} (..., L, 2D), "
            f"x_dbl {tuple(x_dbl.shape)} (..., L, R + 2S), dt_weight "
            f"{tuple(dt_weight.shape)} (D, R), dt_bias {tuple(dt_bias.shape)}, A_log "
            f"{tuple(A_log.shape)} (D, S), D {tuple(D.shape)}")
    args = (dt_weight, dt_bias, A_log, D)
    if u.device.type == "cpu":
        build.count_launch(ssm_kernel, "plain")
        return ssm_scan_plain(u, xz, x_dbl, *args, reverse)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {u.device}")
    _check_cuda("ssm_scan", dict(zip(("input", "xz", "x_dbl", "dt_weight", "dt_bias", "A_log",
                                      "D"), (u, xz, x_dbl, *args))), ("input", "xz", "x_dbl"))
    if d % 8 or rank != DT_RANK or states != D_STATE:
        raise ValueError(f"ssm_scan takes D a multiple of 8, R = {DT_RANK} and S = {D_STATE}, "
                         f"not D = {d}, R = {rank} and S = {states}")
    y = torch.empty_like(u)
    n = _rows(u)
    if n == 0:
        return y
    with build.on_device(u.device):
        rc = _lib().ssm_scan_launch(u.data_ptr(), xz.data_ptr(), x_dbl.data_ptr(),
                                    *(t.data_ptr() for t in args), y.data_ptr(),
                                    int(u.dtype == torch.bfloat16), n, u.shape[-2], d,
                                    int(bool(reverse)), build.stream_handle(u.device))
    _launched("ssm_scan", rc)
    return y
