"""The collectives inside a meshed U-Net: channel tensor parallelism and
BatchNorm over the global batch.

XLA's SPMD partitioner gives the JAX package both for free once the
kernels and the batch are sharded; here they are written out.

- **Column-parallel layers.** A model rank holds the output-channel slice
  of a wide conv or deconv (with its bias and BatchNorm slice) and computes
  that slice from the whole input; BatchNorm and ReLU are per channel and
  run on the slice; ``gather_channels`` then concatenates the slices along
  channels before the next layer. Its backward hands each rank its own
  slice of the cotangent, and ``copy_to_model`` (the identity forward)
  all-reduces the input's partial cotangents over the model group.
- **BatchNorm over the global batch** (``synced_batch_norm``). Under JAX's
  batch sharding a mean over axis 0 is a mean over the whole global batch.
  Each data rank takes its rows' per-channel mean and biased variance
  (Welford's form, ``torch.var_mean``), all-gathers them with the row
  counts, and combines them with Chan's pairwise form, ``mean = sum(w_r
  m_r)`` and ``var = sum(w_r (v_r + (m_r - mean)^2))`` with ``w_r =
  n_r / N``: with one rank that is the local statistics bit for bit. The
  backward all-reduces the two per-channel sums of the standard BatchNorm
  gradient, so every rank's input gradient is that of the sum of all
  ranks' losses; the weight and bias gradients stay local, and the data
  group's gradient average turns them into the global batch's.

Gloo (the CPU) and NCCL (the card) carry all three; every rank of a group
calls them in the same order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


class TensorParallel(NamedTuple):
    """The model group a column-parallel layer gathers over, and this
    rank's place in it."""

    group: object
    size: int
    rank: int


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` in a layout a collective takes: channels_last stays channels_last."""
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t
    return t.contiguous()


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = _dense(grad).clone()
        dist.all_reduce(grad, group=ctx.tp.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[1]
        x = _dense(x)
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x, group=tp.group)
        out = torch.cat(parts, dim=1)
        if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.tp.rank * ctx.width
        return grad[:, lo:lo + ctx.width], None


def copy_to_model(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The input of a column-parallel layer: the identity, whose backward
    all-reduces the cotangent over the model group (None: no group)."""
    return x if tp is None else _CopyToModel.apply(x, tp)


def gather_channels(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """Concatenate the model ranks' channel slices in rank order (None: no
    group); the backward keeps this rank's slice of the cotangent."""
    return x if tp is None else _GatherChannels.apply(x, tp)


def _global_stats(x: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor, float]:
    """The per-channel mean and biased variance of the data group's rows of
    (N, C, H, W) ``x``, and their count (Chan's pairwise combination)."""
    var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
    count = x.numel() // x.shape[1]
    stats = torch.stack([mean, var, torch.full_like(mean, float(count))])
    parts = [torch.empty_like(stats) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, stats, group=group)
    stats = torch.stack(parts)  # (ranks, 3, C)
    total = stats[:, 2].sum(0)
    w = stats[:, 2] / total
    g_mean = (w * stats[:, 0]).sum(0)
    g_var = (w * (stats[:, 1] + (stats[:, 0] - g_mean).square())).sum(0)
    return g_mean, g_var, float(total[0])


class _SyncedBatchNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        mean, var, count = _global_stats(x, group)
        invstd = torch.rsqrt(var + eps)
        y = torch.batch_norm(x, weight, bias, mean, var, False, 0.0, eps,
                             torch.backends.cudnn.enabled)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count, ctx.group = count, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, grad, _mean_grad, _var_grad):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        sum_dy = grad.sum((0, 2, 3))
        sum_dy_xhat = (grad * xhat).sum((0, 2, 3))
        sums = torch.stack([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        dx = (weight * invstd).view(shape) * (
            grad - (sums[0] / ctx.count).view(shape) - xhat * (sums[1] / ctx.count).view(shape))
        return dx, sum_dy_xhat, sum_dy, None, None


def synced_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      eps: float, group) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of float32 (N, C, H, W) ``x`` with the data
    group's statistics; returns ``(y, mean, biased var)``, the statistics
    identical on every rank of the group."""
    return _SyncedBatchNorm.apply(x, weight, bias, eps, group)
