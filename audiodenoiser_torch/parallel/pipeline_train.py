"""Pipeline-parallel training with the 1F1B schedule (port of
``parallel/pipeline_train.py``).

JAX compiles a whole 1F1B step into one SPMD program over a
``('data', 'stage')`` mesh: ``lax.ppermute`` moves activations to stage
s+1 and cotangents to stage s-1 each tick, and every boundary's payload
is packed into one fixed-size buffer so that all ticks exchange one
shape. Here one process drives the S stages on a list of devices and
walks the same host-built table tick by tick (``schedule_1f1b``), so no
buffer packing is needed: a stage's output and skip tuple go to stage
s+1 as they are, and the cotangents come back the same way. CUDA's
asynchronous launches let stages on different cards overlap.

- A forward runs the stage in train mode without autograd and keeps its
  input (the input stash); BatchNorm folds the microbatch's statistics
  into its running ones then, in microbatch order.
- A backward recomputes the stage from its stashed input under autograd
  (BatchNorm on the batch's statistics, the running ones left alone) and
  pushes the cotangent of the activation and of the skips it consumed to
  stage s-1; skips that only pass through hand their cotangents on as they
  are. The last stage seeds its backward with the loss over ``n_micro``.
- Gradients accumulate in each stage's ``.grad``. After the last tick the
  data ranks (``data_group``: each runs its own pipeline on its block of
  the microbatches) average the gradients, the BatchNorm statistics and
  the loss; then comes the global-norm clip over every stage and AdamW
  (JAX's constant-rate optax ``adamw``: torch defaults, weight decay on
  every parameter), each stage on its own device.

The semantics are JAX's: a step with M microbatches is sequential
per-microbatch gradient accumulation with BatchNorm normalising each
microbatch by its own statistics, the loss the mean over microbatches.
Batches are (n_micro, micro_batch * data ranks, C, F, T): NCHW samples
where JAX's are (F, T, C).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.losses import combined_perceptual_loss
from audiodenoiser_torch.parallel.pipeline import (
    default_devices,
    make_stages,
    place_stages,
    recomputing,
)


def schedule_1f1b(n_stages: int, n_micro: int):
    """Host-side 1F1B scheduler, JAX's table.

    Returns ``(fwd, bwd)`` int32 tables of shape (ticks, n_stages): entry
    [t, s] is the microbatch whose forward (resp. backward) stage ``s``
    runs at tick ``t``, or -1. fwd(m, s) comes strictly after fwd(m, s-1);
    bwd(m, s) strictly after bwd(m, s+1), but the last stage may run bwd(m)
    in the tick of fwd(m); a stage runs at most one forward and one backward
    a tick, each in microbatch order, and holds at most ``n_stages - s``
    microbatches forwarded but not yet backwarded.
    """
    S, M = n_stages, n_micro
    next_f = [0] * S
    next_b = [0] * S
    tick_f: dict = {}
    tick_b: dict = {}
    rows_f, rows_b = [], []
    t = 0
    while any(b < M for b in next_b):
        row_f = [-1] * S
        row_b = [-1] * S
        for s in range(S):
            m = next_f[s]
            if m < M and (next_f[s] - next_b[s]) < (S - s):
                if s == 0 or tick_f.get((m, s - 1), t) < t:
                    row_f[s] = m
                    tick_f[(m, s)] = t
                    next_f[s] += 1
        for s in range(S):
            m = next_b[s]
            if m < M and m < next_f[s]:
                if s == S - 1:
                    ready = tick_f.get((m, s), t + 1) <= t
                else:
                    ready = tick_b.get((m, s + 1), t) < t
                if ready:
                    row_b[s] = m
                    tick_b[(m, s)] = t
                    next_b[s] += 1
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
        if t > 4 * (S + M) + 16:
            raise RuntimeError("1F1B schedule did not converge")
    return np.asarray(rows_f, np.int32), np.asarray(rows_b, np.int32)


def schedule_forward(n_stages: int, n_micro: int) -> np.ndarray:
    """Forward-only wavefront: fwd(m, s) at tick m + s."""
    T = n_stages + n_micro - 1
    tbl = -np.ones((T, n_stages), np.int32)
    for m in range(n_micro):
        for s in range(n_stages):
            tbl[m + s, s] = m
    return tbl


@dataclass
class PipeTrainState:
    """The stages (stage s on its device, parameters and running
    statistics), one AdamW a stage and the count of steps taken."""

    step: int
    stages: list
    optimizers: list
    grad_norm: Optional[torch.Tensor] = None  # of the last step, before the clip


def _mean_over(tensors: list, group, size: int) -> None:
    """Average ``tensors`` (one device) over ``group`` in place, one bucket."""
    if not tensors:
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    torch._foreach_copy_(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))


class PipelineTrainer:
    """1F1B pipeline-parallel trainer for the U-Net block sequence.

    Args:
      devices: one device a stage (default: every visible card); a device
        may repeat (all stages on ``cuda:0``, or on the CPU).
      micro_batch: rows a microbatch on each data rank.
      n_micro: microbatches a step. The batch is ``micro_batch * n_micro *
        data ranks``.
      input_shape: (C, F, T) of one sample.
      loss_fn: (out, clean) -> scalar; default the combined perceptual loss
        (the mean over the microbatch), as ``train.loop``'s.
      features/bottleneck/out_channels/dtype/in_channels: the U-Net.
      learning_rate/weight_decay/clip_norm/b1/b2/eps: global-norm clip and
        AdamW at a constant rate.
      data_group: the process group of the data ranks (None: one data rank).
    """

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None, micro_batch: int = 2,
                 n_micro: int = 4, input_shape: tuple = (1, 256, 64),
                 loss_fn: Optional[Callable] = None,
                 features: Sequence[int] = (64, 128, 256, 512), bottleneck: int = 1024,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 learning_rate: float = 1e-4, weight_decay: float = 0.01,
                 clip_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, data_group=None, in_channels: int = 1):
        if devices is None:
            devices = default_devices()
        self.devices = [resolve_device(d) for d in devices]
        self.n_stages = len(self.devices)
        self.data_group = data_group
        self.data_parallel = 1 if data_group is None else dist.get_world_size(data_group)
        self.data_rank = 0 if data_group is None else dist.get_rank(data_group)
        self.micro_batch = micro_batch
        self.n_micro = n_micro
        self.input_shape = tuple(input_shape)
        self.loss_fn = loss_fn or (lambda out, clean: combined_perceptual_loss(out, clean).total)
        self.hp = dict(lr=learning_rate, wd=weight_decay, clip=clip_norm, b1=b1, b2=b2, eps=eps)
        self.arch = dict(features=tuple(features), bottleneck=bottleneck,
                         out_channels=out_channels, dtype=dtype, in_channels=in_channels)
        self.stages = make_stages(self.n_stages, **self.arch)  # the layout; states hold their own
        self.fwd_table, self.bwd_table = schedule_1f1b(self.n_stages, n_micro)

    # -- state packing ---------------------------------------------------

    def pack_state(self, state_dict: Mapping[str, torch.Tensor],
                   moments: Optional[Mapping[str, dict]] = None, step: int = 0) -> PipeTrainState:
        """A full U-Net state dict (and, to resume, the AdamW moments by
        parameter name from ``optimizer_state``) -> the stage-split state."""
        stages = make_stages(self.n_stages, **self.arch)
        place_stages(state_dict, stages, self.devices)
        optimizers = []
        for stage in stages:
            opt = torch.optim.AdamW(stage.parameters(), lr=self.hp["lr"],
                                    betas=(self.hp["b1"], self.hp["b2"]), eps=self.hp["eps"],
                                    weight_decay=self.hp["wd"])
            if moments:
                for name, p in stage.named_parameters():
                    # the step count stays on the CPU, as AdamW keeps it
                    opt.state[p] = {k: v.detach().to("cpu" if k == "step" else p.device,
                                                     torch.float32).clone()
                                    for k, v in moments[name].items()}
            optimizers.append(opt)
        return PipeTrainState(step=int(step), stages=stages, optimizers=optimizers)

    def init(self, state_dict: Mapping[str, torch.Tensor]) -> PipeTrainState:
        return self.pack_state(state_dict)

    def unpack_state(self, state: PipeTrainState) -> dict:
        """The stage-split state -> one ordinary ``UNet`` state dict (CPU
        tensors), which the loaders and ``flax_from_state_dict`` take."""
        out = {}
        for stage in state.stages:
            out.update({k: v.detach().cpu().clone() for k, v in stage.state_dict().items()})
        return out

    def optimizer_state(self, state: PipeTrainState) -> dict:
        """AdamW's moments and step count by ``UNet`` parameter name (CPU
        tensors): a resume state that any stage count takes."""
        out = {}
        for stage, opt in zip(state.stages, state.optimizers):
            for name, p in stage.named_parameters():
                if p in opt.state:
                    out[name] = {k: v.detach().cpu().clone() for k, v in opt.state[p].items()}
        return out

    # -- the step -----------------------------------------------------------

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """This data rank's block of every microbatch's rows."""
        x = torch.as_tensor(x)
        want = (self.n_micro, self.micro_batch * self.data_parallel, *self.input_shape)
        if tuple(x.shape) != want:
            raise ValueError(f"expected a batch of shape {want}, got {tuple(x.shape)}")
        lo = self.data_rank * self.micro_batch
        return x[:, lo:lo + self.micro_batch]

    def step(self, state: PipeTrainState, noisy, clean):
        """One 1F1B step, in place; returns ``(state, loss)``, the loss the
        mean over the microbatches and data ranks (a device scalar)."""
        S, M = self.n_stages, self.n_micro
        noisy, clean = self._local(noisy), self._local(clean)
        stages, devs = state.stages, self.devices
        for stage, opt in zip(stages, state.optimizers):
            stage.train()
            opt.zero_grad(set_to_none=True)
        inbox: dict = {}  # (m, s) -> stage s's input (activation, skips)
        stash: dict = {}  # (m, s) -> the input a forward kept for its backward
        cotangents: dict = {}  # (m, s) -> cotangents of stage s's output
        loss = torch.zeros((), device=devs[-1])
        for t in range(self.fwd_table.shape[0]):
            for s in range(S):
                m = int(self.fwd_table[t, s])
                if m < 0:
                    continue
                if s == 0:
                    x, skips = noisy[m].to(devs[0], torch.float32, non_blocking=True), ()
                else:
                    x, skips = inbox.pop((m, s))
                stash[(m, s)] = (x, skips)
                with torch.no_grad():
                    y, skips_out = stages[s](x, skips)
                if s < S - 1:
                    inbox[(m, s + 1)] = (y.to(devs[s + 1], non_blocking=True),
                                         tuple(k.to(devs[s + 1], non_blocking=True)
                                               for k in skips_out))
            for s in range(S - 1, -1, -1):
                m = int(self.bwd_table[t, s])
                if m < 0:
                    continue
                x, skips = stash.pop((m, s))
                passed = stages[s].n_passed(len(skips))
                x = x.detach().requires_grad_(s > 0)
                consumed = [k.detach().requires_grad_(True) for k in skips[passed:]]
                with recomputing(stages[s]):
                    y, skips_out = stages[s](x, (*skips[:passed], *consumed))
                if s == S - 1:
                    target = clean[m].to(devs[s], torch.float32, non_blocking=True)
                    term = self.loss_fn(y.float(), target) / M
                    term.backward()
                    loss = loss + term.detach()
                    ct_passed = ()
                else:
                    ct_y, ct_skips = cotangents.pop((m, s))
                    torch.autograd.backward([y, *skips_out[passed:]], [ct_y, *ct_skips[passed:]])
                    ct_passed = ct_skips[:passed]
                if s > 0:
                    prev = devs[s - 1]
                    cotangents[(m, s - 1)] = (
                        x.grad.to(prev, non_blocking=True),
                        tuple(c.to(prev, non_blocking=True)
                              for c in (*ct_passed, *(k.grad for k in consumed))))
        if self.data_group is not None:
            for stage in stages:
                grads = [p.grad for p in stage.parameters() if p.grad is not None]
                stats = [b for n, b in stage.named_buffers() if "running" in n]
                _mean_over(grads + stats, self.data_group, self.data_parallel)
            dist.all_reduce(loss, group=self.data_group)
            loss = loss / self.data_parallel
        self._clip_and_update(state)
        state.step += 1
        return state, loss

    @torch.no_grad()
    def _clip_and_update(self, state: PipeTrainState) -> None:
        """optax's ``clip_by_global_norm`` over every stage, then AdamW."""
        grads = [[p.grad for p in stage.parameters() if p.grad is not None]
                 for stage in state.stages]
        home = self.devices[0]
        sq = torch.stack([torch.stack(torch._foreach_norm(g)).square().sum().to(home)
                          for g in grads if g])
        norm = torch.sqrt(sq.sum())
        scale = torch.where(norm < self.hp["clip"], torch.ones_like(norm), self.hp["clip"] / norm)
        for g, opt, dev in zip(grads, state.optimizers, self.devices):
            if g:
                torch._foreach_mul_(g, scale.to(dev))
            opt.step()
        state.grad_norm = norm

    # -- the pipelined forward (inference) ---------------------------------

    @torch.inference_mode()
    def forward(self, state: PipeTrainState, xs) -> torch.Tensor:
        """Pipelined inference, eval-mode BatchNorm, on the forward
        wavefront (``schedule_forward``): (n_micro, micro_batch * data
        ranks, C, F, T) -> the same shape with the output channels, every
        data rank's rows gathered (on the last stage's device)."""
        xs = self._local(xs)
        S = self.n_stages
        for stage in state.stages:
            stage.eval()
        inbox: dict = {}
        outs: dict = {}
        table = schedule_forward(S, self.n_micro)
        for t in range(table.shape[0]):
            for s in range(S):
                m = int(table[t, s])
                if m < 0:
                    continue
                if s == 0:
                    x, skips = xs[m].to(self.devices[0], torch.float32), ()
                else:
                    x, skips = inbox.pop((m, s))
                y, skips = state.stages[s](x, skips)
                if s < S - 1:
                    nxt = self.devices[s + 1]
                    inbox[(m, s + 1)] = (y.to(nxt), tuple(k.to(nxt) for k in skips))
                else:
                    outs[m] = y.float()
        out = torch.stack([outs[m] for m in range(self.n_micro)])
        if self.data_group is None:
            return out
        parts = [torch.empty_like(out) for _ in range(self.data_parallel)]
        dist.all_gather(parts, out.contiguous(), group=self.data_group)
        return torch.cat(parts, dim=1)
