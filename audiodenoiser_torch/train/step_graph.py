"""One CUDA graph for a whole training step of the complex-mask family.

``GraphedStep`` wraps an eager step ``(state, noisy, clean) -> (state,
losses)``: ``train.mask.make_mask_steps``' train step, which launches both
STFTs in one K1 launch, the features, the model in train mode, the mask,
the losses, K2, the waveform L1 and SI-SDR, the backward (K2's gradient a
K1 launch), the global-norm clip and AdamW. That is about a thousand
launches a step, and at small batches issuing them from Python, not the
device, sets the step's pace. A replay issues them as one. The kernels
are the eager step's own; the mixer stays outside, the caller's.

A call runs eagerly, counted by the first reason that applies, in this
order:

- ``cpu``: the model or the batch is not on a CUDA device; there is no
  graph to capture.
- ``teacher``: distillation. Its feature taps are forward hooks that live
  for one call, and the teacher's step is not proven equal under capture.
- ``layout``: a mesh (``parallel.mesh``): collectives over the process
  group and sharded tensors.
- ``grad_accum``: accumulation over micro-steps. The optimizer updates on
  one call in k, which Python decides.
- ``hook``: the model, a submodule or a parameter carries a hook, or a
  global module hook is set. A replay runs no Python, so no hook would
  fire. The model's modules and parameters are listed once per model, so
  a model's tree is taken as fixed after its first step.
- ``remat``: a model that recomputes its blocks in the backward
  (``UNet(remat=True)``), not proven equal under capture.
- ``warmup``: the first eligible call for a key (below). It first makes
  the optimizer capturable (``ClippedAdamW.make_capturable``), then runs on
  the capture stream, as PyTorch asks of the work before a capture: it
  creates AdamW's moments, lets cuDNN choose its plans and fills the
  constant caches (windows, the mel bank, the identity mask), so that no
  first-call work is captured.

A key is the step, the model, the batch's shapes, dtypes and device, and
the backend switches that choose kernels (cuDNN's enabled, benchmark,
deterministic and TF32 flags, the matmul precision, deterministic
algorithms). The second eligible call for a key captures: it copies the
batch into static buffers, records the eager step once into a graph with
its own memory pool, and replays it at once. Every later eligible call
with that key copies its batch into the buffers, loads the schedule's rate
into AdamW's rate tensor and replays. Both copy the losses and the gradient
norm out, in one launch, into a tensor of the caller's, so that no later
replay overwrites what the caller holds.

A replay does what the eager step does besides its kernels: the model is
left in train mode, ``state.step`` and the optimizer's update count
advance once, ``state.grad_norm`` is set, the parameters' ``.grad`` are
the graph's gradients, and the kernels' launch counters (``ops.cuda``)
advance by the launches the graph holds. BatchNorm's running statistics and
``num_batches_tracked`` move inside the graph. A capturable AdamW computes
its bias corrections on the device, so its steps round apart from a
non-capturable one's by an ulp or so of each update; eager steps after a
capture share that form.

The graphs live on the optimizer (``ClippedAdamW.graphs``), since they
write its moments in place; ``ClippedAdamW.load_state_dict`` drops them.

``counts`` keeps, in the way of the kernels' counters
(``ops.cuda.variant_launches(step_graph.counts)``), the calls captured
(``capture``), replayed (``replay``) and run eagerly by reason
(``eager_cpu``, ``eager_hook``, ...); ``counts.launches`` is their sum.
"""

from __future__ import annotations

import weakref
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn.modules import module as nn_module

from audiodenoiser_torch.ops import cuda as kernels
from audiodenoiser_torch.ops.cuda import build
from audiodenoiser_torch.utils.profiling import STEP_GRAPH, span

EAGER_REASONS = ("cpu", "teacher", "layout", "grad_accum", "hook", "remat", "warmup")


class _Counts:
    """Calls of every ``GraphedStep``, by what each did."""

    variants = ("capture", "replay") + tuple(f"eager_{r}" for r in EAGER_REASONS)

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches = 0
        for v in self.variants:
            setattr(self, f"{v}_launches", 0)

    def count(self, variant: str) -> None:
        self.launches += 1
        setattr(self, f"{variant}_launches", getattr(self, f"{variant}_launches") + 1)


counts = _Counts()
_capture_streams: dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream on which this module warms up and captures, one a device."""
    stream = _capture_streams.get(device.index)
    if stream is None:
        stream = _capture_streams[device.index] = torch.cuda.Stream(device)
    return stream


_trees: "weakref.WeakKeyDictionary[nn.Module, tuple]" = weakref.WeakKeyDictionary()


def _tree(model: nn.Module) -> tuple:
    """``model``'s modules and parameters as lists, and whether any module
    recomputes its blocks in the backward, read once per model: a replay's
    host time is what the step graph exists to shorten, and a model's tree
    is taken as fixed after its first step, as a captured graph takes it."""
    tree = _trees.get(model)
    if tree is None:
        modules = list(model.modules())
        tree = _trees[model] = (modules, list(model.parameters()),
                                any(getattr(m, "remat", False) for m in modules))
    return tree


def _hooked(model: nn.Module) -> bool:
    """Whether a forward or backward hook would fire in ``model``'s step."""
    if (nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks
            or nn_module._global_backward_hooks or nn_module._global_backward_pre_hooks):
        return True
    modules, params, _ = _tree(model)
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for m in modules) \
        or any(p._backward_hooks or p._post_accumulate_grad_hooks for p in params)


def _launch_counts() -> dict:
    return {k: kernels.variant_launches(k) for k in kernels.KERNELS}


class _Captured:
    """One captured step: its graph (with its own memory pool), the static
    batch it reads, the tensors it writes that the caller reads (the
    losses, the gradient norm, the gradients) and the kernel launches it
    holds. Capturing runs the step's Python once and its kernels not at
    all: the caller replays."""

    def __init__(self, step: Callable, state, noisy: torch.Tensor, clean: torch.Tensor):
        self.noisy, self.clean = noisy.clone(), clean.clone()
        before = _launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=_capture_stream(noisy.device)):
            _, losses = step(state, self.noisy, self.clean)
        self.losses = losses
        self.norm = state.grad_norm
        self.grads = [p.grad for p in state.optimizer.params]
        self.held = [(k, v, n - before[k][v]) for k, after in _launch_counts().items()
                     for v, n in after.items() if n != before[k][v]]

    def outputs(self) -> tuple:
        """The losses and the gradient norm of the last replay, copied out
        of the graph's buffers in one launch."""
        owned = torch.stack([*self.losses, self.norm]).unbind()
        return self.losses._make(owned[:-1]), owned[-1]


class GraphedStep:
    """``step`` (an eager train step) replayed from a CUDA graph where the
    call allows it, as the module's docstring says; ``teacher`` marks a
    distilling step, which always runs eagerly."""

    def __init__(self, step: Callable, teacher: Optional[nn.Module] = None):
        self.step = step
        self.teacher = teacher

    def eager_reason(self, state, noisy: torch.Tensor, clean: torch.Tensor) -> Optional[str]:
        """Why this call runs eagerly (one of ``EAGER_REASONS`` but
        ``warmup``), or None."""
        if not (state.device.type == noisy.device.type == clean.device.type == "cuda"):
            return "cpu"
        if self.teacher is not None:
            return "teacher"
        if state.layout is not None or state.optimizer.layout is not None:
            return "layout"
        if state.optimizer.grad_accum > 1:
            return "grad_accum"
        if _hooked(state.model):
            return "hook"
        if _tree(state.model)[2]:
            return "remat"
        return None

    def _key(self, state, noisy: torch.Tensor, clean: torch.Tensor) -> tuple:
        cudnn = torch.backends.cudnn
        return (self, state.model, noisy.shape, noisy.dtype, clean.shape, clean.dtype,
                noisy.device, cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
                cudnn.allow_tf32, torch.get_float32_matmul_precision(),
                torch.are_deterministic_algorithms_enabled())

    def __call__(self, state, noisy: torch.Tensor, clean: torch.Tensor):
        """One update in place; returns ``(state, losses)``."""
        reason = self.eager_reason(state, noisy, clean)
        if reason is not None:
            counts.count(f"eager_{reason}")
            return self.step(state, noisy, clean)
        opt = state.optimizer
        key = self._key(state, noisy, clean)
        if key not in opt.graphs:
            counts.count("eager_warmup")
            opt.make_capturable()
            main, side = torch.cuda.current_stream(noisy.device), _capture_stream(noisy.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.step(state, noisy, clean)
            # what the step made on the side stream is used on main next; the
            # side stream takes new work only after waiting for main again
            main.wait_stream(side)
            opt.graphs[key] = None
            return out
        entry = opt.graphs[key]
        with span(STEP_GRAPH):
            if entry is None:
                counts.count("capture")
                opt.load_rate()
                # the capture runs the step's Python: its counters advance there
                entry = opt.graphs[key] = _Captured(self.step, state, noisy, clean)
            else:
                counts.count("replay")
                state.model.train()  # the mode the eager step leaves
                entry.noisy.copy_(noisy)
                entry.clean.copy_(clean)
                opt.load_rate()
                state.step += 1
                opt.updates += 1
                for kernel, variant, n in entry.held:
                    build.count_launch(kernel, variant, n)
            entry.graph.replay()
            losses, state.grad_norm = entry.outputs()
        if opt.params[0].grad is not entry.grads[0]:
            for p, g in zip(opt.params, entry.grads):  # an eager step came between
                p.grad = g
        return state, losses
