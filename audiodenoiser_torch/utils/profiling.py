"""Tracing and timing (port of ``utils/profiling.py``).

``maybe_trace(dir)`` records the enclosed scope with ``torch.profiler``
(host activity, and the card's kernels when a GPU is present) and writes
one Chrome trace file, ``trace_<pid>_<time>.json``, into ``dir``; without a
directory it does nothing. ``cli.train --profile_dir`` wraps ``fit`` in it.
``timed(fn)`` is the steady wall time of ``fn()``, the device synchronised
before each clock read.

``span(name)`` marks one phase of the program's hot paths as a profiler
range, named by one of the constants below, while a profiler records; the
ranges sit on the profiler's timeline beside the card's kernels, nest on
the calling thread and are written out with the trace:

- ``MIXER``: the on-device mixer's draw and its arithmetic
  (``data.pipeline.OnDeviceMixer``);
- ``FORWARD``, ``LOSS``, ``BACKWARD``, ``OPTIMIZER``: a training step's
  forward (the input STFTs, the features, the model, the mask), its losses
  (K2, the waveform terms, SI-SDR, distillation), autograd's backward and
  the optimizer (``train.mask``, ``train.loop``), in an eager step only;
- ``STEP_GRAPH``: a complex-mask training step replayed from its CUDA
  graph (``train.step_graph``): the batch copied in, the rate loaded, the
  replay, which holds all four phases above in one launch, and the losses
  copied out. A replay runs no Python, so the four ranges mark the
  family's eager steps alone (the CPU, hooks, a teacher, accumulation, a
  mesh, remat, a first call) and the capture, which runs nothing;
- ``STFT``, ``MODEL``, ``ISTFT``: a runner call's K1 side (the STFT, the
  magnitude and phase or the features), the model and its K2 side (the
  phase or mask product, the iSTFT) (``eval.runner.DenoiserRunner``);
- ``MP_*``: MP-SENet's phases inside ``MODEL`` (``models.mpsenet``): the
  encoder, each time and frequency half of a TS-Conformer block with its
  attention nested inside, and the two decoders; they cover the model's
  whole forward;
- ``SM_*``: SEMamba's phases inside ``MODEL`` (``models.semamba``): each
  time and frequency half of a TF-Mamba block (the permute, both
  directions, the merge and the residual), with each Mamba mixer
  (``in_proj`` to ``out_proj``, both directions) nested inside; its encoder
  and decoders, MP-SENet's code, keep ``MP_ENCODER`` and ``MP_DECODERS``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MIXER = "adt.mixer"
FORWARD = "adt.forward"
LOSS = "adt.loss"
BACKWARD = "adt.backward"
OPTIMIZER = "adt.optimizer"
STEP_GRAPH = "adt.step_graph"
STFT = "adt.stft"
MODEL = "adt.model"
ISTFT = "adt.istft"
MP_ENCODER = "adt.mp.encoder"
MP_TIME = "adt.mp.time"
MP_TIME_ATTENTION = "adt.mp.time_attention"
MP_FREQ = "adt.mp.freq"
MP_FREQ_ATTENTION = "adt.mp.freq_attention"
MP_DECODERS = "adt.mp.decoders"
SM_TIME = "adt.sm.time"
SM_TIME_MIXER = "adt.sm.time_mixer"
SM_FREQ = "adt.sm.freq"
SM_FREQ_MIXER = "adt.sm.freq_mixer"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range ``name`` while a profiler records; else
    one shared null context, so that a span costs one flag read when no
    profiler is on."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Profile the enclosed scope into ``trace_dir`` if set, else no-op."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed(fn: Callable, warmup: int = 2, iters: int = 10) -> dict:
    """Steady-state seconds a call of ``fn()``, the device drained first
    and after the timed calls."""
    for _ in range(warmup):
        fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync()
    return {"mean_s": (time.perf_counter() - t0) / iters, "iters": iters}
