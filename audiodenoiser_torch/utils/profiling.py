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
  the optimizer (``train.mask``, ``train.loop``);
- ``STFT``, ``MODEL``, ``ISTFT``: a runner call's K1 side (the STFT, the
  magnitude and phase or the features), the model and its K2 side (the
  phase or mask product, the iSTFT) (``eval.runner.DenoiserRunner``).
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
STFT = "adt.stft"
MODEL = "adt.model"
ISTFT = "adt.istft"

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
