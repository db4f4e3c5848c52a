"""Tracing and timing (port of ``utils/profiling.py``).

``maybe_trace(dir)`` records the enclosed scope with ``torch.profiler``
(host activity, and the card's kernels when a GPU is present) and writes
one Chrome trace file, ``trace_<pid>_<time>.json``, into ``dir``; without a
directory it does nothing. ``cli.train --profile_dir`` wraps ``fit`` in it.
``timed(fn)`` is the steady wall time of ``fn()``, the device synchronised
before each clock read.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


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
