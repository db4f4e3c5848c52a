"""Device time from the profiler over a short steady sub-window, and CUDA
event timing of one entry.

``profile`` runs a step function under ``torch.profiler`` and reduces the
trace to: the seconds in which some operation ran on the device (the
union of kernel, copy and set intervals), the sub-window's wall seconds,
device time by operation name, and the longest idle gaps on the device,
each named by the benchmark's span (``bench.<name>``) that was open on the
host when the gap began.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

TOP = 10


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def profile(step, iters: int, cell) -> dict:
    """Run ``step`` ``iters`` times under the profiler; the reduction is
    kept as ``cell.record['device_trace']`` and returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cell.sync()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.subwindow"):
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            cell.sync()
            wall = time.perf_counter() - t0
    device_iv, by_name, spans, window = [], {}, [], None
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            device_iv.append((start, end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (end - start) * 1e-6
        elif e.name.startswith("bench."):
            if e.name == "bench.subwindow":
                window = (start, end)
            else:
                spans.append((start, end, e.name[len("bench."):]))
    merged = _merge(device_iv)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = []
    if window is not None and merged:
        edges = [window[0]] + [x for iv in merged for x in iv] + [window[1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                open_spans = [sp for sp in spans if sp[0] <= s < sp[1]]
                # the innermost span open when the gap began
                label = min(open_spans, key=lambda sp: sp[1] - sp[0])[2] if open_spans \
                    else "outside spans"
                gaps.append([label, (e - s) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    out = {"busy_s": busy, "window_s": wall, "iters": iters, "by_name": by_name,
           "device_ops": sorted(([k[:120], v] for k, v in by_name.items()),
                                key=lambda kv: -kv[1])[:TOP],
           "idle_gaps": gaps[:TOP]}
    cell.record["device_trace"] = out
    return out


def kernel_roofline(record: dict, key: str, kernel) -> Optional[float]:
    """The kernels' share of their byte bound, in %: the bytes that one
    step of the traced sub-window must move through them
    (``record['kernel_bytes'][key]``) at the card's HBM bandwidth, over
    the device time, a step, of every kernel whose name ``kernel`` (a
    compiled pattern) finds. None where either is missing."""
    from benchmark.counts import bound_seconds

    t, n_bytes = record.get("device_trace"), record.get("kernel_bytes", {}).get(key)
    if not t or not n_bytes:
        return None
    seconds = sum(v for name, v in t["by_name"].items() if kernel.search(name))
    if seconds <= 0:
        return None
    return 100.0 * bound_seconds(n_bytes) * t["iters"] / seconds


def event_seconds(fn, iters: int, device) -> float:
    """Mean seconds a call of ``fn`` by CUDA events over ``iters`` calls,
    after one call to warm it."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e-3 / iters


class Fence:
    """Marks the work queued so far; ``wait`` blocks until it is done (a
    CUDA event on the card, nothing on the CPU)."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
