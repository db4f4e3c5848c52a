"""The device's idle time, device time and launches put down to the
program's own spans, from the traced sub-window's profiler events.

  python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs one cell as ``benchmark/run.py --trace 1`` does, with ``reduce`` over
the events of ``devtrace.profile``'s own profiler, and prints the cell's
result line. The benchmark's own runs do not call it: ``devtrace.profile``
keeps no events.

The program marks its phases with profiler ranges named ``adt.<phase>``
(``audiodenoiser_torch.utils.profiling.span``). ``reduce`` keeps under
``record['device_trace']['program']``:

- ``idle_s``: every idle interval of the device inside the sub-window,
  split over the innermost ``adt.*`` span open on the caller's thread (the
  thread that opened ``bench.subwindow``, and ``bench.step`` or
  ``bench.batch`` inside it) at each instant, the rest to ``outside``: the
  parts add up to the idle time that ``device_idle.*`` reads;
- ``device_s`` and ``launches``: every device operation (kernel, copy,
  set) put down to the innermost span open on the caller's thread at the
  moment it was launched, whichever thread launched it (autograd's
  backward launches from its own thread while the caller blocks inside
  ``adt.backward``). An operation is linked to its launch, a CUDA runtime
  or driver call on the host (``cudaLaunchKernel``, or ``cuLaunchKernel``
  for K1 and K2's ctypes launches), by the profiler's correlation id; one
  without that link falls back to the device-side copy that the profiler
  makes of each ``record_function`` range (``gpu_user_annotation``), which
  covers launches from the range's own thread only; the rest goes to
  ``outside``;
- ``route``: how many operations each way put down (``correlation``,
  ``annotation``, ``unlinked``), and ``phases``, the program's spans seen
  on the caller's thread (none in a program without spans).

It prints both sums beside what they must equal, and the launches by
phase, on standard error.
"""

from __future__ import annotations

import bisect
import re
import sys
from typing import Optional

PREFIX = "adt."
OUTSIDE = "outside"
WINDOW = "bench.subwindow"
# the host's side of a launch: CUDA runtime and driver calls (cudaLaunchKernel,
# cudaMemcpyAsync, cuLaunchKernel), not aten's ops nor cuDNN's
LAUNCH = re.compile(r"^cu(da)?[A-Z]")


def _pieces(spans: list) -> list:
    """The caller's timeline cut where its innermost span changes: sorted,
    disjoint ``[start, end, phase]`` pieces. Spans nest on one thread, so
    the innermost open span is the one that started last."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        inner = [sp for sp in spans if sp[0] <= mid < sp[1]]
        if not inner:
            continue
        phase = max(inner, key=lambda sp: (sp[0], -sp[1]))[2]
        if pieces and pieces[-1][2] == phase and pieces[-1][1] == a:
            pieces[-1][1] = b
        else:
            pieces.append([a, b, phase])
    return pieces


def attribute(events) -> Optional[dict]:
    """The reduction above, in seconds and counts over the whole
    sub-window; None without a ``bench.subwindow`` range. ``events`` are
    the profiler's (``prof.events()``: ``name``, ``thread``, ``id`` (the
    correlation id), ``device_type``, ``time_range`` in microseconds,
    ``is_user_annotation``)."""
    from torch.autograd import DeviceType

    from benchmark.devtrace import _merge

    host, ops, mirrors = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                if e.name.startswith(PREFIX):
                    mirrors.append(e)
            else:
                ops.append(e)
        else:
            host.append(e)
    window = next((e for e in host if e.name == WINDOW), None)
    if window is None:
        return None
    w0, w1 = window.time_range.start, window.time_range.end
    spans = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):]) for e in host
             if e.thread == window.thread and e.name.startswith(PREFIX)]
    pieces = _pieces(spans)
    starts = [p[0] for p in pieces]

    def phase_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][2] if i >= 0 and t < pieces[i][1] else OUTSIDE

    phases = sorted({sp[2] for sp in spans})
    idle = dict.fromkeys(phases + [OUTSIDE], 0.0)
    busy = _merge((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in ops
                  if e.time_range.end > w0 and e.time_range.start < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):  # the device's idle gaps
        left = g1 - g0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(pieces) and pieces[i][0] < g1:
            a, b, phase = pieces[i]
            part = min(b, g1) - max(a, g0)
            if part > 0:
                idle[phase] += part
                left -= part
            i += 1
        idle[OUTSIDE] += max(left, 0.0)

    launched = {e.id: e.time_range.start for e in host if LAUNCH.match(e.name)}
    device = dict.fromkeys(phases + [OUTSIDE], 0.0)
    launches = dict.fromkeys(phases + [OUTSIDE], 0)
    route = {"correlation": 0, "annotation": 0, "unlinked": 0}
    for op in ops:
        t = launched.get(op.id) if op.id else None
        if t is not None:
            phase, way = phase_at(t), "correlation"
        else:
            start = op.time_range.start
            cover = [m for m in mirrors if m.time_range.start <= start < m.time_range.end]
            if cover:
                inner = min(cover, key=lambda m: m.time_range.end - m.time_range.start)
                phase, way = inner.name[len(PREFIX):], "annotation"
            else:
                phase, way = OUTSIDE, "unlinked"
        device[phase] = device.get(phase, 0.0) + (op.time_range.end - op.time_range.start)
        launches[phase] = launches.get(phase, 0) + 1
        route[way] += 1
    return {"phases": phases,
            "idle_s": {k: v * 1e-6 for k, v in idle.items()},
            "device_s": {k: v * 1e-6 for k, v in device.items()},
            "launches": launches, "route": route}


def reduce(events, out: dict, cell) -> None:
    """``attribute`` over the events of the profiler that ``devtrace.profile``
    reduced to ``out``, kept as ``out['program']``, with its identities
    printed on standard error."""
    program = attribute(events)
    if program is None:
        return
    out["program"] = program
    window, iters = out["window_s"], out["iters"]
    idle = {k: 100.0 * v / window for k, v in program["idle_s"].items()}
    device_idle = 100.0 * max(0.0, 1.0 - out["busy_s"] / window)
    device = {k: 1e3 * v / iters for k, v in program["device_s"].items()}
    busy = 1e3 * out["busy_s"] / iters

    def line(parts):
        return " ".join(f"{k} {v:.4f}" for k, v in parts.items())

    cell.log(f"spans idle % of the window: {line(idle)}; sum {sum(idle.values()):.4f} "
             f"against device idle {device_idle:.4f} "
             f"({abs(sum(idle.values()) - device_idle):.4f} points apart)")
    cell.log(f"spans device ms a traced call: {line(device)}; sum {sum(device.values()):.4f} "
             f"against busy {busy:.4f} "
             f"({100.0 * abs(sum(device.values()) - busy) / max(busy, 1e-12):.3f}% apart)")
    cell.log(f"spans launches a traced call: "
             f"{line({k: n / iters for k, n in program['launches'].items()})}; "
             f"put down by {program['route']}")


def with_spans(profile):
    """``profile`` (``devtrace.profile``), then ``reduce`` over the events
    of the profiler it ran, kept by a subclass of ``torch.profiler.profile``
    while it runs. What ``profile`` computes is left as it is."""

    def run(step, iters: int, cell) -> dict:
        import torch.profiler

        base, kept = torch.profiler.profile, []

        class Kept(base):
            def __enter__(self):
                kept.append(self)
                return super().__enter__()

        torch.profiler.profile = Kept
        try:
            out = profile(step, iters, cell)
        finally:
            torch.profiler.profile = base
        reduce(kept[-1].events(), out, cell)
        return out

    return run


def main(argv=None) -> int:
    """``harness.main`` with ``--trace 1`` and ``devtrace.profile`` wrapped
    by ``with_spans``; the caches are pinned before torch is imported."""
    from benchmark import harness

    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    harness.pin_caches()
    from benchmark import devtrace

    base = devtrace.profile
    devtrace.profile = with_spans(base)
    try:
        return harness.main(argv)
    finally:
        devtrace.profile = base


if __name__ == "__main__":
    sys.exit(main())
