"""``benchmark.spans`` on synthetic profiler events: the two identities
against ``devtrace.profile``'s own sums, an idle gap split between two
spans, a kernel launched from another thread put down to the caller's
span, a kernel with no span to ``outside``, the fallback to the
device-side ranges, ``devtrace.profile``'s keys unchanged by the
wrapper, and ``main`` running the harness traced with the wrapper in
place."""

import itertools
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import devtrace, harness, spans  # noqa: E402

CALLER, AUTOGRAD = 1, 2


def host(name, start, end, thread=CALLER, corr=0):
    return SimpleNamespace(name=name, thread=thread, id=corr, device_type=DeviceType.CPU,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def device(name, start, end, corr=0, annotation=False):
    return SimpleNamespace(name=name, thread=0, id=corr, device_type=DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


def step_events():
    """Two traced steps of 100 us in a window of 200 us. Each: the mixer
    (10-20), the forward (20-40), the backward (50-80, its kernels launched
    from autograd's thread), the optimizer (80-95); one kernel launched
    outside every span, one copy with no launch on record."""
    events = [host("bench.subwindow", 0, 200)]
    corr = itertools.count(1)
    for base in (0, 100):
        events.append(host("bench.step", base, base + 100))
        for name, s, e in (("mixer", 10, 20), ("forward", 20, 40), ("backward", 50, 80),
                           ("optimizer", 80, 95)):
            events.append(host(f"adt.{name}", base + s, base + e))
        for launch_at, thread, run in ((12, CALLER, (14, 18)), (22, CALLER, (25, 35)),
                                       (55, AUTOGRAD, (60, 70)), (82, CALLER, (85, 90)),
                                       (97, CALLER, (98, 99))):
            c = next(corr)
            events.append(host("cudaLaunchKernel", base + launch_at, base + launch_at + 1,
                               thread, c))
            events.append(device("kernel", base + run[0], base + run[1], c))
        events.append(device("Memcpy HtoD", base + 1, base + 3))
    return events


def fake_profiler(events):
    """A ``torch.profiler.profile`` whose trace is ``events``."""

    class FakeProfiler:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return events

    return FakeProfiler


def profiled(monkeypatch, events, wrapped=True):
    """``devtrace.profile`` over ``events`` in place of a trace, wrapped by
    ``spans.with_spans`` or not, the host's clock ticking one second a
    read."""
    fake = fake_profiler(events)
    monkeypatch.setattr(torch.profiler, "profile", fake)
    clock = itertools.count()
    monkeypatch.setattr(devtrace.time, "perf_counter", lambda: float(next(clock)))
    cell = SimpleNamespace(sync=lambda: None, record={}, log=lambda *a: None)
    profile = spans.with_spans(devtrace.profile) if wrapped else devtrace.profile
    assert profile(lambda: None, 2, cell) is cell.record["device_trace"]
    assert torch.profiler.profile is fake
    return cell.record["device_trace"]


def test_the_parts_add_up_to_devtraces_sums(monkeypatch):
    out = profiled(monkeypatch, step_events())
    p = out["program"]
    assert p["phases"] == ["backward", "forward", "mixer", "optimizer"]
    # the window is 200 us of profiler time; devtrace's wall is the clock's one tick
    idle_us = {k: v * 1e6 for k, v in p["idle_s"].items()}
    assert sum(idle_us.values()) == pytest.approx(200 - out["busy_s"] * 1e6)
    assert sum(p["device_s"].values()) == pytest.approx(out["busy_s"])
    assert idle_us == pytest.approx({"mixer": 2 * 6, "forward": 2 * 10, "backward": 2 * 20,
                                     "optimizer": 2 * 10, "outside": 2 * 22})
    per_step = {k: v * 1e6 / out["iters"] for k, v in p["device_s"].items()}
    assert per_step == pytest.approx({"mixer": 4, "forward": 10, "backward": 10,
                                      "optimizer": 5, "outside": 3})
    assert p["launches"] == {"mixer": 2, "forward": 2, "backward": 2, "optimizer": 2,
                             "outside": 4}
    assert p["route"] == {"correlation": 10, "annotation": 0, "unlinked": 2}


def test_an_idle_gap_across_two_spans_is_split():
    events = [host("bench.subwindow", 0, 100), host("adt.mixer", 5, 15),
              host("adt.forward", 20, 40), host("adt.loss", 25, 30),
              device("kernel", 0, 10, 1), device("kernel", 40, 100, 2)]
    p = spans.attribute(events)
    assert {k: v * 1e6 for k, v in p["idle_s"].items()} == pytest.approx(
        {"mixer": 5, "forward": 15, "loss": 5, "outside": 5})


def test_a_kernel_from_another_thread_goes_to_the_callers_span():
    events = [host("bench.subwindow", 0, 100), host("adt.backward", 10, 60),
              host("autograd::engine::evaluate_function", 20, 30, AUTOGRAD),
              host("cudaLaunchKernel", 21, 22, AUTOGRAD, corr=7),
              device("kernel", 40, 50, corr=7)]
    p = spans.attribute(events)
    assert p["launches"] == {"backward": 1, "outside": 0}
    assert p["device_s"]["backward"] == pytest.approx(10e-6)


def test_a_kernel_with_no_span_goes_outside():
    events = [host("bench.subwindow", 0, 100), host("adt.forward", 10, 20),
              host("cuLaunchKernel", 30, 31, corr=3), device("stft_fft_kernel", 32, 40, 3)]
    p = spans.attribute(events)
    assert p["launches"] == {"forward": 0, "outside": 1}
    assert p["route"]["correlation"] == 1


def test_an_unlinked_kernel_falls_back_to_the_device_side_range():
    events = [host("bench.subwindow", 0, 100), host("adt.stft", 10, 20),
              host("adt.model", 20, 30), device("adt.model", 22, 60, annotation=True),
              device("kernel", 25, 50, corr=9)]
    p = spans.attribute(events)
    assert p["launches"]["model"] == 1 and p["route"]["annotation"] == 1


def test_a_program_without_spans_puts_everything_outside():
    events = [host("bench.subwindow", 0, 100), host("bench.batch", 0, 100),
              host("cudaLaunchKernel", 1, 2, corr=1), device("kernel", 3, 90, 1)]
    p = spans.attribute(events)
    assert p["phases"] == [] and p["launches"] == {"outside": 1}
    assert p["idle_s"]["outside"] == pytest.approx(13e-6)


def test_devtrace_keys_unchanged_by_the_wrapper(monkeypatch):
    events = step_events()
    wrapped = profiled(monkeypatch, events)
    plain = profiled(monkeypatch, events, wrapped=False)
    assert set(wrapped) - set(plain) == {"program"}
    assert {k: v for k, v in wrapped.items() if k != "program"} == plain


def test_main_runs_the_harness_traced_with_the_wrapper(monkeypatch):
    seen = {}

    def fake_main(argv):
        seen["argv"], seen["profile"] = argv, devtrace.profile
        return 0

    monkeypatch.setattr(harness, "main", fake_main)
    monkeypatch.setattr(harness, "pin_caches", lambda: None)
    base = devtrace.profile
    assert spans.main(["--workload", "w", "--seed", "1", "--seconds", "2"]) == 0
    assert seen["argv"][-2:] == ["--trace", "1"]
    assert seen["profile"].__qualname__ == "with_spans.<locals>.run"
    assert devtrace.profile is base
