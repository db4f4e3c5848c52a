"""The program's spans (``utils.profiling.span``) on the CPU.

With no profiler recording, a span makes no ``record_function`` and
allocates nothing. Under a CPU ``torch.profiler`` the training step's
phases (the mixer, the forward, the loss, the backward, the optimizer)
and a runner call's (the STFT side, the model, the iSTFT side) appear in
order on the calling thread, and ``cli.train --profile_dir`` writes them
into its Chrome trace.
"""

import contextlib
import itertools
import json
import os
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet
from audiodenoiser_torch.models.unet import UNet, scaled_widths
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_torch.train import mask as port_mask
from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips
from audiodenoiser_torch.utils.profiling import (
    BACKWARD,
    FORWARD,
    ISTFT,
    LOSS,
    MIXER,
    MODEL,
    OPTIMIZER,
    STFT,
    span,
)

TINY = dict(features=(4, 8), bottleneck=16)
FEATS, BOTTLENECK = scaled_widths(0.25)
CLIP = 4096  # a hop multiple of 33 frames: the mask step's loss needs 32
CALLER = "test.caller"
# zero_grad's optimizer range comes before the backward, the update's after it
STEP_PHASES = [FORWARD, LOSS, OPTIMIZER, BACKWARD, OPTIMIZER]


def _mixer():
    bank = NoiseBank(synth_noise_clips(3, seed=2), target_len=CLIP, device="cpu")
    return OnDeviceMixer(synth_chunks(4, seed=1)[:, :CLIP], "mixed", noise_bank=bank,
                         device="cpu")


def _mask_step():
    """One mixer draw and one mask step at width 0.25, as ``cli.train
    --model complex_mask --noise_type mixed`` runs them."""
    mixer, gen = _mixer(), torch.Generator().manual_seed(0)
    state = port_mask.create_mask_train_state(
        0, ComplexMaskUNet(mask_bound=8.0, residual=True, features=FEATS,
                           bottleneck=BOTTLENECK), device="cpu")
    train_step, _ = port_mask.make_mask_steps(0.5, 30.0)

    def step():
        draws = mixer.draw(gen, 2)
        train_step(state, *mixer.sample_audio_from(draws))

    return step


def _magnitude_step():
    mixer, gen = _mixer(), torch.Generator().manual_seed(0)
    state = port_loop.create_train_state(0, UNet(**TINY), device="cpu")
    return lambda: port_loop.train_step(state, *mixer.sample(gen, 2))


def _runner_call(mode):
    model = ComplexMaskUNet(**TINY) if mode == "complex_mask" else UNet(**TINY)
    runner = DenoiserRunner(model, device="cpu")
    audio = torch.from_numpy(synth_chunks(2, seed=3)[:, :CLIP])
    return lambda: runner.denoise_audio(audio, mode=mode, gl_iters=1)


def _phases(fn) -> list:
    """The program's ranges that ``fn`` opens on the calling thread, in the
    order they start, under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALLER):
            fn()
    events = prof.events()  # ordered by start, a parent before its child
    caller = next(e.thread for e in events if e.name == CALLER)
    return [e.name for e in events if e.thread == caller and e.name.startswith("adt.")]


def test_span_off_makes_no_range_and_allocates_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    calls = [_mask_step(), _magnitude_step(), _runner_call("noisy_phase"),
             _runner_call("complex_mask")]
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for fn in calls:
        fn()
    assert span(FORWARD) is span(MIXER)

    null = contextlib.nullcontext()

    def loop(make):
        for _ in itertools.repeat(None, 10000):
            with make():
                pass

    peaks = {}
    for label, make in (("null", lambda: null), ("span", lambda: span(LOSS))):
        loop(make)
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            loop(make)
            peaks[label] = tracemalloc.get_traced_memory()[1] - base
        finally:
            tracemalloc.stop()
    # the loop's own bytes are the same either way: a span adds none
    assert peaks["span"] <= peaks["null"], peaks


@pytest.mark.parametrize("make,mixer_ranges", [
    (_mask_step, 2),       # the draw, the corruption
    (_magnitude_step, 3),  # the draw, the corruption, the features
], ids=["complex_mask", "magnitude"])
def test_training_step_phases_in_order(make, mixer_ranges):
    step = make()
    assert _phases(step) == [MIXER] * mixer_ranges + STEP_PHASES


@pytest.mark.parametrize("mode,phases", [
    ("noisy_phase", [STFT, MODEL, ISTFT]),
    ("complex_mask", [STFT, MODEL, ISTFT]),
    ("griffin_lim", [STFT, MODEL]),  # the Griffin-Lim loop has no span of its own
], ids=["noisy_phase", "complex_mask", "griffin_lim"])
def test_runner_phases_in_order(mode, phases):
    call = _runner_call(mode)
    assert _phases(call) == phases


def test_cli_train_trace_shows_the_phases(tmp_path, monkeypatch):
    from audiodenoiser_torch.cli.train import main
    from audiodenoiser_torch.data.wav_io import write_wav

    monkeypatch.setattr(port_mask, "ComplexMaskUNet", lambda **kw: ComplexMaskUNet(
        **{**kw, **TINY}))
    (tmp_path / "data" / "clean").mkdir(parents=True)
    for i, chunk in enumerate(synth_chunks(4, seed=11).reshape(2, -1)):
        write_wav(str(tmp_path / "data" / "clean" / f"c{i}.wav"), chunk, 8000)
    prof = tmp_path / "prof"
    main(["--base_dataset_path", str(tmp_path / "data"), "--model", "complex_mask",
          "--pipeline", "on_device", "--noise_type", "white",
          "--output_path", str(tmp_path / "runs"), "--epochs", "1", "--steps_per_epoch", "1",
          "--batch_size", "2", "--precision", "f32", "--device", "cpu",
          "--profile_dir", str(prof)])
    (trace,) = os.listdir(prof)
    with open(prof / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {MIXER, FORWARD, LOSS, BACKWARD, OPTIMIZER} <= names
