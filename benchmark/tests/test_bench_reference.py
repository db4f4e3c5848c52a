"""The plain reference against the port at a small width on the CPU, in
float32: the serving modes, the mixer's corruptions and a training step."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import inputs, program  # noqa: E402
from benchmark.harness import load_json, BENCH_DIR  # noqa: E402
from benchmark.reference import mixer as ref_mixer  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from benchmark.reference import unet as ref_unet  # noqa: E402

SMALL = dict(features=[8, 16, 32, 64], bottleneck=128)


def small_config(name):
    cfg = load_json(BENCH_DIR / "configs" / f"{name}.json")
    cfg.update(SMALL)
    return cfg


@pytest.mark.parametrize("name", ["unet31m", "cmask31m"])
def test_denoise_matches_the_port(name):
    from audiodenoiser_torch.eval.runner import DenoiserRunner

    cfg = small_config(name)
    weights = inputs.make_weights(cfg, 5, "cpu")
    gen = inputs.generator(5, "cpu")
    audio = inputs.noisy_speech(gen, 3, 16000 + 77, 8000, (0.0, 10.0), "cpu")
    model = program.build_model(cfg, weights, "cpu", torch.float32).eval()
    runner = DenoiserRunner(model, device="cpu")
    got = runner.denoise_audio(audio)
    want = ref_unet.denoise(weights, cfg, audio)
    err = float((got - want).norm() / want.norm())
    assert err < 1e-5, err


def test_mixer_matches_the_port():
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer

    gen = inputs.generator(7, "cpu")
    clean = inputs.speech_like(gen, 40, 16000, 8000, "cpu")
    clips = [np.asarray(inputs.speech_like(gen, 1, n, 8000, "cpu")[0])
             for n in (9000, 16000, 31000, 40000)]
    bank = NoiseBank(clips, target_len=16000, device="cpu")
    mixer = OnDeviceMixer(clean.numpy(), "mixed", noise_bank=bank, device="cpu")
    draws = mixer.draw(torch.Generator().manual_seed(3), 40)
    noisy, got_clean = mixer.sample_audio_from(draws)
    want = ref_mixer.corrupt(clean[draws["idx"]], draws, clips, 8000, 8.0)
    assert torch.equal(got_clean, clean[draws["idx"]])
    assert set(draws["choice"].tolist()) == {0, 1, 2, 3}
    assert float((noisy - want).abs().max()) < 1e-5


def test_train_step_matches_the_port():
    from audiodenoiser_torch.train.loop import TrainState, make_optimizer
    from audiodenoiser_torch.train.mask import make_mask_steps

    cfg = small_config("cmask31m")
    traffic = load_json(BENCH_DIR / "traffic" / "train16.json")
    weights = inputs.make_weights(cfg, 11, "cpu")
    model = program.build_model(cfg, weights, "cpu", torch.float32)
    names = [n for n, _ in model.named_parameters()]
    state = TrainState(model, make_optimizer(model.parameters(), traffic["learning_rate"],
                                             traffic["weight_decay"], traffic["clip_norm"]))
    step, _ = make_mask_steps(traffic["si_sdr_weight"], traffic["si_sdr_clamp"])
    gen = inputs.generator(11, "cpu")
    batches = [(inputs.noisy_speech(gen, 4, 16000, 8000, (0.0, 10.0), "cpu"),
                inputs.speech_like(gen, 4, 16000, 8000, "cpu")) for _ in range(2)]
    losses = [float(step(state, n, c)[1].total) for n, c in batches[:1]]
    # the first gradient as AdamW took it: its first moment after one step
    grad = {n: state.optimizer.adamw.state[p]["exp_avg"] / 0.1
            for n, p in model.named_parameters()}
    losses += [float(step(state, n, c)[1].total) for n, c in batches[1:]]
    ref = ref_train.train_steps(weights, names, cfg, traffic, batches)
    assert np.allclose(losses, ref["loss"], rtol=1e-4, atol=1e-5), (losses, ref["loss"])
    params = dict(model.named_parameters())
    moved = ref_train.moved_leaves(ref["grad"], names)
    assert 0 < len(names) - len(moved) < len(names) // 4
    gap, at = ref_train.worst(ref_train.leaf_gaps(
        {n: params[n].detach() - weights[n] for n in moved},
        {n: ref["params"][n] - weights[n] for n in moved}, moved))
    # AdamW's first steps are about lr x sign(g): an element whose gradient
    # sign float32 rounding decides moves either way, on both sides alike
    assert gap < 5e-2, (gap, at)
    # the float32 gradient of this step is ill-conditioned: two orders of
    # summation part by up to a few 1e-3 at a leaf
    gap, at = ref_train.worst(ref_train.leaf_gaps(grad, ref["grad"], names))
    assert gap < 5e-3, (gap, at)


def test_the_control_rounds_coarser_than_bf16():
    x = torch.randn(10000)
    e8 = float((ref_unet.round_int8(x) - x).norm() / x.norm())
    e16 = float((x.bfloat16().float() - x).norm() / x.norm())
    assert 4 * e16 < e8 < 0.1
