"""The noise router of the port against the JAX package on the CPU: the
classifier (``models.router``) and its weight conversion, the labelled
mixer stream (``OnDeviceMixer.sample_labeled``), the router's train step
and ``fit_router`` (``train.router``), and ``cli.train --model router``.

Weights are seeded Flax-layout trees (``random_router_flax_variables``)
carried into both packages. Tolerances: the fp32 classifier within 1e-5 of
max|JAX| (every layer's SAME padding and GroupNorm as Flax computes them,
at even and odd input sizes); the bf16 classifier within 2e-2 of
max|JAX|, its argmax equal wherever JAX's top-2 margin exceeds that; the
labelled stream's labels equal and its features within one float16
rounding (the reference loader's cast); three fp32 train steps' losses and
parameters within 1e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
from audiodenoiser_torch.data.wav_io import write_wav
from audiodenoiser_torch.eval.ensemble import load_router
from audiodenoiser_torch.models import (
    NOISE_CLASSES,
    NoiseClassifier,
    count_params,
    random_router_flax_variables,
    router_flax_from_state_dict,
    router_state_dict_from_flax,
)
from audiodenoiser_torch.models.router import same_pads
from audiodenoiser_torch.train import router as port_router
from audiodenoiser_torch.train.checkpoints import load_exported
from audiodenoiser_tpu.data import NoiseBank as JaxBank
from audiodenoiser_tpu.data import OnDeviceMixer as JaxMixer
from audiodenoiser_tpu.models.router import NOISE_CLASSES as JAX_CLASSES
from audiodenoiser_tpu.models.router import NoiseClassifier as FlaxClassifier

FP32_TOL, BF16_TOL = 1e-5, 2e-2


def _port(params, dtype=torch.float32):
    model = NoiseClassifier(dtype=dtype)
    model.load_state_dict(router_state_dict_from_flax(params), strict=True)
    return model.eval()


def _mags(shape, seed=0):
    return (3.0 * np.abs(np.random.default_rng(seed).standard_normal(shape))).astype(np.float32)


def _jax_logits(params, x, dtype=jnp.float32):
    return np.asarray(FlaxClassifier(dtype=dtype).apply({"params": params},
                                                        jnp.asarray(x)[..., None]))


class TestClassifier:
    @pytest.fixture(scope="class")
    def params(self):
        return random_router_flax_variables(3)["params"]

    def test_counts_and_labels(self):
        assert count_params(NoiseClassifier()) == 98_148
        assert NOISE_CLASSES == JAX_CLASSES

    @pytest.mark.parametrize("n,pads", [(256, (0, 1)), (64, (0, 1)), (257, (1, 1)),
                                        (37, (1, 1)), (1, (1, 1))])
    def test_same_padding_follows_parity(self, n, pads):
        """Flax SAME at k=3, s=2: an even length pads (0, 1), an odd one
        (1, 1), and the output keeps ceil(n / 2)."""
        assert same_pads(n) == pads
        assert (n + sum(pads) - 3) // 2 + 1 == -(-n // 2)

    @pytest.mark.parametrize("shape", [(2, 256, 64), (3, 257, 188), (2, 256, 40),
                                       (2, 255, 37)])
    def test_fp32_matches_jax(self, params, shape):
        """The training crop, a whole clip, and T < 64 at even and odd sizes."""
        x = _mags(shape)
        ref = _jax_logits(params, x)
        with torch.no_grad():
            ours = _port(params)(torch.from_numpy(x)[:, None])
        assert ours.shape == (shape[0], 4) and ours.dtype == torch.float32
        err = np.abs(ours.numpy() - ref).max() / np.abs(ref).max()
        assert err < FP32_TOL, err

    def test_symmetric_padding_would_miss(self, params):
        """The parity padding is load-bearing: padding (1, 1) always, as
        ``Conv2d(padding=1)`` does, moves the logits of an even input far
        past the fp32 tolerance."""
        x = torch.from_numpy(_mags((2, 256, 64)))[:, None]
        model = _port(params)
        import audiodenoiser_torch.models.router as router_mod

        real = router_mod.same_pads
        try:
            router_mod.same_pads = lambda n, kernel=3, stride=2: (1, 1)
            with torch.no_grad():
                shifted = model(x).numpy()
        finally:
            router_mod.same_pads = real
        ref = _jax_logits(params, x[:, 0].numpy())
        assert np.abs(shifted - ref).max() / np.abs(ref).max() > 100 * FP32_TOL

    def test_bf16_matches_jax(self, params):
        x = _mags((6, 257, 130), seed=1)
        ref = _jax_logits(params, x, jnp.bfloat16)
        with torch.no_grad():
            ours = _port(params, torch.bfloat16)(torch.from_numpy(x)[:, None]).numpy()
        tol = BF16_TOL * np.abs(ref).max()
        assert np.abs(ours - ref).max() < tol
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tol
        assert clear.any()
        np.testing.assert_array_equal(ours.argmax(-1)[clear], ref.argmax(-1)[clear])

    def test_conversion_round_trip(self, params):
        back = router_flax_from_state_dict(_port(params).state_dict())
        assert sorted(back) == sorted(params)
        for layer in params:
            for name, arr in params[layer].items():
                np.testing.assert_array_equal(back[layer][name], arr)


@pytest.fixture(scope="module")
def mixer_data():
    """Harmonic clean chunks (so the corruptions are separable) and a noise
    clip, as the JAX package's router tests."""
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 8000.0
    chunks = []
    for _ in range(24):
        f0 = rng.uniform(100, 900)
        x = sum(rng.uniform(0.1, 0.3) * np.sin(2 * np.pi * f0 * (k + 1) * t) for k in range(3))
        chunks.append(np.clip(x, -1, 1).astype(np.float32))
    clip = (0.5 * np.random.default_rng(1).standard_normal(9000)).astype(np.float32)
    return np.stack(chunks), clip


def _labeled_jax_draws(key, b, n_chunks, length, n_clips):
    """The random tensors ``JaxMixer.sample_labeled(key, b)`` draws
    (augmentation off), as the port's ``draws`` dict."""
    r = jax.random
    k_idx, k_pick, k_all = r.split(key, 3)
    out = {"idx": r.randint(k_idx, (b,), 0, n_chunks), "choice": r.randint(k_pick, (b,), 0, 4)}
    k_white, k_urban, _, k_nc = r.split(k_all, 4)
    out["white_noise"] = jnp.stack([r.normal(k, (length,)) for k in r.split(k_white, b)])
    k_clip, k_start = r.split(r.split(k_urban)[0])
    out["bank_idx"] = r.randint(k_clip, (b,), 0, n_clips)
    out["bank_start"] = r.randint(k_start, (b,), 0, 2 ** 30)
    out["gate"] = r.bernoulli(k_nc, 0.8, (b, -(-length // 16000)))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


class TestLabeledStream:
    def test_matches_jax_given_its_draws(self, mixer_data):
        chunks, clip = mixer_data
        key = jax.random.key(5)
        ref = JaxMixer(chunks, "mixed", noise_bank=JaxBank([clip])).sample_labeled(key, 12)
        ours = OnDeviceMixer(chunks, "mixed", noise_bank=NoiseBank([clip], device="cpu"),
                             device="cpu").sample_labeled_from(
            _labeled_jax_draws(key, 12, len(chunks), 16000, 1))
        np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
        assert len(set(ours[2].tolist())) >= 2  # an actual mixture
        for got, want in zip(ours[:2], ref[:2]):
            assert got.shape == (12, 1, 256, 64) and got.dtype == torch.float32
            want = np.asarray(want)[..., 0]
            # one float16 rounding (the cast after the STFT may land either
            # side) on top of the fp32 STFTs' own roundoff, 1e-6 of the peak
            gap = np.abs(got[:, 0].numpy() - want)
            assert np.all(gap <= 2.0 ** -10 * np.abs(want) + 1e-6 * np.abs(want).max())

    def test_own_draws_and_refusal(self, mixer_data):
        chunks, clip = mixer_data
        mixer = OnDeviceMixer(chunks, "mixed", noise_bank=NoiseBank([clip], device="cpu"),
                              device="cpu")
        a = mixer.sample_labeled(torch.Generator().manual_seed(2), 8)
        b = mixer.sample_labeled(torch.Generator().manual_seed(2), 8)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert a[2].shape == (8,) and 0 <= int(a[2].min()) and int(a[2].max()) < 4
        with pytest.raises(ValueError, match="mixed"):
            OnDeviceMixer(chunks, "white", device="cpu").sample_labeled(
                torch.Generator().manual_seed(0), 4)


class TestTraining:
    def test_three_steps_match_jax(self, mixer_data):
        """fp32 weights from one Flax init, the same three labelled batches:
        every loss within 1e-5, and after the third AdamW update the
        parameters as one vector within 2e-5 relative L2 (9.3e-6 measured).
        The gradients agree within about 1e-5 a tensor, but AdamW's early
        updates are near +-lr whatever a gradient's size, so an element
        whose gradient lies near roundoff moves by another fraction of lr
        on either side; element by element the parameters differ up to
        1e-4 of their tensor's largest."""
        from audiodenoiser_tpu.train.router import create_router_state, router_train_step

        chunks, clip = mixer_data
        jm = JaxMixer(chunks, "mixed", noise_bank=JaxBank([clip]))
        batches = [jm.sample_labeled(jax.random.key(20 + i), 8) for i in range(3)]
        state = create_router_state(jax.random.key(1), model=FlaxClassifier(dtype=jnp.float32),
                                    learning_rate=1e-3)
        params = jax.tree_util.tree_map(np.asarray, state.params)
        ours = port_router.create_router_state(params=params, device="cpu", learning_rate=1e-3,
                                               model=NoiseClassifier(dtype=torch.float32))
        for noisy, _, labels in batches:
            state, loss, acc = router_train_step(state, noisy, labels)
            x = torch.from_numpy(np.array(noisy)[..., 0])[:, None]
            ours, our_loss, our_acc = port_router.router_train_step(
                ours, x, torch.from_numpy(np.array(labels)))
            assert abs(float(our_loss) - float(loss)) < 1e-5 * abs(float(loss))
            assert float(our_acc) == float(acc)
        got = router_flax_from_state_dict(ours.model.state_dict())
        ours_all = np.concatenate([got[k][n].ravel() for k in sorted(got) for n in sorted(got[k])])
        want_all = np.concatenate([np.asarray(state.params[k][n]).ravel()
                                   for k in sorted(got) for n in sorted(got[k])])
        rel = np.linalg.norm(ours_all - want_all) / np.linalg.norm(want_all)
        assert rel < 2e-5, rel
        assert ours.step == 3

    @pytest.fixture
    def one_thread(self):
        """The fit is thousands of small ops: on a CPU shared by several test
        workers, many intra-op threads each run them far slower than one."""
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)

    def test_fit_router_learns_corruption_types(self, mixer_data, one_thread):
        """A brief fit beats chance (0.25) clearly on held-out batches, as
        the JAX package's does (there 90 steps of 32 at lr 2e-3; here 60 of
        16, a third of the work, which keeps the test short on a loaded
        CPU)."""
        chunks, clip = mixer_data
        mixer = OnDeviceMixer(chunks, "mixed", noise_bank=NoiseBank([clip], device="cpu"),
                              device="cpu")
        logged = []
        state, acc = port_router.fit_router(mixer, steps=60, batch_size=16,
                                            learning_rate=2e-3, seed=0, log_every=30,
                                            log=logged.append)
        assert acc > 0.5, f"held-out accuracy {acc:.3f} barely above chance"
        assert len(logged) == 2 and state.step == 60
        assert next(state.model.parameters()).dtype == torch.float32  # bf16 compute only


class TestTrainCLI:
    def test_exports_router_and_sidecar(self, mixer_data, tmp_path):
        from audiodenoiser_torch.cli.train import main

        chunks, clip = mixer_data
        for sub in ("clean", "noise"):
            os.makedirs(tmp_path / "data" / sub)
        for i in range(3):
            write_wav(str(tmp_path / "data" / "clean" / f"c{i}.wav"),
                      np.concatenate(list(chunks[4 * i: 4 * i + 4])), 8000)
        write_wav(str(tmp_path / "data" / "noise" / "n0.wav"), clip, 8000)
        out = main(["--base_dataset_path", str(tmp_path / "data"), "--model", "router",
                    "--pipeline", "on_device", "--noise_type", "mixed", "--epochs", "2",
                    "--steps_per_epoch", "2", "--batch_size", "4", "--learning_rate", "1e-3",
                    "--output_path", str(tmp_path / "runs"), "--run_name", "r",
                    "--export_dir", str(tmp_path / "saved"), "--device", "cpu"])
        assert set(out) == {"best_path", "router_accuracy"}
        assert 0.0 <= out["router_accuracy"] <= 1.0
        best = tmp_path / "runs" / "r" / "checkpoints" / "noise_router.ckpt"
        assert out["best_path"] == str(best)
        shipped = tmp_path / "saved" / "noise_router.ckpt"
        for ckpt in (best, shipped):
            with open(os.path.splitext(ckpt)[0] + ".json") as f:
                assert json.load(f) == {"window": [256, 64]}
        assert open(best, "rb").read() == open(shipped, "rb").read()
        payload = load_exported(str(shipped))
        assert payload["batch_stats"] == {}
        assert payload["params"]["head"]["kernel"].shape == (128, 4)
        # the loader reads it back to the weights the JAX classifier scores
        router, window = load_router(str(shipped), torch.float32)
        x = _mags((2, 256, 64), seed=4)
        with torch.no_grad():
            ours = router(torch.from_numpy(x)[:, None]).numpy()
        ref = _jax_logits(payload["params"], x)
        assert window == (256, 64)
        assert np.abs(ours - ref).max() / np.abs(ref).max() < FP32_TOL

    @pytest.mark.parametrize("flags", [["--noise_type", "mixed"],
                                       ["--pipeline", "on_device", "--noise_type", "white"]])
    def test_needs_the_mixed_on_device_stream(self, tmp_path, flags):
        from audiodenoiser_torch.cli.train import main

        with pytest.raises(SystemExit, match="requires --pipeline on_device --noise_type mixed"):
            main(["--base_dataset_path", str(tmp_path), "--model", "router", *flags])
