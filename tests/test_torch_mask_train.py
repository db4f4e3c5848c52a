"""Port parity of complex-mask training (``train.mask``, the mixer's
``sample_audio``, the inverse weight conversion, ``fit``'s ``.ckpt``
export and ``cli.train --model complex_mask``) against the JAX package on
the CPU.

Both sides start from one Flax-layout tree (``random_flax_variables(seed,
in_channels=3, out_channels=2)``) and take the same numpy audio: three
4096-sample clips, one with a digitally silent stretch (its |S_hat| bins
are exactly 0), one plain noisy clip and one whose noisy audio is its
clean audio. The SI-SDR clamp acts on clips that the mask passes
through (~100 dB): the zero-initialised identity mask makes them, and its
own tests hold the clamped reward to exactly no gradient there.

The train step is compared at the two-level width of the U-Net step in
``tests/test_torch_train.py``, with the K3 upsampling path on both sides
(its plain version here, interpret mode in JAX). At four levels (width
0.125, a 16 x 2 bottleneck over three clips) the fp32 gradient of this
step is ill-conditioned: against a float64 evaluation of the same step,
JAX's own fp32 gradients there miss 1e-4 too. The checkpoint and CLI
tests, which compare no gradient, run at width 0.125, the smallest that
``cli.train`` and JAX's ``load_model_from_path`` rebuild from a sidecar.

Tolerances: losses 1e-5 relative; gradients 1e-4 relative L2 (fp32
summation order through a backward); parameters after the AdamW update
1e-6 absolute; BatchNorm running statistics 1e-5 relative L2; raw mixer
waveforms 1e-6 absolute; the eval-mode mask of a ``.ckpt`` the port wrote,
loaded by JAX, 1e-5 relative L2.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import audiodenoiser_torch.dsp.stft as port_stft
from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
from audiodenoiser_torch.eval.metrics import si_sdr
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    flax_from_state_dict,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.complex_mask import mask_spectrogram
from audiodenoiser_torch.models.unet import scaled_widths
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_torch.train import mask as port_mask
from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips
from audiodenoiser_torch.train.checkpoints import export_model, load_exported
from audiodenoiser_tpu.data import NoiseBank as JaxBank
from audiodenoiser_tpu.data import OnDeviceMixer as JaxMixer
from audiodenoiser_tpu.eval.metrics import si_sdr as jax_si_sdr
from audiodenoiser_tpu.eval.runner import load_model_from_path
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMask
from audiodenoiser_tpu.models.complex_mask import spectrogram_features as jax_features
from audiodenoiser_tpu.train import mask as jax_mask
from tests.test_torch_pipeline import _jax_draws

WIDTH = 0.125
FEATS, BOTTLENECK = scaled_widths(WIDTH)
W = dict(features=FEATS, bottleneck=BOTTLENECK)
STEP = dict(features=(4, 8), bottleneck=16, pallas_deconv=True)
CLIP = 4096  # a hop multiple: the centre iSTFT then covers every sample
BN_FED_BIASES = ("double_conv.0.bias", "double_conv.3.bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _audio(seed=0):
    clean = synth_chunks(3, seed)[:, :CLIP].copy()
    rng = np.random.default_rng(seed + 1)
    noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), -1, 1).astype(np.float32)
    clean[0, :800] = noisy[0, :800] = 0.0  # silent: |S_hat| = 0 in its first frames
    noisy[2] = clean[2]                      # the pass-through clip
    return noisy, clean


def _variables(seed=1, widths=W):
    widths = {k: widths[k] for k in ("features", "bottleneck")}
    return random_flax_variables(seed, **widths, in_channels=3, out_channels=2)


def _bound(residual):
    return 8.0 if residual else 2.0


def _jax_state(variables, residual, widths=W):
    model = FlaxMask(**widths, mask_bound=_bound(residual), residual=residual)
    state = jax_mask.create_mask_train_state(jax.random.key(0), model, input_shape=(1, 32, 32, 3))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return state.replace(
        params=params, opt_state=state.tx.init(params),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))


def _port_state(variables, residual, widths=W):
    model = ComplexMaskUNet(**widths, mask_bound=_bound(residual), residual=residual)
    return port_mask.create_mask_train_state(0, model, variables=variables, device="cpu")


def _jax_step(state, noisy, clean, weight, clamp):
    """JAX's mask train step, split as the jitted step computes it:
    losses, new batch statistics, gradients, updated parameters."""
    def loss_fn(params):
        total, losses, new_bs = jax_mask._mask_losses(
            state, params, noisy, clean, train=True, si_sdr_weight=weight, si_sdr_clamp=clamp)
        return total, (losses, new_bs)

    (_, (losses, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params)
    updates, _ = state.tx.update(grads, state.opt_state, state.params)
    return losses, new_bs, grads, optax.apply_updates(state.params, updates)


class TestMaskStep:
    @pytest.mark.parametrize("residual", [True, False])
    @pytest.mark.parametrize("clamp", [None, 30.0])
    @pytest.mark.parametrize("weight", [0.0, 0.5])
    def test_train_step_matches_jax(self, weight, clamp, residual):
        noisy, clean = _audio()
        variables = _variables(widths=STEP)
        jstate = _jax_state(variables, residual, STEP)
        losses, new_bs, grads, new_params = _jax_step(
            jstate, jnp.asarray(noisy), jnp.asarray(clean), weight, clamp)

        state = _port_state(variables, residual, STEP)
        train_step, _ = port_mask.make_mask_steps(weight, clamp)
        state, ours = train_step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
        assert state.step == 1
        for a, b in zip(ours, losses):
            assert np.isfinite(float(a))
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))

        ref_norm = float(optax.global_norm(grads))
        assert abs(float(state.grad_norm) - ref_norm) <= 1e-4 * ref_norm
        g_ref = state_dict_from_flax({"params": jax.device_get(grads),
                                      "batch_stats": jax.device_get(new_bs)})
        after = state_dict_from_flax({"params": jax.device_get(new_params),
                                      "batch_stats": jax.device_get(new_bs)})
        scale = min(1.0, 1.0 / ref_norm)  # the port's gradients are clipped in place
        for name, p in state.model.named_parameters():
            assert torch.isfinite(p.grad).all(), name
            if name.endswith(BN_FED_BIASES):
                # a conv bias feeding train-mode BN has a zero gradient: both
                # sides hold rounding noise there
                assert float(p.grad.abs().max()) < 1e-6 * scale * ref_norm, name
                continue
            assert _rel(p.grad.numpy(), scale * g_ref[name].numpy()) < 1e-4, name
            assert np.abs(p.detach().numpy() - after[name].numpy()).max() < 1e-6, name
        got = state.model.state_dict()
        for k in (k for k in after if "running" in k):
            assert _rel(got[k].numpy(), after[k].numpy()) < 1e-5, k

    def test_eval_step_matches_jax_and_leaves_stats(self):
        noisy, clean = _audio(2)
        variables = _variables(seed=3)
        _, eval_step = port_mask.make_mask_steps(0.5, 30.0)
        state = _port_state(variables, True)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        ours = eval_step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
        ref = jax_mask.make_mask_steps(0.5, 30.0)[1](
            _jax_state(variables, True), jnp.asarray(noisy), jnp.asarray(clean))
        for a, b in zip(ours, ref):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        for k, v in state.model.state_dict().items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)

    def test_distillation_is_refused_by_name(self, tmp_path):
        """The refusals the JAX CLI keeps, with its messages: a teacher for
        the magnitude family, and the feature term without a teacher."""
        from audiodenoiser_torch.cli.train import main

        base = ["--base_dataset_path", str(tmp_path), "--pipeline", "on_device",
                "--noise_type", "white", "--device", "cpu"]
        with pytest.raises(SystemExit, match="--distill_from supports --model complex_mask"):
            main([*base, "--model", "unet", "--distill_from", "whatever.ckpt"])
        with pytest.raises(SystemExit, match="--distill_features requires --distill_from"):
            main([*base, "--model", "complex_mask", "--distill_features", "1.0"])


class TestZeroInit:
    def test_identity_mask(self):
        """``zero_out_init``: the head's kernel is 0 after Flax-like init and
        the residual mask is exactly (1, 0) in both modes. Every gradient
        upstream of the head is then exactly 0, in both packages, and the
        head's own agrees with JAX's."""
        model = ComplexMaskUNet(**W, mask_bound=8.0, residual=True, zero_out_init=True)
        state = port_mask.create_mask_train_state(5, model, device="cpu")
        assert float(state.model.out.weight.detach().abs().max()) == 0.0
        feats = torch.rand(2, 3, 64, 32)
        for mode in ("train", "eval"):
            with torch.no_grad():
                mask = getattr(state.model, mode)()(feats)
            assert torch.equal(mask[:, 0], torch.ones_like(mask[:, 0]))
            assert torch.equal(mask[:, 1], torch.zeros_like(mask[:, 1]))

        # no clip here reconstructs its clean audio: where one does, the
        # waveform L1's gradient is the sign of rounding noise
        clean = synth_chunks(2, seed=4)[:, :CLIP].copy()
        rng = np.random.default_rng(5)
        noisy = np.clip(clean + 0.1 * rng.standard_normal(clean.shape), -1, 1).astype(np.float32)
        variables = flax_from_state_dict(state.model.state_dict())
        losses, _, jgrads, _ = _jax_step(_jax_state(variables, True), jnp.asarray(noisy),
                                         jnp.asarray(clean), 0.5, 30.0)
        ref = state_dict_from_flax({"params": jax.device_get(jgrads),
                                    "batch_stats": variables["batch_stats"]})
        state.optimizer.step = lambda: None  # keep the raw gradients
        state, ours = port_mask.make_mask_steps(0.5, 30.0)[0](
            state, torch.from_numpy(noisy), torch.from_numpy(clean))
        for a, b in zip(ours, losses):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        for name, p in state.model.named_parameters():
            if name.startswith("out."):
                assert float(p.grad.abs().max()) > 0 and _rel(p.grad, ref[name]) < 1e-4, name
            else:
                assert float(p.grad.abs().max()) == 0.0, name
                assert float(np.abs(ref[name].numpy()).max()) == 0.0, name

    def test_clamped_reward_of_a_pass_through_clip_adds_no_gradient(self):
        """Clips the identity mask passes through score ~100 dB, past the
        30 dB clamp: the clamped reward's gradient is exactly 0 in both
        packages, and a mask step on them gets bit for bit the gradients
        of the objective without the SI-SDR term."""
        _, clean = _audio(6)
        model = ComplexMaskUNet(**W, mask_bound=8.0, residual=True, zero_out_init=True)
        state = port_mask.create_mask_train_state(7, model, device="cpu")
        with torch.no_grad():
            spec = port_stft.stft(torch.from_numpy(clean), 512, 128)
            y = port_stft.istft(mask_spectrogram(state.model.train(), spec), 128,
                                n_fft=512, length=CLIP)
        ref = torch.from_numpy(clean)
        assert float(si_sdr(y, ref).min()) > 30.0
        y.requires_grad_()
        torch.clamp(si_sdr(y, ref), max=30.0).mean().backward()
        assert float(y.grad.abs().max()) == 0.0
        jy = jax.grad(lambda a: jnp.mean(jnp.minimum(jax_si_sdr(a, jnp.asarray(clean)), 30.0)))(
            jnp.asarray(y.detach().numpy()))
        assert float(jnp.abs(jy).max()) == 0.0

        variables = flax_from_state_dict(state.model.state_dict())
        grads = []
        for weight, clamp in ((0.0, None), (0.5, 30.0)):
            st = _port_state(variables, True)
            st.optimizer.step = lambda: None  # keep the raw gradients
            port_mask.make_mask_steps(weight, clamp)[0](st, ref, ref)
            grads.append({n: p.grad for n, p in st.model.named_parameters()})
        for name, g in grads[0].items():
            assert torch.equal(g, grads[1][name]), name


class TestSampleAudio:
    @pytest.fixture(scope="class")
    def data(self):
        return synth_chunks(5, seed=8), synth_noise_clips(3, seed=9)

    @pytest.mark.parametrize("noise_type,augment,snr", [
        ("white", False, None),
        ("urban", True, (2.0, 10.0)),
        ("reverb", False, None),
        ("noise_cancellation", True, None),
        ("mixed", False, None),
    ])
    def test_sample_audio_with_jax_draws(self, data, noise_type, augment, snr):
        chunks, clips = data
        kw = {"snr_db": snr} if snr else {}
        jbank = JaxBank(clips) if noise_type in ("urban", "mixed") else None
        jm = JaxMixer(chunks, noise_type, noise_bank=jbank, augment=augment, **kw)
        key = jax.random.key(12)
        ref_noisy, ref_clean = jm.sample_audio(key, 4)
        bank = NoiseBank(clips, device="cpu") if jbank is not None else None
        pm = OnDeviceMixer(chunks, noise_type, noise_bank=bank, augment=augment,
                           device="cpu", **kw)
        draws = _jax_draws(key, 4, len(chunks), 16000, noise_type, augment, snr, len(clips))
        noisy, clean = pm.sample_audio_from(draws)
        assert noisy.shape == clean.shape == (4, 16000) and noisy.dtype == torch.float32
        np.testing.assert_allclose(clean.numpy(), np.asarray(ref_clean), atol=1e-6)
        np.testing.assert_allclose(noisy.numpy(), np.asarray(ref_noisy), atol=1e-6)
        gen = pm.sample_audio(torch.Generator().manual_seed(1), 3)
        again = pm.sample_audio(torch.Generator().manual_seed(1), 3)
        for a, b in zip(gen, again):
            assert a.shape == (3, 16000) and torch.equal(a, b)


class TestCheckpoint:
    def test_inverse_conversion_round_trips(self):
        v = random_flax_variables(6, **W, in_channels=3, out_channels=2)
        back = flax_from_state_dict(state_dict_from_flax(v))
        for group in ("params", "batch_stats"):
            want = jax.tree_util.tree_leaves_with_path(v[group])
            got = jax.tree_util.tree_leaves_with_path(back[group])
            assert [p for p, _ in want] == [p for p, _ in got]
            for (path, a), (_, b) in zip(want, got):
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
                np.testing.assert_array_equal(a, b)
        model = ComplexMaskUNet(**W)
        port_loop.init_flax_like(model, 2)
        sd = model.state_dict()
        again = state_dict_from_flax(flax_from_state_dict(sd))
        assert again.keys() == sd.keys()
        for k, t in sd.items():
            if not k.endswith("num_batches_tracked"):  # no Flax counterpart
                assert torch.equal(again[k], t), k

    def test_port_ckpt_loads_in_jax(self, tmp_path):
        noisy, clean = _audio(7)
        state = _port_state(_variables(seed=8), True)
        train_step, _ = port_mask.make_mask_steps(0.5, 30.0)
        state, _ = train_step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
        tree = flax_from_state_dict(state.model.state_dict())
        path = str(tmp_path / "mask_denoiser_mixed.ckpt")
        export_model(path, tree["params"], tree["batch_stats"])
        with open(tmp_path / "mask_denoiser_mixed.json", "w") as f:
            json.dump({"width_mult": WIDTH, "mask_bound": 8.0, "residual": True}, f)
        model, variables = load_model_from_path(path, dtype=jnp.float32)
        assert model.mask_bound == 8.0 and model.residual
        spec = port_stft.stft(torch.from_numpy(noisy), 512, 128)
        with torch.no_grad():
            ours = mask_spectrogram(state.model.eval(), spec)
        jspec = jnp.asarray(spec.numpy())
        jmask = model.apply(variables, jax_features(jspec), train=False)
        ref = np.asarray(jax.lax.complex(jmask[..., 0], jmask[..., 1]) * jspec)
        assert _rel(torch.view_as_real(ours).numpy(),
                    np.stack([ref.real, ref.imag], -1)) < 1e-5


def _tiny_mask(**kw):
    return ComplexMaskUNet(**W, **kw)


class TestFitAndCLI:
    def test_fit_with_mask_steps_writes_best_ckpt(self, tmp_path):
        from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel

        mixer = OnDeviceMixer(synth_chunks(6, seed=10), "white", device="cpu")
        gen = torch.Generator().manual_seed(0)
        cfg = port_loop.FitConfig(run_name="mask", output_path=str(tmp_path), epochs=2,
                                  batch_size=2, precision="f32", log_every=1)
        res = port_loop.fit(
            cfg, lambda e: (mixer.sample_audio(gen, 2) for _ in range(2)),
            lambda: iter([mixer.sample_audio(gen, 2)]),
            state_factory=lambda: port_mask.create_mask_train_state(
                0, _tiny_mask(mask_bound=8.0, residual=True, zero_out_init=True,
                              pallas_deconv=True), device="cpu"),
            steps=port_mask.make_mask_steps(0.5, 30.0))
        assert res["steps"] == 4 and res["exported_best"]
        assert res["best_path"].endswith(os.path.join("checkpoints", "best_model.ckpt"))
        assert all(np.isfinite(h["train"]) and np.isfinite(h["val"]) for h in res["history"])
        assert stft_kernel.launches == istft_kernel.launches == 0  # CPU: plain versions
        payload = load_exported(res["best_path"])
        back = state_dict_from_flax(payload)
        # the export is the best epoch's model: the last one when it was the best
        if res["best_val"] == res["history"][-1]["val"]:
            for k, t in res["state"].model.state_dict().items():
                if not k.endswith("num_batches_tracked"):
                    assert torch.equal(back[k], t), k

    @staticmethod
    def _wavs(root, noise=False):
        from audiodenoiser_torch.data.wav_io import write_wav

        (root / "clean").mkdir(parents=True)
        for i, chunk in enumerate(synth_chunks(6, seed=11).reshape(3, -1)):
            write_wav(str(root / "clean" / f"c{i}.wav"), chunk, 8000)
        if noise:
            (root / "noise").mkdir()
            for i, clip in enumerate(synth_noise_clips(2, seed=12)):
                write_wav(str(root / "noise" / f"n{i}.wav"), clip, 8000)

    @pytest.mark.parametrize("noise_type,flags,meta", [
        ("noise_cancellation", [],
         {"mask_bound": 8.0, "si_sdr_weight": 0.5, "si_sdr_clamp": 30.0, "residual": True}),
        ("white", ["--si_sdr_clamp", "0", "--mask_residual", "off"],
         {"mask_bound": 2.0, "si_sdr_weight": 0.5, "si_sdr_clamp": None, "residual": False}),
        ("mixed", ["--mask_bound", "4", "--si_sdr_weight", "0.25"],
         {"mask_bound": 4.0, "si_sdr_weight": 0.25, "si_sdr_clamp": 30.0, "residual": True}),
    ])
    def test_cli_trains_and_exports_the_mask_family(self, tmp_path, monkeypatch,
                                                    noise_type, flags, meta):
        from audiodenoiser_torch.cli.train import main

        built = []

        def narrow(**kw):
            built.append(kw)
            return _tiny_mask(**kw)

        monkeypatch.setattr(port_mask, "ComplexMaskUNet", narrow)
        self._wavs(tmp_path / "data", noise=noise_type == "mixed")
        saved = tmp_path / "saved"
        out = main(["--base_dataset_path", str(tmp_path / "data"), "--model", "complex_mask",
                    "--pipeline", "on_device", "--noise_type", noise_type,
                    "--output_path", str(tmp_path / "runs"), "--run_name", "m",
                    "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "2",
                    "--precision", "f32", "--device", "cpu", "--export_dir", str(saved),
                    *flags])
        assert out["steps"] == 2 and out["best_path"].endswith("best_model.ckpt")
        assert built == [{"dtype": torch.float32, "mask_bound": meta["mask_bound"],
                          "residual": meta["residual"], "zero_out_init": meta["residual"],
                          "attn_bottleneck": False, "s2d_stem": False, "s2d_skip": 0}]
        for sidecar in (os.path.splitext(out["best_path"])[0] + ".json",
                        saved / f"mask_denoiser_{noise_type}.json"):
            with open(sidecar) as f:
                assert json.load(f) == meta
        ckpt = saved / f"mask_denoiser_{noise_type}.ckpt"
        assert open(ckpt, "rb").read() == open(out["best_path"], "rb").read()
        assert load_exported(str(ckpt))["params"]["out"]["kernel"].shape == (1, 1, FEATS[0], 2)

    def test_cli_refuses_without_the_on_device_pipeline(self, tmp_path):
        from audiodenoiser_torch.cli.train import main

        with pytest.raises(SystemExit, match="requires --pipeline on_device"):
            main(["--base_dataset_path", str(tmp_path), "--model", "complex_mask",
                  "--noise_type", "white"])
        with pytest.raises(SystemExit, match="requires --pipeline on_device --noise_type mixed"):
            main(["--base_dataset_path", str(tmp_path), "--model", "router",
                  "--noise_type", "mixed"])
