"""Port parity of the training slice: the U-Net in train mode and in bf16,
the mel spectrogram, the combined loss, the optimizer, one train step,
``fit`` and ``cli.train``, against the JAX package on the CPU.

Weights are one Flax-layout tree (``random_flax_variables``) given to both
sides: as-is to JAX, through ``state_dict_from_flax`` to the port. JAX's
gradients go through the same converter (it is linear: transposes and a
flip), so every tensor is compared in the port's layout. Tolerances: 1e-5
relative for forwards and losses, 1e-4 for gradients and BN statistics
after a backward (fp32 summation order), 1e-6 for the optimizer fed
identical gradients.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodenoiser_tpu.dsp.mel import mel_filterbank as jax_filterbank
from audiodenoiser_tpu.dsp.mel import mel_spectrogram as jax_mel
from audiodenoiser_tpu.losses import spectral as jax_loss
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.train import loop as jax_loop
from audiodenoiser_torch.dsp.mel import mel_filterbank, mel_spectrogram
from audiodenoiser_torch.losses import spectral as port_loss
from audiodenoiser_torch.models import UNet, random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.models.unet import BatchNorm2d
from audiodenoiser_torch.train import loop as port_loop

NARROW = dict(features=(8, 16, 24, 32), bottleneck=48)
TINY = dict(features=(4, 8), bottleneck=16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nchw(x):  # NHWC numpy -> NCHW torch
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _port_model(variables, **kw):
    model = UNet(**{**NARROW, **kw})
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(0, **NARROW)


class TestBatchNormFault:
    """Train-mode BN folds Flax's biased batch variance into running_var."""

    def test_running_var_matches_flax(self):
        import flax.linen as nn

        x = (1.3 * np.random.default_rng(5).standard_normal((4, 3, 5, 6))).astype(np.float32)
        bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        xn = jnp.asarray(x.transpose(0, 2, 3, 1))
        v = bn.init(jax.random.key(0), xn)
        y_ref, upd = bn.apply(v, xn, mutable=["batch_stats"])
        ref_var = np.asarray(upd["batch_stats"]["var"])

        ours = BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
        y = ours(torch.from_numpy(x))
        np.testing.assert_allclose(ours.running_var.numpy(), ref_var, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ours.running_mean.numpy(),
                                   np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(y_ref), atol=1e-5)
        assert int(ours.num_batches_tracked) == 1
        # torch's own layer folds the unbiased variance: the fault repaired
        plain = torch.nn.BatchNorm2d(3, eps=1e-5, momentum=0.1).train()
        plain(torch.from_numpy(x))
        n = 4 * 5 * 6
        np.testing.assert_allclose(plain.running_var.numpy() - 0.9,
                                   (ref_var - 0.9) * n / (n - 1), rtol=1e-5)
        assert np.abs(plain.running_var.numpy() - ref_var).max() > 1e-4

    def test_eval_mode_reads_running_stats(self):
        bn = BatchNorm2d(2).eval()
        bn.running_mean.fill_(1.0)
        bn.running_var.fill_(4.0)
        x = torch.full((1, 2, 3, 3), 3.0)
        torch.testing.assert_close(bn(x), torch.full_like(x, 2.0 / np.sqrt(4.0 + 1e-5)))
        assert int(bn.num_batches_tracked) == 0


class TestUNetTrainMode:
    @pytest.mark.parametrize("pallas_deconv", [False, True])
    def test_eval_forward_fp32(self, variables, pallas_deconv):
        x = np.abs(np.random.default_rng(1).standard_normal((2, 32, 48, 1))).astype(np.float32)
        ref = FlaxUNet(**NARROW, pallas_deconv=pallas_deconv).apply(variables, jnp.asarray(x))
        model = _port_model(variables, pallas_deconv=pallas_deconv).eval()
        with torch.no_grad():
            ours = model(_nchw(x))
        assert _rel(ours.numpy().transpose(0, 2, 3, 1), ref) < 1e-5

    def test_train_forward_and_running_stats(self, variables):
        """Batch statistics amplify fp32 rounding: at this shape JAX's own
        CPU forward lies 6.5e-6 from a float64 forward, the port's 2e-6."""
        x = np.abs(np.random.default_rng(2).standard_normal((4, 64, 48, 1))).astype(np.float32)
        ref, upd = FlaxUNet(**NARROW, pallas_deconv=True).apply(
            variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        model = _port_model(variables, pallas_deconv=True).train()
        with torch.no_grad():
            ours = model(_nchw(x))
        assert _rel(ours.numpy().transpose(0, 2, 3, 1), ref) < 1e-5
        exact = _port_model(variables, dtype=torch.float64).double()
        with torch.no_grad():
            assert _rel(ours, exact.train()(_nchw(x).double())) < 1e-5
        want = state_dict_from_flax({"params": variables["params"],
                                     "batch_stats": jax.device_get(upd["batch_stats"])})
        got = model.state_dict()
        stats = [k for k in want if "running" in k]
        assert len(stats) == 2 * 2 * 9
        for k in stats:
            assert _rel(got[k].numpy(), want[k].numpy()) < 1e-5, k
            assert int(got[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == 1

    def test_bf16_forward(self, variables):
        """bf16 convolutions on both sides; they round at other places (and
        the JAX module adds the Cout < 128 deconv bias in bf16 after
        rounding, K3 in fp32 before), so the bound is the repo's bf16 one,
        0.02 (tests/test_torch_unet.py)."""
        x = np.abs(np.random.default_rng(3).standard_normal((2, 32, 48, 1))).astype(np.float32)
        ref = FlaxUNet(**NARROW, dtype=jnp.bfloat16, pallas_deconv=True).apply(
            variables, jnp.asarray(x))
        model = _port_model(variables, dtype=torch.bfloat16, pallas_deconv=True).eval()
        with torch.no_grad():
            ours = model(_nchw(x))
        assert ours.dtype == torch.float32
        assert _rel(ours.numpy().transpose(0, 2, 3, 1), ref) < 0.02

    def test_channels_last_activations(self, variables):
        model = _port_model(variables, pallas_deconv=True).eval()
        seen = []
        model.upconv1.up.register_forward_hook(lambda m, i, o: seen.append(
            (i[0].is_contiguous(memory_format=torch.channels_last),
             o.is_contiguous(memory_format=torch.channels_last))))
        with torch.no_grad():
            model(torch.rand(2, 1, 32, 32))
        assert seen == [(True, True)]


class TestLoss:
    @pytest.fixture
    def pair(self):
        rng = np.random.default_rng(4)
        return (np.abs(rng.standard_normal((3, 256, 64))).astype(np.float32),
                np.abs(rng.standard_normal((3, 256, 64))).astype(np.float32))

    def test_filterbank_is_a_copy(self):
        np.testing.assert_array_equal(mel_filterbank(32, 0.0, 4000.0, 64, 8000),
                                      jax_filterbank(32, 0.0, 4000.0, 64, 8000))

    @pytest.mark.parametrize("n", [64, 100])
    def test_mel_spectrogram(self, n):
        x = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32)
        ref = np.asarray(jax_mel(jnp.asarray(x)))
        ours = mel_spectrogram(torch.from_numpy(x)).numpy()
        assert ours.shape == ref.shape
        assert _rel(ours, ref) < 1e-5

    @pytest.mark.parametrize("term", ["multi_scale_stft_loss", "mel_loss", "l1_loss"])
    def test_each_term(self, pair, term):
        p, t = pair
        ref = float(getattr(jax_loss, term)(jnp.asarray(p)[..., None], jnp.asarray(t)[..., None]))
        ours = float(getattr(port_loss, term)(torch.from_numpy(p)[:, None],
                                              torch.from_numpy(t)[:, None]))
        assert abs(ours - ref) <= 1e-5 * abs(ref)

    @pytest.mark.parametrize("rank", [4, 3, 2])
    def test_total_and_layouts(self, pair, rank):
        p, t = pair
        ref = jax_loss.combined_perceptual_loss(jnp.asarray(p)[..., None],
                                                jnp.asarray(t)[..., None])
        pt, tt = torch.from_numpy(p), torch.from_numpy(t)
        if rank == 4:
            pt, tt = pt[:, None], tt[:, None]
        elif rank == 2:  # unbatched: compare against JAX on the first item
            ref = jax_loss.combined_perceptual_loss(jnp.asarray(p[0]), jnp.asarray(t[0]))
            pt, tt = pt[0], tt[0]
        ours = port_loss.combined_perceptual_loss(pt, tt)
        for a, b in zip(ours, ref):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))

    def test_gradient_wrt_pred(self, pair):
        p, t = pair
        ref = jax.grad(lambda q: jax_loss.combined_perceptual_loss(
            q, jnp.asarray(t)[..., None]).total)(jnp.asarray(p)[..., None])
        pt = torch.from_numpy(p)[:, None].requires_grad_()
        port_loss.combined_perceptual_loss(pt, torch.from_numpy(t)[:, None]).total.backward()
        ref = np.asarray(ref)[..., 0]
        assert np.abs(pt.grad[:, 0].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def _jax_state(variables, model, lr=1e-4):
    state = jax_loop.create_train_state(jax.random.key(0), model, learning_rate=lr,
                                        input_shape=(1, 32, 32, 1))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return state.replace(params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                         opt_state=state.tx.init(params))


def _batch(seed, b=2, f=32, t=32):
    rng = np.random.default_rng(seed)
    noisy = np.abs(rng.standard_normal((b, f, t, 1))).astype(np.float32)
    return noisy, (0.8 * noisy + 0.1 * rng.random((b, f, t, 1))).astype(np.float32)


class TestOptimizer:
    @pytest.mark.parametrize("scale", [1e-3, 10.0])  # below and above the clip
    def test_three_steps_match_optax(self, scale):
        rng = np.random.default_rng(6)
        shapes = [(3, 4), (5,), (2, 2, 3)]
        p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        grads = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
                 for _ in range(3)]
        tx = jax_loop.make_optimizer(1e-2)
        jp = [jnp.asarray(p) for p in p0]
        opt = tx.init(jp)
        params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        ours = port_loop.make_optimizer(params, 1e-2)
        for g in grads:
            upd, opt = tx.update([jnp.asarray(x) for x in g], opt, jp)
            jp = optax.apply_updates(jp, upd)
            for p, x in zip(params, g):
                p.grad = torch.from_numpy(x.copy())
            norm = ours.step()
            assert abs(float(norm) - float(np.sqrt(sum((x ** 2).sum() for x in g)))) \
                <= 1e-5 * float(norm)
        for a, b in zip(params, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)

    def test_weight_decay_reaches_every_parameter(self):
        """optax's adamw has no mask here: BN scale and biases decay too."""
        p = torch.nn.Parameter(torch.ones(3))
        opt = port_loop.make_optimizer([p], learning_rate=0.1, weight_decay=0.5)
        p.grad = torch.zeros(3)
        opt.step()
        torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.1 * 0.5))


class TestTrainStep:
    @pytest.fixture(scope="class")
    def tiny(self):
        return random_flax_variables(1, **TINY)

    def test_one_step_matches_jax(self, tiny):
        noisy, clean = _batch(7)
        model = FlaxUNet(**TINY)
        jstate = _jax_state(tiny, model)
        losses, new_bs, grads = jax.jit(jax_loop._loss_and_updates)(
            jstate, jnp.asarray(noisy), jnp.asarray(clean))
        updates, _ = jstate.tx.update(grads, jstate.opt_state, jstate.params)
        new_params = optax.apply_updates(jstate.params, updates)

        state = port_loop.create_train_state(0, UNet(**TINY), variables=tiny, device="cpu")
        state, ours = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
        assert state.step == 1
        for a, b in zip(ours, losses):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))

        g_ref = state_dict_from_flax({"params": jax.device_get(grads),
                                      "batch_stats": jax.device_get(new_bs)})
        # the port's gradients are clipped in place; the norm is logged
        g_norm = float(state.grad_norm)
        ref_norm = float(optax.global_norm(grads))
        assert abs(g_norm - ref_norm) <= 1e-4 * ref_norm
        after = state_dict_from_flax({"params": jax.device_get(new_params),
                                      "batch_stats": jax.device_get(new_bs)})
        got = state.model.state_dict()
        for k in (k for k in after if "running" in k):
            assert _rel(got[k].numpy(), after[k].numpy()) < 1e-4, k
        scale = min(1.0, 1.0 / ref_norm)
        for name, p in state.model.named_parameters():
            if name.endswith(("double_conv.0.bias", "double_conv.3.bias")):
                # a conv bias that feeds train-mode BN has a zero gradient:
                # both sides hold rounding noise there
                assert float(p.grad.abs().max()) < 1e-6 * scale * ref_norm, name
                continue
            assert _rel(p.grad.numpy(), scale * g_ref[name].numpy()) < 1e-4, name
        # parameters after the update: AdamW moves each by about lr, so the
        # ones with a real gradient agree to the update's rounding
        for name, p in state.model.named_parameters():
            if not name.endswith(("double_conv.0.bias", "double_conv.3.bias")):
                assert np.abs(p.detach().numpy() - after[name].numpy()).max() < 1e-6, name

    def test_eval_step_leaves_stats(self, tiny):
        noisy, clean = _batch(8)
        state = port_loop.create_train_state(0, UNet(**TINY), variables=tiny, device="cpu")
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        out = port_loop.eval_step(state, _nchw(noisy), _nchw(clean))
        ref = jax_loop.eval_step(_jax_state(tiny, FlaxUNet(**TINY)),
                                 jnp.asarray(noisy), jnp.asarray(clean))
        for a, b in zip(out, ref):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        for k, v in state.model.state_dict().items():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)

    def test_loss_decreases_and_clip_bounds_update(self):
        state = port_loop.create_train_state(0, UNet(**TINY), learning_rate=1e-3,
                                             device="cpu")
        noisy, clean = _batch(9)
        first = None
        for _ in range(20):
            state, losses = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
            first = float(losses.total) if first is None else first
        assert float(losses.total) < first
        big = port_loop.create_train_state(0, UNet(**TINY), learning_rate=1.0, device="cpu")
        port_loop.train_step(big, torch.full((1, 1, 32, 32), 1e6), torch.zeros(1, 1, 32, 32))
        assert all(torch.isfinite(p).all() for p in big.model.parameters())

    def test_flax_like_init(self):
        model = port_loop.init_flax_like(UNet(features=(64, 128), bottleneck=256), seed=3)
        w = model.downconv2.conv.double_conv[3].weight
        assert abs(float(w.std()) * np.sqrt(128 * 9) - 1.0) < 0.02
        assert float(w.abs().max()) <= 2.0 / 0.87962566103423978 / np.sqrt(128 * 9) + 1e-6
        assert all(float(m.bias.abs().max()) == 0 for m in model.modules()
                   if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)))
        again = port_loop.init_flax_like(UNet(features=(64, 128), bottleneck=256), seed=3)
        torch.testing.assert_close(again.state_dict(), model.state_dict(), rtol=0, atol=0)

    def test_entry_points_default_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_loop.create_train_state(0, UNet(**TINY))


def _write_npy_dataset(d, n=8, shape=(70, 40)):
    rng = np.random.default_rng(0)
    for i in range(n):
        clean = np.abs(rng.standard_normal(shape)).astype(np.float32)
        noisy = clean + 0.3 * np.abs(rng.standard_normal(shape)).astype(np.float32)
        np.save(d / f"clean_chunk_{i}.npy", clean)
        np.save(d / f"noisy_chunk_{i}.npy", noisy)


def _tiny_unet(dtype=torch.float32, **kw):
    return UNet(**TINY, dtype=dtype)


class TestFit:
    def test_fit_end_to_end_npy(self, tmp_path, monkeypatch):
        from audiodenoiser_torch.data.dataset import SpectrogramPairs, batches, split_train_val
        from audiodenoiser_torch.eval.runner import load_model_for_noise

        monkeypatch.setattr(port_loop, "UNet", _tiny_unet)
        data_dir = tmp_path / "npy"
        data_dir.mkdir()
        _write_npy_dataset(data_dir)
        ds = SpectrogramPairs(str(data_dir), target_size=(64, 32))
        tr, va = split_train_val(len(ds), 0.25, seed=0)
        cfg = port_loop.FitConfig(run_name="t1", output_path=str(tmp_path / "out"),
                                  epochs=2, batch_size=4, precision="f32", log_every=1,
                                  device="cpu")
        res = fit_res = port_loop.fit(cfg, lambda e: batches(ds, tr, 4, True, seed=e),
                                      lambda: batches(ds, va, 4, False))
        run_dir = res["run_dir"]
        log_text = open(os.path.join(run_dir, "training.log")).read()
        assert "steps/s" in log_text and "step 1 (epoch 1)" in log_text
        csv_text = open(os.path.join(run_dir, "tensorboard_logs", "scalars.csv")).read()
        assert "Loss/train_batch" in csv_text and "Loss/validation" in csv_text
        assert len(res["history"]) == 2 and np.isfinite(res["best_val"])
        import json

        meta = json.load(open(os.path.splitext(res["best_path"])[0] + ".val.json"))
        assert meta["val_loss"] == pytest.approx(fit_res["best_val"])
        from audiodenoiser_torch.train.checkpoints import load_exported

        model = UNet(**TINY)
        model.load_state_dict(state_dict_from_flax(load_exported(res["best_path"])), strict=True)
        # the .ckpt export loads through the serving loader
        monkeypatch.setattr("audiodenoiser_torch.eval.runner.UNet", lambda **kw: UNet(**TINY))
        os.replace(res["best_path"], tmp_path / "unet_denoiser_white.ckpt")
        folded = load_model_for_noise("white", str(tmp_path), device="cpu")
        assert folded(torch.rand(1, 1, 32, 32)).shape == (1, 1, 32, 32)

    def test_fit_aborts_on_non_finite_loss(self, tmp_path, monkeypatch):
        monkeypatch.setattr(port_loop, "UNet", _tiny_unet)
        bad = np.full((2, 1, 32, 32), np.nan, np.float32)
        cfg = port_loop.FitConfig(run_name="nan", output_path=str(tmp_path), epochs=1,
                                  precision="f32", device="cpu")
        with pytest.raises(FloatingPointError):
            port_loop.fit(cfg, lambda e: iter([(bad, bad)]), lambda: iter([]))

    def test_fit_with_state_factory_and_mixer(self, tmp_path):
        from audiodenoiser_torch.data.pipeline import OnDeviceMixer
        from audiodenoiser_torch.ops.cuda import deconv_kernel

        rng = np.random.default_rng(0)
        chunks = np.clip(rng.standard_normal((8, 16000)) * 0.2, -1, 1).astype(np.float32)
        mixer = OnDeviceMixer(chunks, "white", target_size=(64, 32), device="cpu")
        gen = torch.Generator().manual_seed(0)
        cfg = port_loop.FitConfig(run_name="odm", output_path=str(tmp_path), epochs=1,
                                  batch_size=4, precision="f32")
        res = port_loop.fit(
            cfg, lambda e: (mixer.sample(gen, 4) for _ in range(2)),
            lambda: iter([mixer.sample(gen, 4)]),
            state_factory=lambda: port_loop.create_train_state(
                0, UNet(**TINY, pallas_deconv=True), device="cpu"))
        assert np.isfinite(res["best_val"]) and res["steps"] == 2
        assert deconv_kernel.launches == 0  # CPU tensors take the plain version


class TestBenches:
    def test_inference_bench_pallas_deconv_on_cpu(self):
        from audiodenoiser_torch.eval.bench import build_runner, run_bench

        out = run_bench(batch_size=1, clip_seconds=0.25, iters=1, warmup=0, device="cpu",
                        pallas_deconv=True)
        assert out["value"] > 0 and out["pallas_deconv"] and "K3" in out["metric"]
        runner = build_runner(0, device="cpu", pallas_deconv=True)
        assert runner.model.pallas_deconv and runner.model.dtype == torch.bfloat16


class TestTrainCLI:
    def test_cli_npy_pipeline(self, tmp_path, monkeypatch):
        from audiodenoiser_torch.cli.train import main

        monkeypatch.setattr(port_loop, "UNet", _tiny_unet)
        data_dir = tmp_path / "white"
        data_dir.mkdir()
        _write_npy_dataset(data_dir, n=6, shape=(257, 122))
        out = main(["--base_dataset_path", str(tmp_path), "--noise_type", "white",
                    "--output_path", str(tmp_path / "runs"), "--run_name", "clirun",
                    "--epochs", "1", "--batch_size", "2", "--precision", "f32",
                    "--device", "cpu", "--export_dir", str(tmp_path / "saved_models")])
        assert os.path.exists(tmp_path / "saved_models" / "unet_denoiser_white.ckpt")
        assert os.path.exists(out["best_path"])

    def test_cli_on_device_pipeline(self, tmp_path, monkeypatch):
        from audiodenoiser_torch.cli.train import main
        from audiodenoiser_torch.data.wav_io import write_wav

        monkeypatch.setattr(port_loop, "UNet", _tiny_unet)
        clean = tmp_path / "data" / "clean"
        clean.mkdir(parents=True)
        rng = np.random.default_rng(1)
        for i in range(3):
            write_wav(str(clean / f"c{i}.wav"),
                      np.clip(0.3 * rng.standard_normal(40000), -1, 1), 8000)
        out = main(["--base_dataset_path", str(tmp_path / "data"), "--pipeline", "on_device",
                    "--noise_type", "white", "--output_path", str(tmp_path / "runs"),
                    "--epochs", "1", "--steps_per_epoch", "2", "--batch_size", "2",
                    "--precision", "f32", "--device", "cpu", "--augment",
                    "--snr_min", "0", "--snr_max", "10",
                    "--export_dir", str(tmp_path / "saved")])
        assert os.path.exists(tmp_path / "saved" / "unet_denoiser_white.ckpt")
        assert out["steps"] == 2

    @pytest.mark.parametrize("flag", [["--pp_microbatches", "8"], ["--pp_stages", "4"],
                                      ["--pp_stages", "2", "--mesh", "on"],
                                      ["--pp_stages", "2"]])
    def test_unported_flags_name_their_roadmap_item(self, tmp_path, monkeypatch, flag):
        """The pipeline flags are ported (ROADMAP A.11) and do what JAX's CLI
        does with them: ``--pp_microbatches`` alone changes nothing (the
        plain ``fit`` runs), ``--pp_stages S`` trains the 1F1B pipeline with
        S stages (here on the CPU), and ``--mesh`` is ignored beside it."""
        from audiodenoiser_torch.cli.train import main

        monkeypatch.setattr(port_loop, "UNet", _tiny_unet)
        data_dir = tmp_path / "white"
        data_dir.mkdir()
        _write_npy_dataset(data_dir, n=9, shape=(257, 122))
        out = main(["--base_dataset_path", str(tmp_path), "--noise_type", "white",
                    "--output_path", str(tmp_path / "runs"), "--run_name", "pp", "--epochs", "1",
                    "--batch_size", "4", "--precision", "f32", "--device", "cpu", *flag])
        log = (tmp_path / "runs" / "pp" / "training.log").read_text()
        stages = int(flag[1]) if flag[0] == "--pp_stages" else 0
        assert ("1F1B pipeline-parallel run: mesh {'data': 1, 'stage': %d}" % stages in log) \
            == bool(stages)
        assert ("trainer" in out) == bool(stages)
        assert "Device mesh" not in log
        if stages:
            assert len(out["state"].stages) == stages and out["state"].step == 2
        assert out["exported_best"] and os.path.exists(out["best_path"])
