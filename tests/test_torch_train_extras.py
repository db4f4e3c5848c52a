"""The training extras against the JAX package on the CPU: the learning-rate
schedules and gradient accumulation of ``make_optimizer`` (optax's
``linear_schedule``, ``warmup_cosine_decay_schedule`` and ``MultiSteps``),
``fit`` with an EMA, resume, ``UNet(remat=True)``, the mask family's
optimizer keywords, ``utils.profiling`` and ``cli.train``'s flags for them
(with ``--sample_rate`` and ``--chunk_seconds``).

Models are narrow (``features=(4, 8)``, as the JAX tests); JAX's weights
reach the port through ``state_dict_from_flax``. Tolerances: 1e-6 for the
optimizer fed identical gradients and for the schedules' rates (relative to
the peak rate); 1e-5 relative for a step's losses and 1e-4 for its
gradients and BN statistics (fp32 summation order, as
``tests/test_torch_train.py``); for ``fit`` after several updates, 1e-5
for the training losses and 1e-4 for the exported and EMA parameters but
the conv biases that feed a train-mode BatchNorm (``test_ema_fit_matches_jax``
says why). A resumed run on the CPU is bit-equal to an uninterrupted one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodenoiser_torch.models import UNet, random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet
from audiodenoiser_torch.train import checkpoints as port_ckpt
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_torch.train import mask as port_mask
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_torch.train.checkpoints import load_exported
from audiodenoiser_torch.utils.profiling import maybe_trace, timed
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.train import loop as jax_loop

TINY = dict(features=(4, 8), bottleneck=16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nchw(x):  # NHWC numpy -> NCHW torch
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _batch(seed, b=2, f=32, t=32):
    rng = np.random.default_rng(seed)
    noisy = np.abs(rng.standard_normal((b, f, t, 1))).astype(np.float32)
    return noisy, (0.8 * noisy + 0.1 * rng.random((b, f, t, 1))).astype(np.float32)


def _jax_state(variables, model, lr=1e-4, **opt):
    state = jax_loop.create_train_state(jax.random.key(0), model, learning_rate=lr,
                                        input_shape=(1, 32, 32, 1), **opt)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return state.replace(params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                         opt_state=state.tx.init(params))


OPT_CASES = {
    "warmup": dict(schedule="constant", warmup_steps=3),
    "cosine": dict(schedule="cosine", warmup_steps=2, total_steps=8),
    "cosine_no_warmup": dict(schedule="cosine", total_steps=6),
    "accum2": dict(grad_accum=2),
    "accum3": dict(grad_accum=3),
    "cosine_accum2": dict(schedule="cosine", warmup_steps=1, total_steps=7, grad_accum=2),
}


class TestOptimizer:
    @pytest.mark.parametrize("case", sorted(OPT_CASES))
    def test_updates_match_optax(self, case):
        """Seven updates (7k micro-steps) on gradients above and below the
        clip: every micro-step's parameters within 1e-6 of optax's, and
        bit-equal to the last update's between updates."""
        opt_kw = OPT_CASES[case]
        k = opt_kw.get("grad_accum", 1)
        rng = np.random.default_rng(6)
        shapes = [(3, 4), (5,), (2, 2, 3)]
        p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        tx = jax_loop.make_optimizer(1e-2, **opt_kw)
        jp = [jnp.asarray(p) for p in p0]
        opt_state = tx.init(jp)
        params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        ours = port_loop.make_optimizer(params, 1e-2, **opt_kw)
        for i in range(7 * k):
            scale = 10.0 if i % 3 == 0 else 1e-3
            g = [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
            upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
            jp = optax.apply_updates(jp, upd)
            if ours.micro_step == 0:
                ours.zero_grad()
            before = [p.detach().clone() for p in params]
            for p, x in zip(params, g):  # backward passes sum into .grad
                t = torch.from_numpy(x.copy())
                p.grad = t if p.grad is None else p.grad + t
            norm = ours.step()
            updated = (i + 1) % k == 0
            assert (norm is not None) == updated
            if not updated:
                assert all(torch.equal(a, b) for a, b in zip(params, before))
            for a, b in zip(params, jp):
                np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=0)
        assert ours.updates == 7

    def test_first_warmup_update_uses_rate_zero(self):
        """optax.linear_schedule(0, lr, w) at count 0: the parameters stay
        bit-equal while the AdamW moments move."""
        p = torch.nn.Parameter(torch.ones(4))
        opt = port_loop.make_optimizer([p], 1e-2, schedule="constant", warmup_steps=4)
        p.grad = torch.full((4,), 0.5)
        opt.step()
        assert torch.equal(p.detach(), torch.ones(4))
        assert float(opt.adamw.state[p]["exp_avg"].abs().sum()) > 0

    @pytest.mark.parametrize("kw", [dict(schedule="constant", warmup_steps=5),
                                    dict(schedule="cosine", warmup_steps=3, total_steps=20),
                                    dict(schedule="cosine", total_steps=9)])
    def test_rates_match_optax(self, kw):
        if kw["schedule"] == "constant":
            ref = optax.linear_schedule(0.0, 3e-3, kw["warmup_steps"])
        else:
            ref = optax.warmup_cosine_decay_schedule(0.0, 3e-3, max(1, kw.get("warmup_steps", 0)),
                                                     decay_steps=kw["total_steps"])
        ours = port_loop.learning_rate_schedule(3e-3, **kw)
        for count in range(25):
            assert abs(ours(count) - float(ref(count))) <= 1e-6 * 3e-3, count

    def test_constant_without_warmup_has_no_schedule(self):
        assert port_loop.learning_rate_schedule(1e-3) is None

    @pytest.mark.parametrize("kw,match", [
        (dict(schedule="cosine"), "total_steps"),
        (dict(schedule="cosine", warmup_steps=4, total_steps=4), "decay_steps"),
        (dict(schedule="linear"), "unknown schedule"),
    ])
    def test_refusals_match_optax(self, kw, match):
        with pytest.raises(ValueError, match=match):
            port_loop.make_optimizer([torch.nn.Parameter(torch.ones(1))], 1e-3, **kw)
        with pytest.raises(ValueError):
            jax_loop.make_optimizer(1e-3, **kw)

    def test_accumulated_step_moves_bn_stats_every_micro_step(self):
        """Under grad_accum 2 a micro-step moves the running statistics and
        not the parameters, as JAX's train_step with MultiSteps."""
        state = port_loop.create_train_state(0, UNet(**TINY), learning_rate=1e-3,
                                             grad_accum=2, device="cpu")
        noisy, clean = _batch(3)
        p0 = {k: v.clone() for k, v in state.model.state_dict().items()}
        state, _ = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
        p1 = state.model.state_dict()
        names = dict(state.model.named_parameters())
        for k, v in p1.items():
            if k in names:
                assert torch.equal(v, p0[k]), k
            elif k.endswith("running_mean"):
                assert not torch.equal(v, p0[k]), k
        assert state.grad_norm is None and state.step == 1
        state, _ = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
        assert state.grad_norm is not None and state.optimizer.updates == 1
        assert any(not torch.equal(v, p0[k]) for k, v in state.model.state_dict().items()
                   if k in names)


class TestRemat:
    def test_remat_step_equals_plain_step(self):
        """One bf16 step with K3's path: the loss, every gradient, the
        running statistics and num_batches_tracked as without remat."""
        variables = random_flax_variables(1, **TINY)
        noisy, clean = _batch(4)
        got = []
        for remat in (False, True):
            model = UNet(**TINY, dtype=torch.bfloat16, pallas_deconv=True, remat=remat)
            state = port_loop.create_train_state(0, model, variables=variables, device="cpu")
            state, losses = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
            got.append((float(losses.total), {n: p.grad.clone()
                                              for n, p in model.named_parameters()},
                        model.state_dict()))
        (l0, g0, s0), (l1, g1, s1) = got
        assert abs(l1 - l0) <= 1e-6 * abs(l0)
        for n in g0:
            assert _rel(g1[n], g0[n]) <= 1e-6, n
        for k in s0:
            if k.endswith("num_batches_tracked"):
                assert int(s1[k]) == int(s0[k]) == 1, k
            else:
                assert _rel(s1[k], s0[k]) <= 1e-6, k

    def test_remat_step_matches_jax(self):
        """JAX's ``remat=True`` step on the input of
        ``tests/test_torch_train.py::test_one_step_matches_jax``, to its bounds."""
        variables = random_flax_variables(1, **TINY)
        noisy, clean = _batch(7)
        jstate = _jax_state(variables, FlaxUNet(**TINY, remat=True))
        losses, new_bs, grads = jax.jit(jax_loop._loss_and_updates)(
            jstate, jnp.asarray(noisy), jnp.asarray(clean))
        state = port_loop.create_train_state(0, UNet(**TINY, remat=True), variables=variables,
                                             device="cpu")
        state, ours = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
        for a, b in zip(ours, losses):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        ref_norm = float(optax.global_norm(grads))
        assert abs(float(state.grad_norm) - ref_norm) <= 1e-4 * ref_norm
        after = state_dict_from_flax({"params": jax.device_get(grads),
                                      "batch_stats": jax.device_get(new_bs)})
        got = state.model.state_dict()
        for k in (k for k in after if "running" in k):
            assert _rel(got[k].numpy(), after[k].numpy()) < 1e-4, k
        scale = min(1.0, 1.0 / ref_norm)
        for name, p in state.model.named_parameters():
            if not name.endswith(("double_conv.0.bias", "double_conv.3.bias")):
                assert _rel(p.grad.numpy(), scale * after[name].numpy()) < 1e-4, name


def _npy_batches(seed, n, b=2):
    return [_batch(seed + i, b) for i in range(n)]


class TestFitExtras:
    def test_ema_fit_matches_jax(self, tmp_path):
        """Two epochs of three steps with warm-up + cosine, grad_accum 2 and
        an EMA of 0.9 from the same weights and batches: the training losses
        within 1e-5 and the exported best and best-EMA parameters within
        1e-4, except the conv biases that feed a train-mode BatchNorm. Their
        gradient is zero but for rounding on both sides, which AdamW scales
        up to a step of about the rate, so they wander by up to 4 x rate an
        update apart; they act only in eval mode, which moves the
        validation losses (within 5%: 0.4-1.6% at this input)."""
        variables = random_flax_variables(3, **TINY)
        train = _npy_batches(10, 3)
        val = _npy_batches(20, 1)
        lr, opt = 1e-3, dict(schedule="cosine", warmup_steps=1, total_steps=6, grad_accum=2)
        jcfg = jax_loop.FitConfig(run_name="j", output_path=str(tmp_path), epochs=2,
                                  precision="f32", ema_decay=0.9, log_every=0)
        ref = jax_loop.fit(jcfg, lambda e: iter(train), lambda: iter(val),
                           state_factory=lambda: _jax_state(variables, FlaxUNet(**TINY),
                                                            lr=lr, **opt))
        pcfg = port_loop.FitConfig(run_name="p", output_path=str(tmp_path), epochs=2,
                                   precision="f32", ema_decay=0.9, log_every=0)
        ours = port_loop.fit(
            pcfg, lambda e: ((_nchw(a), _nchw(b)) for a, b in train),
            lambda: ((_nchw(a), _nchw(b)) for a, b in val),
            state_factory=lambda: port_loop.create_train_state(
                0, UNet(**TINY), learning_rate=lr, variables=variables, device="cpu", **opt))
        for h_ours, h_ref in zip(ours["history"], ref["history"], strict=True):
            assert abs(h_ours["train"] - h_ref["train"]) <= 1e-5 * abs(h_ref["train"])
            assert abs(h_ours["val"] - h_ref["val"]) <= 5e-2 * abs(h_ref["val"])
        assert ours["best_ema_path"].endswith("best_model_ema.ckpt")
        assert ours["exported_best_ema"] and ref["exported_best_ema"]
        updates = 3
        for path in ("best_path", "best_ema_path"):
            got = state_dict_from_flax(load_exported(ours[path]))
            want = state_dict_from_flax(load_exported(ref[path]))
            for k in (k for k in want if "running" not in k and "num_batches" not in k):
                if k.endswith(("double_conv.0.bias", "double_conv.3.bias")):
                    assert float((got[k] - want[k]).abs().max()) <= 4 * lr * updates, (path, k)
                else:
                    assert _rel(got[k], want[k]) < 1e-4, (path, k)
        raw, ema = (state_dict_from_flax(load_exported(ours[p]))
                    for p in ("best_path", "best_ema_path"))
        assert max(float((raw[k] - ema[k]).abs().max()) for k in raw) > 0

    @staticmethod
    def _fit(tmp_path, run, epochs, resume=False, **kw):
        train = [_npy_batches(30 + 3 * e, 3) for e in range(3)]
        val = _npy_batches(40, 1)
        cfg = port_loop.FitConfig(run_name=run, output_path=str(tmp_path), epochs=epochs,
                                  precision="f32", resume=resume, lr_schedule="cosine",
                                  warmup_steps=1, total_steps=9, grad_accum=2, ema_decay=0.9,
                                  log_every=0, device="cpu", learning_rate=1e-3, **kw)
        return port_loop.fit(cfg, lambda e: ((_nchw(a), _nchw(b)) for a, b in train[e]),
                             lambda: ((_nchw(a), _nchw(b)) for a, b in val))

    def test_resume_is_bit_equal(self, tmp_path, monkeypatch):
        """Three micro-steps an epoch under grad_accum 2, so an update spans
        the epochs: the summed gradients, the micro-step, AdamW, the
        schedule's count, the EMA and the BN statistics all carry over."""
        monkeypatch.setattr(port_loop, "UNet", lambda dtype, remat=False, **kw: UNet(
            **TINY, dtype=dtype, remat=remat))
        whole = self._fit(tmp_path, "whole", 2)
        self._fit(tmp_path, "split", 1)
        state_path = os.path.join(tmp_path, "split", "checkpoints", "train_state.pt")
        assert port_ckpt.saved_keys(state_path) == {
            "model", "optimizer", "step", "epoch", "best_val", "global_step", "ema",
            "best_ema_val"}
        assert port_ckpt.restore_train_state(state_path)["optimizer"]["micro_step"] == 1
        resumed = self._fit(tmp_path, "split", 2, resume=True)
        assert [h["epoch"] for h in resumed["history"]] == [1]
        assert resumed["history"][0] == whole["history"][1]
        assert resumed["steps"] == whole["steps"] == 6
        a, b = whole["state"], resumed["state"]
        assert a.step == b.step and a.optimizer.updates == b.optimizer.updates == 3
        for k, v in a.model.state_dict().items():
            assert torch.equal(v, b.model.state_dict()[k]), k
        sa, sb = (port_ckpt.restore_train_state(os.path.join(tmp_path, r, "checkpoints",
                                                             "train_state.pt"))
                  for r in ("whole", "split"))
        for n, t in sa["ema"].items():
            assert torch.equal(t, sb["ema"][n]), n
        for i, st in sa["optimizer"]["adamw"]["state"].items():
            for key, t in st.items():
                assert torch.equal(t, sb["optimizer"]["adamw"]["state"][i][key]), (i, key)
        assert sa["best_val"] == sb["best_val"] and sa["best_ema_val"] == sb["best_ema_val"]

    def test_resume_keeps_the_sidecar_floor(self, tmp_path, monkeypatch):
        """A resume state older than the best export (``ckpt_every``) must
        not let a worse model overwrite it; a fresh run ignores the floor."""
        monkeypatch.setattr(port_loop, "UNet", lambda dtype, remat=False, **kw: UNet(
            **TINY, dtype=dtype, remat=remat))
        res = self._fit(tmp_path, "floor", 1)
        meta = os.path.splitext(res["best_path"])[0] + ".val.json"
        assert json.load(open(meta))["val_loss"] == pytest.approx(res["best_val"])
        with open(meta, "w") as f:
            json.dump({"val_loss": -1e9, "epoch": 0}, f)
        again = self._fit(tmp_path, "floor", 2, resume=True)
        assert again["best_val"] == -1e9 and not again["exported_best"]
        assert json.load(open(meta))["val_loss"] == -1e9
        fresh = self._fit(tmp_path, "floor", 1)
        assert fresh["exported_best"] and fresh["best_val"] > -1e9

    def test_ckpt_every_writes_after_the_last_epoch(self, tmp_path, monkeypatch):
        monkeypatch.setattr(port_loop, "UNet", lambda dtype, remat=False, **kw: UNet(
            **TINY, dtype=dtype, remat=remat))
        self._fit(tmp_path, "every", 3, ckpt_every=2)
        state = port_ckpt.restore_train_state(os.path.join(tmp_path, "every", "checkpoints",
                                                           "train_state.pt"))
        assert state["epoch"] == 2 and state["global_step"] == 9

    def test_magnitude_best_model_is_a_ckpt(self, tmp_path, monkeypatch):
        """The U-Net's best model is the JAX package's .ckpt, which the
        serving loader reads."""
        from audiodenoiser_torch.eval.runner import load_model_for_noise

        monkeypatch.setattr(port_loop, "UNet", lambda dtype, remat=False, **kw: UNet(
            **TINY, dtype=dtype, remat=remat))
        res = self._fit(tmp_path, "ckpt", 1)
        assert res["best_path"].endswith("best_model.ckpt")
        tree = load_exported(res["best_path"])
        want = res["state"].model.state_dict()
        for k, v in state_dict_from_flax(tree).items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, want[k]), k
        monkeypatch.setattr("audiodenoiser_torch.eval.runner.UNet", lambda **kw: UNet(**TINY))
        os.replace(res["best_path"], tmp_path / "unet_denoiser_white.ckpt")
        folded = load_model_for_noise("white", str(tmp_path), device="cpu")
        assert folded(torch.rand(1, 1, 32, 32)).shape == (1, 1, 32, 32)


class TestMaskFamily:
    def test_mask_state_takes_the_optimizer_keywords(self):
        """grad_accum 2 with warm-up + cosine on the mask step (the iSTFT in
        its loss): micro-steps leave the parameters, the first update runs
        at rate 0, the second moves them."""
        model = ComplexMaskUNet(**TINY, mask_bound=2.0, residual=True)
        state = port_mask.create_mask_train_state(0, model, learning_rate=1e-3, device="cpu",
                                                  schedule="cosine", warmup_steps=1,
                                                  total_steps=4, grad_accum=2)
        audio = torch.from_numpy(synth_chunks(2, seed=4))
        noisy, clean = audio + 0.05 * torch.randn(audio.shape, generator=torch.Generator()
                                                  .manual_seed(0)), audio
        p0 = [p.detach().clone() for p in model.parameters()]
        for i in range(4):
            state, losses = port_mask.mask_train_step(state, noisy, clean)
            assert np.isfinite(float(losses.total))
            same = all(torch.equal(a, b) for a, b in zip(model.parameters(), p0))
            assert same == (i < 3), i
        assert state.optimizer.updates == 2


class TestProfiling:
    def test_timed_returns_mean(self):
        out = timed(lambda: torch.ones(8) * 2, warmup=1, iters=3)
        assert out["iters"] == 3 and out["mean_s"] > 0

    def test_maybe_trace_noop_without_dir(self):
        with maybe_trace(None):
            x = torch.ones(4).sum()
        assert float(x) == 4.0

    def test_maybe_trace_writes_profile(self, tmp_path):
        d = str(tmp_path / "trace")
        with maybe_trace(d):
            torch.ones(64).sum()
        files = [f for _, _, fs in os.walk(d) for f in fs]
        assert files and all(f.endswith(".json") for f in files)


def _wavs(root, rate):
    from audiodenoiser_torch.data.wav_io import write_wav

    (root / "clean").mkdir(parents=True)
    for i, chunk in enumerate(synth_chunks(8, seed=11).reshape(2, -1)):
        write_wav(str(root / "clean" / f"c{i}.wav"), chunk, rate)


class TestTrainCli:
    def test_sample_rate_and_window_reach_the_mixer(self, tmp_path, monkeypatch):
        """--sample_rate 16000 --chunk_seconds 1.5: 24000-sample chunks, a
        16 kHz reverb, and the magnitude family's sidecar, which the
        serving loader reads."""
        from audiodenoiser_torch.cli.train import main
        from audiodenoiser_torch.data import pipeline
        from audiodenoiser_torch.eval.runner import load_model_for_noise

        monkeypatch.setattr(port_loop, "UNet", lambda dtype, remat=False, **kw: UNet(
            **TINY, dtype=dtype, remat=remat))
        seen = []
        real_init = pipeline.OnDeviceMixer.__init__

        def spy(self, chunks, *a, **kw):
            seen.append((np.asarray(chunks).shape[1], kw.get("sample_rate")))
            real_init(self, chunks, *a, **kw)

        monkeypatch.setattr(pipeline.OnDeviceMixer, "__init__", spy)
        _wavs(tmp_path / "data", 16000)
        saved = tmp_path / "saved"
        out = main(["--base_dataset_path", str(tmp_path / "data"), "--pipeline", "on_device",
                    "--noise_type", "reverb", "--sample_rate", "16000", "--chunk_seconds",
                    "1.5", "--output_path", str(tmp_path / "runs"), "--epochs", "1",
                    "--steps_per_epoch", "2", "--batch_size", "2", "--precision", "f32",
                    "--device", "cpu", "--export_dir", str(saved)])
        assert out["steps"] == 2 and seen == [(24000, 16000), (24000, 16000)]
        meta = {"width_mult": 1.0, "sample_rate": 16000}
        for sidecar in (os.path.splitext(out["best_path"])[0] + ".json",
                        saved / "unet_denoiser_reverb.json"):
            assert json.load(open(sidecar)) == meta
        monkeypatch.setattr("audiodenoiser_torch.eval.runner.UNet", lambda **kw: UNet(**TINY))
        folded = load_model_for_noise("reverb", str(saved), device="cpu")
        assert folded(torch.rand(1, 1, 32, 32)).shape == (1, 1, 32, 32)

    @pytest.mark.parametrize("flag", [["--sample_rate", "16000"], ["--chunk_seconds", "4"]])
    def test_npy_refuses_rate_and_window(self, tmp_path, flag):
        from audiodenoiser_torch.cli.train import main

        with pytest.raises(SystemExit, match="requires --pipeline on_device"):
            main(["--base_dataset_path", str(tmp_path), "--noise_type", "white", *flag])

    def test_npy_with_extras_then_resume(self, tmp_path, monkeypatch):
        """Every training extra on the npy pipeline: the .ckpt export, the EMA
        export with its .val.json, a trace file; --resume runs only the
        epochs after the saved one."""
        from audiodenoiser_torch.cli.train import main

        monkeypatch.setattr(port_loop, "UNet", lambda dtype, remat=False, **kw: UNet(
            **TINY, dtype=dtype, remat=remat))
        data = tmp_path / "white"
        data.mkdir()
        rng = np.random.default_rng(0)
        for i in range(6):
            clean = np.abs(rng.standard_normal((257, 122))).astype(np.float32)
            np.save(data / f"clean_white_chunk_{i}.npy", clean)
            np.save(data / f"noisy_white_chunk_{i}.npy", clean + 0.3)
        flags = ["--base_dataset_path", str(tmp_path), "--noise_type", "white",
                 "--output_path", str(tmp_path / "runs"), "--run_name", "x",
                 "--batch_size", "2", "--precision", "f32", "--device", "cpu",
                 "--export_dir", str(tmp_path / "saved"), "--lr_schedule", "cosine",
                 "--warmup_steps", "1", "--grad_accum", "2", "--ema_decay", "0.99",
                 "--ckpt_every", "1", "--remat", "--profile_dir", str(tmp_path / "prof")]
        first = main(flags + ["--epochs", "1"])
        ckpts = os.listdir(os.path.join(first["run_dir"], "checkpoints"))
        assert {"best_model.ckpt", "best_model_ema.ckpt", "best_model_ema.val.json",
                "train_state.pt"} <= set(ckpts)
        assert os.listdir(tmp_path / "saved") == ["unet_denoiser_white.ckpt"]
        assert os.listdir(tmp_path / "prof")
        second = main(flags + ["--epochs", "2", "--resume"])
        assert [h["epoch"] for h in second["history"]] == [1]
        assert second["steps"] == 2 * first["steps"]
