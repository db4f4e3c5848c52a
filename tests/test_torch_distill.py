"""Port parity of knowledge distillation for compact mask students
(``train.mask.make_mask_steps(teacher=...)``, ``cli.train --distill_from``)
against the JAX package on the CPU.

A teacher at the two-level width of the mask step tests, (4, 8)/16, and a
half-width student, (2, 4)/8, both with the K3 upsampling path (its plain
version here, interpret mode in JAX), start from numpy trees shared by
both packages (``random_flax_variables``) and take the audio of
``tests/test_torch_mask_train.py``. The student and teacher share spatial
sizes at every level, so the attention maps compare with no projection.

Tolerances: the attention map 1e-6 absolute (fp32 over a plane normalised
to unit L2 norm); losses 1e-5 relative; gradients 1e-4 relative L2 (fp32
summation order through a backward); parameters after the AdamW update
1e-6 absolute, at every element where that gradient tolerance bounds the
step's change by 1e-6 (``_steady_elements``), and at every element when
the port's AdamW takes JAX's gradients; BatchNorm running statistics 1e-5
relative L2. The conv biases that feed a train-mode BatchNorm are left out
of the gradient and weight checks: their gradient is rounding alone on
both sides. A first AdamW step is ``lr * g / (|g| + eps)``: on an element
whose gradient is within rounding of 0 (the feature term leaves one in
the bottleneck's second conv, 1.6e-8 against JAX's 1.3e-8) it moves
4.5e-6 apart between the packages. The remaining cases are
JAX ``tests/test_distill.py``'s, on the port alone.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodenoiser_torch.models import ComplexMaskUNet, random_flax_variables
from audiodenoiser_torch.models import state_dict_from_flax
from audiodenoiser_torch.train import mask as port_mask
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_torch.train.checkpoints import export_model, load_exported
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMask
from audiodenoiser_tpu.train import mask as jax_mask
from audiodenoiser_tpu.train.checkpoints import export_model as jax_export_model
from audiodenoiser_tpu.train.checkpoints import load_exported as jax_load_exported
from tests.test_torch_mask_train import BN_FED_BIASES, _audio, _jax_state, _rel

TEACHER = dict(features=(4, 8), bottleneck=16)
STUDENT = dict(features=(2, 4), bottleneck=8)
TINY = dict(features=(4, 8), bottleneck=16)


def _variables(seed, widths):
    return random_flax_variables(seed, **widths, in_channels=3, out_channels=2)


def _port_model(variables, widths, **kw):
    model = ComplexMaskUNet(**widths, mask_bound=8.0, residual=True, pallas_deconv=True, **kw)
    model.load_state_dict(state_dict_from_flax(variables))
    return model


def _port_teacher(variables):
    return _port_model(variables, TEACHER).eval().requires_grad_(False)


def _port_state(variables, **kw):
    model = ComplexMaskUNet(**STUDENT, mask_bound=8.0, residual=True, pallas_deconv=True, **kw)
    return port_mask.create_mask_train_state(0, model, variables=variables, device="cpu")


def _jax_teacher(variables):
    model = FlaxMask(**TEACHER, mask_bound=8.0, residual=True, pallas_deconv=True)
    return model.apply, jax.tree_util.tree_map(jnp.asarray, variables)


def _jax_losses(state, params, noisy, clean, train, teacher, dw, fw):
    return jax_mask._mask_losses(state, params, noisy, clean, train=train, si_sdr_weight=0.5,
                                 si_sdr_clamp=30.0, teacher=teacher, distill_weight=dw,
                                 distill_feat_weight=fw)


class TestAttentionMap:
    @pytest.mark.parametrize("shape,dtype", [((2, 16, 8, 4), np.float32),
                                             ((3, 5, 16, 7), np.float32),
                                             ((2, 8, 4, 4), "bfloat16")])
    def test_matches_jax(self, shape, dtype):
        x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(x)
        j = jnp.asarray(x.transpose(0, 2, 3, 1))  # JAX is NHWC
        if dtype == "bfloat16":
            t, j = t.to(torch.bfloat16), j.astype(jnp.bfloat16)
        ours = port_mask._attention_map(t.contiguous(memory_format=torch.channels_last))
        ref = np.asarray(jax_mask._attention_map(j))
        assert ours.dtype == torch.float32 and ours.shape == ref.shape == (shape[0], *shape[2:])
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
        np.testing.assert_allclose(torch.linalg.vector_norm(ours, dim=(-2, -1)).numpy(), 1.0,
                                   rtol=1e-6)


LR, EPS = 1e-4, 1e-8  # the AdamW of the steps (optax's and the port's)


def _steady_elements(g):
    """Where a first AdamW step, ``lr * g / (|g| + eps)``, moves by less
    than 1e-6 when the gradient moves by the 1e-4 relative L2 these tests
    allow (``d = 1e-4 * ||g||``): ``|g| >= sqrt(lr * eps * d / 1e-6)``.
    Below that the gradient is rounding-level for its tensor and AdamW
    scales the rounding up to a step of order ``lr``, as it does on the
    conv biases that feed a train-mode BatchNorm."""
    d = 1e-4 * np.linalg.norm(g)
    return np.abs(g) >= np.sqrt(LR * EPS * d / 1e-6)


class TestDistilledStep:
    @pytest.mark.parametrize("dw,fw", [(0.5, 1.0), (0.0, 1.0), (0.5, 0.0)])
    def test_train_step_matches_jax(self, dw, fw):
        noisy, clean = _audio()
        t_vars, s_vars = _variables(5, TEACHER), _variables(1, STUDENT)
        jstate = _jax_state(s_vars, True, dict(**STUDENT, pallas_deconv=True))
        teacher = _jax_teacher(t_vars)

        def loss_fn(params):
            total, losses, new_bs = _jax_losses(jstate, params, jnp.asarray(noisy),
                                                jnp.asarray(clean), True, teacher, dw, fw)
            return total, (losses, new_bs)

        (_, (losses, new_bs)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jstate.params)
        updates, _ = jstate.tx.update(grads, jstate.opt_state, jstate.params)
        new_params = optax.apply_updates(jstate.params, updates)

        state = _port_state(s_vars)
        train_step, _ = port_mask.make_mask_steps(0.5, 30.0, teacher=_port_teacher(t_vars),
                                                  distill_weight=dw, distill_feat_weight=fw)
        state, ours = train_step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
        for a, b in zip(ours, losses):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))

        ref_norm = float(optax.global_norm(grads))
        assert abs(float(state.grad_norm) - ref_norm) <= 1e-4 * ref_norm
        g_ref = state_dict_from_flax({"params": jax.device_get(grads),
                                      "batch_stats": jax.device_get(new_bs)})
        after = state_dict_from_flax({"params": jax.device_get(new_params),
                                      "batch_stats": jax.device_get(new_bs)})
        scale = min(1.0, 1.0 / ref_norm)  # the port's gradients are clipped in place
        for name, p in state.model.named_parameters():
            if name.endswith(BN_FED_BIASES):
                continue
            g = scale * g_ref[name].numpy()
            assert _rel(p.grad.numpy(), g) < 1e-4, name
            held = _steady_elements(g)
            assert np.abs(p.detach().numpy() - after[name].numpy())[held].max() < 1e-6, name
        got = state.model.state_dict()
        for k in (k for k in after if "running" in k):
            assert _rel(got[k].numpy(), after[k].numpy()) < 1e-5, k
        # the port's AdamW on JAX's gradients (it clips them as optax does)
        # gives JAX's weights at every element, the rounding-level ones too
        fresh = _port_state(s_vars)
        for name, p in fresh.model.named_parameters():
            p.grad = torch.from_numpy(g_ref[name].numpy().copy())
        fresh.optimizer.step()
        for name, p in fresh.model.named_parameters():
            assert np.abs(p.detach().numpy() - after[name].numpy()).max() < 1e-6, name

    def test_eval_step_matches_jax(self):
        noisy, clean = _audio(2)
        t_vars, s_vars = _variables(5, TEACHER), _variables(3, STUDENT)
        jstate = _jax_state(s_vars, True, dict(**STUDENT, pallas_deconv=True))
        _, ref, _ = jax.jit(lambda n, c: _jax_losses(
            jstate, jstate.params, n, c, False, _jax_teacher(t_vars), 0.5, 1.0))(
            jnp.asarray(noisy), jnp.asarray(clean))
        _, eval_step = port_mask.make_mask_steps(0.5, 30.0, teacher=_port_teacher(t_vars),
                                                 distill_weight=0.5, distill_feat_weight=1.0)
        ours = eval_step(_port_state(s_vars), torch.from_numpy(noisy), torch.from_numpy(clean))
        for a, b in zip(ours, ref):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))

    def test_taps_fire_once_under_remat_and_leave_no_hook(self):
        """The bottleneck hook fires once a call with remat on, which gives
        the step of the model without remat, and no hook outlives a step."""
        noisy, clean = (torch.from_numpy(a) for a in _audio())
        t_vars, s_vars = _variables(5, TEACHER), _variables(1, STUDENT)
        teacher = _port_teacher(t_vars)
        fired = []
        teacher.bottleneck.register_forward_hook(lambda *a: fired.append(1))
        steps = port_mask.make_mask_steps(0.5, 30.0, teacher=teacher, distill_weight=0.5,
                                          distill_feat_weight=1.0)
        results = []
        for remat in (False, True):
            state = _port_state(s_vars, remat=remat)
            state, losses = steps[0](state, noisy, clean)
            assert not state.model.bottleneck._forward_hooks
            results.append((losses, {n: p.detach().clone()
                                     for n, p in state.model.named_parameters()}))
        assert len(fired) == 2 and len(teacher.bottleneck._forward_hooks) == 1
        (l0, w0), (l1, w1) = results
        for a, b in zip(l0, l1):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))
        for name, w in w0.items():
            if not name.endswith(BN_FED_BIASES):
                torch.testing.assert_close(w1[name], w, rtol=0, atol=1e-7)


def _tiny_teacher():
    """JAX ``test_distill.py``'s teacher: a zero-initialised residual head
    moved off the identity, here by +0.01 on every variable."""
    v = _variables(7, TINY)
    v = jax.tree_util.tree_map(lambda a: a + np.float32(0.01), v)
    model = ComplexMaskUNet(**TINY, mask_bound=2.0, residual=True)
    model.load_state_dict(state_dict_from_flax(v))
    return model.eval().requires_grad_(False), v


def _student(seed=0, widths=TINY, lr=1e-4):
    model = ComplexMaskUNet(**widths, residual=True, zero_out_init=True)
    return port_mask.create_mask_train_state(seed, model, learning_rate=lr, device="cpu")


def _batch(n=2, seed=1):
    rng = np.random.default_rng(seed)
    clean = 0.2 * rng.standard_normal((n, 16000)).astype(np.float32)
    noisy = clean + 0.1 * rng.standard_normal((n, 16000)).astype(np.float32)
    return torch.from_numpy(noisy), torch.from_numpy(clean)


def _eval_total(state, **kw):
    return float(port_mask.make_mask_steps(0.0, **kw)[1](state, *_batch()).total)


class TestDistillLoss:
    def test_distill_term_changes_total(self):
        teacher, _ = _tiny_teacher()
        state = _student()
        assert _eval_total(state, teacher=teacher, distill_weight=1.0) > _eval_total(state)

    def test_distill_gradient_pulls_student_toward_teacher(self):
        teacher, _ = _tiny_teacher()
        state = _student(lr=1e-2)
        tr, ev = port_mask.make_mask_steps(0.0, teacher=teacher, distill_weight=50.0)
        noisy, clean = _batch()
        first = float(ev(state, noisy, clean).total)
        for _ in range(5):
            state, _ = tr(state, noisy, clean)
        assert float(ev(state, noisy, clean).total) < first

    def test_teacher_without_weights_adds_nothing(self):
        teacher, _ = _tiny_teacher()
        state = _student()
        assert _eval_total(state, teacher=teacher) == _eval_total(state)


class TestFeatureDistill:
    def test_feature_term_zero_when_student_is_teacher(self):
        teacher, v = _tiny_teacher()
        state = port_mask.create_mask_train_state(
            0, ComplexMaskUNet(**TINY, mask_bound=2.0, residual=True), variables=v,
            device="cpu")
        np.testing.assert_allclose(
            _eval_total(state, teacher=teacher, distill_feat_weight=5.0), _eval_total(state),
            rtol=1e-6)

    def test_feature_term_nonzero_for_different_student(self):
        teacher, _ = _tiny_teacher()
        state = _student(seed=3)
        assert _eval_total(state, teacher=teacher, distill_feat_weight=5.0) > _eval_total(state)

    def test_feature_term_works_across_widths(self):
        """A narrower student trains against the tiny teacher and the
        train-mode total falls (eval mode sees the running statistics move
        early in training)."""
        teacher, _ = _tiny_teacher()
        state = _student(widths=dict(features=(2, 4), bottleneck=8), lr=1e-3)
        tr, _ = port_mask.make_mask_steps(0.0, teacher=teacher, distill_feat_weight=10.0)
        noisy, clean = _batch()
        totals = []
        for _ in range(10):
            state, losses = tr(state, noisy, clean)
            totals.append(float(losses.total))
        assert np.all(np.isfinite(totals)) and totals[-1] < totals[0]


class TestDistillCLI:
    def test_student_distilled_from_an_exported_teacher(self, tmp_path):
        """End to end at width 0.125 from a width-0.25 teacher export with
        both terms and ``--export_quantized``: the sidecar records the
        provenance with JAX's keys, the int8 export equals JAX's of the
        run's best tree, and the port's loader rebuilds the student."""
        from audiodenoiser_torch.cli.train import main
        from audiodenoiser_torch.data.wav_io import write_wav
        from audiodenoiser_torch.eval.runner import load_model_from_path
        from audiodenoiser_torch.models.unet import width_kwargs

        t_vars = _variables(7, width_kwargs(0.25))
        t_path = str(tmp_path / "mask_denoiser_teacher.ckpt")
        export_model(t_path, t_vars["params"], t_vars["batch_stats"])
        with open(tmp_path / "mask_denoiser_teacher.json", "w") as f:
            json.dump({"width_mult": 0.25, "mask_bound": 2.0, "residual": True}, f)
        (tmp_path / "data" / "clean").mkdir(parents=True)
        for i, chunk in enumerate(synth_chunks(6, seed=11).reshape(3, -1)):
            write_wav(str(tmp_path / "data" / "clean" / f"c{i}.wav"), chunk, 8000)
        saved = tmp_path / "sm"
        out = main(["--base_dataset_path", str(tmp_path / "data"), "--pipeline", "on_device",
                    "--model", "complex_mask", "--noise_type", "white", "--width_mult", "0.125",
                    "--distill_from", t_path, "--distill_weight", "1.0",
                    "--distill_features", "1.0", "--epochs", "1", "--batch_size", "2",
                    "--steps_per_epoch", "2", "--precision", "f32", "--device", "cpu",
                    "--run_name", "distillrun", "--output_path", str(tmp_path / "runs"),
                    "--export_dir", str(saved), "--export_quantized"])
        assert np.isfinite(out["best_val"])
        with open(saved / "mask_denoiser_white.json") as f:
            meta = json.load(f)
        assert meta == {"mask_bound": 2.0, "si_sdr_weight": 0.5, "si_sdr_clamp": 30.0,
                        "residual": True, "width_mult": 0.125, "distilled_from": t_path,
                        "distill_features": 1.0}
        best = jax_load_exported(out["best_path"])
        ref = str(tmp_path / "jax_int8.ckpt")
        jax_export_model(ref, best["params"], best["batch_stats"], quantize=True)
        dst = saved / "mask_denoiser_white.ckpt"
        assert open(dst, "rb").read() == open(ref, "rb").read()
        student = load_model_from_path(str(dst), dtype=torch.float32, device="cpu", fold=False)
        assert student.features == (8, 16, 32, 64) and student.mask_bound == 2.0
        assert sorted(load_exported(str(dst))["params"]) == sorted(best["params"])
        assert not any(m._forward_hooks for m in student.modules())
        assert os.path.getsize(dst) < os.path.getsize(out["best_path"]) / 2
