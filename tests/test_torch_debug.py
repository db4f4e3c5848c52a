"""The port's package surface against the JAX package's: the finiteness
guard ``utils.assert_tree_finite`` (JAX ``tests/test_utils.py``'s cases,
and its message against JAX's on the same tree), the public names and
constants of each package ``__init__``, an import of the package that
builds no kernel and loads no JAX, and the ``cli.bench`` entry point's
options. Exact checks throughout.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_torch
import audiodenoiser_tpu
from audiodenoiser_torch.utils import assert_tree_finite
from audiodenoiser_tpu.utils import assert_tree_finite as jax_assert_tree_finite

ROOT = Path(__file__).resolve().parents[1]
CONSTANTS = ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_SECONDS", "CHUNK_SAMPLES", "SNR_DB",
             "NOISE_TYPES", "TARGET_SIZE")
# the JAX package's name the port has no counterpart of by that name: JAX's fold
# of a (model, variables) pair, whose counterpart is fold_for_inference
NOT_PORTED = {"models": {"fold_runner_inputs"}}


class TestAssertTreeFinite:
    def test_passes(self):
        assert_tree_finite({"a": np.ones(3), "b": {"c": np.zeros(2)}})
        assert_tree_finite({"w": torch.ones(2, dtype=torch.bfloat16), "l": [torch.zeros(1)]})

    def test_raises_with_path(self):
        with pytest.raises(FloatingPointError, match="b"):
            assert_tree_finite({"a": np.ones(3), "b": np.array([np.nan])})

    def test_ignores_integer_leaves(self):
        assert_tree_finite({"steps": np.array([1, 2, 3])})
        assert_tree_finite({"steps": torch.arange(3), "mask": torch.ones(2, dtype=torch.bool)})

    @pytest.mark.parametrize("tree", [
        {"a": [np.ones(2), np.array([np.inf])], "b": (np.nan, {"c": np.array([1.0, np.nan])})},
        {"params": {f"conv{i}": {"kernel": np.full(2, np.nan)} for i in range(7)}},
        [np.zeros(1), {"x": np.float32(-np.inf)}],
    ])
    def test_message_matches_jax(self, tree):
        """The key paths of the non-finite leaves, the first five, in JAX's
        words; the same tree of tensors gives the same message."""
        with pytest.raises(FloatingPointError) as ref:
            jax_assert_tree_finite(tree, "state")
        with pytest.raises(FloatingPointError) as ours:
            assert_tree_finite(tree, "state")
        assert str(ours.value) == str(ref.value)

        def as_tensors(t):
            if isinstance(t, dict):
                return {k: as_tensors(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return type(t)(as_tensors(v) for v in t)
            return torch.as_tensor(np.asarray(t, np.float32))

        with pytest.raises(FloatingPointError) as tensors:
            assert_tree_finite(as_tensors(tree), "state")
        assert str(tensors.value) == str(ref.value)


def _public(module):
    return set(getattr(module, "__all__", ()))


class TestPublicNames:
    def test_constants_match_jax(self):
        for name in CONSTANTS:
            assert getattr(audiodenoiser_torch, name) == getattr(audiodenoiser_tpu, name), name

    @pytest.mark.parametrize("sub", ["dsp", "data", "eval", "train", "losses", "utils",
                                     "models", "serve"])
    def test_all_holds_the_jax_names(self, sub):
        ours = importlib.import_module(f"audiodenoiser_torch.{sub}")
        ref = importlib.import_module(f"audiodenoiser_tpu.{sub}")
        want = _public(ref) - NOT_PORTED.get(sub, set())
        assert want <= _public(ours), sorted(want - _public(ours))
        if sub not in ("models", "serve"):  # there the port exports more
            assert _public(ours) == want
        for name in _public(ours):
            assert getattr(ours, name) is not None, name

    def test_dsp_aliases(self):
        from audiodenoiser_torch import dsp
        from audiodenoiser_torch.dsp import stft as stft_module

        assert dsp.compute_stft is stft_module.stft and dsp.stft_mod is stft_module
        spec = dsp.compute_stft(torch.from_numpy(
            np.random.default_rng(0).standard_normal(2048).astype(np.float32)), 512, 128)
        # JAX's magnitude is jnp.abs: the same |z| within one fp32 rounding
        np.testing.assert_allclose(dsp.magnitude(spec).numpy(),
                                   np.asarray(jnp.abs(jnp.asarray(spec.numpy()))), rtol=1e-6)

    def test_package_import_builds_nothing(self):
        """Every package ``__init__`` in a fresh interpreter: no kernel
        built or loaded, no JAX module imported."""
        code = (
            "import sys, importlib\n"
            "for m in ['audiodenoiser_torch', 'audiodenoiser_torch.dsp', "
            "'audiodenoiser_torch.data', 'audiodenoiser_torch.eval', "
            "'audiodenoiser_torch.train', 'audiodenoiser_torch.losses', "
            "'audiodenoiser_torch.utils', 'audiodenoiser_torch.models', "
            "'audiodenoiser_torch.serve', 'audiodenoiser_torch.cli.bench']:\n"
            "    importlib.import_module(m)\n"
            "from audiodenoiser_torch.ops.cuda import build\n"
            "assert not build._libs and not build.build_log, build.build_log\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'audiodenoiser_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


class TestBenchEntryPoint:
    def test_cli_bench_takes_the_jax_options(self):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "-m", "audiodenoiser_torch.cli.bench", "--help"],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        for flag in ("--width_mult", "--no_student", "--fold", "--no-fold", "--no_train",
                     "--train_batch_size", "--pallas_deconv", "--mode", "--no_s2d",
                     "--no_int8", "int8"):
            assert flag in res.stdout, flag

    @pytest.mark.parametrize("argv,width,train,student", [
        ([], 1.0, 256, True),
        (["--width_mult", "0.25", "--no-fold", "--train_batch_size", "16"], 0.25, 16, False),
        (["--no_train", "--no_student", "--mode", "complex_mask"], 1.0, None, False),
    ])
    def test_main_runs_the_legs(self, monkeypatch, capsys, argv, width, train, student):
        """``main``'s wiring, with each leg recorded instead of run: the
        headline at the run's width and fold, the training leg at its
        batch, the student at width 0.25 in the run's mode and half the
        iterations (at least 5), beside a full-width headline only; there
        too the s2d legs (s2d, s2d_skip 16) in the run's mode and fold, the
        s2d training leg at the training batch, and the int8 leg."""
        from audiodenoiser_torch.eval import bench

        calls = []

        def fake_bench(batch, clip, iters, **kw):
            calls.append(("bench", iters, kw))
            return {"value": {0.25: 4.0}.get(kw.get("width_mult"), 1.0)
                    + 2.0 * kw.get("s2d", False) + kw.get("s2d_skip", 0)
                    + 3.0 * (kw.get("mode") == "int8")}

        monkeypatch.setattr(bench, "run_bench", fake_bench)
        monkeypatch.setattr(bench, "run_train_bench",
                            lambda b, **kw: calls.append(("train", b, kw.get("s2d", False)))
                            or {"train_step_ms": 1})
        monkeypatch.setattr(bench, "stream_benches",
                            lambda *a, width_mult: calls.append(("stream", width_mult)) or {})
        bench.main(["--no_stream", "--no_pool", *argv])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        head = calls[0]
        assert head[0] == "bench" and head[1] == 20 and head[2]["width_mult"] == width
        assert head[2]["fold"] == ("--no-fold" not in argv)
        mode = "complex_mask" if "complex_mask" in argv else "noisy_phase"
        assert head[2]["mode"] == mode
        assert (("train", train, False) in calls) == (train is not None)
        assert ("stream", width) in calls
        legs = [c for c in calls[1:] if c[0] == "bench"]
        students = [c for c in legs if c[2].get("width_mult") == 0.25]
        if student:
            assert students == [("bench", 10, {"pipelined": True, "mode": mode,
                                               "width_mult": 0.25})]
            assert out["student_width_mult"] == 0.25 and out["student_frames_per_sec"] == 4.0
        else:
            assert not students and "student_frames_per_sec" not in out
        variants = [c for c in legs if c not in students]
        s2d_train = ("train", train, True)
        if width == 1.0:
            fold = "--no-fold" not in argv
            assert variants == [
                ("bench", 10, {"pipelined": True, "mode": mode, "fold": fold, "s2d": True,
                               "s2d_skip": 0}),
                ("bench", 10, {"pipelined": True, "mode": mode, "fold": fold, "s2d": True,
                               "s2d_skip": 16}),
                ("bench", 10, {"pipelined": True, "mode": "int8"})]
            assert (out["s2d_frames_per_sec"], out["s2d_skip16_frames_per_sec"],
                    out["int8_frames_per_sec"]) == (3.0, 19.0, 4.0)
            assert (s2d_train in calls) == (train is not None)
        else:
            assert not variants and s2d_train not in calls
            assert not {"s2d_frames_per_sec", "int8_frames_per_sec"} & set(out)

    def test_train_leg_on_cpu(self, monkeypatch):
        """The training leg at two levels on the CPU: JAX's keys, a
        positive rate and the operations ``FlopCounterMode`` counted."""
        import functools

        from audiodenoiser_torch import models
        from audiodenoiser_torch.eval.bench import run_train_bench

        monkeypatch.setattr(models, "UNet", functools.partial(models.UNet, features=(4, 8),
                                                              bottleneck=16))
        out = run_train_bench(2, iters=2, device="cpu")
        assert out["train_samples_per_sec"] > 0 and out["train_step_ms"] > 0
        assert out["train_tflops_per_sec"] > 0 and np.isfinite(out["train_last_loss"])
        assert out["train_batch_size"] == 2 and "train_peak_memory_gib" not in out
