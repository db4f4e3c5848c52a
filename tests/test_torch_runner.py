"""Port parity for the slice as a whole: ``DenoiserRunner.denoise_audio``
(noisy-phase STFT -> folded U-Net -> iSTFT) against the JAX runner on the
CPU, plus the package rules (no JAX import, no silent CPU fallback).

The port runs fp32 on the CPU, where its STFT/iSTFT kernels take their
plain versions; JAX runs ``FoldedUNet`` fp32 with ``precision="fft"`` and,
on a short clip, ``precision="pallas"`` in interpret mode. Bound:
``_rel < 1e-4``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.eval.runner import identity_bypass as jax_bypass
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs
from audiodenoiser_tpu.train.torch_export import save_pth
from audiodenoiser_torch.eval.runner import (
    DenoiserRunner,
    identity_bypass,
    load_model_for_noise,
)
from audiodenoiser_torch.models import (
    UNet,
    fold_for_inference,
    random_flax_variables,
    state_dict_from_flax,
)

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)
ROOT = Path(__file__).resolve().parents[1]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(5, **NARROW)


@pytest.fixture(scope="module")
def port_runner(variables):
    model = UNet(**NARROW)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return DenoiserRunner(fold_for_inference(model.eval(), torch.float32),
                          device="cpu")


def _jax_runner(variables, precision):
    fm, fv = fold_runner_inputs(FlaxUNet(**NARROW), variables, dtype=jnp.float32)
    return JaxRunner(fm, fv, precision=precision)


def _audio(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.2 * rng.standard_normal(shape), -1, 1).astype(np.float32)


class TestSliceParity:
    @pytest.mark.parametrize("shape", [(2, 6000), (3, 4096), (5000,)])
    def test_matches_jax_fft_runner(self, variables, port_runner, shape):
        """6000 and 5000 are not hop multiples: the hop pad and trim run.
        The port takes an unbatched clip, which JAX's folded model does
        not: that case is held against JAX on a batch of one."""
        audio = _audio(shape)
        batched = audio if audio.ndim == 2 else audio[None]
        ref = np.asarray(_jax_runner(variables, "fft").denoise_audio(
            jnp.asarray(batched), jax.random.key(0))).reshape(audio.shape)
        ours = port_runner.denoise_audio(torch.from_numpy(audio)).numpy()
        assert ours.shape == ref.shape == audio.shape
        assert _rel(ours, ref) < 1e-4, _rel(ours, ref)

    def test_matches_jax_pallas_runner(self, variables, port_runner):
        audio = _audio((1, 2000), seed=1)
        ref = np.asarray(_jax_runner(variables, "pallas").denoise_audio(
            jnp.asarray(audio), jax.random.key(0)))
        ours = port_runner.denoise_audio(torch.from_numpy(audio)).numpy()
        assert _rel(ours, ref) < 1e-4, _rel(ours, ref)

    @pytest.mark.parametrize("precision", ["fft", "matmul"])
    def test_matches_jax_runner_of_the_same_precision(self, variables, precision):
        model = UNet(**NARROW)
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        ours = DenoiserRunner(fold_for_inference(model.eval(), torch.float32), device="cpu",
                              precision=precision)
        assert ours.precision == precision
        audio = _audio((2, 3000), seed=4)
        ref = np.asarray(_jax_runner(variables, precision).denoise_audio(
            jnp.asarray(audio), jax.random.key(0)))
        got = ours.denoise_audio(torch.from_numpy(audio)).numpy()
        assert _rel(got, ref) < 1e-4, _rel(got, ref)

    def test_unknown_precision_raises(self, port_runner):
        with pytest.raises(ValueError, match="precision"):
            DenoiserRunner(port_runner.model, device="cpu", precision="pallas")

    def test_center_false(self, variables, port_runner):
        audio = _audio((2, 4096), seed=2)
        ref = np.asarray(_jax_runner(variables, "fft").denoise_audio(
            jnp.asarray(audio), jax.random.key(0), center=False))
        ours = port_runner.denoise_audio(torch.from_numpy(audio), center=False).numpy()
        assert ours.shape == ref.shape
        assert _rel(ours, ref) < 1e-4, _rel(ours, ref)

    def test_denoise_spectrogram_matches(self, variables, port_runner):
        mag = np.abs(np.random.default_rng(3).standard_normal((2, 257, 20))).astype(np.float32)
        ref = np.asarray(_jax_runner(variables, "fft").denoise_spectrogram(jnp.asarray(mag)))
        ours = port_runner.denoise_spectrogram(torch.from_numpy(mag)).numpy()
        assert _rel(ours, ref) < 1e-5


class _Identity(nn.Module):
    def forward(self, x):
        return x


class TestIdentityBypass:
    @pytest.mark.parametrize("thresh", [10.0, 40.0, 80.0])
    def test_matches_jax(self, thresh):
        rng = np.random.default_rng(4)
        orig = rng.standard_normal((4, 500)).astype(np.float32)
        out = orig.copy()
        out[0] += 1e-3 * rng.standard_normal(500).astype(np.float32)  # -60 dB
        out[1] += 0.3 * rng.standard_normal(500).astype(np.float32)   # -10 dB
        out[2] = orig[2]                                              # untouched
        out[3] += 1e-2 * rng.standard_normal(500).astype(np.float32)  # -40 dB
        ours = identity_bypass(torch.from_numpy(out), torch.from_numpy(orig), thresh)
        ref = np.asarray(jax_bypass(jnp.asarray(out), jnp.asarray(orig),
                                    jnp.float32(thresh)))
        np.testing.assert_array_equal(ours.numpy(), ref)

    def test_runner_gate_passes_clean_clip_verbatim(self):
        runner = DenoiserRunner(_Identity(), device="cpu")
        audio = torch.from_numpy(_audio((2, 4000), seed=5))
        plain = runner.denoise_audio(audio)
        assert not torch.equal(plain, audio)
        torch.testing.assert_close(plain, audio, atol=1e-3, rtol=0)
        gated = runner.denoise_audio(audio, bypass_db=40.0)
        assert torch.equal(gated, audio)


class TestModes:
    @pytest.mark.parametrize("mode,gl_mode", [("griffin_lim", "correct"),
                                              ("reference_gl", "reference")])
    def test_unported_modes_name_their_roadmap_item(self, variables, port_runner, mode,
                                                    gl_mode):
        """The Griffin-Lim modes, once refused naming ROADMAP A.7, are served
        by a magnitude model: the port's runner against the JAX runner on
        JAX's initial phase (5 iterations; tests/test_torch_griffin_lim.py
        holds 50). A mask model refuses them naming the mode it serves."""
        audio = _audio((2, 3000), seed=4)
        key = jax.random.key(1)
        ref = np.asarray(_jax_runner(variables, "fft").denoise_audio(
            jnp.asarray(audio), key, mode=mode, gl_iters=5))
        theta = np.array(jax.random.uniform(key, (2, 257, 1 + 3072 // 128),
                                            minval=0.0, maxval=2.0 * np.pi))
        ours = port_runner.denoise_audio(torch.from_numpy(audio), mode=mode, gl_iters=5,
                                         theta=torch.from_numpy(theta)).numpy()
        assert ours.shape == ref.shape == audio.shape
        assert _rel(ours, ref) < 1e-4, (gl_mode, _rel(ours, ref))
        from audiodenoiser_torch.models import ComplexMaskUNet

        mask = DenoiserRunner(ComplexMaskUNet(mask_bound=2.0, **NARROW).eval(), device="cpu")
        with pytest.raises(NotImplementedError, match="serves 'complex_mask'"):
            mask.denoise_audio(torch.zeros(1, 1000), mode=mode)

    def test_unknown_mode_is_value_error(self, port_runner):
        with pytest.raises(ValueError, match="unknown mode"):
            port_runner.denoise_audio(torch.zeros(1, 1000), mode="bogus")


class TestLoadModel:
    def test_loads_reference_pth_and_folds(self, tmp_path):
        v = random_flax_variables(6)
        save_pth(v, str(tmp_path / "unet_denoiser_urban.pth"))
        folded = load_model_for_noise("urban", str(tmp_path), dtype=torch.float32,
                                      device="cpu")
        model = UNet()
        model.load_state_dict(state_dict_from_flax(v))
        direct = fold_for_inference(model.eval(), torch.float32)
        x = torch.from_numpy(np.abs(np.random.default_rng(7).standard_normal(
            (1, 1, 33, 20))).astype(np.float32))
        torch.testing.assert_close(folded(x), direct(x), rtol=0, atol=0)
        assert folded.dtype == torch.float32

    def test_missing_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_model_for_noise("white", str(tmp_path), device="cpu")


class TestDeviceRules:
    """Entry points default to CUDA and raise without it; never a silent
    move to the CPU."""

    def test_entry_points_raise_without_gpu(self, monkeypatch, tmp_path):
        from audiodenoiser_torch.eval.bench import run_bench

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DenoiserRunner(_Identity())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_model_for_noise("white", str(tmp_path))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_bench(batch_size=1, iters=1)

    def test_kernels_refuse_other_devices(self):
        from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel

        meta = torch.device("meta")
        with pytest.raises(ValueError, match="cuda or cpu"):
            stft_kernel(torch.zeros(2, 4000, device=meta), torch.zeros(512, device=meta))
        with pytest.raises(ValueError, match="cuda or cpu"):
            istft_kernel(torch.zeros(1, 257, 4, device=meta),
                         torch.zeros(1, 257, 4, device=meta),
                         torch.zeros(512, device=meta))

    def test_bench_runs_on_cpu_when_asked(self):
        from audiodenoiser_torch.eval.bench import run_bench

        out = run_bench(batch_size=1, clip_seconds=0.25, iters=1, warmup=0,
                        device="cpu")
        assert out["value"] > 0 and out["device"] == "cpu"
        assert out["unit"] == "frames/s" and "vs_baseline" not in out


FORBIDDEN = ("jax", "flax", "optax", "msgpack", "audiodenoiser_tpu")


def _port_sources():
    return sorted((ROOT / "audiodenoiser_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


class TestImportRules:
    def test_port_imports_without_jax(self):
        """Import every module of the port in a fresh interpreter: neither
        JAX nor the JAX package may end up loaded."""
        mods = sorted(
            ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(".__init__", "")
            for p in (ROOT / "audiodenoiser_torch").rglob("*.py"))
        code = (
            "import importlib, sys\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n"
        )
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        assert res.stdout.startswith("ok")

    @pytest.mark.parametrize("module", [
        "data.native", "cli.create_train_dataset", "cli.export_checkpoint",
        "cli.import_checkpoint", "train.torch_export", "train.torch_import",
        "utils.profiling", "models.router", "train.router", "eval.ensemble",
        "utils.debug", "cli.bench", "models.int8", "__init__", "dsp.__init__", "data.__init__",
        "eval.__init__", "train.__init__", "losses.__init__", "utils.__init__",
        "parallel.mesh", "parallel.distributed", "parallel.hybrid", "parallel.__init__",
        "parallel.layers", "parallel.follow", "parallel.pipeline", "parallel.pipeline_train",
        "parallel.spatial", "cli.install", "models.mpsenet", "ops.cuda.layer_norm", "data.synth",
        "ops.cuda.conv_module", "models.semamba", "ops.cuda.ssm"])
    def test_rules_cover_the_training_path_modules(self, module):
        """The training path's, the routed deployment's, the int8 model's, the
        package surface's and the parallel paths' modules are among the
        sources both checks read."""
        path = ROOT / "audiodenoiser_torch" / (module.replace(".", "/") + ".py")
        assert path in _port_sources()

    @pytest.mark.parametrize("path", _port_sources(), ids=lambda p: p.name)
    def test_no_forbidden_import_statements(self, path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: import {name}"
