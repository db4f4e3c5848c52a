"""The complex-mask family: ``ComplexMaskUNet``, its fold, the mask math
and the runner's ``complex_mask`` mode against the JAX package on the
CPU. Weights are drawn once in the Flax tree layout (3 input channels, 2
output channels) and go to both sides. Bounds: 1e-5 relative L2 for the
networks in fp32, 1e-4 for the waveform paths (STFT and iSTFT included),
0.02 in bf16 (tests/test_torch_unet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    apply_mask,
    count_params,
    denoise_waveform,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
    spectrogram_features,
)
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import fold_runner_inputs
from audiodenoiser_tpu.models import complex_mask as jax_mask

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)
HEADS = [(False, 2.0), (True, 2.0), (False, 1.5), (True, 1.5)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(11, in_channels=3, out_channels=2, **NARROW)


def _port(variables, residual, bound, **kw):
    model = ComplexMaskUNet(mask_bound=bound, residual=residual, **NARROW, **kw)
    return load_flax_variables(model, variables).eval()


def _feats(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0])  # a magnitude channel
    return x


def _port_apply(model, x):
    """NHWC numpy -> the port's NCHW model -> NHWC numpy."""
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).float().numpy()


def _spec(shape, seed=0, zeros=True):
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    if zeros:
        spec[..., 0, :] = 0  # whole zero-magnitude rows: phase 1
        spec[..., 5, 3] = 0
    return spec


class TestModel:
    def test_full_width_param_count(self):
        assert count_params(ComplexMaskUNet()) == 31_043_586

    def test_narrow_matches_flax_tree(self, variables):
        n = sum(np.asarray(p).size for p in jax.tree_util.tree_leaves(variables["params"]))
        assert count_params(ComplexMaskUNet(**NARROW)) == n

    @pytest.mark.parametrize("residual,bound", HEADS)
    def test_matches_flax_fp32(self, variables, residual, bound):
        x = _feats((2, 33, 21, 3))
        ref = np.asarray(FlaxMaskUNet(mask_bound=bound, residual=residual, **NARROW)
                         .apply(variables, jnp.asarray(x), train=False))
        ours = _port_apply(_port(variables, residual, bound), x)
        assert ours.shape == ref.shape == (2, 33, 21, 2)
        assert _rel(ours, ref) < 1e-5, _rel(ours, ref)
        lo, hi = (1 - bound, 1 + bound) if residual else (-bound, bound)
        assert ours[..., 0].min() >= lo and ours[..., 0].max() <= hi

    @pytest.mark.parametrize("residual,bound", HEADS)
    def test_fold_matches_live_and_jax_fold(self, variables, residual, bound):
        x = _feats((2, 40, 24, 3), seed=1)
        live = _port(variables, residual, bound)
        folded = fold_for_inference(live, torch.float32)
        assert (folded.mask_bound, folded.mask_residual) == (bound, residual)
        fm, fv = fold_runner_inputs(
            FlaxMaskUNet(mask_bound=bound, residual=residual, **NARROW), variables,
            dtype=jnp.float32)
        ref = np.asarray(fm.apply(fv, jnp.asarray(x), train=False))
        ours = _port_apply(folded, x)
        assert _rel(ours, _port_apply(live, x)) < 1e-5
        assert _rel(ours, ref) < 1e-5, _rel(ours, ref)

    def test_bf16_mask_head_in_fp32(self, variables):
        """In bf16 the head's output is cast back to float32 before the
        tanh, as in Flax: the mask is float32 and within bf16 rounding of
        the Flax bf16 model."""
        x = _feats((2, 32, 32, 3), seed=2)
        ref = np.asarray(FlaxMaskUNet(dtype=jnp.bfloat16, residual=True, **NARROW)
                         .apply(variables, jnp.asarray(x), train=False))
        live = _port(variables, True, 2.0, dtype=torch.bfloat16)
        ours = _port_apply(live, x)
        assert ours.dtype == np.float32 and _rel(ours, ref) < 0.02, _rel(ours, ref)
        folded = _port_apply(fold_for_inference(live), x)
        assert folded.dtype == np.float32 and _rel(folded, ref) < 0.02


class TestMaskMath:
    def test_features_match_jax(self):
        spec = _spec((2, 17, 9))
        ref = np.asarray(jax_mask.spectrogram_features(jnp.asarray(spec)))
        ours = spectrogram_features(torch.from_numpy(spec)).numpy()
        assert ours.shape == ref.shape == (2, 17, 9, 3)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
        assert (ours[:, 0, :, 1] == 1).all() and (ours[:, 0, :, 2] == 0).all()
        assert ours[0, 5, 3].tolist() == [0.0, 1.0, 0.0]

    def test_apply_mask_matches_jax(self):
        spec = _spec((2, 17, 9), seed=1)
        mask = np.random.default_rng(2).uniform(-2, 2, (2, 17, 9, 2)).astype(np.float32)
        ref = np.asarray(jax_mask.apply_mask(jnp.asarray(mask), jnp.asarray(spec)))
        ours = apply_mask(torch.from_numpy(mask), torch.from_numpy(spec)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)

    def test_identity_mask_keeps_spec(self):
        spec = _spec((1, 17, 9), seed=3)
        feats = spectrogram_features(torch.from_numpy(spec))
        mask = torch.zeros(1, 17, 9, 2)
        mask[..., 0] = 1.0
        out = apply_mask(mask, torch.from_numpy(spec)).numpy()
        np.testing.assert_allclose(out, spec, rtol=1e-6)
        rebuilt = feats[..., 0] * torch.complex(feats[..., 1], feats[..., 2])
        np.testing.assert_allclose(rebuilt.numpy(), spec, rtol=1e-5, atol=1e-6)


def _audio(shape, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.2 * rng.standard_normal(shape), -1, 1).astype(np.float32)


class TestWaveform:
    @pytest.mark.parametrize("n", [4096, 5000])
    def test_denoise_waveform_matches_jax(self, variables, n):
        """4096 is a hop multiple, 5000 is not: the pad and trim run."""
        audio = _audio((2, n), seed=n)
        model = FlaxMaskUNet(residual=True, **NARROW)
        ref = np.asarray(jax_mask.denoise_waveform(model, variables, jnp.asarray(audio)))
        with torch.no_grad():
            ours = denoise_waveform(_port(variables, True, 2.0), torch.from_numpy(audio))
        assert ours.shape == ref.shape == audio.shape
        assert _rel(ours.numpy(), ref) < 1e-4, _rel(ours.numpy(), ref)

    def test_denoise_waveform_unbatched(self, variables):
        audio = _audio(3000, seed=1)
        with torch.no_grad():
            model = _port(variables, False, 2.0)
            one = denoise_waveform(model, torch.from_numpy(audio))
            two = denoise_waveform(model, torch.from_numpy(audio[None]))[0]
        torch.testing.assert_close(one, two)


@pytest.fixture(scope="module")
def mask_runner(variables):
    return DenoiserRunner(fold_for_inference(_port(variables, True, 2.0), torch.float32),
                          device="cpu")


def _jax_runner(variables, precision):
    fm, fv = fold_runner_inputs(FlaxMaskUNet(residual=True, **NARROW), variables,
                                dtype=jnp.float32)
    return JaxRunner(fm, fv, precision=precision)


class TestRunner:
    @pytest.mark.parametrize("shape", [(2, 4096), (2, 6000), (3, 2500)])
    def test_matches_jax_fft_runner(self, variables, mask_runner, shape):
        audio = _audio(shape, seed=shape[1])
        ref = np.asarray(_jax_runner(variables, "fft").denoise_audio(
            jnp.asarray(audio), jax.random.key(0), mode="complex_mask"))
        assert mask_runner.mode == "complex_mask"
        ours = mask_runner.denoise_audio(torch.from_numpy(audio)).numpy()
        assert ours.shape == ref.shape == audio.shape
        assert _rel(ours, ref) < 1e-4, _rel(ours, ref)

    def test_matches_jax_pallas_runner(self, variables, mask_runner):
        audio = _audio((1, 2000), seed=1)
        ref = np.asarray(_jax_runner(variables, "pallas").denoise_audio(
            jnp.asarray(audio), jax.random.key(0), mode="complex_mask"))
        ours = mask_runner.denoise_audio(torch.from_numpy(audio),
                                         mode="complex_mask").numpy()
        assert _rel(ours, ref) < 1e-4, _rel(ours, ref)

    def test_residual_zero_head_passes_audio_through(self, variables):
        """A zero head makes the residual mask the identity: the waveform
        comes back within the STFT round trip's error."""
        zero = random_flax_variables(11, in_channels=3, out_channels=2, **NARROW)
        zero["params"]["out"] = {k: np.zeros_like(v) for k, v in zero["params"]["out"].items()}
        runner = DenoiserRunner(_port(zero, True, 2.0), device="cpu")
        audio = _audio((2, 3000), seed=2)
        out = runner.denoise_audio(torch.from_numpy(audio)).numpy()
        np.testing.assert_allclose(out, audio, atol=1e-5)

    def test_mode_must_fit_the_model(self, mask_runner):
        with pytest.raises(NotImplementedError, match="magnitude model"):
            mask_runner.denoise_audio(torch.zeros(1, 1000), mode="noisy_phase")
        with pytest.raises(ValueError, match="magnitude model"):
            mask_runner.denoise_spectrogram(torch.zeros(1, 257, 4))
