"""The port's ``dsp.griffin_lim`` against the JAX package's on the CPU, both
modes, given JAX's own initial phase ``jax.random.uniform(key, shape, 0,
2*pi)``; and the runner's ``griffin_lim`` / ``reference_gl`` modes against
the JAX runner's.

Inputs are the repo's seeded speech-like clips (``data.synth.synth_chunks``).
Bounds, relative L2 of the waveform: 1e-4 in ``reference`` mode; 1e-3 in
``correct`` mode, whose ``rebuilt / |rebuilt|`` step amplifies the last-bit
differences between the two packages' FFTs over the iterations (about 2e-7
after one iteration, up to 6e-4 after 50 with momentum 0.99: PERF.md,
Findings). On white-noise magnitudes ``correct`` mode with momentum is
chaotic: a one-ulp change of the initial phase moves the port's own
waveform as far as JAX's is away, so there the test holds the quantity the
iteration minimises, the spectral convergence, to 1e-3 relative instead.

``python tests/test_torch_griffin_lim.py`` prints the error table that
PERF.md quotes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.dsp.griffin_lim import griffin_lim, initial_phase
from audiodenoiser_torch.dsp.stft import stft
from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.models import (
    UNet,
    fold_for_inference,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_tpu.dsp import stft as jax_stft
from audiodenoiser_tpu.dsp.griffin_lim import griffin_lim as jax_griffin_lim
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs

TOL = {"reference": 1e-4, "correct": 1e-3}
LENGTH = 12000
NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _magnitude(x):
    return np.array(jnp.abs(jax_stft.stft(jnp.asarray(x), 512, 128, center=True)))


def _speech(seed):
    return synth_chunks(2, seed=seed)[:, :LENGTH]


def _pair(mag, seed, theta_shift=False, **kw):
    """(JAX waveform, port waveform) from one magnitude and JAX's phase draw;
    ``theta_shift`` moves every phase of the port's draw up by one ulp."""
    key = jax.random.key(seed)
    ref = np.asarray(jax_griffin_lim(jnp.asarray(mag), key, **kw))
    theta = np.array(jax.random.uniform(key, mag.shape, minval=0.0, maxval=2.0 * jnp.pi))
    if theta_shift:
        theta = np.nextafter(theta, np.float32(10.0)).astype(np.float32)
    ours = griffin_lim(torch.from_numpy(mag), theta=torch.from_numpy(theta), **kw).numpy()
    return ref, ours


def _spectral_convergence(y, mag):
    rebuilt = stft(torch.from_numpy(np.array(y)), 512, 128).abs().numpy()
    return np.linalg.norm(rebuilt - mag) / np.linalg.norm(mag)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode,momentum,n_iter", [
    ("reference", 0.0, 1), ("reference", 0.0, 5), ("reference", 0.0, 50),
    ("correct", 0.0, 1), ("correct", 0.0, 5), ("correct", 0.0, 50),
    ("reference", 0.99, 50), ("correct", 0.99, 50),
])
def test_matches_jax(seed, mode, momentum, n_iter):
    mag = _magnitude(_speech(seed))
    ref, ours = _pair(mag, seed, n_iter=n_iter, mode=mode, momentum=momentum,
                      length=LENGTH)
    assert ours.shape == ref.shape == (2, LENGTH)
    assert _rel(ours, ref) < TOL[mode]


@pytest.mark.parametrize("mode", ["reference", "correct"])
def test_without_length_keeps_every_frame(mode):
    mag = _magnitude(_speech(1))
    ref, ours = _pair(mag, 1, n_iter=50, mode=mode)
    assert ours.shape == ref.shape == (2, (mag.shape[-1] - 1) * 128)
    assert _rel(ours, ref) < TOL[mode]


def test_correct_mode_with_momentum_on_noise_converges_alike():
    """White-noise magnitudes, correct mode, momentum 0.99: the waveforms are
    chaotic (seed 1 here: about 1.7e-2 apart, and the port as far from
    itself under a one-ulp phase shift), the spectral convergence is not."""
    rng = np.random.default_rng(1)
    mag = _magnitude((0.2 * rng.standard_normal((2, 6000))).astype(np.float32))
    kw = dict(n_iter=50, mode="correct", momentum=0.99, length=6000)
    ref, ours = _pair(mag, 1, **kw)
    _, shifted = _pair(mag, 1, theta_shift=True, **kw)
    assert _rel(ours, shifted) > 0.1 * _rel(ours, ref)  # the port's own sensitivity
    sc_ref, sc_ours = _spectral_convergence(ref, mag), _spectral_convergence(ours, mag)
    assert abs(sc_ours - sc_ref) < 1e-3 * sc_ref


def test_batched_leading_dims_and_errors():
    mag = torch.from_numpy(_magnitude(_speech(2)))
    theta = initial_phase(mag.shape, torch.Generator().manual_seed(0))
    flat = griffin_lim(mag, theta=theta, n_iter=3, length=LENGTH)
    nested = griffin_lim(mag[:, None], theta=theta[:, None], n_iter=3, length=LENGTH)
    torch.testing.assert_close(nested[:, 0], flat, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown mode"):
        griffin_lim(mag, n_iter=1, mode="bogus")
    with pytest.raises(ValueError, match="theta shape"):
        griffin_lim(mag, theta=theta[:1], n_iter=1)


def test_initial_phase_from_a_generator():
    a = initial_phase((3, 257, 10), torch.Generator().manual_seed(4))
    b = initial_phase((3, 257, 10), torch.Generator().manual_seed(4))
    assert a.dtype == torch.float32 and a.shape == (3, 257, 10)
    assert torch.equal(a, b)
    assert 0.0 <= float(a.min()) and float(a.max()) < 2.0 * np.pi
    mag = torch.from_numpy(_magnitude(_speech(0)))
    drawn = griffin_lim(mag, torch.Generator().manual_seed(4), n_iter=2)
    given = griffin_lim(mag, theta=initial_phase(mag.shape, torch.Generator().manual_seed(4)),
                        n_iter=2)
    assert torch.equal(drawn, given)


def test_kernel_precision_takes_the_kernel_wrappers(monkeypatch):
    """``precision="kernel"`` sends all 2*n_iter + 1 transforms through K1
    and K2's wrappers (their plain versions on the CPU)."""
    from audiodenoiser_torch.ops.cuda import istft as istft_mod
    from audiodenoiser_torch.ops.cuda import stft as stft_mod

    calls = {"stft": 0, "istft": 0}
    for mod, name in ((stft_mod, "stft"), (istft_mod, "istft")):
        plain = getattr(mod, f"{name}_plain")

        def spy(*a, _plain=plain, _name=name, **k):
            calls[_name] += 1
            return _plain(*a, **k)

        monkeypatch.setattr(mod, f"{name}_plain", spy)
    mag = torch.from_numpy(_magnitude(_speech(0)))
    theta = initial_phase(mag.shape, torch.Generator().manual_seed(0))
    ours = griffin_lim(mag, theta=theta, n_iter=4, precision="kernel")
    assert calls == {"stft": 4, "istft": 5}
    calls.update(stft=0, istft=0)
    plain = griffin_lim(mag, theta=theta, n_iter=4)
    assert calls == {"stft": 0, "istft": 0}
    torch.testing.assert_close(ours, plain, rtol=0, atol=0)


@pytest.fixture(scope="module")
def runners():
    variables = random_flax_variables(7, **NARROW)
    model = UNet(**NARROW)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    port = DenoiserRunner(fold_for_inference(model.eval(), torch.float32), device="cpu")
    jmodel, jvars = fold_runner_inputs(FlaxUNet(**NARROW), variables, dtype=jnp.float32)
    return port, JaxRunner(jmodel, jvars)


@pytest.mark.parametrize("mode,gl_mode", [("griffin_lim", "correct"),
                                          ("reference_gl", "reference")])
def test_runner_modes_match_jax(runners, mode, gl_mode):
    """The whole path: K1, the U-Net, the clamp, Griffin-Lim (20 iterations)
    on a clip that is not a hop multiple, given JAX's phase draw."""
    port, jax_runner = runners
    audio = _speech(4)[:, :7000]
    key = jax.random.key(2)
    ref = np.asarray(jax_runner.denoise_audio(jnp.asarray(audio), key, mode=mode, gl_iters=20))
    frames = 1 + 7040 // 128  # padded to a hop multiple, centred
    theta = np.array(jax.random.uniform(key, (2, 257, frames), minval=0.0, maxval=2.0 * jnp.pi))
    ours = port.denoise_audio(torch.from_numpy(audio), mode=mode, gl_iters=20,
                              theta=torch.from_numpy(theta)).numpy()
    assert ours.shape == ref.shape == (2, 7000)
    assert _rel(ours, ref) < TOL[gl_mode]


def _table():
    """Port-vs-JAX relative L2 of the waveform by mode, momentum and
    iteration count, on the test's speech-like clips (seeds 0-3) and on
    white-noise magnitudes, with the port's own sensitivity to a one-ulp
    shift of the initial phase beside the latter."""
    for label, make in (("speech-like", lambda s: _speech(s)),
                        ("white noise", lambda s: (0.2 * np.random.default_rng(s)
                                                   .standard_normal((2, 6000)))
                         .astype(np.float32))):
        for mode in ("reference", "correct"):
            for momentum in (0.0, 0.99):
                for n_iter in (1, 5, 50):
                    errs, selfs = [], []
                    for seed in range(4):
                        x = make(seed)
                        mag = _magnitude(x)
                        kw = dict(n_iter=n_iter, mode=mode, momentum=momentum,
                                  length=x.shape[-1])
                        ref, ours = _pair(mag, seed, **kw)
                        errs.append(_rel(ours, ref))
                        if label == "white noise":
                            selfs.append(_rel(_pair(mag, seed, theta_shift=True, **kw)[1], ours))
                    line = (f"{label:12s} {mode:9s} momentum {momentum:4.2f} n_iter {n_iter:2d}: "
                            f"port vs JAX {' '.join(f'{e:.2e}' for e in errs)}")
                    if selfs:
                        line += f"; port vs port at +1 ulp {' '.join(f'{e:.2e}' for e in selfs)}"
                    print(line, flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _table()
