"""The port's quality metrics against the JAX package's on the same
waveforms: ``stoi``, ``pesq`` and ``pesq_mos_lqo`` (NumPy copies, held to
1e-6 relative), ``si_sdr`` (torch, batched over the last axis, held to
1e-4 dB), the ``ValueError`` cases, and ``batch_metric_mean`` with a clip
that cannot be scored."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval import metrics
from audiodenoiser_torch.eval.runner import batch_metric_mean
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_tpu.eval import metrics as jax_metrics
from audiodenoiser_tpu.eval.runner import batch_metric_mean as jax_batch_metric_mean

REL = 1e-6
DB = 1e-4


def _pair(seed, n=24000, noise=0.1):
    rng = np.random.default_rng(seed)
    clean = np.tile(synth_chunks(1, seed=seed)[0], 2)[:n]
    return clean, (clean + noise * rng.standard_normal(n)).astype(np.float32)


def _unscorable(fn, clean):
    """A reference the metric cannot score: for STOI a 0.2 s burst in
    silence (under 30 active frames survive its silent-frame removal), for
    PESQ all silence."""
    out = np.zeros_like(clean)
    if fn == "stoi":
        out[8000:9600] = clean[8000:9600]
    return out


def _close(ours, ref, tol=REL):
    assert abs(ours - ref) <= tol * max(abs(ref), 1e-12), (ours, ref)


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("noise", [0.0, 0.05, 0.3])
def test_stoi_matches_jax(fs, noise):
    clean, noisy = _pair(1, noise=noise)
    _close(metrics.stoi(clean, noisy, fs), jax_metrics.stoi(clean, noisy, fs))


@pytest.mark.parametrize("fs", [8000, 16000])
@pytest.mark.parametrize("noise", [0.0, 0.05, 0.3])
def test_pesq_matches_jax(fs, noise):
    clean, noisy = _pair(2, noise=noise)
    _close(metrics.pesq(clean, noisy, fs), jax_metrics.pesq(clean, noisy, fs))


@pytest.mark.parametrize("score", [-0.5, 1.0, 2.37, 4.5])
def test_pesq_mos_lqo_matches_jax(score):
    _close(float(metrics.pesq_mos_lqo(score)), float(jax_metrics.pesq_mos_lqo(score)))


@pytest.mark.parametrize("fn", ["stoi", "pesq"])
@pytest.mark.parametrize("case", ["shape", "short", "silent"])
def test_value_errors_match_jax(fn, case):
    clean, noisy = _pair(3)
    if case == "shape":
        clean, noisy = clean, noisy[:-1]
    elif case == "short":  # under 30 STOI frames, under 64 ms for PESQ
        clean, noisy = clean[:400], noisy[:400]
    else:
        clean = _unscorable(fn, clean)
    with pytest.raises(ValueError) as ref:
        getattr(jax_metrics, fn)(clean, noisy, 8000)
    with pytest.raises(ValueError) as ours:
        getattr(metrics, fn)(clean, noisy, 8000)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("shape", [(3, 4000), (2, 2, 1000), (500,)])
def test_si_sdr_matches_jax(shape):
    rng = np.random.default_rng(4)
    ref = rng.standard_normal(shape).astype(np.float32)
    est = (0.7 * ref + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    ours = metrics.si_sdr(torch.from_numpy(est), torch.from_numpy(ref)).numpy()
    want = np.asarray(jax_metrics.si_sdr(jnp.asarray(est), jnp.asarray(ref)))
    assert ours.shape == want.shape == shape[:-1]
    np.testing.assert_allclose(ours, want, rtol=0, atol=DB)


def test_si_sdr_identical_and_silent():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 800)).astype(np.float32))
    ours = metrics.si_sdr(torch.stack([x[0], torch.zeros(800)]), torch.stack([x[0], x[1]]))
    want = np.asarray(jax_metrics.si_sdr(jnp.asarray(np.stack([x[0].numpy(), np.zeros(800)])),
                                         jnp.asarray(x.numpy())))
    np.testing.assert_allclose(ours.numpy(), want, rtol=0, atol=DB)


@pytest.mark.parametrize("fn", ["stoi", "pesq"])
def test_batch_metric_mean_skips_an_unscorable_clip(fn):
    clips = [_pair(s) for s in range(3)]
    clean = np.stack([c for c, _ in clips])
    noisy = np.stack([n for _, n in clips])
    clean[1] = _unscorable(fn, clean[1])
    ours = batch_metric_mean(getattr(metrics, fn), clean, noisy, 8000)
    ref = jax_batch_metric_mean(getattr(jax_metrics, fn), clean, noisy, 8000)
    _close(ours, ref)
    both = [getattr(metrics, fn)(clean[i], noisy[i], 8000) for i in (0, 2)]
    _close(ours, float(np.mean(both)))
    with pytest.raises(ValueError, match="no clip scorable"):
        batch_metric_mean(getattr(metrics, fn), clean[1:2], noisy[1:2], 8000)
