"""The streaming resampler (``eval/streaming.py``: ``StreamingResampler``
and ``ResampledStreamingSession``) against the JAX package's and against
``scipy.signal.resample_poly`` of the whole signal, on random packet
sizes: bit-identical. The rate adapter is sample-exact at the client
rate, over a pass-through session and over a WOLA session of a folded
fp32 model at width (8, 16, 32, 64)/128."""

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.eval.streaming import (
    ResampledStreamingSession,
    StreamingDenoiser,
    StreamingResampler,
)
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
)
from audiodenoiser_tpu.eval.streaming import ResampledStreamingSession as JaxResampled
from audiodenoiser_tpu.eval.streaming import StreamingResampler as JaxResampler

RATES = [(16000, 8000), (8000, 16000), (44100, 8000), (8000, 22050), (8000, 8000)]


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.3 * rng.standard_normal(n), -1, 1).astype(np.float32)


def _packets(n, seed):
    rng = np.random.default_rng(seed)
    sizes, total = [], 0
    while total < n:
        sizes.append(int(min(n - total, rng.integers(1, 1500))))
        total += sizes[-1]
    return sizes


def _stream(rs, x, sizes):
    outs, start = [], 0
    for n in sizes:
        outs.append(rs.push(x[start:start + n]))
        start += n
    outs.append(rs.flush())
    return np.concatenate(outs)


@pytest.mark.parametrize("in_rate,out_rate", RATES)
@pytest.mark.parametrize("seed", [0, 1])
def test_bit_identical_to_jax_and_resample_poly(in_rate, out_rate, seed):
    x = _audio(9001 + seed * 777, seed)
    sizes = _packets(len(x), seed + 10)
    ours = _stream(StreamingResampler(in_rate, out_rate), x, sizes)
    theirs = _stream(JaxResampler(in_rate, out_rate), x, sizes)
    g = np.gcd(in_rate, out_rate)
    whole = resample_poly(x, out_rate // g, in_rate // g).astype(np.float32)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, whole)


def test_push_after_flush_raises():
    rs = StreamingResampler(16000, 8000)
    rs.push(_audio(100))
    rs.flush()
    assert len(rs.flush()) == 0
    with pytest.raises(RuntimeError, match="flushed"):
        rs.push(_audio(10))


class _Echo:
    latency_samples = 4

    def __init__(self):
        self.closed = False

    def process(self, samples):
        return np.asarray(samples, np.float32)

    def flush(self):
        return np.zeros(0, np.float32)

    def close(self):
        self.closed = True


@pytest.mark.parametrize("n", [1, 3001, 16000])
@pytest.mark.parametrize("client_rate", [16000, 11025])
def test_rate_adapter_is_sample_exact_as_jax(n, client_rate):
    x = _audio(n, seed=n)
    sizes = _packets(n, n + 1)
    got = {}
    for name, cls in (("port", ResampledStreamingSession), ("jax", JaxResampled)):
        sess = cls(_Echo(), client_rate=client_rate, model_rate=8000)
        outs, start = [], 0
        for k in sizes:
            outs.append(sess.process(x[start:start + k]))
            start += k
        outs.append(sess.flush())
        got[name] = np.concatenate(outs)
        assert len(got[name]) == n
        assert sess.latency_samples == cls(_Echo(), client_rate, 8000).latency_samples
    np.testing.assert_array_equal(got["port"], got["jax"])


def test_rate_adapter_closes_and_ends():
    inner = _Echo()
    sess = ResampledStreamingSession(inner, client_rate=16000, model_rate=8000)
    sess.process(_audio(500))
    sess.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        sess.process(_audio(10))
    sess.close()
    assert inner.closed


def test_16_khz_client_on_a_wola_session():
    """A 16 kHz client on an 8 kHz model's session: as many samples out as
    in, and the same as resampling the whole signal through the offline
    denoise to within the resamplers' edge handling."""
    narrow = dict(features=(8, 16, 32, 64), bottleneck=128)
    v = random_flax_variables(51, in_channels=3, out_channels=2, **narrow)
    model = load_flax_variables(ComplexMaskUNet(residual=True, **narrow), v).eval()
    runner = DenoiserRunner(fold_for_inference(model, torch.float32), device="cpu")
    streamer = StreamingDenoiser(runner, chunk_samples=2048)
    x = _audio(12001, seed=3)
    sess = ResampledStreamingSession(streamer.session(), client_rate=16000, model_rate=8000)
    y = np.concatenate([sess.process(p) for p in np.array_split(x, 4)] + [sess.flush()])
    assert len(y) == len(x) and np.isfinite(y).all()
    offline = resample_poly(streamer.denoise(resample_poly(x, 1, 2).astype(np.float32)), 2, 1)
    rel = np.linalg.norm(y - offline[: len(y)]) / np.linalg.norm(offline)
    assert rel < 1e-5, rel
