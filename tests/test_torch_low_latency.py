"""Low-latency streaming (``eval/streaming.py``:
``LowLatencyStreamingDenoiser``, ``from_latency_budget`` and its
session) against the JAX package's on the CPU, in both modes, over a
folded fp32 model at width (8, 16, 32, 64)/128 and a 2048-sample window.
Bound: 1e-5 relative L2 per packet between the two packages (one STFT
round trip per window). Each packet completes 1, 2 or 4 hops, which JAX
compiles once each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.eval.streaming import (
    LowLatencyStreamingDenoiser,
    LowLatencyStreamingSession,
)
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    UNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
)
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.eval.streaming import LowLatencyStreamingDenoiser as JaxLowLatency
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)
WINDOW = 2048
BUDGET_MS = 64  # 512 samples at 8 kHz: hop 292, lookahead 146, crossfade 74


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.2 * rng.standard_normal(n), -1, 1).astype(np.float32)


def _runners(mask: bool, seed: int = 31):
    v = random_flax_variables(seed, in_channels=3 if mask else 1,
                              out_channels=2 if mask else 1, **NARROW)
    model = ComplexMaskUNet(residual=True, **NARROW) if mask else UNet(**NARROW)
    ours = DenoiserRunner(fold_for_inference(load_flax_variables(model, v).eval(),
                                             torch.float32), device="cpu")
    flax_model = FlaxMaskUNet(residual=True, **NARROW) if mask else FlaxUNet(**NARROW)
    fm, fv = fold_runner_inputs(flax_model, v, dtype=jnp.float32)
    return ours, JaxRunner(fm, fv)


@pytest.fixture(scope="module")
def runners():
    return _runners(True)


@pytest.fixture(scope="module")
def pair(request):
    """(port engine, JAX engine) at ``BUDGET_MS`` over one folded model."""
    mode = request.param
    ours, ref = _runners(mode == "complex_mask")
    return (LowLatencyStreamingDenoiser.from_latency_budget(ours, BUDGET_MS,
                                                            window_samples=WINDOW),
            JaxLowLatency.from_latency_budget(ref, BUDGET_MS, window_samples=WINDOW,
                                              mode=mode))


MODES = pytest.mark.parametrize("pair", ["complex_mask", "noisy_phase"], indirect=True)


def _packets(hop: int, hops_each, seed: int):
    """Ragged packet sizes each of which completes ``hops_each[i]`` hops."""
    rng = np.random.default_rng(seed)
    sizes, staged = [], 0
    for k in hops_each:
        rest = int(rng.integers(0, hop))
        sizes.append(k * hop - staged + rest)
        staged = rest
    return sizes


class TestAgainstJax:
    @MODES
    def test_session_per_packet(self, pair):
        ours, ref = pair
        assert (ours.hop, ours.lookahead, ours.xfade) == (ref.hop, ref.lookahead, ref.xfade)
        sizes = _packets(ours.hop, [1, 2, 4, 1, 4, 2], seed=1)
        x = _audio(sum(sizes), seed=2)
        s, r = ours.session(), ref.session()
        assert isinstance(s, LowLatencyStreamingSession)
        assert s.latency_samples == r.latency_samples == 512
        start = 0
        for n in sizes + ["flush"]:
            if n == "flush":
                a, b = s.flush(), r.flush()
            else:
                a, b = s.process(x[start:start + n]), r.process(x[start:start + n])
                start += n
            assert a.shape == b.shape
            if len(b):
                assert _rel(a, b) < 1e-5, (n, _rel(a, b))

    @pytest.mark.parametrize("ms", [2, 16, 64, 224, 250])
    def test_budget_geometry_as_jax(self, runners, ms):
        ours, ref = runners
        rate = 16000 if ms == 2 else 8000
        a = LowLatencyStreamingDenoiser.from_latency_budget(ours, ms, sample_rate=rate)
        b = JaxLowLatency.from_latency_budget(ref, ms, sample_rate=rate)
        assert (a.hop, a.lookahead, a.xfade, a.latency_samples) == \
               (b.hop, b.lookahead, b.xfade, b.latency_samples)
        assert a.latency_samples == round(ms * rate / 1000)


@pytest.fixture(scope="module")
def engine():
    ours, _ = _runners(True, seed=32)
    return LowLatencyStreamingDenoiser.from_latency_budget(ours, BUDGET_MS,
                                                           window_samples=WINDOW)


class TestSession:
    def test_224_ms_at_8_khz(self, engine):
        e = LowLatencyStreamingDenoiser.from_latency_budget(engine.runner, 224)
        assert (e.hop, e.lookahead, e.xfade, e.latency_samples) == (1024, 512, 256, 1792)

    @pytest.mark.parametrize("n", [1, 291, 2000, 5003])
    def test_flush_is_sample_exact(self, engine, n):
        x = _audio(n, seed=n)
        sess = engine.session()
        y = np.concatenate([sess.process(p) for p in np.array_split(x, 3)] + [sess.flush()])
        assert len(y) == n and np.isfinite(y).all()
        assert len(sess.flush()) == 0

    def test_packet_sizes_do_not_change_the_output(self, engine):
        """Every window runs alone, so the stream is the same sample for
        sample whatever the packets."""
        x = _audio(4000, seed=5)
        outs = []
        for parts in (1, 7):
            sess = engine.session()
            outs.append(np.concatenate([sess.process(p) for p in np.array_split(x, parts)]
                                       + [sess.flush()]))
        np.testing.assert_array_equal(outs[0], outs[1])

    def test_process_after_flush_raises(self, engine):
        sess = engine.session()
        sess.process(_audio(600))
        sess.flush()
        with pytest.raises(RuntimeError, match="flushed"):
            sess.process(_audio(10))

    def test_state_stays_on_runner_device(self, engine):
        sess = engine.session()
        sess.process(_audio(700))
        assert all(t.device == engine.device for t in sess._state)
        assert sess._state[0].shape == (WINDOW,) and sess._state[1].shape == (engine.xfade,)

    def test_too_small_budget_raises(self, engine):
        with pytest.raises(ValueError, match="too small"):
            LowLatencyStreamingDenoiser.from_latency_budget(engine.runner, 1.5)

    @pytest.mark.parametrize("kw,match", [
        (dict(hop_samples=100, xfade_samples=101), "xfade"),
        (dict(window_samples=1000, hop_samples=600, lookahead_samples=300,
              xfade_samples=200), "window too small"),
    ])
    def test_bad_geometry_raises(self, engine, kw, match):
        with pytest.raises(ValueError, match=match):
            LowLatencyStreamingDenoiser(engine.runner, **kw)
