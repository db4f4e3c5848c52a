"""Pooled streams (``eval/streaming.py``: ``MultiStreamWola``,
``auto_pool_capacity``, ``PooledStreamSessions``) against the JAX
package's pool and against dedicated port sessions on the CPU, in both
modes, over a folded fp32 model at width (8, 16, 32, 64)/128 and a
2048-sample chunk. Bounds: 1e-5 relative L2 per slot against JAX's pool
and against a dedicated ``StreamingSession`` of the same stream (a slot's
window runs in a batch of ``capacity`` rows, the dedicated one alone);
``auto_pool_capacity`` equal to JAX's on the same probe sizes. Also the
launch counters under concurrent threads."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.eval.streaming import (
    MultiStreamWola,
    PooledStreamSessions,
    StreamingDenoiser,
    auto_pool_capacity,
)
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    UNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
)
from audiodenoiser_torch.ops.cuda import build, stft_kernel, variant_launches
from audiodenoiser_tpu.eval import streaming as jax_streaming
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)
CHUNK = 2048
CAPACITY = 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.2 * rng.standard_normal(n), -1, 1).astype(np.float32)


def _runners(mask: bool, seed: int = 41):
    v = random_flax_variables(seed, in_channels=3 if mask else 1,
                              out_channels=2 if mask else 1, **NARROW)
    model = ComplexMaskUNet(residual=True, **NARROW) if mask else UNet(**NARROW)
    ours = DenoiserRunner(fold_for_inference(load_flax_variables(model, v).eval(),
                                             torch.float32), device="cpu")
    flax_model = FlaxMaskUNet(residual=True, **NARROW) if mask else FlaxUNet(**NARROW)
    fm, fv = fold_runner_inputs(flax_model, v, dtype=jnp.float32)
    return ours, JaxRunner(fm, fv)


@pytest.fixture(scope="module")
def sizing_runners():
    return _runners(True, seed=42)


@pytest.fixture(scope="module")
def runners(request):
    return request.param, *_runners(request.param == "complex_mask")


MODES = pytest.mark.parametrize("runners", ["complex_mask", "noisy_phase"], indirect=True)
STREAMS = {s: _audio(n, seed=10 + s) for s, n in ((0, 3000), (1, 4100), (2, 2600))}


def _drive(pool):
    """Uneven backlogs: slot 1 starts late, slot 2 is staged without an
    advance, and slot 0 is flushed while slot 2's hops are staged."""
    x = STREAMS
    out = {s: [] for s in x}

    def take(got):
        for s, o in got.items():
            out[s].append(o)

    slots = [pool.open() for _ in range(CAPACITY)]
    assert slots == [0, 1, 2]
    take(pool.process({0: x[0][:1500]}))
    take(pool.process({0: x[0][1500:], 1: x[1][:300]}))
    pool.stage(2, x[2][:2500])  # staged, no advance
    take({0: pool.flush(0)})  # consumes slot 0 alone
    assert len(pool._staging[2]) == 2500
    take(pool.process({1: x[1][300:3900]}))  # advances slots 1 and 2
    take(pool.process({2: x[2][2500:]}))
    take(pool.process({1: x[1][3900:]}))
    take({1: pool.flush(1)})
    take({2: pool.flush(2)})
    return {s: np.concatenate(o) for s, o in out.items()}


class TestAgainstJax:
    @MODES
    def test_slots_match_jax_and_dedicated_sessions(self, runners):
        mode, ours, ref = runners
        pool = MultiStreamWola(ours, capacity=CAPACITY, chunk_samples=CHUNK)
        jpool = jax_streaming.MultiStreamWola(ref, capacity=CAPACITY, chunk_samples=CHUNK,
                                              mode=mode)
        got, want = _drive(pool), _drive(jpool)
        streamer = StreamingDenoiser(ours, chunk_samples=CHUNK)
        for s, x in STREAMS.items():
            assert got[s].shape == want[s].shape == x.shape
            assert _rel(got[s], want[s]) < 1e-5, (s, _rel(got[s], want[s]))
            sess = streamer.session()
            alone = np.concatenate([sess.process(x), sess.flush()])
            assert _rel(got[s], alone) < 1e-5, (s, _rel(got[s], alone))
        # one batched denoise per hop step, far fewer than slots x hops
        assert pool.advances < sum(-(-(len(x) + CHUNK) // pool.hop) for x in STREAMS.values())

    @pytest.mark.parametrize("hbm_bytes", [8e6, 2e7, 1e8, 1e12])
    @pytest.mark.parametrize("safety", [0.7, 0.5])
    def test_auto_capacity_is_jax_fit(self, sizing_runners, hbm_bytes, safety):
        """The port's fit on JAX's own probe sizes (XLA's memory analysis
        of its denoise at capacities 2 and 8) gives JAX's capacity."""
        ours, ref = sizing_runners
        fn = jax.jit(lambda w: ref.denoise_audio(w, jax.random.key(0), mode="complex_mask"))
        sizes = {}
        for c in (2, 8):
            ma = fn.lower(jax.ShapeDtypeStruct((c, CHUNK), jnp.float32)).compile() \
                .memory_analysis()
            sizes[c] = int(ma.temp_size_in_bytes + ma.argument_size_in_bytes
                           + ma.output_size_in_bytes)
        want = jax_streaming.auto_pool_capacity(ref, CHUNK, hbm_bytes=hbm_bytes, safety=safety,
                                                mode="complex_mask")
        got = auto_pool_capacity(ours, CHUNK, hbm_bytes=hbm_bytes, safety=safety,
                                 probe=sizes.get)
        assert got == want


@pytest.fixture(scope="module")
def runner():
    return _runners(True, seed=43)[0]


class TestPool:
    def test_full_pool_raises_and_a_closed_slot_is_reused(self, runner):
        pool = MultiStreamWola(runner, capacity=2, chunk_samples=CHUNK)
        a, b = pool.open(), pool.open()
        with pytest.raises(IndexError, match="pool full"):
            pool.open()
        x = _audio(2500, seed=3)
        first = np.concatenate([pool.process({a: x})[a], pool.flush(a)])
        pool.close(a)
        assert pool.open() == a  # reset: the same stream gives the same output
        again = np.concatenate([pool.process({a: x})[a], pool.flush(a)])
        np.testing.assert_array_equal(first, again)
        pool.close(b)

    def test_stage_after_flush_raises(self, runner):
        pool = MultiStreamWola(runner, capacity=1, chunk_samples=CHUNK)
        s = pool.open()
        pool.process({s: _audio(1200)})
        pool.flush(s)
        assert len(pool.flush(s)) == 0
        with pytest.raises(RuntimeError, match="flushed"):
            pool.stage(s, _audio(10))

    def test_closed_slot_refuses_samples(self, runner):
        pool = MultiStreamWola(runner, capacity=1, chunk_samples=CHUNK)
        s = pool.open()
        pool.close(s)
        with pytest.raises(KeyError, match="not open"):
            pool.stage(s, _audio(10))

    @pytest.mark.parametrize("kw,match", [(dict(capacity=0), "capacity"),
                                          (dict(chunk_samples=2047), "even")])
    def test_bad_arguments(self, runner, kw, match):
        with pytest.raises(ValueError, match=match):
            MultiStreamWola(runner, **{"capacity": 2, "chunk_samples": CHUNK, **kw})

    def test_state_stays_on_runner_device(self, runner):
        pool = MultiStreamWola(runner, capacity=2, chunk_samples=CHUNK)
        pool.process({pool.open(): _audio(3000)})
        assert pool._prev.shape == pool._carry.shape == (2, CHUNK // 2)
        assert pool._prev.device == pool._carry.device == runner.device


class TestAutoCapacity:
    def test_fit(self, runner):
        sizes = {2: 1_000_000 + 2 * 500_000, 8: 1_000_000 + 8 * 500_000}
        got = auto_pool_capacity(runner, CHUNK, hbm_bytes=21_000_000, probe=sizes.get)
        assert got == int((0.7 * 21_000_000 - 1_000_000) / 500_000) == 27

    @pytest.mark.parametrize("hbm_bytes,max_capacity,want", [(1e5, 256, 1), (1e12, 64, 64)])
    def test_clamped(self, runner, hbm_bytes, max_capacity, want):
        sizes = {2: 3_000_000, 8: 9_000_000}
        assert auto_pool_capacity(runner, CHUNK, hbm_bytes=hbm_bytes, probe=sizes.get,
                                  max_capacity=max_capacity) == want

    @pytest.mark.parametrize("sizes", [{2: 5, 8: 5}, {2: None, 8: 9}])
    def test_unusable_probe_falls_back_to_8(self, runner, sizes):
        assert auto_pool_capacity(runner, CHUNK, hbm_bytes=1e9, probe=sizes.get) == 8

    def test_cpu_has_no_probe(self, runner):
        assert auto_pool_capacity(runner, CHUNK) == 8
        assert auto_pool_capacity(runner, CHUNK, max_capacity=4) == 4

    @pytest.mark.parametrize("safety", [0.0, 1.5])
    def test_safety_range(self, runner, safety):
        with pytest.raises(ValueError, match="safety"):
            auto_pool_capacity(runner, CHUNK, safety=safety)


class TestPooledSessions:
    def test_concurrent_sessions_match_dedicated(self, runner):
        """Four threads stream uneven packets into one pool: each
        session's output is its dedicated session's."""
        pooled = PooledStreamSessions(MultiStreamWola(runner, capacity=4, chunk_samples=CHUNK))
        streams = [_audio(3000 + 700 * i, seed=20 + i) for i in range(4)]
        sizes = [(300, 1700, 900), (1100, 250), (2048, 64, 999), (500,)]
        results, errors = {}, []

        def run(i):
            try:
                sess = pooled.session()
                x, parts, start = streams[i], [], 0
                while start < len(x):
                    n = sizes[i][len(parts) % len(sizes[i])]
                    parts.append(sess.process(x[start:start + n]))
                    start += n
                results[i] = np.concatenate(parts + [sess.flush()])
            except Exception as e:  # reported below with its traceback
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors, errors
        streamer = StreamingDenoiser(runner, chunk_samples=CHUNK)
        for i, x in enumerate(streams):
            sess = streamer.session()
            alone = np.concatenate([sess.process(x), sess.flush()])
            assert results[i].shape == x.shape
            assert _rel(results[i], alone) < 1e-5, (i, _rel(results[i], alone))
        assert pooled.pool._free and len(pooled.pool._active) == 0  # flush closed them

    def test_closed_session_refuses_and_frees_its_slot(self, runner):
        pooled = PooledStreamSessions(MultiStreamWola(runner, capacity=1, chunk_samples=CHUNK))
        sess = pooled.session()
        with pytest.raises(IndexError):
            pooled.session()
        sess.close()
        with pytest.raises(RuntimeError, match="closed"):
            sess.process(_audio(10))
        pooled.session().close()


def test_launch_counts_lose_nothing_under_threads():
    """``count_launch`` from more threads than cores, with a short switch
    interval, adds every launch."""
    before = stft_kernel.launches, stft_kernel.fft_launches
    n_threads, each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [build.count_launch(stft_kernel, "fft")
                                                    for _ in range(each)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    added = n_threads * each
    assert (stft_kernel.launches, stft_kernel.fft_launches) == (before[0] + added,
                                                                before[1] + added)
    assert variant_launches(stft_kernel)["fft"] == before[1] + added
    stft_kernel.launches, stft_kernel.fft_launches = before
