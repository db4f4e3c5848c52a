"""The port's HTTP denoise service: the cases of tests/test_serve.py that
this slice carries (bucketing, coalescing, fairness, 503 on overload,
error propagation, metrics, the HTTP surface), plus the port's service
against the JAX service on the same weights, and ``mode=auto``: each
routed answer equal to its expert runner's on the power-of-two padded
group the service formed, and the routed service against the JAX one."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from torch import nn

from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.models import (
    UNet,
    fold_for_inference,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.serve import DenoiseService, ServiceOverloaded, make_http_server

NARROW = dict(features=(4, 8, 16, 32), bottleneck=64)


def _runner(seed=0, dtype=torch.float32):
    model = UNet(**NARROW)
    model.load_state_dict(state_dict_from_flax(random_flax_variables(seed, **NARROW)))
    return DenoiserRunner(fold_for_inference(model.eval(), dtype), device="cpu")


@pytest.fixture(scope="module")
def server():
    service = DenoiseService(_runner(), bucket_samples=8000, max_seconds=10.0)
    srv = make_http_server(service, "127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _wav_bytes(audio, sr=8000):
    buf = io.BytesIO()
    wavfile.write(buf, sr, np.clip(audio * 32768, -32768, 32767).astype(np.int16))
    return buf.getvalue()


def _post(url, body, query=""):
    req = urllib.request.Request(f"{url}/denoise{query}", data=body, method="POST")
    return urllib.request.urlopen(req, timeout=60)


class TestHTTP:
    def test_healthz(self, server):
        url, _ = server
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok" and info["device"] == "cpu"
        assert info["sample_rate"] == 8000

    def test_denoise_roundtrip_matches_direct_call(self, server, rng):
        url, service = server
        audio = np.clip(rng.standard_normal(6000) * 0.2, -1, 1).astype(np.float32)
        with _post(url, _wav_bytes(audio)) as r:
            body = r.read()
            assert r.headers["Content-Type"] == "audio/wav"
            assert float(r.headers["X-Latency-Ms"]) > 0
        sr, out = wavfile.read(io.BytesIO(body))
        assert sr == 8000 and len(out) == 6000  # padded to the bucket, trimmed
        # what the service saw: the int16 clip, zero-padded to its bucket
        sent = wavfile.read(io.BytesIO(_wav_bytes(audio)))[1] / 32768.0
        padded = np.zeros((1, 8000), np.float32)
        padded[0, :6000] = sent
        direct = service.runner.denoise_audio(torch.from_numpy(padded))[0, :6000]
        want = np.clip(direct.numpy() * 32768, -32768, 32767).astype(np.int16)
        np.testing.assert_array_equal(out, want)

    def test_resamples_input(self, server, rng):
        url, _ = server
        audio = np.clip(rng.standard_normal(16000) * 0.2, -1, 1).astype(np.float32)
        with _post(url, _wav_bytes(audio, sr=16000)) as r:
            sr, out = wavfile.read(io.BytesIO(r.read()))
        assert sr == 8000 and len(out) == 8000

    @pytest.mark.parametrize("body,query,code", [
        (b"not a wav", "", 400),
        (None, "?mode=bogus", 400),
        (None, "?mode=griffin_lim", 200),  # served by a magnitude U-Net
        (None, "?mode=complex_mask", 501),  # this server's model is a magnitude U-Net
    ])
    def test_error_codes(self, server, body, query, code):
        url, _ = server
        body = body if body is not None else _wav_bytes(np.zeros(4000, np.float32))
        if code == 200:
            with _post(url, body, query) as r:
                assert r.status == 200 and len(wavfile.read(io.BytesIO(r.read()))[1]) == 4000
            return
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, body, query)
        assert e.value.code == code

    def test_too_long_clip_400(self, server):
        url, _ = server
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, _wav_bytes(np.zeros(8000 * 11, np.float32)))  # > 10 s
        assert e.value.code == 400

    @pytest.mark.parametrize("method,path,code", [
        pytest.param("GET", "/nope", 404, id="GET-/nope"),
        pytest.param("POST", "/stream/start", 404, id="POST-/stream/start"),
        # a server without a reload function answers 501, as the JAX one
        pytest.param("POST", "/admin/reload", 501, id="POST-/admin/reload"),
    ])
    def test_unknown_paths_404(self, server, method, path, code):
        url, _ = server
        req = urllib.request.Request(f"{url}{path}", data=b"" if method == "POST" else None,
                                     method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == code

    def test_metrics_counters_and_histogram(self, server, rng):
        url, _ = server
        audio = np.clip(rng.standard_normal(4000) * 0.2, -1, 1).astype(np.float32)
        _post(url, _wav_bytes(audio)).read()
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()

        def value(prefix):
            return int([ln for ln in text.splitlines()
                        if ln.startswith(prefix)][0].split()[-1])

        assert value("adt_requests_total") >= 1
        count = value("adt_request_latency_ms_count")
        assert count >= 1
        assert value('adt_request_latency_ms_bucket{le="+Inf"}') == count
        assert "adt_queue_depth" in text and "adt_errors_total" in text


class _FakeRunner:
    def __init__(self, delay=0.05):
        self.delay = delay
        self.batch_sizes = []

    def denoise_audio(self, audio, mode="noisy_phase", **kw):
        self.batch_sizes.append(audio.shape[0])
        time.sleep(self.delay)  # device "busy": lets followers pile up
        return audio  # identity


def _join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


class TestMicroBatching:
    def test_warmup_runs_first_bucket(self):
        fake = _FakeRunner(delay=0.0)
        service = DenoiseService(fake, bucket_samples=4000, warmup=True)
        assert sorted(fake.batch_sizes) == [1, service.max_batch]
        out = service.denoise(np.ones(2000, np.float32))
        assert out.shape == (2000,) and len(fake.batch_sizes) == 3

    def test_concurrent_requests_coalesce(self):
        fake = _FakeRunner()
        service = DenoiseService(fake, bucket_samples=4000)
        clips = [(0.1 * (i + 1) * np.ones(2000 + 100 * i)).astype(np.float32)
                 for i in range(5)]
        results = [None] * 5

        def call(i):
            results[i] = service.denoise(clips[i])

        _join_all([threading.Thread(target=call, args=(i,)) for i in range(5)])
        for i in range(5):
            np.testing.assert_array_equal(results[i], clips[i])
        assert service.requests_served == 5
        assert service.batches_run < 5  # fewer device calls than requests
        assert max(fake.batch_sizes) > 1
        assert all(b & (b - 1) == 0 for b in fake.batch_sizes)  # powers of two

    def test_mixed_buckets_not_merged(self):
        service = DenoiseService(_FakeRunner(delay=0.02), bucket_samples=4000)
        a, b = np.ones(2000, np.float32), np.ones(6000, np.float32)  # 4000 / 8000
        results = {}

        def call(name, clip):
            results[name] = service.denoise(clip)

        _join_all([threading.Thread(target=call, args=("a", a)),
                   threading.Thread(target=call, args=("b", b))])
        np.testing.assert_array_equal(results["a"], a)
        np.testing.assert_array_equal(results["b"], b)

    @pytest.mark.parametrize("n,bucket", [(1, 4000), (4000, 4000), (4001, 8000),
                                          (9000, 12000)])
    def test_bucket_lengths(self, n, bucket):
        assert DenoiseService(_FakeRunner(0.0), bucket_samples=4000)._bucket_len(n) == bucket

    def test_error_propagates_to_caller(self):
        class BoomRunner:
            def denoise_audio(self, audio, **kw):
                raise RuntimeError("boom")

        service = DenoiseService(BoomRunner(), bucket_samples=4000)
        with pytest.raises(RuntimeError, match="boom"):
            service.denoise(np.ones(100, np.float32))
        assert "adt_errors_total 1" in service.metrics_text()

    def test_empty_audio_rejected(self):
        with pytest.raises(ValueError):
            DenoiseService(_FakeRunner(0.0)).denoise(np.zeros(0, np.float32))


class TestFairnessAndBackpressure:
    def test_no_starvation_under_single_bucket_flood(self):
        service = DenoiseService(_FakeRunner(delay=0.02), bucket_samples=4000)
        stop = threading.Event()
        a, b = np.ones(2000, np.float32), np.ones(6000, np.float32)

        def flood():
            while not stop.is_set():
                service.denoise(a)

        floods = [threading.Thread(target=flood, daemon=True) for _ in range(4)]
        for t in floods:
            t.start()
        time.sleep(0.1)  # flood established, dispatcher busy on bucket A
        done = threading.Event()
        out = {}

        def lone():
            out["b"] = service.denoise(b)
            done.set()

        threading.Thread(target=lone, daemon=True).start()
        assert done.wait(timeout=5.0), "bucket-B request starved"
        stop.set()
        np.testing.assert_array_equal(out["b"], b)
        for t in floods:
            t.join(timeout=5.0)

    def test_overload_returns_503_and_counts(self):
        service = DenoiseService(_FakeRunner(delay=0.2), bucket_samples=4000,
                                 max_queue=2, max_batch=1)
        a = np.ones(1000, np.float32)
        errors, oks = [], []

        def call():
            try:
                oks.append(service.denoise(a))
            except ServiceOverloaded as e:
                errors.append(e)

        _join_all([threading.Thread(target=call) for _ in range(12)])
        assert errors and oks and len(oks) + len(errors) == 12
        assert f"adt_overloaded_total {len(errors)}" in service.metrics_text()

    def test_overload_is_http_503(self):
        service = DenoiseService(_FakeRunner(delay=0.3), bucket_samples=4000,
                                 max_queue=1, max_batch=1)
        srv = make_http_server(service, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        codes = []

        def call():
            try:
                _post(url, _wav_bytes(np.ones(1000, np.float32) * 0.1)).read()
                codes.append(200)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
                assert e.headers["Retry-After"] == "1"

        try:
            _join_all([threading.Thread(target=call) for _ in range(8)])
        finally:
            srv.shutdown()
            srv.server_close()
        assert 503 in codes and 200 in codes


class _Identity(nn.Module):
    def forward(self, x):
        return x


class TestServing:
    def test_bypass_gate_returns_clean_clip_verbatim(self, rng):
        runner = DenoiserRunner(_Identity(), device="cpu")
        audio = np.clip(rng.standard_normal(4000) * 0.2, -1, 1).astype(np.float32)
        gated = DenoiseService(runner, bucket_samples=8000, bypass_db=40.0).denoise(audio)
        np.testing.assert_array_equal(gated, audio)
        plain = DenoiseService(runner, bucket_samples=8000).denoise(audio)
        assert not np.array_equal(plain, audio)
        np.testing.assert_allclose(plain, audio, atol=1e-3)
        off = DenoiseService(runner, bucket_samples=8000, bypass_db=0.0).denoise(audio)
        np.testing.assert_array_equal(off, plain)

    def test_matches_jax_service(self, rng):
        """Same weights, same clip: the port's service against the JAX
        service over the JAX folded fp32 runner (``precision="fft"``)."""
        from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
        from audiodenoiser_tpu.models import UNet as FlaxUNet
        from audiodenoiser_tpu.models import fold_runner_inputs
        from audiodenoiser_tpu.serve import DenoiseService as JaxService

        v = random_flax_variables(0, **NARROW)
        fm, fv = fold_runner_inputs(FlaxUNet(**NARROW), v, dtype=jnp.float32)
        jax_service = JaxService(JaxRunner(fm, fv), bucket_samples=8000)
        audio = np.clip(rng.standard_normal(6000) * 0.2, -1, 1).astype(np.float32)
        ref = jax_service.denoise(audio)
        ours = DenoiseService(_runner(0), bucket_samples=8000).denoise(audio)
        assert ours.shape == ref.shape == (6000,)
        rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
        assert rel < 1e-4, rel


def _router(seed=9):
    from audiodenoiser_torch.models import (
        NoiseClassifier,
        random_router_flax_variables,
        router_state_dict_from_flax,
    )

    params = random_router_flax_variables(seed)["params"]
    model = NoiseClassifier(dtype=torch.float32)
    model.load_state_dict(router_state_dict_from_flax(params), strict=True)
    return model.eval(), params


class _LoudnessRouter(nn.Module):
    """A stand-in router that spreads clips over the experts by level:
    the label nearest ``log10(mean magnitude) + 2``."""

    def forward(self, x):
        level = torch.log10(x.mean(dim=(1, 2, 3))) + 2.0
        return -(level[:, None] - torch.arange(4.0)) ** 2


def _routed_service(router=None, **kw):
    experts = {i: _runner(30 + i) for i in range(4)}
    router = _router()[0] if router is None else router
    return DenoiseService(experts[0], bucket_samples=4000, router=(router, (256, 64)),
                          expert_runners=experts, default_mode="auto", **kw), router, experts


class TestRoutedService:
    def test_answers_are_the_routed_experts_on_their_padded_groups(self):
        """Five clips in one coalesced batch (padded to 8 rows): one router
        call on the padded batch, then each predicted group zero-padded to
        a power of two through its expert."""
        from audiodenoiser_torch.dsp.stft import stft
        from audiodenoiser_torch.eval.ensemble import windowed_logits
        from audiodenoiser_torch.serve.server import _Request

        service, router, experts = _routed_service(_LoudnessRouter())
        rng = np.random.default_rng(7)
        clips = [(s * rng.standard_normal(n)).clip(-1, 1).astype(np.float32)
                 for s, n in ((0.05, 3000), (0.6, 4000), (0.2, 2500), (0.9, 3900), (0.01, 1000))]
        batch = [_Request(c, len(c), "auto", 4000) for c in clips]
        service._run_batch(batch)
        stacked = np.zeros((8, 4000), np.float32)
        for i, c in enumerate(clips):
            stacked[i, : len(c)] = c
        with torch.no_grad():
            mag = stft(torch.from_numpy(stacked), 512, 128, center=True).abs()
            labels = windowed_logits(router, mag[:, None]).argmax(-1).numpy()
        assert len(set(labels[:5].tolist())) == 4  # a group per expert, one of two
        assert service.batches_run == 1 and all(r.error is None for r in batch)
        for lab in set(labels[:5].tolist()):
            idx = [i for i in range(5) if labels[i] == lab]
            sub = np.zeros((1 << (len(idx) - 1).bit_length(), 4000), np.float32)
            sub[: len(idx)] = stacked[idx]
            direct = experts[lab].denoise_audio(torch.from_numpy(sub)).numpy()
            for j, i in enumerate(idx):
                np.testing.assert_array_equal(batch[i].result, direct[j, : len(clips[i])])

    def test_denoise_defaults_to_auto(self):
        service, _, _ = _routed_service()
        x = np.clip(0.3 * np.random.default_rng(8).standard_normal(3000), -1, 1).astype(np.float32)
        assert service.default_mode == "auto" and len(service.expert_runners) == 4
        out = service.denoise(x)
        assert out.shape == x.shape and np.isfinite(out).all()
        np.testing.assert_array_equal(service.denoise(x, mode="auto"), out)

    def test_auto_needs_a_router(self):
        with pytest.raises(ValueError, match="--auto_route"):
            DenoiseService(_runner(), bucket_samples=4000, default_mode="auto")
        with pytest.raises(ValueError, match="--auto_route"):
            DenoiseService(_runner(), bucket_samples=4000).denoise(np.ones(100, np.float32),
                                                                     mode="auto")

    def test_matches_jax_routed_service(self):
        """Same router, experts and clip: the port's mode=auto answer
        against the JAX service's over its folded fp32 runners."""
        from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
        from audiodenoiser_tpu.models import UNet as FlaxUNet
        from audiodenoiser_tpu.models import fold_runner_inputs
        from audiodenoiser_tpu.models.router import NoiseClassifier as FlaxClassifier
        from audiodenoiser_tpu.serve import DenoiseService as JaxService

        jax_experts = {}
        for i in range(4):
            fm, fv = fold_runner_inputs(FlaxUNet(**NARROW), random_flax_variables(30 + i, **NARROW),
                                        dtype=jnp.float32)
            jax_experts[i] = JaxRunner(fm, fv)
        _, params = _router()
        jax_service = JaxService(jax_experts[0], bucket_samples=4000,
                                 router=(FlaxClassifier(dtype=jnp.float32), params),
                                 expert_runners=jax_experts, default_mode="auto")
        audio = np.clip(0.3 * np.random.default_rng(9).standard_normal(5000), -1, 1)
        audio = audio.astype(np.float32)
        ref = jax_service.denoise(audio)
        ours = _routed_service()[0].denoise(audio)
        assert ours.shape == ref.shape == (5000,)
        assert np.linalg.norm(ours - ref) / np.linalg.norm(ref) < 1e-4


class TestServeCLI:
    def test_defaults_and_flags(self):
        from audiodenoiser_torch.cli.serve import parse_args

        a = parse_args([])
        assert (a.noise_type, a.port, a.bucket_seconds, a.precision) == \
            ("white", 8800, 2.0, "bf16")
        assert a.bypass_db is None
        b = parse_args(["--noise_type", "mixed", "--precision", "f32",
                        "--bypass_db", "40", "--max_seconds", "5"])
        assert (b.noise_type, b.precision, b.bypass_db, b.max_seconds) == \
            ("mixed", "f32", 40.0, 5.0)

    def test_unknown_noise_type_rejected(self):
        from audiodenoiser_torch.cli.serve import parse_args

        with pytest.raises(SystemExit):
            parse_args(["--noise_type", "pink"])
