"""Hot reload, generations and stream admission of the port's server and
serve CLI on the CPU (``serve/server.py``, ``cli/serve.py``), as the JAX
service defines them: ``POST /admin/reload`` swaps in the checkpoint now
in ``--saved_models_dir``; an open session finishes on its generation, new
sessions and requests take the new one; a failed reload answers 500 and
the old generation serves on. Pool slots are released when a session is
refused or evicted; a routed deployment (``--auto_route``) reloads its
router and specialists as one generation. Models: folded fp32 models at
width 0.125."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from audiodenoiser_torch.cli import serve as serve_cli
from audiodenoiser_torch.eval.runner import DenoiserRunner, load_model_for_noise
from audiodenoiser_torch.eval.streaming import (
    MultiStreamWola,
    PooledStreamSessions,
    StreamingDenoiser,
)
from audiodenoiser_torch.models import random_flax_variables
from audiodenoiser_torch.models.unet import scaled_widths
from audiodenoiser_torch.serve import DenoiseService, make_http_server
from audiodenoiser_torch.train.checkpoints import export_model

FEATS, BOTTLENECK = scaled_widths(0.125)
BUCKET = 2000  # --bucket_seconds 0.25 at 8 kHz
TOL = 1e-6  # relative L2: the same fp32 computation on both sides


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.2 * rng.standard_normal(n), -1, 1).astype(np.float32)


def _export(d, seed):
    v = random_flax_variables(seed, in_channels=3, out_channels=2, features=FEATS,
                              bottleneck=BOTTLENECK)
    export_model(str(d / "mask_denoiser_mixed.ckpt"), v["params"], v["batch_stats"])
    with open(d / "mask_denoiser_mixed.json", "w") as f:
        json.dump({"width_mult": 0.125, "mask_bound": 2.0, "residual": True}, f)


def _direct(d):
    """The runner ``cli.serve --precision f32`` builds from ``d`` now."""
    model = load_model_for_noise("mixed", str(d), dtype=torch.float32, device="cpu",
                                 stem="mask_denoiser")
    return DenoiserRunner(model, device="cpu")


def _post(url, body=b"", timeout=60):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _code(url, body=b""):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value


def _stream(url, x, sid=None):
    sid = sid or json.loads(_post(f"{url}/stream/start"))["session"]
    out = _post(f"{url}/stream/{sid}", x.astype("<f4").tobytes())
    out += _post(f"{url}/stream/{sid}/flush")
    return np.frombuffer(out, "<f4")


class _Serving:
    def __init__(self, server):
        self.srv = server
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{server.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def test_reload_over_http(tmp_path):
    _export(tmp_path, 61)
    old = _direct(tmp_path)
    service, server, _ = serve_cli.build_server(serve_cli.parse_args([
        "--model", "complex_mask", "--noise_type", "mixed", "--saved_models_dir",
        str(tmp_path), "--port", "0", "--bucket_seconds", "0.25", "--device", "cpu",
        "--precision", "f32"]))
    s = _Serving(server)
    try:
        x = _audio(3000, seed=1)
        before = json.loads(_post(f"{s.url}/stream/start"))
        assert before["generation"] == 0
        head = _post(f"{s.url}/stream/{before['session']}", x[:1200].astype("<f4").tobytes())

        _export(tmp_path, 62)
        info = json.loads(_post(f"{s.url}/admin/reload"))
        assert info["generation"] == 1 and info["saved_models_dir"] == str(tmp_path)
        assert json.loads(_get(f"{s.url}/healthz"))["model_generation"] == 1
        assert "adt_model_generation 1" in _get(f"{s.url}/metrics")
        new = _direct(tmp_path)

        # the session opened before the reload finishes on generation 0
        tail = _post(f"{s.url}/stream/{before['session']}", x[1200:].astype("<f4").tobytes())
        tail += _post(f"{s.url}/stream/{before['session']}/flush")
        got = np.frombuffer(head + tail, "<f4")
        want = StreamingDenoiser(old, chunk_samples=BUCKET).denoise(x)
        assert got.shape == x.shape and _rel(got, want) < TOL
        # a new session and a request take generation 1
        after = json.loads(_post(f"{s.url}/stream/start"))
        assert after["generation"] == 1
        got = _stream(s.url, x, after["session"])
        assert _rel(got, StreamingDenoiser(new, chunk_samples=BUCKET).denoise(x)) < TOL
        clip = _audio(1500, seed=2)
        assert _rel(service.denoise(clip), new.denoise_audio(
            np.pad(clip, (0, BUCKET - 1500))[None])[0, :1500].numpy()) < TOL

        # an unreadable directory: 500, and generation 1 serves on
        (tmp_path / "mask_denoiser_mixed.ckpt").write_bytes(b"not a checkpoint")
        e = _code(f"{s.url}/admin/reload")
        assert e.code == 500 and "error" in json.loads(e.read())
        assert service.generation == 1
        assert json.loads(_get(f"{s.url}/healthz"))["model_generation"] == 1
        assert json.loads(_post(f"{s.url}/stream/start"))["generation"] == 1
        assert _rel(service.denoise(clip), new.denoise_audio(
            np.pad(clip, (0, BUCKET - 1500))[None])[0, :1500].numpy()) < TOL
    finally:
        s.close()


def test_routed_reload_over_http(tmp_path):
    """``cli.serve --auto_route``: ``/admin/reload`` of new specialists and
    a new router gives generation 1, and a ``mode=auto`` request after it
    is the new mixture's routed answer."""
    from audiodenoiser_torch.models import NOISE_CLASSES, random_router_flax_variables

    def export(seed):
        for i, nt in enumerate(NOISE_CLASSES):
            v = random_flax_variables(seed + i, features=FEATS, bottleneck=BOTTLENECK)
            export_model(str(tmp_path / f"unet_denoiser_{nt}.ckpt"), v["params"],
                         v["batch_stats"])
            with open(tmp_path / f"unet_denoiser_{nt}.json", "w") as f:
                json.dump({"width_mult": 0.125}, f)
        export_model(str(tmp_path / "noise_router.ckpt"),
                     random_router_flax_variables(seed)["params"], {})

    def routed(mix, clip):
        padded = torch.from_numpy(np.pad(clip, (0, BUCKET - len(clip)))[None])
        label = int(mix.classify_waveform(padded)[0])
        return mix.runners[label].denoise_audio(padded)[0, : len(clip)].numpy()

    export(70)
    service, server, _ = serve_cli.build_server(serve_cli.parse_args([
        "--auto_route", "--saved_models_dir", str(tmp_path), "--port", "0",
        "--bucket_seconds", "0.25", "--device", "cpu", "--precision", "f32"]))
    s = _Serving(server)
    try:
        clip = _audio(1500, seed=3)
        old = server.current_generation()["mixture"]
        assert _rel(service.denoise(clip), routed(old, clip)) < TOL
        export(80)
        info = json.loads(_post(f"{s.url}/admin/reload"))
        assert info["generation"] == 1 and service.generation == 1
        new = server.current_generation()["mixture"]
        assert new is not old and service.expert_runners[0] is new.runners[0]
        assert json.loads(_post(f"{s.url}/stream/start?mode=auto"))["generation"] == 1
        want = routed(new, clip)
        assert _rel(service.denoise(clip, mode="auto"), want) < TOL
        assert _rel(want, routed(old, clip)) > 1e-2  # another generation's answer
    finally:
        s.close()


class _Runner:
    device = None

    def __init__(self, scale=1.0):
        self.scale = scale
        self.calls = []

    def denoise_audio(self, audio, **kw):
        self.calls.append(tuple(audio.shape))
        return audio * self.scale


class _SpectralRunner(_Runner):
    """What the service's router reads off its runner: the STFT's shape,
    path and device."""
    n_fft, hop, precision, device = 512, 128, "fft", torch.device("cpu")


class TestService:
    def test_reload_warms_the_new_runner_before_the_swap(self):
        service = DenoiseService(_Runner(), bucket_samples=100, max_batch=4)
        new = _Runner(scale=2.0)
        seen = []
        new.denoise_audio = lambda audio, **kw: seen.append(service.runner is new) or audio
        assert service.reload(runner=new, warmup=True) == 1
        assert seen == [False, False] and service.runner is new  # batch 1 and 4
        assert "adt_model_generation 1" in service.metrics_text()

    def test_requests_after_a_reload_use_the_new_runner(self):
        service = DenoiseService(_Runner(), bucket_samples=100)
        x = _audio(50)
        np.testing.assert_array_equal(service.denoise(x), x)
        service.reload(runner=_Runner(scale=2.0))
        np.testing.assert_allclose(service.denoise(x), 2 * x)

    @pytest.mark.parametrize("kw", [dict(expert_runners={}), dict(router=object())])
    def test_routed_reload_is_refused(self, kw):
        """Half a routed generation cannot be swapped into a service that
        has none: a router needs its experts and the experts a router."""
        service = DenoiseService(_Runner())
        with pytest.raises(ValueError, match="both router and expert_runners"):
            service.reload(**kw)
        assert service.generation == 0 and service.expert_runners is None

    def test_routed_reload_swaps_router_and_experts(self):
        """A routed generation swaps in whole and bumps the generation; the
        new experts are warmed up before the swap."""
        from audiodenoiser_torch.models import NoiseClassifier

        old = {i: _Runner(scale=1.0) for i in range(4)}
        service = DenoiseService(_SpectralRunner(), bucket_samples=100, max_batch=2,
                                 router=(NoiseClassifier(dtype=torch.float32), (256, 64)),
                                 expert_runners=old, default_mode="auto")
        x = _audio(50)
        np.testing.assert_array_equal(service.denoise(x), x)
        new = {i: _Runner(scale=3.0) for i in range(4)}
        seen = []
        for r in new.values():
            r.denoise_audio = (lambda audio, _r=r, **kw: seen.append(service.expert_runners
                                                                      is new) or 3.0 * audio)
        assert service.reload(expert_runners=new, warmup=True) == 1
        assert seen and not any(seen) and service.expert_runners is new
        np.testing.assert_allclose(service.denoise(x), 3.0 * x)
        assert "adt_model_generation 1" in service.metrics_text()

    def test_no_reload_fn_is_501(self):
        s = _Serving(make_http_server(DenoiseService(_Runner()), "127.0.0.1", 0))
        try:
            assert _code(f"{s.url}/admin/reload").code == 501
        finally:
            s.close()


class _Closable:
    latency_samples = 4

    def __init__(self):
        self._closed = False

    def process(self, samples):
        return np.asarray(samples, np.float32)

    def flush(self):
        return np.zeros(0, np.float32)

    def close(self):
        self._closed = True


class TestAdmission:
    def test_refused_session_is_closed(self):
        made = []

        def factory(mode):
            made.append(_Closable())
            return made[-1], 7  # a generation-stamped factory

        service = DenoiseService(_Runner())
        s = _Serving(make_http_server(service, "127.0.0.1", 0, stream_factory=factory,
                                      max_stream_sessions=1))
        try:
            assert json.loads(_post(f"{s.url}/stream/start"))["generation"] == 7
            assert _code(f"{s.url}/stream/start").code == 503
            assert [m._closed for m in made] == [False, True]
            assert "adt_overloaded_total 1" in service.metrics_text()
        finally:
            s.close()

    @pytest.fixture(scope="class")
    def runner(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("pool")
        _export(d, 63)
        return _direct(d)

    def test_full_pool_is_503_and_a_flushed_slot_is_reused(self, runner):
        pooled = PooledStreamSessions(MultiStreamWola(runner, capacity=2, chunk_samples=BUCKET))
        service = DenoiseService(runner, bucket_samples=BUCKET)
        s = _Serving(make_http_server(service, "127.0.0.1", 0,
                                      stream_factory=lambda mode: pooled.session()))
        try:
            sids = [json.loads(_post(f"{s.url}/stream/start"))["session"] for _ in range(2)]
            e = _code(f"{s.url}/stream/start")
            assert e.code == 503 and "pool full" in e.read().decode()
            x = _audio(2500, seed=4)
            y = _stream(s.url, x, sids[0])  # the flush closes the session and its slot
            want = StreamingDenoiser(runner, chunk_samples=BUCKET).denoise(x)
            assert len(y) == len(x) and _rel(y, want) < 1e-5
            assert len(_stream(s.url, x)) == len(x)  # on the freed slot
        finally:
            s.close()

    def test_evicted_pooled_session_frees_its_slot(self, runner):
        pooled = PooledStreamSessions(MultiStreamWola(runner, capacity=1, chunk_samples=BUCKET))
        s = _Serving(make_http_server(DenoiseService(runner, bucket_samples=BUCKET),
                                      "127.0.0.1", 0, stream_ttl=0.2,
                                      stream_factory=lambda mode: pooled.session()))
        try:
            sid = json.loads(_post(f"{s.url}/stream/start"))["session"]
            time.sleep(0.4)
            # the start evicts the idle session first, closing its slot
            assert len(_stream(s.url, _audio(900, seed=5))) == 900
            assert _code(f"{s.url}/stream/{sid}", b"\0" * 4).code == 404
        finally:
            s.close()
