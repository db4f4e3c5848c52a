"""WOLA streaming (``eval/streaming.py``) against the JAX package's
``StreamingDenoiser`` on the CPU, and the HTTP stream API of the port's
server and serve CLI. A small chunk (2048) keeps the CPU time short.
Bounds: 1e-5 relative L2 between the two packages (one STFT round trip
per window); a session against the offline denoise of the same runner
exactly (every window runs alone in both)."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.cli import serve as serve_cli
from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.eval.streaming import StreamingDenoiser
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    UNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
)
from audiodenoiser_torch.serve import DenoiseService, make_http_server
from audiodenoiser_torch.train.checkpoints import export_model
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.eval.streaming import StreamingDenoiser as JaxStreamer
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)  # width_mult 0.125
CHUNK = 2048
PACKETS = [700, 1500, 3000, 100, 2600, 1100]  # 9000 samples, ragged


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _audio(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(0.2 * rng.standard_normal(n), -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pair(request):
    """(port streamer, JAX streamer) over the same folded fp32 model."""
    kind = request.param
    mask = kind == "complex_mask"
    v = random_flax_variables(21, in_channels=3 if mask else 1,
                              out_channels=2 if mask else 1, **NARROW)
    model = ComplexMaskUNet(residual=True, **NARROW) if mask else UNet(**NARROW)
    ours = DenoiserRunner(fold_for_inference(load_flax_variables(model, v).eval(),
                                             torch.float32), device="cpu")
    flax_model = FlaxMaskUNet(residual=True, **NARROW) if mask else FlaxUNet(**NARROW)
    fm, fv = fold_runner_inputs(flax_model, v, dtype=jnp.float32)
    return (StreamingDenoiser(ours, chunk_samples=CHUNK),
            JaxStreamer(JaxRunner(fm, fv), chunk_samples=CHUNK, mode=kind))


MODES = pytest.mark.parametrize("pair", ["complex_mask", "noisy_phase"], indirect=True)


class TestAgainstJax:
    @MODES
    def test_offline_denoise(self, pair):
        ours, ref = pair
        x = _audio(7000)
        a, b = ours.denoise(x), ref.denoise(x)
        assert a.shape == b.shape == x.shape
        assert _rel(a, b) < 1e-5, _rel(a, b)

    @MODES
    def test_session_per_call(self, pair):
        """The same ragged packets to both: the same samples per call."""
        ours, ref = pair
        x = _audio(sum(PACKETS), seed=1)
        s, r = ours.session(), ref.session()
        assert s.latency_samples == r.latency_samples == CHUNK
        start = 0
        for n in PACKETS + ["flush"]:
            if n == "flush":
                a, b = s.flush(), r.flush()
            else:
                a, b = s.process(x[start:start + n]), r.process(x[start:start + n])
                start += n
            assert a.shape == b.shape
            if len(b):
                assert _rel(a, b) < 1e-5, (n, _rel(a, b))


@pytest.fixture(scope="module")
def mask_streamer():
    v = random_flax_variables(22, in_channels=3, out_channels=2, **NARROW)
    model = load_flax_variables(ComplexMaskUNet(residual=True, **NARROW), v).eval()
    runner = DenoiserRunner(fold_for_inference(model, torch.float32), device="cpu")
    return StreamingDenoiser(runner, chunk_samples=CHUNK)


class TestSession:
    @pytest.mark.parametrize("n", [9000, 2048, 1500, 700])
    def test_flush_is_sample_exact(self, mask_streamer, n):
        x = _audio(n, seed=n)
        sess = mask_streamer.session()
        pieces = [sess.process(p) for p in np.array_split(x, 5)]
        pieces.append(sess.flush())
        y = np.concatenate(pieces)
        assert len(y) == n
        np.testing.assert_array_equal(y, mask_streamer.denoise(x))
        assert len(sess.flush()) == 0

    def test_process_after_flush_raises(self, mask_streamer):
        sess = mask_streamer.session()
        sess.process(_audio(3000))
        sess.flush()
        with pytest.raises(RuntimeError, match="flushed"):
            sess.process(_audio(100))

    def test_nothing_before_one_chunk(self, mask_streamer):
        sess = mask_streamer.session()
        assert len(sess.process(np.zeros(CHUNK - 1, np.float32))) == 0
        assert len(sess.process(np.zeros(1, np.float32))) == CHUNK // 2

    def test_state_stays_on_runner_device(self, mask_streamer):
        sess = mask_streamer.session()
        sess.process(_audio(5000))
        assert sess._prev.device == sess._carry.device == mask_streamer.device

    def test_odd_chunk_rejected(self, mask_streamer):
        with pytest.raises(ValueError, match="even"):
            StreamingDenoiser(mask_streamer.runner, chunk_samples=999)

    def test_needs_a_gpu_unless_asked(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingDenoiser(DenoiserRunner(ComplexMaskUNet(**NARROW)))


def _post(url, body=b"", timeout=60):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _code(url, body=b""):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    return e.value


class _Serving:
    def __init__(self, service, **kw):
        self.srv = make_http_server(service, "127.0.0.1", 0, **kw)
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


class _EchoSession:
    latency_samples = 4

    def process(self, samples):
        return np.asarray(samples, np.float32)

    def flush(self):
        return np.zeros(0, np.float32)


class _NullRunner:
    device = None

    def denoise_audio(self, audio, **kw):
        return audio


class TestHTTPStream:
    def test_start_packets_flush(self, mask_streamer):
        service = DenoiseService(mask_streamer.runner, bucket_samples=CHUNK,
                                 default_mode="complex_mask")
        s = _Serving(service, stream_factory=lambda mode: mask_streamer.session())
        try:
            info = json.loads(_post(f"{s.url}/stream/start"))
            assert info["format"] == "f32le" and info["sample_rate"] == 8000
            assert info["latency_samples"] == CHUNK and info["generation"] == 0
            x = _audio(5000, seed=3)
            got = [np.frombuffer(_post(f"{s.url}/stream/{info['session']}",
                                       p.astype("<f4").tobytes()), "<f4")
                   for p in np.array_split(x, 3)]
            text = urllib.request.urlopen(f"{s.url}/metrics", timeout=30).read().decode()
            assert "adt_stream_sessions 1" in text
            got.append(np.frombuffer(_post(f"{s.url}/stream/{info['session']}/flush"), "<f4"))
            y = np.concatenate(got)
            assert len(y) == len(x)
            np.testing.assert_array_equal(y, mask_streamer.denoise(x))
            # flushed sessions are gone
            assert _code(f"{s.url}/stream/{info['session']}", b"\0" * 4).code == 404
        finally:
            s.close()

    def test_errors(self):
        s = _Serving(DenoiseService(_NullRunner()), stream_factory=lambda mode: _EchoSession())
        try:
            assert _code(f"{s.url}/stream/0123456789abcdef").code == 404
            assert _code(f"{s.url}/stream/nope").code == 404
            assert _code(f"{s.url}/stream/start?rate=abc").code == 400
            e = _code(f"{s.url}/stream/start?rate=16000")
            assert e.code == 501 and "A.9" in e.read().decode()
            sid = json.loads(_post(f"{s.url}/stream/start?rate=8000"))["session"]
            assert _code(f"{s.url}/stream/{sid}", b"\0" * 6).code == 400  # not f32
        finally:
            s.close()

    def test_session_cap_is_503(self):
        service = DenoiseService(_NullRunner())
        s = _Serving(service, stream_factory=lambda mode: _EchoSession(),
                     max_stream_sessions=2)
        try:
            for _ in range(2):
                _post(f"{s.url}/stream/start")
            e = _code(f"{s.url}/stream/start")
            assert e.code == 503 and e.headers["Retry-After"] == "1"
            assert "adt_overloaded_total 1" in service.metrics_text()
        finally:
            s.close()

    def test_idle_sessions_expire(self):
        s = _Serving(DenoiseService(_NullRunner()), stream_factory=lambda mode: _EchoSession(),
                     stream_ttl=0.2)
        try:
            sid = json.loads(_post(f"{s.url}/stream/start"))["session"]
            body = np.arange(3, dtype="<f4").tobytes()
            assert _post(f"{s.url}/stream/{sid}", body) == body
            time.sleep(0.4)
            assert _code(f"{s.url}/stream/{sid}", body).code == 404
        finally:
            s.close()

    def test_concurrent_packets_keep_order(self):
        """Each session has its own lock: packets of one session run one
        at a time, so a counter the session bumps loses no update."""

        class Counting(_EchoSession):
            def __init__(self):
                self.n = 0

            def process(self, samples):
                n = self.n
                time.sleep(0.001)
                self.n = n + 1
                return np.zeros(0, np.float32)

        made = []

        def factory(mode):
            made.append(Counting())
            return made[-1]

        s = _Serving(DenoiseService(_NullRunner()), stream_factory=factory)
        try:
            sid = json.loads(_post(f"{s.url}/stream/start"))["session"]
            threads = [threading.Thread(target=_post, args=(f"{s.url}/stream/{sid}", b"\0" * 4))
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            assert made[0].n == 16
        finally:
            s.close()


@pytest.fixture(scope="module")
def mask_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("saved")
    v = random_flax_variables(23, in_channels=3, out_channels=2, **NARROW)
    export_model(str(d / "mask_denoiser_mixed.ckpt"), v["params"], v["batch_stats"])
    with open(d / "mask_denoiser_mixed.json", "w") as f:
        json.dump({"width_mult": 0.125, "mask_bound": 2.0, "residual": True}, f)
    return d


def _cli(mask_dir, *extra):
    return serve_cli.parse_args(["--model", "complex_mask", "--noise_type", "mixed",
                                 "--saved_models_dir", str(mask_dir), "--port", "0",
                                 "--bucket_seconds", "0.25", *extra])


class TestServeCLI:
    def test_serves_mask_model_and_streams(self, mask_dir):
        service, server, name = serve_cli.build_server(
            _cli(mask_dir, "--device", "cpu", "--precision", "f32"))
        assert name == "mask_denoiser_mixed"
        assert service.default_mode == service.runner.mode == "complex_mask"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            info = json.loads(_post(f"{url}/stream/start"))
            assert info["latency_samples"] == 2000  # bucket_seconds * 8000, even
            x = _audio(3000, seed=4)
            out = _post(f"{url}/stream/{info['session']}", x.astype("<f4").tobytes())
            out += _post(f"{url}/stream/{info['session']}/flush")
            assert len(out) == 4 * len(x)
            assert _code(f"{url}/stream/start?mode=auto").code == 501
            assert _code(f"{url}/stream/start?mode=noisy_phase").code == 501
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)

    @pytest.mark.parametrize("flag,item", [(["--stream_pool", "4"], "A.9"),
                                           (["--stream_latency_ms", "224"], "A.9"),
                                           (["--auto_route"], "A.10")])
    def test_unported_flags_name_their_item(self, mask_dir, flag, item):
        with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
            _cli(mask_dir, *flag)

    @pytest.mark.parametrize("model,mode,message", [
        ("complex_mask", "griffin_lim", "ROADMAP A.7"),
        ("unet", "reference_gl", "ROADMAP A.7"),
        ("complex_mask", "auto", "ROADMAP A.10"),
        ("complex_mask", "noisy_phase", "serves complex_mask"),
        ("unet", "complex_mask", "serves noisy_phase"),
    ])
    def test_mode_must_be_the_models_own(self, model, mode, message):
        with pytest.raises(SystemExit, match=message):
            serve_cli.parse_args(["--model", model, "--mode", mode])

    @pytest.mark.parametrize("model,mode", [("complex_mask", "complex_mask"),
                                            ("unet", "noisy_phase")])
    def test_mode_defaults_to_the_models_own(self, model, mode):
        assert serve_cli.parse_args(["--model", model]).mode == mode
        assert serve_cli.parse_args(["--model", model, "--mode", mode]).mode == mode

    def test_needs_a_gpu_unless_asked(self, mask_dir, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_cli.build_server(_cli(mask_dir))
