"""WOLA streaming (``eval/streaming.py``) against the JAX package's
``StreamingDenoiser`` on the CPU, the noise-routed session
(``RoutedStreamingSession``) against the JAX package's, and the HTTP
stream API of the port's server and serve CLI, routed streams included. A
small chunk (2048) keeps the CPU time short. Bounds: 1e-5 relative L2
between the two packages (one STFT round trip per window); a session
against the offline denoise of the same runner exactly (every window runs
alone in both)."""

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

from audiodenoiser_torch.cli import serve as serve_cli
from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.eval.ensemble import MixtureOfDenoisers
from audiodenoiser_torch.eval.streaming import RoutedStreamingSession, StreamingDenoiser
from audiodenoiser_torch.models import (
    NOISE_CLASSES,
    ComplexMaskUNet,
    NoiseClassifier,
    UNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
    random_router_flax_variables,
    router_state_dict_from_flax,
)
from audiodenoiser_torch.serve import DenoiseService, make_http_server
from audiodenoiser_torch.train.checkpoints import export_model
from audiodenoiser_tpu.eval import ensemble as jax_ens
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.eval.streaming import RoutedStreamingSession as JaxRoutedSession
from audiodenoiser_tpu.eval.streaming import StreamingDenoiser as JaxStreamer
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs
from audiodenoiser_tpu.models.router import NoiseClassifier as FlaxClassifier

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


THIN = dict(features=(4, 8), bottleneck=16)


@pytest.fixture(scope="module")
def routed_pair():
    """(port mixture, JAX mixture): the same fp32 magnitude experts and router."""
    params = random_router_flax_variables(7)["params"]
    router = NoiseClassifier(dtype=torch.float32)
    router.load_state_dict(router_state_dict_from_flax(params), strict=True)
    experts, jax_experts = {}, {}
    for i, nt in enumerate(NOISE_CLASSES):
        v = random_flax_variables(40 + i, **THIN)
        experts[nt] = load_flax_variables(UNet(**THIN), v)
        jax_experts[nt] = (FlaxUNet(dtype=jnp.float32, **THIN), v)
    return (MixtureOfDenoisers(experts, router, device="cpu"),
            jax_ens.MixtureOfDenoisers(jax_experts, params,
                                       router_model=FlaxClassifier(dtype=jnp.float32)))


def _drive(session, x, packets):
    """Each packet's output, then the flush's."""
    outs, start = [], 0
    for n in packets:
        outs.append(session.process(x[start:start + n]))
        start += n
    return outs + [session.flush()]


class _Scale(torch.nn.Module):
    def __init__(self, k):
        super().__init__()
        self.k = k

    def forward(self, x):
        return self.k * x


class _LoudRouted:
    """A mixture whose router says 1 (urban) for a loud chunk, else 0."""
    family, n_fft, hop = "magnitude", 512, 128

    def __init__(self, experts, loud):
        self.expert_models, self.expert_vars = experts, [{}, {}]
        self.device = torch.device("cpu")
        self._loud = loud

    def classify_waveform(self, w):
        return self._loud(w)


class TestRoutedStreaming:
    def test_matches_jax_and_the_chosen_expert(self, routed_pair):
        mix, jax_mix = routed_pair
        x = _audio(sum(PACKETS), seed=5)
        sess, ref = RoutedStreamingSession(mix, CHUNK), JaxRoutedSession(jax_mix, CHUNK)
        assert sess.latency_samples == ref.latency_samples == 2 * CHUNK
        ours, want = _drive(sess, x, PACKETS), _drive(ref, x, PACKETS)
        assert [len(a) for a in ours] == [len(b) for b in want]
        y = np.concatenate(ours)
        assert len(y) == len(x)
        assert _rel(y, np.concatenate(want)) < 1e-5
        assert sess.chosen == ref.chosen and sess.chosen in NOISE_CLASSES
        assert sess.switches == ref.switches == 0
        # no switch: the chosen expert's own WOLA session, exactly
        label = NOISE_CLASSES.index(sess.chosen)
        direct = StreamingDenoiser(mix.runners[label], CHUNK).session()
        np.testing.assert_array_equal(y, np.concatenate(_drive(direct, x, PACKETS)))
        assert (label, CHUNK, 8000, "kernel", "noisy_phase") in mix._stream_cache

    def test_nothing_before_the_routing_chunk_and_a_short_flush(self, routed_pair):
        mix, _ = routed_pair
        sess = RoutedStreamingSession(mix, CHUNK)
        assert len(sess.process(np.zeros(CHUNK - 1, np.float32))) == 0 and sess.chosen is None
        short = RoutedStreamingSession(mix, CHUNK)
        x = _audio(1000, seed=6)
        assert len(short.process(x)) == 0
        y = short.flush()
        assert len(y) == 1000 and short.chosen in NOISE_CLASSES and np.isfinite(y).all()

    def test_forced_switch_matches_jax(self):
        """Quiet, then loud input under a stub router: the session switches
        from the identity expert to the doubling one mid-stream, its WOLA
        state carried over, as the JAX session does."""
        import jax.numpy as jnp_

        class _FlaxScale(FlaxUNet):
            k: float = 1.0

            def __call__(self, x, train=False):
                return self.k * x

        def loud_torch(w):
            return torch.tensor([int(float(torch.as_tensor(w).abs().mean()) > 0.3)])

        def loud_jax(w):
            return jnp_.asarray([jnp_.where(jnp_.mean(jnp_.abs(w)) > 0.3, 1, 0)])

        ours = _LoudRouted([_Scale(1.0), _Scale(2.0)], loud_torch)
        ref = _LoudRouted([_FlaxScale(k=1.0), _FlaxScale(k=2.0)], loud_jax)
        x = np.concatenate([0.1 * np.ones(3 * CHUNK), 0.6 * np.ones(6 * CHUNK)])
        x = x.astype(np.float32)
        packets = [3 * CHUNK] + [CHUNK] * 6
        s = RoutedStreamingSession(ours, CHUNK, reclassify_every=1)
        r = JaxRoutedSession(ref, CHUNK, reclassify_every=1)
        a, b = _drive(s, x, packets), _drive(r, x, packets)
        assert [len(p) for p in a] == [len(p) for p in b]
        y = np.concatenate(a)
        assert len(y) == len(x)
        assert _rel(y, np.concatenate(b)) < 1e-5
        assert s.switches == r.switches >= 1 and s.chosen == r.chosen == "urban"
        np.testing.assert_allclose(y[-2 * CHUNK:], 1.2, atol=0.02)  # the 2x expert


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
        prev, carry = sess._state  # the previous hop and the overlap-add carry
        assert prev.device == carry.device == mask_streamer.device

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
            assert _code(f"{s.url}/stream/start?rate=500").code == 400
            # another rate is resampled in the stream, sample-exact at the client's
            info = json.loads(_post(f"{s.url}/stream/start?rate=16000"))
            assert info["sample_rate"] == 16000
            x = _audio(3001, seed=6)
            out = _post(f"{s.url}/stream/{info['session']}", x.astype("<f4").tobytes())
            out += _post(f"{s.url}/stream/{info['session']}/flush")
            assert len(out) == 4 * len(x)
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

    @pytest.mark.parametrize("flag,item", [(["--auto_route", "--mesh", "on"], "A.11"),
                                           (["--mesh", "on"], "A.11"),
                                           (["--model_parallel", "2"], "A.11")])
    def test_unported_flags_name_their_item(self, mask_dir, flag, item, request):
        """The device mesh is ported (ROADMAP A.11, its first half). In one
        process ``--mesh on`` serves over a world-size-1 mesh: a request
        and a stream answer as the unmeshed service's; with ``--auto_route``
        the specialists' runners are meshed and the routed denoise is the
        unmeshed one's; ``--model_parallel 2`` stops with JAX's error."""
        from audiodenoiser_torch.data.wav_io import read_wav, write_wav

        if flag == ["--model_parallel", "2"]:
            with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
                serve_cli.build_mesh(_cli(mask_dir, "--device", "cpu", *flag))
            return
        if "--auto_route" in flag:
            routed = request.getfixturevalue("routed_dir")
            argv = ["--auto_route", "--saved_models_dir", str(routed), "--port", "0",
                    "--bucket_seconds", "0.25", "--device", "cpu", "--precision", "f32"]
            mixes = []
            for extra in ([], flag[1:]):
                args = serve_cli.parse_args(argv + extra)
                _, server, _ = serve_cli.build_server(args, serve_cli.build_mesh(args))
                mixes.append(server.current_generation()["mixture"])
                server.server_close()
            assert mixes[0].runners[0].mesh is None
            assert dict(zip(mixes[1].runners[0].mesh.mesh_dim_names,
                            mixes[1].runners[0].mesh.shape)) == {"data": 1, "model": 1}
            x = torch.from_numpy(np.stack([_audio(2000, seed=s) for s in (1, 2, 3)]))
            torch.testing.assert_close(mixes[1].denoise_waveform(x),
                                       mixes[0].denoise_waveform(x), rtol=0, atol=0)
            return
        answers = []
        for extra in ([], flag):
            args = _cli(mask_dir, "--device", "cpu", "--precision", "f32", *extra)
            _, server, _ = serve_cli.build_server(args, serve_cli.build_mesh(args))
            assert (server.current_generation()["runner"].mesh is None) == (not extra)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{server.server_address[1]}"
            try:
                buf = io.BytesIO()
                write_wav(buf, _audio(1500, seed=5), 8000)
                got = read_wav(io.BytesIO(_post(f"{url}/denoise", buf.getvalue())))[0]
                info = json.loads(_post(f"{url}/stream/start"))
                x = _audio(3000, seed=6)
                out = _post(f"{url}/stream/{info['session']}", x.astype("<f4").tobytes())
                out += _post(f"{url}/stream/{info['session']}/flush")
                answers.append((got, np.frombuffer(out, "<f4")))
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=10)
        for a, b in zip(*answers):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("flag,latency", [(["--stream_pool", "4"], 2000),
                                              (["--stream_latency_ms", "224"], 1792)])
    def test_stream_flags_serve(self, mask_dir, flag, latency):
        """The stream flags the port once refused (ROADMAP A.9) serve
        sample-exact streams: a pool of 4, and low-latency sessions of a
        224 ms budget over a window of one bucket."""
        service, server, _ = serve_cli.build_server(
            _cli(mask_dir, "--device", "cpu", "--precision", "f32", *flag))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            info = json.loads(_post(f"{url}/stream/start"))
            assert info["latency_samples"] == latency
            x = _audio(3000, seed=7)
            out = _post(f"{url}/stream/{info['session']}", x.astype("<f4").tobytes())
            out += _post(f"{url}/stream/{info['session']}/flush")
            assert len(out) == 4 * len(x)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)

    @pytest.mark.parametrize("flags,precision,folded", [
        ([], "kernel", True),
        (["--precision_path", "pallas"], "kernel", True),
        (["--precision_path", "fft", "--no-fold"], "fft", False),
        (["--precision_path", "matmul", "--fold"], "matmul", True),
    ])
    def test_generation_flags(self, mask_dir, flags, precision, folded):
        """``--precision_path`` picks the runner's STFT path (JAX's Pallas
        path is the kernels) and ``--no-fold`` serves the live-BN model,
        both as each generation is built; ``--sample_rate`` sets the
        service's and the streams' rate."""
        from audiodenoiser_torch.models import FoldedUNet

        args = _cli(mask_dir, "--device", "cpu", "--sample_rate", "16000", *flags)
        gen = serve_cli.build_generation(args)
        assert gen["runner"].precision == precision
        assert isinstance(gen["runner"].model, FoldedUNet) == folded
        assert gen["runner"].model.mask_bound == 2.0
        assert gen["streamer"].sample_rate == 16000 and gen["streamer"].chunk == 4000

    def test_no_warmup_skips_the_first_batches(self, mask_dir, monkeypatch):
        calls = []
        monkeypatch.setattr(DenoiseService, "_warmup", lambda self, runner=None: calls.append(1))
        service, server, _ = serve_cli.build_server(
            _cli(mask_dir, "--device", "cpu", "--no_warmup"))
        server.server_close()
        assert calls == []
        service, server, _ = serve_cli.build_server(_cli(mask_dir, "--device", "cpu"))
        server.server_close()
        assert calls == [1]

    @pytest.mark.parametrize("flags,message", [
        (["--stream_pool", "0"], ">= 1"),
        (["--stream_pool", "many"], "integer or 'auto'"),
        (["--stream_pool", "2", "--stream_latency_ms", "224"], "WOLA sessions only"),
    ])
    def test_stream_flag_checks(self, mask_dir, flags, message):
        with pytest.raises(SystemExit, match=message):
            _cli(mask_dir, *flags)

    @pytest.mark.parametrize("model,mode,message", [
        ("complex_mask", "griffin_lim", "serves complex_mask"),
        ("unet", "reference_gl", None),  # a magnitude model serves the Griffin-Lim modes
        ("complex_mask", "auto", "requires --auto_route"),
        ("complex_mask", "noisy_phase", "serves complex_mask"),
        ("unet", "complex_mask", "serves noisy_phase"),
    ])
    def test_mode_must_be_the_models_own(self, model, mode, message):
        """A mode the model does not serve exits naming the modes it does."""
        if message is None:
            assert serve_cli.parse_args(["--model", model, "--mode", mode]).mode == mode
            return
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


@pytest.fixture(scope="module")
def routed_dir(tmp_path_factory):
    """Four magnitude specialists at width 0.125 and a seeded router."""
    d = tmp_path_factory.mktemp("routed")
    for i, nt in enumerate(NOISE_CLASSES):
        v = random_flax_variables(50 + i, **NARROW)
        export_model(str(d / f"unet_denoiser_{nt}.ckpt"), v["params"], v["batch_stats"])
        with open(d / f"unet_denoiser_{nt}.json", "w") as f:
            json.dump({"width_mult": 0.125}, f)
    export_model(str(d / "noise_router.ckpt"), random_router_flax_variables(8)["params"], {})
    return d


class TestRoutedServeCLI:
    def test_auto_route_serves_requests_and_routed_streams(self, routed_dir):
        from audiodenoiser_torch.data.wav_io import read_wav, write_wav

        service, server, _ = serve_cli.build_server(serve_cli.parse_args([
            "--auto_route", "--saved_models_dir", str(routed_dir), "--port", "0",
            "--bucket_seconds", "0.25", "--device", "cpu", "--precision", "f32"]))
        assert service.default_mode == "auto" and len(service.expert_runners) == 4
        mix = server.current_generation()["mixture"]
        assert mix.family == "magnitude" and mix.runners[0].precision == "kernel"
        url = f"http://127.0.0.1:{server.server_address[1]}"
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            buf = io.BytesIO()
            write_wav(buf, _audio(1500, seed=7), 8000)
            req = urllib.request.Request(f"{url}/denoise?mode=auto", data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = read_wav(io.BytesIO(r.read()))[0]
            sent = read_wav(io.BytesIO(buf.getvalue()))[0]
            padded = torch.from_numpy(np.pad(sent, (0, 2000 - len(sent)))[None])
            label = int(mix.classify_waveform(padded)[0])
            want = mix.runners[label].denoise_audio(padded)[0, :1500].numpy()
            back = io.BytesIO()
            write_wav(back, want, 8000)  # the answer's 16-bit PCM
            assert _rel(got, read_wav(io.BytesIO(back.getvalue()))[0]) < 1e-4
            x = _audio(sum(PACKETS), seed=8)
            for query in ("?mode=auto", ""):
                info = json.loads(_post(f"{url}/stream/start{query}"))
                assert info["latency_samples"] == 4000  # router chunk + WOLA chunk
                out = b"".join(_post(f"{url}/stream/{info['session']}",
                                     x[a:a + n].astype("<f4").tobytes())
                               for a, n in zip(np.cumsum([0] + PACKETS[:-1]), PACKETS))
                out += _post(f"{url}/stream/{info['session']}/flush")
                y = np.frombuffer(out, "<f4")
                direct = RoutedStreamingSession(mix, 2000)
                np.testing.assert_array_equal(y, np.concatenate(_drive(direct, x, PACKETS)))
            assert _code(f"{url}/stream/start?mode=complex_mask").code == 501
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10)
