"""HTTP denoise service over ``DenoiserRunner`` (port of ``serve/server.py``).

- **Length bucketing**: audio is zero-padded to the next multiple of
  ``bucket_samples`` and trimmed back after reconstruction, so the device
  sees a few shapes instead of one per request length.
- **Micro-batching**: one dispatcher thread drains the admission queue;
  requests of one (bucket, mode) that arrive while the device is busy run
  as one batched call, the batch padded to a power of two.
- **Fairness and backpressure**: pending (bucket, mode) groups are served
  round-robin, and a full admission queue raises ``ServiceOverloaded``
  (HTTP 503) instead of growing without bound.
- ``make_http_server``: ``GET /healthz``, ``GET /metrics`` (Prometheus
  text with a latency histogram) and ``POST /denoise`` with WAV bytes in
  and out (``X-Latency-Ms`` header, ``?mode=``: the Griffin-Lim modes
  draw their initial phase from one constant seed, as the JAX service's
  constant key does; ``mode=auto`` when the service has a noise router
  and expert runners: the coalesced batch is classified on the device and
  each predicted group runs through its specialist); with a ``stream_factory``
  also the chunked streaming API, ``POST /stream/start``,
  ``POST /stream/{id}`` and ``POST /stream/{id}/flush``; with a
  ``reload_fn`` also ``POST /admin/reload``, a hot swap of the model.
- ``DenoiseService.reload``: the next batch runs on the new runner (and
  router and experts); the batch on the device finishes on the old ones.
  ``generation`` counts the swaps (``adt_model_generation``,
  ``/healthz``'s ``model_generation``).
"""

from __future__ import annotations

import io
import json
import queue
import re
import threading
import time
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.data.wav_io import read_wav, write_wav
from audiodenoiser_torch.device import device_name
from audiodenoiser_torch.eval.ensemble import windowed_logits
from audiodenoiser_torch.eval.streaming import ResampledStreamingSession


class ServiceOverloaded(RuntimeError):
    """Admission queue full — surfaced to HTTP callers as 503."""


class _Request:
    __slots__ = ("audio", "n", "mode", "bucket", "result", "error", "done")

    def __init__(self, audio, n, mode, bucket):
        self.audio = audio
        self.n = n
        self.mode = mode
        self.bucket = bucket
        self.result = None
        self.error = None
        self.done = threading.Event()


def _pow2_batch(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class DenoiseService:
    def __init__(
        self,
        runner,
        sample_rate: int = 8000,
        bucket_samples: int = 16000,
        max_seconds: float = 60.0,
        default_mode: str = "noisy_phase",
        max_batch: int = 8,
        max_queue: int = 128,
        warmup: bool = False,
        router=None,  # (NoiseClassifier, training window) for mode='auto'
        expert_runners=None,  # {label index: DenoiserRunner} for mode='auto'
        auto_expert_mode: str = "noisy_phase",  # the specialists' mode
        bypass_db=None,  # identity-bypass gate threshold (dB); None/<=0 off
    ):
        self.runner = runner
        self.sample_rate = sample_rate
        self.bucket = bucket_samples
        self.max_samples = int(max_seconds * sample_rate)
        self.default_mode = default_mode
        self.max_batch = max_batch
        self.bypass_db = (
            None if bypass_db is not None and bypass_db <= 0 else bypass_db
        )
        self.generation = 0  # model generation, bumped by reload()
        self.requests_served = 0
        self.batches_run = 0
        self.overloaded_total = 0
        self.errors_total = 0
        # request latency histogram (admission -> result), Prometheus-style
        # cumulative buckets in milliseconds
        self._lat_bounds = (10, 25, 50, 100, 250, 500, 1000, 2500, 10000)
        self._lat_counts = [0] * (len(self._lat_bounds) + 1)  # +inf tail
        self._lat_sum_ms = 0.0
        self._lat_n = 0
        self._metrics_lock = threading.Lock()
        self.auto_expert_mode = auto_expert_mode
        # (classify, expert runners), swapped as one by reload()
        self._auto = None
        if router is not None and expert_runners is not None:
            self._auto = (self._build_classifier(router, runner), expert_runners)
        if default_mode == "auto" and self._auto is None:
            raise ValueError("default_mode='auto' requires router and expert_runners "
                             "(cli.serve --auto_route)")
        if warmup:
            self._warmup()
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._worker = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="denoise-dispatch"
        )
        self._worker.start()

    @property
    def expert_runners(self):
        return None if self._auto is None else self._auto[1]

    @staticmethod
    def _build_classifier(router, runner):
        """(B, samples) audio -> (B,) numpy labels: the centred STFT on the
        runner's path (K1 on the card), its magnitude, the router's
        windowed vote (``eval.ensemble.windowed_logits``) and the argmax."""
        model, window = router
        model = model.to(runner.device).eval()

        @torch.inference_mode()
        def classify(audio):
            a = torch.as_tensor(audio, dtype=torch.float32).to(runner.device)
            mag = stft_lib.stft(a, runner.n_fft, runner.hop, center=True,
                                precision=runner.precision).abs()
            return windowed_logits(model, mag[:, None], window).argmax(-1).cpu().numpy()

        return classify

    def _warmup(self, runner=None, auto=None):
        """Run the first bucket at batch 1 and ``max_batch`` before serving
        (through the router and every expert in ``mode=auto``), so the first
        requests do not pay the kernel build and cuDNN set-up."""
        runner = self.runner if runner is None else runner
        auto = self._auto if auto is None else auto
        for b in {1, self.max_batch}:
            z = torch.zeros((b, self.bucket), dtype=torch.float32)
            if self.default_mode != "auto":
                runner.denoise_audio(z, mode=self.default_mode, bypass_db=self.bypass_db)
                continue
            auto[0](z)
            for expert in auto[1].values():
                expert.denoise_audio(z, mode=self.auto_expert_mode, bypass_db=self.bypass_db)

    def reload(self, runner=None, warmup: bool = False, expert_runners=None,
               router=None) -> int:
        """Swap in a new model generation without dropping traffic.

        The new runner, router and experts (each None keeps the current
        one) are warmed up first (``warmup``), then swapped in: the batch
        on the device finishes on the old ones, every later batch runs on
        the new. Returns the new generation."""
        runner = self.runner if runner is None else runner
        auto = self._auto
        if router is not None or expert_runners is not None:
            if auto is None and (router is None or expert_runners is None):
                raise ValueError("a first routed generation needs both router and "
                                 "expert_runners")
            classify = auto[0] if router is None else self._build_classifier(router, runner)
            auto = (classify, auto[1] if expert_runners is None else expert_runners)
        if warmup:
            self._warmup(runner, auto)
        self.runner, self._auto = runner, auto
        with self._metrics_lock:
            self.generation += 1
            return self.generation

    def _bucket_len(self, n: int) -> int:
        return max(self.bucket, -(-n // self.bucket) * self.bucket)

    def _admit(self, r, groups: dict, rotation: deque):
        key = (r.bucket, r.mode)
        if key not in groups:
            groups[key] = deque()
            rotation.append(key)
        groups[key].append(r)

    def _dispatch_loop(self):
        # pending requests grouped per (bucket, mode), groups served
        # round-robin so one steady shape cannot starve another
        groups: dict = {}
        rotation: deque = deque()
        while True:
            if not rotation:  # idle: block for work
                self._admit(self._queue.get(), groups, rotation)
            while True:  # drain whatever else piled up
                try:
                    self._admit(self._queue.get_nowait(), groups, rotation)
                except queue.Empty:
                    break
            key = rotation[0]
            rotation.rotate(-1)
            dq = groups[key]
            batch = [dq.popleft() for _ in range(min(self.max_batch, len(dq)))]
            if not dq:
                del groups[key]
                rotation.remove(key)
            self._run_batch(batch)

    def _run_batch(self, batch):
        first = batch[0]
        runner, auto = self.runner, self._auto  # one generation for the whole batch
        try:
            b_pad = _pow2_batch(len(batch), self.max_batch)
            stacked = np.zeros((b_pad, first.bucket), np.float32)
            for i, r in enumerate(batch):
                stacked[i, : r.n] = r.audio[: r.n]
            if first.mode == "auto":
                self._dispatch_auto(batch, stacked, auto)
            else:
                out = runner.denoise_audio(
                    torch.from_numpy(stacked), mode=first.mode,
                    bypass_db=self.bypass_db,
                ).float().cpu().numpy()
                for i, r in enumerate(batch):
                    r.result = out[i, : r.n]
            self.batches_run += 1
            self.requests_served += len(batch)
        except Exception as e:  # propagate to every waiter
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.done.set()

    def _dispatch_auto(self, batch, stacked, auto):
        """Router-dispatched batch: classify the power-of-two padded rows in
        one call (the padded rows' labels are discarded), then run each
        predicted group, padded to a power of two, through its specialist."""
        classify, experts = auto
        labels = classify(torch.from_numpy(stacked))
        for lab in sorted(set(labels[: len(batch)].tolist())):
            idx = [i for i in range(len(batch)) if labels[i] == lab]
            sub = np.zeros((_pow2_batch(len(idx), self.max_batch), stacked.shape[1]),
                           np.float32)
            sub[: len(idx)] = stacked[idx]
            out = experts[int(lab)].denoise_audio(
                torch.from_numpy(sub), mode=self.auto_expert_mode,
                bypass_db=self.bypass_db).float().cpu().numpy()
            for j, i in enumerate(idx):
                batch[i].result = out[j, : batch[i].n]

    def denoise(self, audio: np.ndarray, mode: str | None = None) -> np.ndarray:
        """Denoise one mono clip (float32 [-1,1]); thread-safe, batched."""
        mode = mode or self.default_mode
        if mode == "auto" and self._auto is None:
            raise ValueError("mode='auto' requires the service to be built with a router "
                             "and expert runners (cli.serve --auto_route)")
        n = len(audio)
        if n == 0:
            raise ValueError("empty audio")
        if n > self.max_samples:
            raise ValueError(f"clip too long: {n} > {self.max_samples} samples")
        req = _Request(np.asarray(audio, np.float32), n, mode, self._bucket_len(n))
        t0 = time.perf_counter()
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.count_overload()
            raise ServiceOverloaded(
                f"admission queue full ({self._queue.maxsize} pending)"
            ) from None
        req.done.wait()
        ms = (time.perf_counter() - t0) * 1e3
        with self._metrics_lock:
            self._lat_sum_ms += ms
            self._lat_n += 1
            for i, b in enumerate(self._lat_bounds):
                if ms <= b:
                    self._lat_counts[i] += 1
                    break
            else:
                self._lat_counts[-1] += 1
            if req.error is not None:
                self.errors_total += 1
        if req.error is not None:
            raise req.error
        return req.result

    def count_overload(self) -> None:
        with self._metrics_lock:
            self.overloaded_total += 1

    def metrics_text(self, stream_sessions: int = 0) -> str:
        """Prometheus text-format service metrics (``GET /metrics``);
        ``stream_sessions`` is the number of live stream sessions."""
        with self._metrics_lock:
            counts = list(self._lat_counts)
            lat_sum, lat_n = self._lat_sum_ms, self._lat_n
            lines = [
                "# TYPE adt_requests_total counter",
                f"adt_requests_total {self.requests_served}",
                "# TYPE adt_batches_total counter",
                f"adt_batches_total {self.batches_run}",
                "# TYPE adt_overloaded_total counter",
                f"adt_overloaded_total {self.overloaded_total}",
                "# TYPE adt_errors_total counter",
                f"adt_errors_total {self.errors_total}",
                "# TYPE adt_queue_depth gauge",
                f"adt_queue_depth {self._queue.qsize()}",
                "# TYPE adt_stream_sessions gauge",
                f"adt_stream_sessions {stream_sessions}",
                "# TYPE adt_model_generation gauge",
                f"adt_model_generation {self.generation}",
                "# TYPE adt_request_latency_ms histogram",
            ]
        cum = 0
        for bound, c in zip(self._lat_bounds, counts):
            cum += c
            lines.append(f'adt_request_latency_ms_bucket{{le="{bound}"}} {cum}')
        cum += counts[-1]
        lines.append(f'adt_request_latency_ms_bucket{{le="+Inf"}} {cum}')
        lines.append(f"adt_request_latency_ms_sum {lat_sum:.3f}")
        lines.append(f"adt_request_latency_ms_count {lat_n}")
        return "\n".join(lines) + "\n"


_STREAM_RE = re.compile(r"^/stream/([0-9a-f]{16})(/flush)?$")


def _close(session) -> None:
    """Release what a session holds (a pool slot), where it holds any."""
    close = getattr(session, "close", None)
    if callable(close):
        close()


def make_http_server(service: DenoiseService, host: str = "127.0.0.1",
                     port: int = 8800, stream_factory=None,
                     stream_ttl: float = 600.0,
                     max_stream_sessions: int = 64,
                     reload_fn=None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; call .serve_forever() to run.

    ``stream_factory(mode)`` returns a session (``process`` / ``flush`` /
    ``latency_samples``), or ``(session, generation)`` stamped from the
    same snapshot the session was built from, and enables the chunked
    streaming API:

    - ``POST /stream/start[?mode=][&rate=]`` -> ``{"session",
      "generation", "latency_samples", "format": "f32le", "sample_rate"}``;
      a ``rate`` other than the service's wraps the session in a
      ``ResampledStreamingSession``, and the stream is at the client's
      rate;
    - ``POST /stream/{id}`` with raw little-endian float32 samples in the
      body -> the samples finalized so far, in the same format;
    - ``POST /stream/{id}/flush`` -> the remaining tail; closes the session.

    Idle sessions expire after ``stream_ttl`` seconds; an unknown or
    expired session is a 404. At ``max_stream_sessions`` live sessions, or
    when the factory raises ``IndexError`` (a full pool), a start is
    refused with 503 and ``Retry-After``. A session that is refused, or
    evicted, is closed, under its own lock, so a pool slot is released.
    Each session has its own lock, so one client's packets run in order.

    ``reload_fn() -> dict`` enables ``POST /admin/reload``: 200 with the
    new ``generation``; 500 when it raises, the old generation serving on;
    501 without a ``reload_fn``.
    """
    sessions: dict = {}
    s_lock = threading.Lock()

    def live_sessions() -> int:
        with s_lock:
            return len(sessions)

    def evict_idle() -> None:
        now = time.monotonic()
        with s_lock:
            expired = [sessions.pop(sid) for sid in
                       [k for k, v in sessions.items() if now - v["t"] > stream_ttl]]
        for entry in expired:
            # under the session's lock: a packet in flight finishes before
            # its slot can go to another stream
            with entry["lock"]:
                _close(entry["s"])

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str, extra=None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, info: dict, extra=None):
            self._send(code, json.dumps(info).encode(), "application/json", extra)

        def _error(self, code: int, e: Exception, extra=None):
            self._json(code, {"error": f"{type(e).__name__}: {e}"}, extra)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "device": device_name(getattr(service.runner, "device", None)),
                    "sample_rate": service.sample_rate,
                    "requests_served": service.requests_served,
                    "model_generation": service.generation,
                })
            elif path == "/metrics":
                self._send(200, service.metrics_text(live_sessions()).encode(),
                           "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": "not found"})

        def _stream_start(self, query: str):
            evict_idle()
            qs = parse_qs(query)
            mode = qs.get("mode", [None])[0]
            rate = qs.get("rate", [None])[0]
            if rate is not None:
                try:
                    rate = int(rate)
                except ValueError:
                    raise ValueError(f"bad rate {rate!r}") from None
                if not 1000 <= rate <= 384000:
                    raise ValueError(f"rate {rate} out of range")
            # built outside s_lock: a pooled factory waits for the pool's
            # advance, which must not stall every other stream endpoint
            try:
                made = stream_factory(mode)
            except IndexError as e:  # a full pool
                service.count_overload()
                raise ServiceOverloaded(str(e)) from None
            sess, gen = made if isinstance(made, tuple) else (made, service.generation)
            if rate is not None and rate != service.sample_rate:
                sess = ResampledStreamingSession(sess, client_rate=rate,
                                                 model_rate=service.sample_rate)
            sid = uuid.uuid4().hex[:16]
            with s_lock:  # the cap holds even under concurrent starts
                live = len(sessions)
                admitted = live < max_stream_sessions
                if admitted:
                    sessions[sid] = {"s": sess, "lock": threading.Lock(),
                                     "t": time.monotonic()}
            if not admitted:
                _close(sess)
                service.count_overload()
                raise ServiceOverloaded(f"stream session limit reached ({live} live)")
            self._json(200, {"session": sid, "generation": gen,
                             "latency_samples": int(sess.latency_samples),
                             "format": "f32le",
                             "sample_rate": rate or service.sample_rate})

        def _stream_packet(self, sid: str, flushing: bool):
            evict_idle()
            with s_lock:
                entry = sessions.get(sid)
            data = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            if entry is None:
                self._json(404, {"error": "unknown or expired session"})
                return
            with entry["lock"]:
                if getattr(entry["s"], "_closed", False):  # evicted meanwhile
                    self._json(404, {"error": "unknown or expired session"})
                    return
                entry["t"] = time.monotonic()
                if flushing:
                    out = entry["s"].flush()
                    with s_lock:
                        sessions.pop(sid, None)
                else:
                    if len(data) % 4:
                        raise ValueError(f"body of {len(data)} bytes is not f32le samples")
                    out = entry["s"].process(np.frombuffer(data, dtype="<f4"))
            self._send(200, np.asarray(out, "<f4").tobytes(), "application/octet-stream")

        def _reload(self):
            if reload_fn is None:
                self._json(501, {"error": "reload not configured"})
                return
            try:
                info = dict(reload_fn() or {})
            except Exception as e:  # the old generation keeps serving
                self._error(500, e)
                return
            info.setdefault("generation", service.generation)
            self._json(200, info)

        def _stream(self, parsed):
            if stream_factory is None:
                self._json(404, {"error": "streaming not enabled on this server"})
                return
            if parsed.path == "/stream/start":
                self._stream_start(parsed.query)
                return
            m = _STREAM_RE.match(parsed.path)
            if m is None:
                self._json(404, {"error": "not found"})
                return
            self._stream_packet(m.group(1), m.group(2) is not None)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path == "/admin/reload":
                self._reload()
                return
            try:
                if parsed.path.startswith("/stream"):
                    self._stream(parsed)
                elif parsed.path == "/denoise":
                    self._denoise(parsed)
                else:
                    self._json(404, {"error": "not found"})
            except ServiceOverloaded as e:
                self._error(503, e, {"Retry-After": "1"})
            except NotImplementedError as e:  # not ported, or not this deployment's
                self._error(501, e)
            except ValueError as e:  # malformed wav or samples, bad mode, too long
                self._error(400, e)
            except Exception as e:  # device faults: the server's, not the client's
                self._error(500, e)

        def _denoise(self, parsed):
            length = int(self.headers.get("Content-Length", "0"))
            data = self.rfile.read(length)
            mode = parse_qs(parsed.query).get("mode", [None])[0]
            t0 = time.perf_counter()
            audio, _ = read_wav(io.BytesIO(data), service.sample_rate)
            out = service.denoise(audio, mode=mode)
            buf = io.BytesIO()
            write_wav(buf, out, service.sample_rate)
            latency_ms = (time.perf_counter() - t0) * 1e3
            self._send(200, buf.getvalue(), "audio/wav",
                       {"X-Latency-Ms": f"{latency_ms:.1f}"})

    return ThreadingHTTPServer((host, port), Handler)
