"""Streaming denoising (port of ``eval/streaming.py``).

- ``StreamingDenoiser`` / ``StreamingSession``: chunk-level weighted
  overlap-add. The signal is cut into windows of ``chunk_samples``
  advanced by half a window; each window goes through the runner's fused
  path (STFT -> model -> iSTFT, the K1 and K2 kernels on the card) on its
  own, as a batch of one, and is weighted by a periodic Hann crossfade,
  which sums to one at 50% overlap. ``denoise`` runs a whole signal
  offline; a session takes any number of samples and returns every sample
  that is final, with a latency of one chunk.
- ``LowLatencyStreamingDenoiser`` / ``LowLatencyStreamingSession``: a
  rolling window of ``window_samples`` (the model keeps its full left
  context) denoised every ``hop_samples``, emitting the hop that has
  ``lookahead_samples`` of right context, blended over ``xfade_samples``:
  a latency of ``hop + lookahead + xfade``.
- ``MultiStreamWola`` (with ``PooledStreamSessions`` / ``PooledSession``
  for server threads): the WOLA state of up to ``capacity`` streams as
  ``(capacity, hop)`` tensors, every live stream advanced by one
  ``(capacity, chunk)`` batch per hop step; ``auto_pool_capacity`` sizes
  the pool to the card's memory.
- ``StreamingResampler`` / ``ResampledStreamingSession``: host-side
  polyphase resampling whose streamed output is bit-identical to
  ``resample_poly`` of the whole signal, so a client at another rate
  rides a model-rate session.

The session state stays on the runner's device between calls. A session
runs its windows one at a time, at batch 1, where JAX scans a packet's
windows in power-of-two dispatches to bound its recompiles: the results
are those of JAX's scan, and in bf16 they do not change with the packet
sizes (cuDNN picks kernels by batch size, ROADMAP C.1).

- ``RoutedStreamingSession``: the noise router (``eval.ensemble``) picks
  the specialist on the stream's first chunk and re-routes every
  ``reclassify_every`` chunks; on a switch the WOLA state moves whole to
  the new specialist's session, so the next window crossfades the two.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from audiodenoiser_torch.dsp.window import hann_window
from audiodenoiser_torch.models.router import NOISE_CLASSES


def _empty() -> np.ndarray:
    return np.zeros(0, np.float32)


class StreamingDenoiser:
    """Chunked WOLA denoiser around a ``DenoiserRunner``, in the runner's
    mode."""

    def __init__(self, runner, chunk_samples: int = 16000, sample_rate: int = 8000):
        if chunk_samples % 2:
            raise ValueError("chunk_samples must be even (50% overlap)")
        self.runner = runner
        self.chunk = chunk_samples
        self.hop = chunk_samples // 2
        self.sample_rate = sample_rate
        self.mode = runner.mode
        self.device = runner.device
        # periodic Hann: sums to 1 at 50% overlap
        self.xfade = torch.from_numpy(hann_window(chunk_samples)).to(self.device)

    @property
    def latency_samples(self) -> int:
        return self.chunk

    @property
    def lead_in(self) -> int:
        return self.hop

    def _denoise_window(self, window: torch.Tensor) -> torch.Tensor:
        """One (chunk,) window, denoised alone and crossfaded."""
        out = self.runner.denoise_audio(window[None], mode=self.mode)[0]
        return out * self.xfade

    def initial_state(self) -> tuple:
        """(previous hop, overlap-add carry): the silent lead-in."""
        zeros = torch.zeros(self.hop, device=self.device)
        return zeros, zeros.clone()

    def step(self, state: tuple, new_hop: torch.Tensor):
        """Denoise the window [previous hop | new hop]; returns the next
        state and the hop it finalised."""
        prev, carry = state
        den = self._denoise_window(torch.cat([prev, new_hop]))
        return (new_hop, den[self.hop:]), carry + den[: self.hop]

    def flush_padding(self, staged: int) -> int:
        """Silence that emits a session's tail, given its staged samples."""
        return self.chunk

    @torch.inference_mode()
    def denoise(self, audio) -> np.ndarray:
        """Offline streaming-equivalent denoise of a whole (samples,) signal."""
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        n = audio.shape[-1]
        # lead-in and lead-out padding so every sample gets full window weight
        n_windows = max(1, math.ceil(n / self.hop) + 1)
        padded_len = (n_windows + 1) * self.hop
        padded = F.pad(audio, (self.hop, padded_len - n - self.hop))
        outs = torch.stack([self._denoise_window(w)
                            for w in padded.unfold(0, self.chunk, self.hop)])
        acc = torch.zeros(padded_len, dtype=torch.float32, device=self.device)
        # scatter-free WOLA: windows at even and at odd positions are disjoint
        even = outs[0::2].reshape(-1)
        odd = outs[1::2].reshape(-1)
        acc[: even.shape[0]] += even
        acc[self.hop: self.hop + odd.shape[0]] += odd
        return acc[self.hop: self.hop + n].cpu().numpy()

    def session(self) -> "StreamingSession":
        return StreamingSession(self)


class StreamingSession:
    """Stateful real-time wrapper: push samples, pull denoised samples.

    The engine (a ``StreamingDenoiser`` or ``LowLatencyStreamingDenoiser``)
    gives the silent initial state, the window step and the lead-in to
    drop: the first ``lead_in`` finalised samples belong to the silence
    before the stream. Emission never runs past the samples fed, so a
    flushed session has returned exactly as many samples as it was given.
    Flushing ends the session: a second flush returns nothing and
    ``process`` raises.
    """

    def __init__(self, parent):
        self.p = parent
        self._staging = _empty()  # host staging, < hop samples
        self._state = parent.initial_state()
        self._drop = parent.lead_in  # lead-in samples still to swallow
        self._fed = 0  # real input samples fed (flush padding excluded)
        self._emitted = 0  # output samples returned so far
        self._flushed = False

    @property
    def latency_samples(self) -> int:
        return self.p.latency_samples

    def process(self, samples) -> np.ndarray:
        """Feed samples; returns whatever denoised audio is final."""
        if self._flushed:
            # the state holds the flush's silence: further output would be
            # its decay crossfaded into the new input
            raise RuntimeError("session is flushed; open a new session")
        samples = np.asarray(samples, np.float32).ravel()
        self._fed += samples.size
        return self._advance(samples)

    @torch.inference_mode()
    def _advance(self, samples: np.ndarray) -> np.ndarray:
        p = self.p
        self._staging = np.concatenate([self._staging, samples])
        k = len(self._staging) // p.hop
        if k == 0:
            return _empty()
        hops = torch.from_numpy(self._staging[: k * p.hop].reshape(k, p.hop)).to(p.device)
        self._staging = self._staging[k * p.hop:]
        finals = []
        for new in hops:  # the state threads hop by hop
            self._state, out = p.step(self._state, new)
            finals.append(out)
        out = torch.cat(finals).cpu().numpy()
        if self._drop:
            d = min(self._drop, len(out))
            out = out[d:]
            self._drop -= d
        # never emit past the samples fed: the tail beyond is the flush
        # silence's decay, which the offline denoise() trims the same way
        out = out[: max(0, self._fed - self._emitted)]
        self._emitted += len(out)
        return out

    def flush(self) -> np.ndarray:
        """Pad with silence to emit the buffered tail (the padding is not
        counted as fed) and end the session."""
        if self._flushed:
            return _empty()
        self._flushed = True
        pad = self.p.flush_padding(len(self._staging))
        return self._advance(np.zeros(pad, np.float32))


class RoutedStreamingSession:
    """Self-routing real-time denoising over a ``MixtureOfDenoisers``.

    The router classifies the stream's first full chunk and the chunk goes
    to that specialist's WOLA session: one chunk of router listening on top
    of the session's own chunk of latency. Every ``reclassify_every``
    chunks of input (None: never) the router scores the latest chunk
    again; when the label changes, the old session's WOLA state (the
    previous hop and the overlap-add carry, device tensors, the staging,
    the lead-in left to drop and the sample counts) moves whole to the new
    specialist's session, whose next window crossfades out of the old
    expert's tail. ``chosen`` names the current specialist, ``switches``
    counts the changes. Either family: magnitude experts stream in
    ``noisy_phase``, mask experts in ``complex_mask``.
    """

    def __init__(self, mixture, chunk_samples: int = 16000, sample_rate: int = 8000,
                 precision: str = "kernel", reclassify_every: Optional[int] = 4):
        self.mixture = mixture
        self.chunk = chunk_samples
        self.sample_rate = sample_rate
        self.precision = precision
        self.reclassify_every = reclassify_every
        self._buffer = _empty()
        self._inner: Optional[StreamingSession] = None
        self.chosen: Optional[str] = None
        self.switches = 0
        self._label: Optional[int] = None
        self._recent = _empty()  # the latest <= chunk input samples
        self._since_check = 0  # input samples since the last routing check

    def _streamer_for(self, label: int) -> StreamingDenoiser:
        """One ``StreamingDenoiser`` per (label, chunk, rate, precision,
        mode), cached on the mixture for every later stream, over the
        mixture's own runner of that expert when its precision is the
        session's (a meshed expert runs only through it)."""
        from audiodenoiser_torch.eval.runner import DenoiserRunner

        cache = getattr(self.mixture, "_stream_cache", None)
        if cache is None:
            cache = self.mixture._stream_cache = {}
        mode = "complex_mask" if self.mixture.family == "mask" else "noisy_phase"
        key = (label, self.chunk, self.sample_rate, self.precision, mode)
        if key not in cache:
            runner = getattr(self.mixture, "runners", [None] * (label + 1))[label]
            if runner is None or runner.precision != self.precision:
                runner = DenoiserRunner(self.mixture.expert_models[label], self.mixture.n_fft,
                                        self.mixture.hop, device=self.mixture.device,
                                        precision=self.precision)
            cache[key] = StreamingDenoiser(runner, self.chunk, self.sample_rate)
        return cache[key]

    @property
    def latency_samples(self) -> int:
        # one chunk of router listening + the WOLA chunk
        return 2 * self.chunk

    def _classify_chunk(self, chunk: np.ndarray) -> int:
        return int(self.mixture.classify_waveform(torch.from_numpy(chunk)[None])[0])

    def _maybe_reclassify(self, samples: np.ndarray) -> None:
        if self.reclassify_every is None or self._inner is None:
            return
        self._recent = np.concatenate([self._recent, samples])[-self.chunk:]
        self._since_check += len(samples)
        if (self._since_check < self.reclassify_every * self.chunk
                or len(self._recent) < self.chunk):
            return
        self._since_check = 0
        label = self._classify_chunk(self._recent)
        if label == self._label:
            return
        old, new = self._inner, self._streamer_for(label).session()
        for name in ("_state", "_staging", "_drop", "_fed", "_emitted"):
            setattr(new, name, getattr(old, name))
        self._inner, self._label = new, label
        self.chosen = NOISE_CLASSES[label]
        self.switches += 1

    def _route(self, chunk_for_classify: np.ndarray, buffered: np.ndarray) -> np.ndarray:
        """Classify, open the chosen specialist's session and hand it the
        buffered samples (for ``process`` and a short stream's ``flush``)."""
        label = self._classify_chunk(chunk_for_classify)
        self._label = label
        self.chosen = NOISE_CLASSES[label]
        self._inner = self._streamer_for(label).session()
        self._recent = buffered[-self.chunk:]
        self._buffer = _empty()
        return self._inner.process(buffered)

    def process(self, samples) -> np.ndarray:
        samples = np.asarray(samples, np.float32).ravel()
        if self._inner is not None:
            self._maybe_reclassify(samples)
            return self._inner.process(samples)
        self._buffer = np.concatenate([self._buffer, samples])
        if len(self._buffer) < self.chunk:
            return _empty()
        return self._route(self._buffer[: self.chunk], self._buffer)

    def flush(self) -> np.ndarray:
        if self._inner is None and len(self._buffer):
            # a short stream: route on the zero-padded buffer, feed only the
            # real samples, so that as many samples come out as went in
            padded = np.concatenate([self._buffer, np.zeros(self.chunk, np.float32)])
            head = self._route(padded[: self.chunk], self._buffer)
            return np.concatenate([head, self._inner.flush()])
        if self._inner is None:
            return _empty()
        return self._inner.flush()


class LowLatencyStreamingDenoiser:
    """Look-ahead-bounded streaming: full left context, small latency.

    Keeps a rolling window of ``window_samples`` (W) of input and, every
    ``hop_samples`` (H), denoises the whole window. Of ``den[W-L-H-X :
    W-L]`` it emits the first H samples, which have ``lookahead_samples``
    (L) of right context, the first ``xfade_samples`` (X) of them blended
    with the previous tail by the ramp ``(i+1)/(X+1)`` and its complement
    (a pass-through model gives back its input); the next tail is the
    segment's last X samples. Latency is
    ``hop + lookahead + xfade`` samples (1024 + 512 + 256 = 224 ms at
    8 kHz); the cost is one window-sized forward per hop.
    """

    def __init__(self, runner, window_samples: int = 16000, hop_samples: int = 1024,
                 lookahead_samples: int = 512, xfade_samples: int = 256,
                 sample_rate: int = 8000):
        if xfade_samples > hop_samples:
            raise ValueError("xfade_samples must be <= hop_samples")
        if hop_samples + lookahead_samples + xfade_samples > window_samples:
            raise ValueError("window too small for hop + lookahead + xfade")
        self.runner = runner
        self.window = window_samples
        self.hop = hop_samples
        self.lookahead = lookahead_samples
        self.xfade = xfade_samples
        self.sample_rate = sample_rate
        self.mode = runner.mode
        self.device = runner.device
        self._ramp_up = ((torch.arange(xfade_samples, dtype=torch.float32) + 1.0)
                         / (xfade_samples + 1.0)).to(self.device)

    @classmethod
    def from_latency_budget(cls, runner, latency_ms: float, sample_rate: int = 8000,
                            window_samples: int = 16000) -> "LowLatencyStreamingDenoiser":
        """The geometry of an end-to-end latency budget, split 4:2:1 into
        hop, lookahead and crossfade; the crossfade takes the rounding, so
        ``latency_samples`` is the budget exactly."""
        budget = int(round(latency_ms * sample_rate / 1000.0))
        if budget < 16:
            raise ValueError(
                f"latency budget {latency_ms} ms = {budget} samples at "
                f"{sample_rate} Hz is too small (min 16 samples)")
        hop = max(1, budget * 4 // 7)
        lookahead = budget * 2 // 7
        return cls(runner, window_samples=window_samples, hop_samples=hop,
                   lookahead_samples=lookahead, xfade_samples=budget - hop - lookahead,
                   sample_rate=sample_rate)

    @property
    def latency_samples(self) -> int:
        return self.hop + self.lookahead + self.xfade

    @property
    def lead_in(self) -> int:
        return self.lookahead + self.xfade

    def initial_state(self) -> tuple:
        """(rolling window, crossfade tail): the silent lead-in."""
        return (torch.zeros(self.window, device=self.device),
                torch.zeros(self.xfade, device=self.device))

    def step(self, state: tuple, new_hop: torch.Tensor):
        """Roll ``new_hop`` into the window, denoise it, emit one hop."""
        w, h, la, x = self.window, self.hop, self.lookahead, self.xfade
        buf, tail = state
        buf = torch.cat([buf[h:], new_hop])
        den = self.runner.denoise_audio(buf[None], mode=self.mode)[0]
        seg = den[w - la - h - x: w - la]
        head = self._ramp_up * seg[:x] + (1.0 - self._ramp_up) * tail
        return (buf, seg[h: h + x]), torch.cat([head, seg[x:h]])

    def flush_padding(self, staged: int) -> int:
        need = staged + self.lookahead + self.xfade + self.hop
        return -(-need // self.hop) * self.hop - staged

    def session(self) -> StreamingSession:
        return StreamingSession(self)


# the low-latency session is the same session over the low-latency engine
LowLatencyStreamingSession = StreamingSession


class MultiStreamWola:
    """Fixed-capacity pool of concurrent WOLA streams, one batched
    denoise per hop step.

    The WOLA state of up to ``capacity`` streams lives on the device as
    ``(capacity, hop)`` tensors. An advance runs ``k`` hop steps, ``k``
    the largest per-slot backlog; each step is one ``runner.denoise_audio``
    call on the ``(capacity, chunk)`` batch, rows of dead slots included,
    and a per-slot ``valid`` count masks the state updates and emissions of
    slots with fewer staged hops. A slot's stream is that of a dedicated
    ``StreamingSession`` (same windows, same silent lead-in).

    ``slot = pool.open()`` -> ``pool.process({slot: samples})`` ->
    ``{slot: finalised samples}`` -> ``pool.close(slot)``. Every step
    computes the whole batch whatever the number of live slots, so size
    ``capacity`` to the expected concurrency.
    """

    def __init__(self, runner, capacity: int = 8, chunk_samples: int = 16000,
                 sample_rate: int = 8000):
        if chunk_samples % 2:
            raise ValueError("chunk_samples must be even (50% overlap)")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.runner = runner
        self.capacity = capacity
        self.chunk = chunk_samples
        self.hop = chunk_samples // 2
        self.sample_rate = sample_rate
        self.mode = runner.mode
        self.device = runner.device
        self.xfade = torch.from_numpy(hann_window(chunk_samples)).to(self.device)
        self._prev = torch.zeros((capacity, self.hop), device=self.device)
        self._carry = torch.zeros((capacity, self.hop), device=self.device)
        self._staging = [_empty() for _ in range(capacity)]
        self._drop = [0] * capacity
        self._fed = [0] * capacity  # real samples fed (flush padding excluded)
        self._emitted = [0] * capacity
        self._slot_flushed = [False] * capacity
        self._free = list(range(capacity))[::-1]
        self._active: set[int] = set()
        self.advances = 0  # batched denoise calls, one per hop step

    @property
    def latency_samples(self) -> int:
        return self.chunk

    def open(self) -> int:
        """Claim a slot for a new stream (raises IndexError when full)."""
        if not self._free:
            raise IndexError(f"pool full (capacity {self.capacity})")
        slot = self._free.pop()
        self._active.add(slot)
        self._staging[slot] = _empty()
        self._drop[slot] = self.hop  # silent lead-in, as StreamingSession
        self._fed[slot] = 0
        self._emitted[slot] = 0
        self._slot_flushed[slot] = False
        with torch.inference_mode():  # the state rows an advance made
            self._prev[slot].zero_()
            self._carry[slot].zero_()
        return slot

    def close(self, slot: int) -> None:
        self._active.discard(slot)
        if slot not in self._free:
            self._free.append(slot)

    def stage(self, slot: int, samples) -> None:
        """Buffer samples for a slot without advancing (host only)."""
        if self._slot_flushed[slot]:
            # the slot's state holds the flush's silence
            raise RuntimeError(f"slot {slot} is flushed; close it and open a new one")
        samples = np.asarray(samples, np.float32).ravel()
        self._stage_silent(slot, samples)
        self._fed[slot] += samples.size

    def _stage_silent(self, slot: int, samples: np.ndarray) -> None:
        """Stage without counting toward the slot's fed total (flush pad)."""
        if slot not in self._active:
            raise KeyError(f"slot {slot} is not open")
        self._staging[slot] = np.concatenate([self._staging[slot],
                                              np.asarray(samples, np.float32).ravel()])

    def _consume(self, only: Optional[int] = None) -> dict:
        """Pop every fully staged hop per slot (host only). Split from
        ``_run`` so that a thread-safe wrapper holds its staging lock only
        here, and other threads stage while an advance runs. ``only``
        consumes one slot: a flush takes no other slot's hops."""
        taken = {}
        slots = self._active if only is None else ([only] if only in self._active else [])
        for s in slots:
            k = len(self._staging[s]) // self.hop
            if k:
                taken[s] = self._staging[s][: k * self.hop].reshape(k, self.hop)
                self._staging[s] = self._staging[s][k * self.hop:]
        return taken

    @torch.inference_mode()
    def _run(self, taken: dict) -> dict:
        """Advance the pool over consumed hops: ``k`` batched steps."""
        k = max((h.shape[0] for h in taken.values()), default=0)
        if k == 0:
            return {}
        hops = np.zeros((k, self.capacity, self.hop), np.float32)
        valid = np.zeros(self.capacity, np.int64)
        for s, h in taken.items():
            hops[: h.shape[0], s] = h
            valid[s] = h.shape[0]
        hops_d = torch.from_numpy(hops).to(self.device)
        valid_d = torch.from_numpy(valid).to(self.device)
        outs = []
        for j in range(k):
            new = hops_d[j]
            win = torch.cat([self._prev, new], dim=1)  # (capacity, chunk)
            den = self.runner.denoise_audio(win, mode=self.mode) * self.xfade
            self.advances += 1
            live = (j < valid_d)[:, None]
            outs.append(torch.where(live, self._carry + den[:, : self.hop], 0.0))
            self._prev = torch.where(live, new, self._prev)
            self._carry = torch.where(live, den[:, self.hop:], self._carry)
        outs = torch.stack(outs).cpu().numpy()  # (k, capacity, hop)
        emitted = {}
        for s in taken:
            out = outs[: valid[s], s].reshape(-1)
            if self._drop[s]:
                d = min(self._drop[s], len(out))
                out = out[d:]
                self._drop[s] -= d
            # sample-exact, as StreamingSession: the flush pad's decay is cut
            out = out[: max(0, self._fed[s] - self._emitted[s])]
            self._emitted[s] += len(out)
            if len(out):
                emitted[s] = out
        return emitted

    def process(self, packets: dict) -> dict:
        """Stage per-slot samples and advance all live streams together.
        Returns finalised audio per slot (empty where the backlog is
        still under one hop)."""
        for slot, samples in packets.items():
            self.stage(slot, samples)
        out = self._run(self._consume())
        for s in packets:
            out.setdefault(s, _empty())
        return out

    def flush(self, slot: int) -> np.ndarray:
        """Pad one stream with silence to emit its buffered tail; the
        padding is not counted as fed, so the slot has emitted as many
        samples as were staged on it. Only this slot's hops are consumed.
        A second flush returns nothing; ``stage`` on the slot raises
        until it is closed and opened again."""
        if self._slot_flushed[slot]:
            return _empty()
        self._stage_silent(slot, np.zeros(self.chunk, np.float32))
        self._slot_flushed[slot] = True
        return self._run(self._consume(only=slot)).get(slot, _empty())


def _peak_bytes(runner, chunk_samples: int) -> Callable[[int], Optional[int]]:
    """The probe of ``auto_pool_capacity`` on a CUDA runner: the peak
    bytes of the caching allocator over one denoise at a capacity."""
    dev = runner.device

    def probe(capacity: int) -> int:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        runner.denoise_audio(torch.zeros((capacity, chunk_samples), device=dev))
        torch.cuda.synchronize(dev)
        return int(torch.cuda.max_memory_allocated(dev))

    return probe


def auto_pool_capacity(runner, chunk_samples: int = 16000, *, hbm_bytes: Optional[int] = None,
                       safety: float = 0.7, max_capacity: int = 256,
                       probe_capacities: tuple = (2, 8),
                       probe: Optional[Callable[[int], Optional[int]]] = None) -> int:
    """Size a ``MultiStreamWola`` pool to the device memory budget.

    A pool step is the runner's denoise at batch ``capacity``; its memory
    is affine in the capacity (weights the intercept, a stream's
    activations the slope). ``probe(capacity)`` gives the bytes at the two
    ``probe_capacities``, ``capacity = (safety * budget - intercept) /
    slope``, clamped to ``[1, max_capacity]``: JAX's fit. On a CUDA runner
    the probe is the caching allocator's peak over one denoise
    (``torch.cuda.max_memory_allocated``, after
    ``reset_peak_memory_stats``), which misses what lies outside that
    allocator, such as cuDNN's own workspaces: ``safety`` covers it. The
    budget is ``hbm_bytes``, else the card's total memory. With no probe
    and no budget (a CPU runner), or a probe that sees no growth, the
    capacity is ``min(8, max_capacity)``, as JAX falls back when its
    memory analysis fails.
    """
    if safety <= 0 or safety > 1:
        raise ValueError("safety must be in (0, 1]")
    on_card = runner.device.type == "cuda"
    if hbm_bytes is None and on_card:
        hbm_bytes = torch.cuda.get_device_properties(runner.device).total_memory
    if probe is None and on_card:
        probe = _peak_bytes(runner, chunk_samples)
    fallback = min(8, max_capacity)
    if probe is None or hbm_bytes is None:
        return fallback
    c0, c1 = probe_capacities
    s0, s1 = probe(c0), probe(c1)
    if s0 is None or s1 is None or s1 <= s0:
        return fallback
    slope = (s1 - s0) / (c1 - c0)
    intercept = s0 - slope * c0
    capacity = int((safety * hbm_bytes - intercept) / slope)
    return max(1, min(capacity, max_capacity))


class PooledStreamSessions:
    """Thread-safe sessions over one shared ``MultiStreamWola``.

    HTTP handlers call ``process`` from worker threads. Staging holds a
    short staging lock; the device advance runs under a separate advance
    lock with staging released, so packets that other sessions stage
    during an advance go into the next advance together. Sessions have the
    ``process`` / ``flush`` / ``latency_samples`` surface of a
    ``StreamingSession``, and ``close`` releases the slot.
    """

    def __init__(self, pool: MultiStreamWola):
        self.pool = pool
        self._stage_lock = threading.Lock()
        self._advance_lock = threading.Lock()
        self._out: dict = {}

    def session(self) -> "PooledSession":
        # the advance lock too: opening zeroes the slot's state rows, which
        # an advance in flight reads and replaces
        with self._advance_lock, self._stage_lock:
            slot = self.pool.open()
            self._out[slot] = []
        return PooledSession(self, slot)

    def _take(self, slot: int) -> np.ndarray:
        chunks = self._out.get(slot) or []
        self._out[slot] = []
        return np.concatenate(chunks) if chunks else _empty()


class PooledSession:
    """One stream's view of a ``PooledStreamSessions`` pool."""

    def __init__(self, parent: PooledStreamSessions, slot: int):
        self.parent = parent
        self.slot = slot
        self._closed = False

    @property
    def latency_samples(self) -> int:
        return self.parent.pool.latency_samples

    def process(self, samples) -> np.ndarray:
        p = self.parent
        if self._closed:
            raise RuntimeError("session closed")
        with p._stage_lock:
            p.pool.stage(self.slot, samples)
        return self._advance()

    def _advance(self) -> np.ndarray:
        p = self.parent
        with p._advance_lock:
            with p._stage_lock:
                # a concurrent advance may have emitted this slot's hops
                ready = p._take(self.slot)
                batch = p.pool._consume()
            if not batch:
                return ready
            outs = p.pool._run(batch)  # device work, staging unlocked
            with p._stage_lock:
                for s, o in outs.items():
                    p._out.setdefault(s, []).append(o)
                mine = p._take(self.slot)
            return np.concatenate([ready, mine])

    def flush(self) -> np.ndarray:
        """Emit the tail and close; the silence pad is staged uncounted,
        so the session's output is as long as its input."""
        p = self.parent
        if self._closed:
            raise RuntimeError("session closed")
        with p._stage_lock:
            p.pool._stage_silent(self.slot, np.zeros(p.pool.chunk, np.float32))
        out = self._advance()
        self.close()
        return out

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            with self.parent._stage_lock:
                self.parent.pool.close(self.slot)
                self.parent._out.pop(self.slot, None)


class StreamingResampler:
    """Streaming polyphase resampler whose output is bit-identical to
    ``scipy.signal.resample_poly`` of the whole signal.

    ``resample_poly`` is a zero-phase offline filter: resampling each
    packet alone would put the filter's edge transients at every seam.
    This resampler re-filters from a retire point ``r`` (consumed input,
    a multiple of the decimation factor, so that the output offset
    ``r*up/down`` is whole) and emits only output samples whose filter
    support lies in input already fed (``_ctx`` input samples held back).
    ``r`` advances with the stream, so a push costs O(packet + context).
    """

    def __init__(self, in_rate: int, out_rate: int):
        g = math.gcd(int(in_rate), int(out_rate))
        self.up = int(out_rate) // g
        self.down = int(in_rate) // g
        # resample_poly's default Kaiser filter reaches 10*max(up, down)
        # output-grid taps; 32*max input samples cover it with room
        self._ctx = 32 * max(self.up, self.down)
        self._buf = _empty()  # input since the retire point
        self._r = 0  # retired input samples (a multiple of self.down)
        self._fed = 0  # input samples pushed
        self._emitted = 0  # output samples emitted
        self._flushed = False

    def _out_of(self, n_in: int) -> int:
        """Output samples of ``n_in`` input samples (resample_poly's length)."""
        return -(-n_in * self.up // self.down)

    def _emit(self, target: int) -> np.ndarray:
        from scipy.signal import resample_poly

        y = resample_poly(self._buf, self.up, self.down).astype(np.float32)
        base = self._r * self.up // self.down  # whole: r % down == 0
        out = y[self._emitted - base: target - base]
        self._emitted = target
        return out

    def push(self, samples) -> np.ndarray:
        """Feed samples; returns every output sample now fully determined."""
        if self._flushed:
            raise RuntimeError("resampler is flushed")
        x = np.asarray(samples, np.float32).ravel()
        self._buf = np.concatenate([self._buf, x])
        self._fed += x.size
        # up to the last output whose filter support ends _ctx input
        # samples before the head of the stream
        target = max(self._emitted, self._out_of(self._fed - self._ctx))
        if target == self._emitted:
            return _empty()
        out = self._emit(target)
        # advance the retire point, keeping 2*ctx of history
        keep_from = self._fed - 2 * self._ctx
        if keep_from > self._r:
            new_r = (keep_from // self.down) * self.down
            self._buf = self._buf[new_r - self._r:]
            self._r = new_r
        return out

    def flush(self) -> np.ndarray:
        """Emit the held-back tail: the total output is resample_poly's
        length of the total input. The resampler is terminal afterwards."""
        if self._flushed:
            return _empty()
        self._flushed = True
        target = self._out_of(self._fed)
        if target == self._emitted:
            return _empty()
        return self._emit(target)


class ResampledStreamingSession:
    """A client at ``client_rate`` on a model-rate session.

    Wraps any session with ``process`` / ``flush`` / ``latency_samples``:
    client audio is stream-resampled to the model rate on the way in and
    back on the way out, each through a ``StreamingResampler``. After
    ``flush`` the output is exactly as long as the input, at the client
    rate. ``close`` releases the inner session's resources (a pool slot).
    """

    def __init__(self, inner, client_rate: int, model_rate: int):
        self.inner = inner
        self.client_rate = int(client_rate)
        self.model_rate = int(model_rate)
        self._in_rs = StreamingResampler(client_rate, model_rate)
        self._out_rs = StreamingResampler(model_rate, client_rate)
        self._fed = 0
        self._emitted = 0
        self._flushed = False

    @property
    def latency_samples(self) -> int:
        """The inner latency at the client rate, plus the two resamplers'
        held-back filter contexts."""
        inner_cl = self.inner.latency_samples * self.client_rate
        rs_out_cl = self._out_rs._ctx * self.client_rate
        return (-(-inner_cl // self.model_rate) + self._in_rs._ctx
                + -(-rs_out_cl // self.model_rate))

    @property
    def _closed(self) -> bool:
        return bool(getattr(self.inner, "_closed", False))

    def _clamp(self, out: np.ndarray) -> np.ndarray:
        out = out[: max(0, self._fed - self._emitted)]
        self._emitted += len(out)
        return out

    def process(self, samples) -> np.ndarray:
        if self._flushed:
            raise RuntimeError("session is flushed; open a new session")
        samples = np.asarray(samples, np.float32).ravel()
        self._fed += samples.size
        model_in = self._in_rs.push(samples)
        model_out = self.inner.process(model_in) if len(model_in) else _empty()
        return self._clamp(self._out_rs.push(model_out) if len(model_out) else _empty())

    def close(self) -> None:
        close = getattr(self.inner, "close", None)
        if callable(close):
            close()

    def flush(self) -> np.ndarray:
        """Drain both resamplers and the inner session; terminal."""
        if self._flushed:
            return _empty()
        self._flushed = True
        tail_in = self._in_rs.flush()
        pieces = [self.inner.process(tail_in)] if len(tail_in) else []
        pieces.append(self.inner.flush())
        model_tail = np.concatenate(pieces)
        out = np.concatenate([self._out_rs.push(model_tail) if len(model_tail) else _empty(),
                              self._out_rs.flush()])
        got = self._clamp(out)
        short = self._fed - self._emitted
        if short > 0:
            # the rate ratio's rounding can leave the client a few samples
            # short (an odd-length 16 kHz stream through an 8 kHz model):
            # pad with silence to keep the output as long as the input
            got = np.concatenate([got, np.zeros(short, np.float32)])
            self._emitted += short
        return got
