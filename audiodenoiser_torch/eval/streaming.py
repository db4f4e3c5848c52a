"""Streaming denoising by chunk-level weighted overlap-add (port of
``eval/streaming.py``: ``StreamingDenoiser`` and ``StreamingSession``).

The signal is cut into windows of ``chunk_samples`` advanced by half a
window; each window goes through the runner's fused path (STFT -> model
-> iSTFT, the K1 and K2 kernels on the card) on its own, as a batch of
one, and is weighted by a periodic Hann crossfade. Periodic Hann windows
at 50% overlap sum to one, so a pass-through model gives back its input.

- ``StreamingDenoiser.denoise``: the whole signal offline, the windows
  summed scatter-free (even and odd windows each tile the signal without
  overlap).
- ``StreamingSession``: push any number of samples, get back every sample
  that is final. A window's first half is final once the next window is
  in, so the latency is one chunk. The WOLA state (the previous hop and
  the overlap carry) stays on the runner's device between calls and
  threads hop by hop.

Because every window runs alone, a session gives the offline result
whatever the packet sizes, in bf16 too. The low-latency, pooled, routed
and resampled sessions of the JAX package are not ported yet (ROADMAP A.9).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from audiodenoiser_torch.dsp.window import hann_window


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

    def _denoise_window(self, window: torch.Tensor) -> torch.Tensor:
        """One (chunk,) window, denoised alone and crossfaded."""
        out = self.runner.denoise_audio(window[None], mode=self.mode)[0]
        return out * self.xfade

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

    The stream starts with a synthetic half-window of silence (the zero
    ``prev`` hop), so that the first real samples get full crossfade
    weight; the first finalized hop is that lead-in and is dropped.
    Emission never runs past the samples fed, so a flushed session has
    returned exactly as many samples as it was given. Flushing ends the
    session: a second flush returns nothing and ``process`` raises.
    """

    def __init__(self, parent: StreamingDenoiser):
        self.p = parent
        self._staging = np.zeros(0, np.float32)  # host staging, < hop samples
        self._prev = torch.zeros(parent.hop, device=parent.device)  # silent lead-in
        self._carry = torch.zeros(parent.hop, device=parent.device)  # overlap-add carry
        self._drop = parent.hop  # lead-in samples still to swallow
        self._fed = 0  # real input samples fed (flush padding excluded)
        self._emitted = 0  # output samples returned so far
        self._flushed = False

    @property
    def latency_samples(self) -> int:
        return self.p.chunk

    def process(self, samples) -> np.ndarray:
        """Feed samples; returns whatever denoised audio is final."""
        if self._flushed:
            # the WOLA state holds the flush's silence: further output
            # would be its decay crossfaded into the new input
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
            return np.zeros(0, np.float32)
        hops = torch.from_numpy(self._staging[: k * p.hop].reshape(k, p.hop)).to(p.device)
        self._staging = self._staging[k * p.hop:]
        finals = []
        for new in hops:  # the state threads hop by hop
            den = p._denoise_window(torch.cat([self._prev, new]))
            finals.append(self._carry + den[: p.hop])
            self._prev, self._carry = new, den[p.hop:]
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
            return np.zeros(0, np.float32)
        self._flushed = True
        return self._advance(np.zeros(self.p.chunk, np.float32))
