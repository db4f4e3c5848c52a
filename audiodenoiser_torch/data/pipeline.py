"""On-device input pipeline: noise mixing + STFT on the card (port of
``data/pipeline.py``: ``NoiseBank``, ``OnDeviceMixer.sample`` and
``OnDeviceMixer.sample_audio``).

The clean chunks (2 s at 8 kHz by default: ``sample_rate`` and the
chunks' length set the training window) live in device memory; each training step draws a
random batch, augments it (optionally), synthesizes the corruption and
computes both magnitude spectrograms on the card, with no host round
trip. The STFT (``center=False``) is the K1 kernel on the card. The
output is the reference's (256, 64) training crop, (B, 1, 256, 64)
float32, after the reference loader's float16 round trip.

``sample_audio`` returns the raw (noisy, clean) (B, chunk) waveforms of
the same draws instead, with no STFT: the complex-mask family's stream.
``sample_labeled`` (``noise_type="mixed"`` only) adds each example's
corruption index, the draw's ``choice``: the noise router's stream.

Randomness is split from the arithmetic: ``draw(generator, batch)``
makes every random tensor a batch needs, ``sample_from(draws)`` and
``sample_audio_from(draws)`` are deterministic given them, and ``sample``
and ``sample_audio`` are draw and arithmetic together. A test can so give
the port the JAX package's own draws.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.dsp import noise as noise_lib
from audiodenoiser_torch.utils.profiling import MIXER, span

NOISE_TYPES = ("white", "urban", "reverb", "noise_cancellation")
N_FFT, HOP = 512, 128
Draws = dict[str, torch.Tensor]


class NoiseBank:
    """Device-resident bank of noise clips with the reference's tile/snip
    semantics: clips shorter than ``target_len`` are tiled to it once,
    longer ones keep their length and get a random start per draw."""

    def __init__(self, clips: Sequence[np.ndarray], target_len: int = 16000,
                 device: DeviceLike = None):
        proc = []
        for c in clips:
            c = np.asarray(c, dtype=np.float32)
            if len(c) == 0:
                c = np.zeros(target_len, dtype=np.float32)
            elif len(c) < target_len:
                c = np.tile(c, int(np.ceil(target_len / len(c))))[:target_len]
            proc.append(c)
        self.target_len = target_len
        self.device = resolve_device(device)
        bank = np.zeros((len(proc), max(len(c) for c in proc)), dtype=np.float32)
        for i, c in enumerate(proc):
            bank[i, : len(c)] = c
        self.bank = torch.from_numpy(bank).to(self.device)
        self.lengths = torch.tensor([len(c) for c in proc], device=self.device)

    def __len__(self) -> int:
        return int(self.bank.shape[0])

    def draw(self, generator: torch.Generator, batch_size: int) -> Draws:
        """Clip indices and raw start draws in [0, 2^30)."""
        dev = generator.device
        return {"bank_idx": torch.randint(0, len(self), (batch_size,), generator=generator,
                                          device=dev),
                "bank_start": torch.randint(0, 2 ** 30, (batch_size,), generator=generator,
                                            device=dev)}

    def segments(self, idx: torch.Tensor, raw_start: torch.Tensor) -> torch.Tensor:
        """(B, target_len) snippets: start = raw % max(len - target, 1),
        0 for clips that were tiled to ``target_len``."""
        idx, raw_start = idx.to(self.device), raw_start.to(self.device)
        lens = self.lengths[idx]
        starts = raw_start % torch.clamp(lens - self.target_len, min=1)
        starts = torch.where(lens <= self.target_len, torch.zeros_like(starts), starts)
        pos = starts[:, None] + torch.arange(self.target_len, device=self.device)
        return self.bank[idx[:, None], pos]

    def sample(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """``batch_size`` length-``target_len`` segments drawn from ``generator``."""
        draws = self.draw(generator, batch_size)
        return self.segments(draws["bank_idx"], draws["bank_start"])


def pad_or_truncate_device(x: torch.Tensor, target: tuple[int, int]) -> torch.Tensor:
    """Zero-pad at the end / truncate the last two axes to ``target``."""
    th, tw = target
    h, w = x.shape[-2], x.shape[-1]
    x = x[..., : min(h, th), : min(w, tw)]
    return F.pad(x, (0, max(0, tw - w), 0, max(0, th - h)))


class OnDeviceMixer:
    """Fused sample -> augment -> corrupt -> STFT batch generator for one
    noise type, or a per-example mixture of all four (``"mixed"``).
    ``snr_db`` is a fixed level or a ``(lo, hi)`` range drawn per example.
    ``sample_rate`` is the chunks' rate, which the reverb's impulse
    response follows; the STFT constants (n_fft 512, hop 128) stay."""

    def __init__(self, clean_chunks: np.ndarray, noise_type: str,
                 noise_bank: Optional[NoiseBank] = None,
                 target_size: tuple[int, int] = (256, 64),
                 snr_db: Union[float, tuple[float, float]] = 8.0,
                 sample_rate: int = 8000,
                 augment: bool = False, device: DeviceLike = None):
        if noise_type not in (*NOISE_TYPES, "mixed"):
            raise ValueError(f"unknown noise type {noise_type!r}")
        if noise_type in ("urban", "mixed") and noise_bank is None:
            raise ValueError(f"{noise_type} mixing requires a NoiseBank")
        self.device = resolve_device(device)
        self.augment = bool(augment)
        self.clean = torch.from_numpy(np.asarray(clean_chunks, dtype=np.float32)).to(self.device)
        self.noise_type = noise_type
        self.bank = noise_bank
        self.target_size = target_size
        self.snr_db = snr_db
        self.sample_rate = int(sample_rate)

    def __len__(self) -> int:
        return int(self.clean.shape[0])

    def _snr_range(self) -> bool:
        return isinstance(self.snr_db, (tuple, list))

    def draw(self, generator: torch.Generator, batch_size: int) -> Draws:
        """Every random tensor one batch needs, on ``generator``'s device."""
        with span(MIXER):
            return self._draw(generator, batch_size)

    def _draw(self, generator: torch.Generator, batch_size: int) -> Draws:
        dev, b, n = generator.device, batch_size, self.clean.shape[1]
        g = dict(generator=generator, device=dev)
        draws = {"idx": torch.randint(0, len(self), (b,), **g)}
        if self.augment:
            draws["gain_db"] = torch.rand((b, 1), **g) * 12.0 - 6.0
            draws["polarity"] = torch.rand((b, 1), **g) < 0.5
            draws["shift"] = torch.randint(0, n, (b,), **g)
        kinds = NOISE_TYPES if self.noise_type == "mixed" else (self.noise_type,)
        if self.noise_type == "mixed":
            draws["choice"] = torch.randint(0, 4, (b,), **g)
        for nt in kinds:
            if nt in ("white", "urban") and self._snr_range():
                lo, hi = self.snr_db
                draws[f"{nt}_snr"] = lo + (hi - lo) * torch.rand((b, 1), **g)
            if nt == "white":
                draws["white_noise"] = torch.randn((b, n), **g)
            elif nt == "urban":
                draws.update(self.bank.draw(generator, b))
            elif nt == "noise_cancellation":
                draws["gate"] = torch.rand((b, -(-n // noise_lib.BLOCK)), **g) < 0.8
        return draws

    def _augmented(self, clean: torch.Tensor, draws: Draws) -> torch.Tensor:
        """Gain (+-6 dB, bounded by the chunk's headroom), polarity and a
        circular time shift of the clean chunk before corruption."""
        if not self.augment:
            return clean
        gain = 10.0 ** (draws["gain_db"] / 20.0)
        peak = clean.abs().amax(dim=1, keepdim=True)
        gain = torch.minimum(gain, 1.0 / torch.clamp(peak, min=1e-6))
        pol = torch.where(draws["polarity"], 1.0, -1.0)
        n = clean.shape[1]
        src = (torch.arange(n, device=clean.device) - draws["shift"][:, None]) % n
        return torch.clamp(clean.gather(1, src) * gain * pol, -1.0, 1.0)

    def _corrupt(self, clean: torch.Tensor, draws: Draws,
                 noise_type: Optional[str] = None) -> torch.Tensor:
        nt = self.noise_type if noise_type is None else noise_type
        if nt == "mixed":
            every = torch.stack([self._corrupt(clean, draws, k) for k in NOISE_TYPES])
            return every.gather(0, draws["choice"][None, :, None].expand(1, *clean.shape))[0]
        snr = draws.get(f"{nt}_snr", self.snr_db)
        if nt == "white":
            return noise_lib.white(clean, snr, noise=draws["white_noise"])
        if nt == "urban":
            segs = self.bank.segments(draws["bank_idx"], draws["bank_start"])
            return torch.clamp(clean + noise_lib.snr_scale(clean, segs, snr), -1.0, 1.0)
        if nt == "reverb":
            return noise_lib.reverb(clean, self.sample_rate)
        return noise_lib.noise_cancellation(clean, gate=draws["gate"])

    def _featurize(self, a: torch.Tensor) -> torch.Tensor:
        # K1 on the card (the wrapper takes its plain version on the CPU)
        mag = stft_lib.stft(a, N_FFT, HOP, center=False, precision="kernel").abs()
        mag = mag.half().float()  # the reference loader's lossy float16 cast
        return pad_or_truncate_device(mag, self.target_size)[:, None]

    @torch.no_grad()
    def sample_audio_from(self, draws: Draws) -> tuple[torch.Tensor, torch.Tensor]:
        """(noisy, clean) (B, chunk) float32 waveforms from ``draws``."""
        with span(MIXER):
            draws = {k: v.to(self.device) for k, v in draws.items()}
            clean = self._augmented(self.clean[draws["idx"]], draws)
            return self._corrupt(clean, draws), clean

    @torch.no_grad()
    def sample_from(self, draws: Draws) -> tuple[torch.Tensor, torch.Tensor]:
        """(noisy, clean) (B, 1, F, T) float32 magnitudes from ``draws``."""
        noisy, clean = self.sample_audio_from(draws)
        b = clean.shape[0]
        with span(MIXER):
            feats = self._featurize(torch.cat([noisy, clean]))  # one K1 launch
        return feats[:b], feats[b:]

    def sample(self, generator: torch.Generator, batch_size: int):
        """(noisy, clean) (B, 1, 256, 64) float32 batches."""
        return self.sample_from(self.draw(generator, batch_size))

    def sample_labeled_from(self, draws: Draws):
        """(noisy, clean, label) from ``draws``: the (B, 1, F, T) features
        of ``sample_from`` (one K1 launch for both) and the (B,) corruption
        index (0 white, 1 urban, 2 reverb, 3 noise_cancellation)."""
        self._require_mixed()
        noisy, clean = self.sample_from(draws)
        return noisy, clean, draws["choice"].to(self.device)

    def sample_labeled(self, generator: torch.Generator, batch_size: int):
        """(noisy, clean, label) mixed-corruption batches, the training
        stream of the noise router (``train.router``)."""
        self._require_mixed()
        return self.sample_labeled_from(self.draw(generator, batch_size))

    def _require_mixed(self) -> None:
        if self.noise_type != "mixed":
            raise ValueError("sample_labeled requires noise_type='mixed'")

    def sample_audio(self, generator: torch.Generator, batch_size: int):
        """(noisy, clean) (B, chunk) float32 waveform batches, the input of
        the complex-mask family (``train.mask``)."""
        return self.sample_audio_from(self.draw(generator, batch_size))
