"""The training mixer's four corruptions, from explicit draws (the
reference's ``utils/noise.py`` semantics, as the deployment's ``mixed``
mixer applies them per example):

- white: standard-normal noise scaled to the SNR (RMS over the clip);
- urban: a noise clip tiled to the chunk once if shorter, else a snippet
  from ``raw_start % (len - chunk)``, scaled to the SNR;
- reverb: the JUCE (Pedalboard) reverb's exact impulse response (8 damped
  feedback combs into 4 allpasses, room 0.9, damping 0.9, wet 0.33, dry
  0.4), convolved;
- noise_cancellation: with the drawn gate per 16,000-sample block,
  ``-0.8 x clean`` added over the block's first 8,000 samples.

Every result is clipped to [-1, 1].
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("white", "urban", "reverb", "noise_cancellation")
BLOCK, HALF_BLOCK = 16000, 8000
COMBS_44K = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)
ALLPASSES_44K = (556, 441, 341, 225)


def snr_scaled(clean: torch.Tensor, noise: torch.Tensor, snr_db) -> torch.Tensor:
    c_rms = torch.sqrt(clean.square().mean(-1, keepdim=True) + 1e-12)
    n_rms = torch.sqrt(noise.square().mean(-1, keepdim=True) + 1e-12)
    snr = torch.as_tensor(snr_db, dtype=clean.dtype, device=clean.device)
    scaled = noise * ((c_rms / 10.0 ** (snr / 20.0)) / n_rms)
    return torch.where(n_rms > 1e-9, scaled, torch.zeros_like(noise))


def reverb_ir(sample_rate: int, length: int, room: float = 0.9, damping: float = 0.9,
              wet: float = 0.33, width: float = 1.0) -> np.ndarray:
    from scipy.signal import lfilter

    feedback = room * 0.28 + 0.7
    damp = damping * 0.4
    gain = 0.5 * (wet * 3.0) * (1.0 + width)
    x = np.zeros(length)
    x[0] = 0.015
    acc = np.zeros(length)
    for tuning in COMBS_44K:
        d = sample_rate * tuning // 44100
        b = np.zeros(d + 2)
        b[d], b[d + 1] = 1.0, -damp
        a = np.zeros(d + 1)
        a[0], a[1], a[d] = 1.0, -damp, -feedback * (1.0 - damp)
        acc += lfilter(b, a, x)
    for tuning in ALLPASSES_44K:
        d = sample_rate * tuning // 44100
        b = np.zeros(d + 1)
        b[0], b[d] = -1.0, 1.5
        a = np.zeros(d + 1)
        a[0], a[d] = 1.0, -0.5
        acc = lfilter(b, a, acc)
    return (acc * gain).astype(np.float32)


def reverb(clean: torch.Tensor, sample_rate: int, dry: float = 0.4) -> torch.Tensor:
    n = clean.shape[-1]
    ir = torch.from_numpy(reverb_ir(sample_rate, n)).to(clean.device)
    size = 1 << (2 * n - 2).bit_length()
    wet = torch.fft.irfft(torch.fft.rfft(clean, n=size) * torch.fft.rfft(ir, n=size),
                          n=size)[..., :n]
    return (dry * 2.0 * clean + wet).clamp(-1.0, 1.0)


def noise_segments(clips, idx: torch.Tensor, raw_start: torch.Tensor, length: int,
                   device) -> torch.Tensor:
    """Each row's noise: clip ``idx`` tiled to ``length`` if shorter, else
    ``length`` samples from ``raw_start % max(len - length, 1)``."""
    rows = []
    for i, r in zip(idx.tolist(), raw_start.tolist()):
        c = np.asarray(clips[i], np.float32)
        if len(c) <= length:
            seg = np.tile(c, -(-length // len(c)))[:length]
        else:
            s = r % max(len(c) - length, 1)
            seg = c[s:s + length]
        rows.append(seg)
    return torch.from_numpy(np.stack(rows)).to(device)


def corrupt(clean: torch.Tensor, draws: dict, clips, sample_rate: int,
            snr_db: float) -> torch.Tensor:
    """The ``mixed`` corruption of each row of ``clean``, chosen by
    ``draws['choice']`` (0 white, 1 urban, 2 reverb, 3 noise_cancellation)."""
    d = {k: v.to(clean.device) for k, v in draws.items()}
    n = clean.shape[-1]
    out = {
        "white": clean + snr_scaled(clean, d["white_noise"], d.get("white_snr", snr_db)),
        "urban": clean + snr_scaled(clean, noise_segments(clips, d["bank_idx"],
                                                          d["bank_start"], n, clean.device),
                                    d.get("urban_snr", snr_db)),
        "reverb": reverb(clean, sample_rate),
    }
    pos = torch.arange(n, device=clean.device)
    gate = d["gate"].float()[:, pos // BLOCK] * (pos % BLOCK < HALF_BLOCK).float()
    out["noise_cancellation"] = clean - 0.8 * gate * clean
    every = torch.stack([out[k].clamp(-1.0, 1.0) for k in KINDS])
    return every[d["choice"], torch.arange(clean.shape[0], device=clean.device)]
