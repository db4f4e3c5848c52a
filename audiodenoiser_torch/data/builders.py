"""Dataset builders (port of ``data/builders.py``): clean-chunk loading for
training (the scipy path) and the test set's ``.npy`` artifacts.

The JAX package prefers its native C++ loader (``data/native.py``) and
falls back to scipy; the port has the scipy path only (the native loader
is ROADMAP A.6), and the training-set builder is not ported yet (A.6).

``build_test_dataset`` writes the reference's whole-clip test set:
``clean_{nt}.npy`` / ``noisy_{nt}.npy`` magnitude stacks (N, n_fft/2+1, T)
float32 with a centred STFT, plus the ``clean_audio.npy`` and
``noisy_audio_{nt}.npy`` waveform stacks. Corruption and STFT run batched
on the device (the STFT through K1 on the card); random draws come from a
``torch.Generator`` or are passed in, as in ``dsp/noise.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.data.chunking import frame_audio
from audiodenoiser_torch.data.pipeline import NoiseBank
from audiodenoiser_torch.data.wav_io import load_wav_list, read_wav
from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.dsp import noise as noise_lib

NOISE_TYPES = ("white", "urban", "reverb", "noise_cancellation")


def load_clean_chunks(clean_files: Sequence[str], sample_rate: int,
                      chunk_samples: int) -> np.ndarray:
    """Decode, resample and chunk clean files: (n_chunks, chunk_samples) f32."""
    all_chunks = []
    for cf in clean_files:
        y, _ = read_wav(cf, sample_rate=sample_rate)
        chunks = frame_audio(y, chunk_samples, chunk_samples)
        if len(chunks):
            all_chunks.append(chunks)
    if not all_chunks:
        return np.zeros((0, chunk_samples), dtype=np.float32)
    return np.concatenate(all_chunks, axis=0)


def _corrupt_and_featurize(
    clean: torch.Tensor,
    noise_segs: torch.Tensor,
    noise_type: str,
    n_fft: int,
    hop_length: int,
    center: bool,
    sample_rate: int,
    snr_db: float,
    reverb_wet_level: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
):
    """Corrupt ``clean`` (B, L) by ``noise_type`` and take both magnitude
    spectrograms: ``(noisy, clean_mag, noisy_mag)``. ``noise_segs`` (B, L)
    are the length-matched urban segments (ignored otherwise); ``noise``
    (white) and ``gate`` (noise cancellation) are the draws, else drawn
    from ``generator``."""
    if noise_type == "white":
        noisy = noise_lib.white(clean, snr_db, generator, noise=noise)
    elif noise_type == "urban":
        scaled = noise_lib.snr_scale(clean, noise_segs.to(clean), snr_db)
        noisy = torch.clamp(clean + scaled, -1.0, 1.0)
    elif noise_type == "reverb":
        noisy = noise_lib.reverb(clean, sample_rate, wet_level=reverb_wet_level)
    else:
        noisy = noise_lib.noise_cancellation(clean, generator, gate=gate)

    def to_mag(a):
        return stft_lib.stft(a, n_fft, hop_length, center=center, precision="kernel").abs()

    return noisy, to_mag(clean), to_mag(noisy)


def build_test_dataset(
    clean_dir: str,
    noise_dir: str,
    output_dir: str,
    sample_rate: int = 8000,
    n_fft: int = 512,
    hop_length: int = 128,
    snr_db: float = 8.0,
    noise_types: Sequence[str] = NOISE_TYPES,
    reverb_wet_level: float = 0.35,
    seed: int = 0,
    save_audio: bool = True,
    device: DeviceLike = None,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Whole-clip corruption; writes the ``clean_{nt}.npy`` /
    ``noisy_{nt}.npy`` stacks, and with ``save_audio`` the
    ``clean_audio.npy`` / ``noisy_audio_{nt}.npy`` waveforms. Clips are
    truncated to the shortest so the stacks stay rectangular. Returns the
    (clean, noisy) magnitudes by noise type."""
    device = resolve_device(device)
    os.makedirs(output_dir, exist_ok=True)
    clean_files = load_wav_list(clean_dir)
    noise_files = load_wav_list(noise_dir)
    clips = [read_wav(f, sample_rate=sample_rate)[0] for f in clean_files]
    if not clips:
        return {}
    min_len = min(len(c) for c in clips)
    clean_np = np.stack([c[:min_len] for c in clips])
    clean = torch.from_numpy(clean_np).to(device)
    bank = None
    if noise_files:
        bank = NoiseBank([read_wav(f, sample_rate=sample_rate)[0] for f in noise_files],
                         target_len=min_len, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    if save_audio:
        np.save(os.path.join(output_dir, "clean_audio.npy"), clean_np)
    for nt in noise_types:
        if bank is not None and nt == "urban":
            segs = bank.sample(gen, clean.shape[0])
        else:
            segs = torch.zeros_like(clean)
        noisy, clean_mag, noisy_mag = _corrupt_and_featurize(
            clean, segs, nt, n_fft, hop_length, True, sample_rate, snr_db,
            reverb_wet_level, generator=gen)
        clean_mag, noisy_mag = clean_mag.cpu().numpy(), noisy_mag.cpu().numpy()
        np.save(os.path.join(output_dir, f"clean_{nt}.npy"), clean_mag)
        np.save(os.path.join(output_dir, f"noisy_{nt}.npy"), noisy_mag)
        if save_audio:
            np.save(os.path.join(output_dir, f"noisy_audio_{nt}.npy"), noisy.cpu().numpy())
        out[nt] = (clean_mag, noisy_mag)
    return out
