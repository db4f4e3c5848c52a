"""Port parity of the data path: the noise corruptions, the JUCE reverb
impulse response, the chunking helpers, the clean-chunk loader, the
``.npy`` dataset, the split, and the on-device mixer, against the JAX
package on the CPU.

The port never draws JAX's random numbers: each test draws them with
``jax.random`` exactly as the JAX code does and hands them to the port
(``noise=``, ``gate=``, ``start=``, or a mixer ``draws`` dict), then
compares outputs. Tolerances: 1e-6 absolute for waveforms and the IR,
1e-5 relative L2 for the mixer's magnitudes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_tpu.data import NoiseBank as JaxBank
from audiodenoiser_tpu.data import OnDeviceMixer as JaxMixer
from audiodenoiser_tpu.data import chunking as jax_chunking
from audiodenoiser_tpu.data import dataset as jax_dataset
from audiodenoiser_tpu.data.builders import _load_clean_chunks as jax_load_chunks
from audiodenoiser_tpu.data.wav_io import load_wav_list as jax_wav_list
from audiodenoiser_tpu.dsp import noise as jax_noise
from audiodenoiser_torch.data import chunking, dataset
from audiodenoiser_torch.data.builders import load_clean_chunks
from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer, pad_or_truncate_device
from audiodenoiser_torch.data.wav_io import load_wav_list, write_wav
from audiodenoiser_torch.dsp import noise


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.fixture
def clean():
    rng = np.random.default_rng(0)
    return np.clip(0.3 * rng.standard_normal((3, 20000)), -1, 1).astype(np.float32)


class TestNoise:
    @pytest.mark.parametrize("snr", [8.0, -3.0])
    def test_snr_scale(self, clean, snr):
        n = np.random.default_rng(1).standard_normal(clean.shape).astype(np.float32)
        ref = jax_noise.snr_scale(jnp.asarray(clean), jnp.asarray(n), snr)
        ours = noise.snr_scale(torch.from_numpy(clean), torch.from_numpy(n), snr)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
        silent = noise.snr_scale(torch.from_numpy(clean), torch.zeros(3, 20000), snr)
        assert float(silent.abs().max()) == 0.0

    def test_white_with_jax_draws(self, clean):
        key = jax.random.key(3)
        ref = jax_noise.white(key, jnp.asarray(clean))
        draw = np.asarray(jax.random.normal(key, clean.shape, jnp.float32))
        ours = noise.white(torch.from_numpy(clean), noise=torch.from_numpy(draw.copy()))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
        gen = noise.white(torch.from_numpy(clean), generator=torch.Generator().manual_seed(0))
        assert gen.shape == clean.shape and float(gen.abs().max()) <= 1.0

    @pytest.mark.parametrize("n", [5000, 16000, 30000])
    def test_match_length_and_urban(self, clean, n):
        clip = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 0.1
        key = jax.random.key(4)
        ref = jax_noise.urban(key, jnp.asarray(clean[:, :16000]), jnp.asarray(clip))
        start = (int(jax.random.randint(key, (), 0, n - 16000)) if n > 16000 else None)
        ours = noise.urban(torch.from_numpy(clean[:, :16000]), torch.from_numpy(clip),
                           start=start)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)

    def test_noise_cancellation_with_jax_gate(self, clean):
        key = jax.random.key(5)
        ref = jax_noise.noise_cancellation(key, jnp.asarray(clean))
        gate = np.asarray(jax.random.bernoulli(key, 0.8, (3, 2)))
        ours = noise.noise_cancellation(torch.from_numpy(clean), gate=torch.from_numpy(gate))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)

    def test_reverb_ir_and_reverb(self, clean):
        for args in [(8000, 16000), (8000, 20000, 0.9, 0.9, 0.35), (16000, 4000, 0.5, 0.2)]:
            np.testing.assert_allclose(noise.reverb_impulse_response(*args),
                                       jax_noise.reverb_impulse_response(*args), atol=1e-6)
        ref = jax_noise.reverb(jnp.asarray(clean))
        ours = noise.reverb(torch.from_numpy(clean))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)

    def test_add_noise_dispatch(self, clean):
        c = torch.from_numpy(clean)
        torch.testing.assert_close(noise.add_noise(c, "reverb"), noise.reverb(c))
        for nt in ("white", "urban", "noise_cancellation"):
            out = noise.add_noise(c, nt, generator=torch.Generator().manual_seed(1))
            assert out.shape == c.shape and float(out.abs().max()) <= 1.0
        with pytest.raises(ValueError):
            noise.add_noise(c, "pink")


class TestChunkingAndData:
    def test_chunking_copies(self):
        a = np.arange(50000, dtype=np.float32)
        for hop in (None, 4000):
            np.testing.assert_array_equal(chunking.frame_audio(a, 16000, hop),
                                          jax_chunking.frame_audio(a, 16000, hop))
        assert chunking.frame_audio(a[:10], 16000).shape == (0, 16000)
        for n in (100, 16000, 40000):
            x = np.arange(n, dtype=np.float32)
            np.testing.assert_array_equal(
                chunking.match_audio_length(x, 16000, np.random.default_rng(2)),
                jax_chunking.match_audio_length(x, 16000, np.random.default_rng(2)))
        for shape in [(257, 122), (100, 30), (3, 300, 70)]:
            d = np.random.default_rng(0).random(shape).astype(np.float32)
            np.testing.assert_array_equal(chunking.pad_or_truncate(d),
                                          jax_chunking.pad_or_truncate(d))
            torch.testing.assert_close(
                pad_or_truncate_device(torch.from_numpy(d), (256, 64)),
                torch.from_numpy(chunking.pad_or_truncate(d)))

    @pytest.mark.parametrize("n,ratio,seed", [(10, 0.1, 0), (163, 0.1, 3), (8, 0.25, 0)])
    def test_split_train_val(self, n, ratio, seed):
        for a, b in zip(dataset.split_train_val(n, ratio, seed),
                        jax_dataset.split_train_val(n, ratio, seed)):
            np.testing.assert_array_equal(a, b)

    def test_wavs_to_chunks(self, tmp_path):
        rng = np.random.default_rng(6)
        for i, n in enumerate((40000, 10000, 33000)):
            write_wav(str(tmp_path / f"c{i}.wav"), 0.3 * rng.standard_normal(n), 16000)
        (tmp_path / "notes.txt").write_text("x")
        files = load_wav_list(str(tmp_path))
        assert files == jax_wav_list(str(tmp_path)) and len(files) == 3
        ours = load_clean_chunks(files, 8000, 16000)
        np.testing.assert_allclose(ours, jax_load_chunks(files, 8000, 16000), atol=1e-6)
        assert ours.shape == (2, 16000)

    def test_spectrogram_pairs(self, tmp_path):
        rng = np.random.default_rng(7)
        for i in range(5):
            np.save(tmp_path / f"clean_{i}.npy", rng.random((257, 122)).astype(np.float32))
            np.save(tmp_path / f"noisy_{i}.npy", rng.random((257, 122)).astype(np.float32))
        ours = dataset.SpectrogramPairs(str(tmp_path), subset_fraction=0.6, seed=1)
        ref = jax_dataset.SpectrogramPairs(str(tmp_path), subset_fraction=0.6, seed=1)
        assert len(ours) == len(ref) == 3
        for i in range(3):
            for a, b in zip(ours[i], ref[i]):
                assert a.shape == (1, 256, 64)
                np.testing.assert_array_equal(a[0], b[..., 0])
        got = list(dataset.batches(ours, [0, 1, 2], 2, shuffle=False))
        assert [g[0].shape for g in got] == [(2, 1, 256, 64), (1, 1, 256, 64)]


def _jax_draws(key, b, n_chunks, length, noise_type, augment=False, snr=None,
               n_clips=0):
    """The random tensors ``JaxMixer.sample(key, b)`` draws, as the port's
    ``draws`` dict (mirrors pipeline.py's key splits)."""
    r = jax.random
    out = {}
    if augment:
        k_idx, k_aug, k_noise = r.split(key, 3)
        k_g, k_p, k_s = r.split(k_aug, 3)
        out["gain_db"] = r.uniform(k_g, (b, 1), minval=-6.0, maxval=6.0)
        out["polarity"] = r.bernoulli(k_p, 0.5, (b, 1))
        out["shift"] = r.randint(k_s, (b,), 0, length)
    else:
        k_idx, k_noise = r.split(key)
    out["idx"] = r.randint(k_idx, (b,), 0, n_chunks)

    def corrupt(k, nt):
        if nt == "white":
            if snr is not None:
                k, k_snr = r.split(k)
                out["white_snr"] = r.uniform(k_snr, (b, 1), minval=snr[0], maxval=snr[1])
            keys = r.split(k, b)
            out["white_noise"] = jnp.stack([r.normal(kk, (length,)) for kk in keys])
        elif nt == "urban":
            k_bank, k_snr = r.split(k)
            if snr is not None:
                out["urban_snr"] = r.uniform(k_snr, (b, 1), minval=snr[0], maxval=snr[1])
            k_clip, k_start = r.split(k_bank)
            out["bank_idx"] = r.randint(k_clip, (b,), 0, n_clips)
            out["bank_start"] = r.randint(k_start, (b,), 0, 2 ** 30)
        elif nt == "noise_cancellation":
            out["gate"] = r.bernoulli(k, 0.8, (b, -(-length // 16000)))

    if noise_type == "mixed":
        k_pick, k_all = r.split(k_noise)
        out["choice"] = r.randint(k_pick, (b,), 0, 4)
        for k, nt in zip(r.split(k_all, 4), ("white", "urban", "reverb", "noise_cancellation")):
            corrupt(k, nt)
    else:
        corrupt(k_noise, noise_type)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


class TestMixer:
    @pytest.fixture(scope="class")
    def data(self):
        rng = np.random.default_rng(8)
        t = np.arange(16000) / 8000.0
        chunks = np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in (220, 330, 440, 550, 660)])
        chunks = np.clip(chunks + 0.05 * rng.standard_normal(chunks.shape), -1, 1)
        clips = [0.2 * rng.standard_normal(n) for n in (9000, 16000, 27000)]
        return chunks.astype(np.float32), [c.astype(np.float32) for c in clips]

    @pytest.mark.parametrize("noise_type,augment,snr", [
        ("white", False, None),
        ("white", True, (0.0, 12.0)),
        ("urban", False, (2.0, 10.0)),
        ("reverb", False, None),
        ("noise_cancellation", True, None),
        ("mixed", False, None),
    ])
    def test_sample_with_jax_draws(self, data, noise_type, augment, snr):
        chunks, clips = data
        kw = {"snr_db": snr} if snr else {}
        jbank = JaxBank(clips) if noise_type in ("urban", "mixed") else None
        jm = JaxMixer(chunks, noise_type, noise_bank=jbank, augment=augment, **kw)
        key = jax.random.key(11)
        ref_noisy, ref_clean = jm.sample(key, 4)
        bank = NoiseBank(clips, device="cpu") if jbank is not None else None
        pm = OnDeviceMixer(chunks, noise_type, noise_bank=bank, augment=augment,
                           device="cpu", **kw)
        draws = _jax_draws(key, 4, len(chunks), 16000, noise_type, augment, snr, len(clips))
        noisy, clean = pm.sample_from(draws)
        assert noisy.shape == clean.shape == (4, 1, 256, 64)
        assert noisy.dtype == torch.float32
        assert _rel(clean[:, 0].numpy(), np.asarray(ref_clean)[..., 0]) < 1e-5
        assert _rel(noisy[:, 0].numpy(), np.asarray(ref_noisy)[..., 0]) < 1e-5

    def test_featurize_same_audio(self, data):
        chunks, _ = data
        ref = JaxMixer(chunks, "white")._featurize(jnp.asarray(chunks))
        ours = OnDeviceMixer(chunks, "white", device="cpu")._featurize(torch.from_numpy(chunks))
        assert _rel(ours[:, 0].numpy(), np.asarray(ref)[..., 0]) < 1e-5

    def test_own_draws_are_seeded(self, data):
        chunks, clips = data
        pm = OnDeviceMixer(chunks, "mixed", noise_bank=NoiseBank(clips, device="cpu"),
                           augment=True, snr_db=(0.0, 5.0), device="cpu")
        a = pm.sample(torch.Generator().manual_seed(3), 6)
        b = pm.sample(torch.Generator().manual_seed(3), 6)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert all(torch.isfinite(t).all() for t in a)

    def test_rejects_bad_configuration(self, data):
        chunks, _ = data
        with pytest.raises(ValueError):
            OnDeviceMixer(chunks, "pink", device="cpu")
        with pytest.raises(ValueError, match="NoiseBank"):
            OnDeviceMixer(chunks, "urban", device="cpu")
