"""The port's native ingest (``data/native.py``) against the JAX package's
bindings of the same ``native/audioio.cpp`` and against the port's scipy
path, on the CPU.

The two bindings compile one source with one set of flags, so their
outputs are held equal; against scipy the bound is JAX's own, 1e-6 at the
wavs' rate and 2e-4 through the resampler. The port's library is built
under ``audiodenoiser_torch/_build/`` and ``native/`` is only read.
"""

import os

import numpy as np
import pytest
from scipy.io import wavfile

from audiodenoiser_torch.data import builders as port_builders
from audiodenoiser_torch.data import native
from audiodenoiser_torch.data.wav_io import read_wav, write_wav
from audiodenoiser_tpu.data import native as jax_native


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"no C++ compiler here: {native.build_log}")
    return native


def _wav(path, n, seed, rate=8000):
    x = np.clip(np.random.default_rng(seed).standard_normal(n) * 0.3, -1, 1).astype(np.float32)
    write_wav(str(path), x, rate)
    return str(path)


class TestBuild:
    def test_library_is_built_beside_the_port(self, lib):
        path = lib.library_path()
        assert os.path.dirname(path) == str(native.BUILD_DIR)
        assert os.path.basename(path).startswith("libaudioio-") and path.endswith(".so")
        assert native.SOURCE.parent.name == "native" and native.SOURCE.exists()

    def test_disable_switch(self, monkeypatch):
        monkeypatch.setattr(native, "_tried", False)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setenv("ADT_DISABLE_NATIVE", "1")
        assert not native.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            native.load_wav("x.wav")


class TestDecode:
    def test_16bit_matches_jax_and_scipy(self, lib, tmp_path):
        p = _wav(tmp_path / "a.wav", 8000, 0)
        ours = lib.load_wav(p)
        np.testing.assert_array_equal(ours, jax_native.load_wav(p))
        np.testing.assert_allclose(ours, read_wav(p)[0], atol=1e-6)

    def test_float32_wav(self, lib, tmp_path):
        x = np.clip(np.random.default_rng(1).standard_normal(4000) * 0.3, -1, 1)
        p = str(tmp_path / "f.wav")
        wavfile.write(p, 8000, x.astype(np.float32))
        np.testing.assert_allclose(lib.load_wav(p), x, atol=1e-7)

    def test_stereo_downmix(self, lib, tmp_path):
        p = str(tmp_path / "s.wav")
        wavfile.write(p, 8000, np.stack([np.ones(64, np.float32), np.zeros(64, np.float32)], 1))
        np.testing.assert_allclose(lib.load_wav(p), 0.5, atol=1e-6)

    @pytest.mark.parametrize("rate", [44100, 16000])
    def test_resample_matches_jax_and_scipy(self, lib, tmp_path, rate):
        t = np.arange(rate) / rate
        p = str(tmp_path / "r.wav")
        wavfile.write(p, rate, (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
        ours = lib.load_wav(p, sample_rate=8000)
        np.testing.assert_array_equal(ours, jax_native.load_wav(p, sample_rate=8000))
        ref = read_wav(p, sample_rate=8000)[0]
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=2e-4)

    def test_missing_file_raises(self, lib, tmp_path):
        with pytest.raises(IOError):
            lib.load_wav(str(tmp_path / "nope.wav"))


class TestBatch:
    @pytest.fixture
    def paths(self, tmp_path):
        return [_wav(tmp_path / f"{i}.wav", n, i) for i, n in enumerate((40000, 20000, 9000))]

    def test_chunks_match_jax_and_scipy(self, lib, paths):
        ours = lib.load_batch(paths, 8000, 16000)
        assert ours.shape == (3, 16000) and ours.dtype == np.float32  # 2 + 1 + 0 chunks
        np.testing.assert_array_equal(ours, jax_native.load_batch(paths, 8000, 16000))
        np.testing.assert_allclose(ours, port_builders._load_clean_chunks(paths, 8000, 16000),
                                   atol=1e-6)

    def test_empty_batch(self, lib):
        assert lib.load_batch([], 8000, 16000).shape == (0, 16000)


class TestLoadCleanChunks:
    @pytest.mark.parametrize("native_ok", [True, False])
    def test_path_taken_is_counted(self, lib, tmp_path, monkeypatch, native_ok):
        """The native loader when it is there; scipy when it is not, or when
        it cannot decode a file (JAX's fallback); the same chunks either way."""
        paths = [_wav(tmp_path / f"{i}.wav", n, i) for i, n in enumerate((36000, 17000))]
        if not native_ok:
            def refuse(*a):
                raise IOError("exotic subtype")
            monkeypatch.setattr(native, "load_batch", refuse)
        before = dict(port_builders.INGEST_COUNTS)
        got = port_builders.load_clean_chunks(paths, 8000, 16000)
        taken = "native" if native_ok else "scipy"
        assert port_builders.INGEST_COUNTS[taken] == before[taken] + 1
        assert sum(port_builders.INGEST_COUNTS.values()) == sum(before.values()) + 1
        np.testing.assert_allclose(got, port_builders._load_clean_chunks(paths, 8000, 16000),
                                   atol=1e-6)

    def test_without_a_library_scipy(self, tmp_path, monkeypatch):
        monkeypatch.setattr(native, "available", lambda: False)
        paths = [_wav(tmp_path / "0.wav", 33000, 3)]
        before = port_builders.INGEST_COUNTS["scipy"]
        assert port_builders.load_clean_chunks(paths, 8000, 16000).shape == (2, 16000)
        assert port_builders.INGEST_COUNTS["scipy"] == before + 1
