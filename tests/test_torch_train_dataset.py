"""The training-set builder against the JAX package on the CPU:
``data.builders._corrupt_and_featurize`` with an uncentred STFT (the
training set's), ``build_train_dataset`` and ``cli.create_train_dataset``.

Random draws are not compared as streams (ROADMAP "Randomness"): the file
sets, shapes and dtypes must be equal, and the contents the draws do not
touch (the clean magnitudes and the deterministic reverb) must agree; handed
the draws JAX's builder makes from its key chain, every file must agree.
Bound: max |port - JAX| <= 1e-5 max |JAX| per noise type (the two FFTs
differ in the last bits).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_torch.data.builders as port_builders
from audiodenoiser_torch.cli import create_train_dataset as port_cli
from audiodenoiser_torch.data.wav_io import write_wav
from audiodenoiser_torch.train.bench import synth_chunks
from audiodenoiser_tpu.cli import create_train_dataset as jax_cli
from audiodenoiser_tpu.data import builders as jax_builders

SR = 8000
NOISE_TYPES = ("white", "urban", "reverb", "noise_cancellation")
TOL = 1e-5
FRAMES = 1 + (16000 - 512) // 128  # 122 frames of a 2 s chunk, uncentred


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Three clean files giving 2 + 1 + 0 chunks of 2 s, and one 1 s noise
    clip: tiled to the chunk, so its segments are the same whatever either
    package draws."""
    root = tmp_path_factory.mktemp("wavs")
    clean, noise = root / "clean", root / "noise"
    clean.mkdir(), noise.mkdir()
    speech = synth_chunks(6, seed=11).reshape(-1)
    for i, n in enumerate((36000, 20000, 9000)):
        write_wav(str(clean / f"c{i}.wav"), speech[i * 32000: i * 32000 + n], SR)
    rng = np.random.default_rng(12)
    write_wav(str(noise / "n0.wav"), (0.3 * rng.standard_normal(SR)).astype(np.float32), SR)
    return str(clean), str(noise)


BUILD = dict(device_batch=2, seed=3, num_debug_wav=2)


@pytest.fixture(scope="module")
def jax_set(wav_dirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_set")
    n = jax_builders.build_train_dataset(*wav_dirs, str(out / "set"),
                                         debug_dir=str(out / "debug"), **BUILD)
    assert n == 3
    return str(out)


def _jax_draws(key, noise_type, shape):
    """The draws JAX's _corrupt_and_featurize makes from ``key``."""
    if noise_type == "white":
        keys = jax.random.split(key, shape[0])
        return {"noise": np.stack([np.asarray(jax.random.normal(k, shape[1:])) for k in keys])}
    if noise_type == "noise_cancellation":
        n_blocks = -(-shape[1] // 16000)
        return {"gate": np.asarray(jax.random.bernoulli(key, 0.8, (shape[0], n_blocks)))}
    return {}


def _load_set(root):
    out = {}
    for nt in sorted(os.listdir(root)):
        for f in sorted(os.listdir(os.path.join(root, nt))):
            out[(nt, f)] = np.load(os.path.join(root, nt, f))
    return out


def _check_against(ours_root, ref_root, types):
    ours, ref = _load_set(ours_root), _load_set(ref_root)
    assert sorted(ours) == sorted(ref)
    assert len(ref) == 2 * 3 * len(NOISE_TYPES)
    for key, want in ref.items():
        got = ours[key]
        assert got.shape == want.shape == (257, FRAMES) and got.dtype == want.dtype == np.float32
    for nt in NOISE_TYPES:
        for kind in ("clean", "noisy"):
            if kind == "noisy" and nt not in types:
                continue
            keys = [k for k in ref if k[0] == nt and k[1].startswith(kind)]
            assert _close(np.stack([ours[k] for k in keys]), np.stack([ref[k] for k in keys])), \
                (nt, kind)


class TestCorruptAndFeaturize:
    @pytest.mark.parametrize("noise_type", NOISE_TYPES)
    def test_uncentred_matches_jax_given_its_draws(self, noise_type):
        clean = synth_chunks(6, seed=2).reshape(3, -1)[:, :20000]  # 2.5 s: two blocks
        segs = (0.2 * np.random.default_rng(3).standard_normal(clean.shape)).astype(np.float32)
        key = jax.random.key(5)
        ref = jax_builders._corrupt_and_featurize(
            key, jnp.asarray(clean), jnp.asarray(segs), noise_type, 512, 128, False, SR,
            8.0, 0.33)
        draws = {k: torch.from_numpy(np.array(v))
                 for k, v in _jax_draws(key, noise_type, clean.shape).items()}
        ours = port_builders._corrupt_and_featurize(
            torch.from_numpy(clean), torch.from_numpy(segs), noise_type, 512, 128, False, SR,
            8.0, 0.33, **draws)
        assert ours[1].shape == (3, 257, 1 + (20000 - 512) // 128)
        for got, want in zip(ours, ref):
            assert got.shape == want.shape and got.dtype == torch.float32
            assert _close(got.numpy(), want)


class TestBuildTrainDataset:
    def test_files_match_jax(self, wav_dirs, jax_set, tmp_path):
        """Same names, shapes and dtypes; the clean magnitudes and the
        reverb files (no draws) agree, and the debug wavs are JAX's."""
        n = port_builders.build_train_dataset(*wav_dirs, str(tmp_path / "set"),
                                              debug_dir=str(tmp_path / "debug"),
                                              device="cpu", **BUILD)
        assert n == 3
        _check_against(str(tmp_path / "set"), os.path.join(jax_set, "set"), ("reverb",))
        assert sorted(os.listdir(tmp_path / "debug")) == sorted(
            os.listdir(os.path.join(jax_set, "debug"))) == sorted(
            f"debug_{nt}_{c}.wav" for nt in NOISE_TYPES for c in range(2))

    def test_every_file_matches_jax_given_its_draws(self, wav_dirs, jax_set, tmp_path,
                                                    monkeypatch):
        """The port handed the draws of JAX's key chain (a split per batch:
        the segments' key, then one key per noise type) writes JAX's files."""
        key, keys = jax.random.key(BUILD["seed"]), []
        for _ in range(2):  # two batches of device_batch 2
            key, _seg, *nt_keys = jax.random.split(key, 2 + len(NOISE_TYPES))
            keys += nt_keys
        real, calls = port_builders._corrupt_and_featurize, iter(keys)

        def with_jax_draws(clean, segs, nt, *args, generator=None):
            draws = _jax_draws(next(calls), nt, tuple(clean.shape))
            return real(clean, segs, nt, *args, **{k: torch.from_numpy(np.array(v))
                                                   for k, v in draws.items()})

        monkeypatch.setattr(port_builders, "_corrupt_and_featurize", with_jax_draws)
        port_builders.build_train_dataset(*wav_dirs, str(tmp_path / "set"), device="cpu",
                                          **BUILD)
        assert next(calls, None) is None
        _check_against(str(tmp_path / "set"), os.path.join(jax_set, "set"), NOISE_TYPES)

    def test_seeded_and_batch_independent_where_drawless(self, wav_dirs, tmp_path):
        a, b, c = (str(tmp_path / x) for x in "abc")
        port_builders.build_train_dataset(*wav_dirs, a, device="cpu", seed=1)
        port_builders.build_train_dataset(*wav_dirs, b, device="cpu", seed=1)
        port_builders.build_train_dataset(*wav_dirs, c, device="cpu", seed=2, device_batch=1)
        sa, sb, sc = _load_set(a), _load_set(b), _load_set(c)
        assert all(np.array_equal(sa[k], sb[k]) for k in sa)
        # another batching changes the FFTs' rounding only
        assert all(_close(sa[k], sc[k]) for k in sa
                   if k[0] == "reverb" or k[1].startswith("clean"))
        assert not np.array_equal(sa[("white", "noisy_white_chunk_0.npy")],
                                  sc[("white", "noisy_white_chunk_0.npy")])

    def test_empty_clean_dir(self, tmp_path):
        (tmp_path / "c").mkdir(), (tmp_path / "n").mkdir()
        assert port_builders.build_train_dataset(str(tmp_path / "c"), str(tmp_path / "n"),
                                                 str(tmp_path / "o"), device="cpu") == 0

    def test_defaults_to_the_card(self, wav_dirs, tmp_path, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_builders.build_train_dataset(*wav_dirs, str(tmp_path / "o"))


class TestCli:
    def test_cli_writes_what_jax_writes(self, wav_dirs, tmp_path, capsys):
        flags = ["--clean_dir", wav_dirs[0], "--noise_dir", wav_dirs[1], "--seed", "3",
                 "--device_batch", "2", "--num_debug_wav", "1"]
        ours, ref = tmp_path / "port", tmp_path / "jax"
        assert port_cli.main(flags + ["--output_base", str(ours / "set"), "--debug_dir",
                                      str(ours / "debug"), "--device", "cpu"]) == 3
        assert "Processed 3 chunks." in capsys.readouterr().out
        jax_cli.main(flags + ["--output_base", str(ref / "set"), "--debug_dir",
                              str(ref / "debug")])
        _check_against(str(ours / "set"), str(ref / "set"), ("reverb",))
        assert sorted(os.listdir(ours / "debug")) == sorted(os.listdir(ref / "debug"))
        assert len(os.listdir(ours / "debug")) == len(NOISE_TYPES)

    def test_cli_options_reach_the_builder(self, wav_dirs, tmp_path):
        """--chunk_seconds, --noise_types: 1 s chunks (59 frames) of white only."""
        port_cli.main(["--clean_dir", wav_dirs[0], "--noise_dir", wav_dirs[1], "--output_base",
                       str(tmp_path / "set"), "--debug_dir", str(tmp_path / "d"),
                       "--chunk_seconds", "1.0", "--noise_types", "white", "--device", "cpu"])
        assert os.listdir(tmp_path / "set") == ["white"]
        files = os.listdir(tmp_path / "set" / "white")
        assert len(files) == 2 * (4 + 2 + 1)
        assert np.load(tmp_path / "set" / "white" / files[0]).shape == (257, 59)
