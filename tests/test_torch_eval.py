"""The evaluation slice against the JAX package on the CPU:
``data.builders._corrupt_and_featurize`` (the four noise types, given JAX's
draws), ``build_test_dataset`` and ``cli.create_test_dataset`` (names,
shapes, dtypes, and the contents the draws do not touch),
``eval.runner.test_single_noise_type`` and ``test_noise_type_waveform``
(file names, metric keys, metrics), and ``cli.test`` (``--universal``,
``--n_seeds``, the refusals; ``--auto_route`` is tests/test_torch_ensemble.py's).

Narrow models (widths of ``width_mult`` 0.125) carry JAX's weights through
``state_dict_from_flax``; both sides run fp32. The synthetic clips include
a 0.2 s burst in silence, which STOI cannot score, and a silent clip, which
PESQ cannot score: ``batch_metric_mean`` drops each from its mean. Bounds:
waveforms and magnitudes 1e-5 relative L2; losses, STOI and PESQ 1e-4
relative; SI-SDR 1e-3 dB (the model and the FFTs differ in the last bits);
a metrics file's printed numbers within one unit of their last digit plus
those bounds. One case is looser, the mask model's waveform eval under
reverb, 1e-3 relative and 1e-2 dB: the burst clip's silent lead-in comes
out of the reverb's FFT convolution as roundoff (about 1e-9) whose phases,
the mask model's [cos, sin] features, differ between the two packages'
FFTs; the U-Net carries that into the loud bins around them, and the
denoised burst clip ends 2.9e-5 relative L2 apart (4.4e-3 dB of mean
SI-SDR, 1.4e-4 of the STFT loss), where the other three noise types stay
within 2.2e-6 and 1.9e-6 dB. ``python tests/test_torch_eval.py`` prints
these gaps.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_torch.data.builders as port_builders
import audiodenoiser_torch.eval.runner as port_runner
import audiodenoiser_tpu.eval.runner as jax_runner
from audiodenoiser_torch.cli import create_test_dataset as port_create_cli
from audiodenoiser_torch.cli import test as port_test_cli
from audiodenoiser_torch.data.wav_io import write_wav
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    UNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
)
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_torch.train.checkpoints import export_model
from audiodenoiser_tpu.cli import create_test_dataset as jax_create_cli
from audiodenoiser_tpu.data import builders as jax_builders
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import UNet as FlaxUNet

SR = 8000
NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)  # width_mult 0.125
NOISE_TYPES = ("white", "urban", "reverb", "noise_cancellation")
REL, DB, WAVE = 1e-4, 1e-3, 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _clips():
    """Four speech-like clips of ragged lengths (truncated to the shortest,
    1.5 s), a 0.2 s burst in silence and a silent clip."""
    speech = synth_chunks(6, seed=8)
    clips = [speech[i, : 12000 + 300 * i] for i in range(4)]
    burst = np.zeros(12800, np.float32)
    burst[4000:5600] = speech[4, 4000:5600]
    return clips + [burst, np.zeros(12400, np.float32)]


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    clean, noise = root / "clean", root / "noise"
    clean.mkdir(), noise.mkdir()
    for i, c in enumerate(_clips()):
        write_wav(str(clean / f"c{i}.wav"), c, SR)
    # one noise clip shorter than the clips: tiled, so its segments are the
    # same whatever either package draws
    rng = np.random.default_rng(9)
    write_wav(str(noise / "n0.wav"), (0.3 * rng.standard_normal(SR)).astype(np.float32), SR)
    return str(clean), str(noise)


@pytest.fixture(scope="module")
def npy_set(wav_dirs, tmp_path_factory):
    """The test set as the JAX package writes it."""
    out = str(tmp_path_factory.mktemp("test_processed"))
    jax_builders.build_test_dataset(*wav_dirs, out, noise_types=("white", "reverb"))
    return out


def _jax_draws(key, noise_type, shape):
    """The draws JAX's _corrupt_and_featurize makes from ``key``."""
    if noise_type == "white":
        keys = jax.random.split(key, shape[0])
        return {"noise": np.stack([np.asarray(jax.random.normal(k, shape[1:])) for k in keys])}
    if noise_type == "noise_cancellation":
        n_blocks = -(-shape[1] // 16000)
        return {"gate": np.asarray(jax.random.bernoulli(key, 0.8, (shape[0], n_blocks)))}
    return {}


class TestCorruptAndFeaturize:
    @pytest.mark.parametrize("noise_type", NOISE_TYPES)
    def test_matches_jax_given_its_draws(self, noise_type):
        clean = synth_chunks(3, seed=2)[:, :20000]  # 2.5 s: two cancellation blocks
        segs = (0.2 * np.random.default_rng(3).standard_normal(clean.shape)).astype(np.float32)
        key = jax.random.key(5)
        ref = jax_builders._corrupt_and_featurize(
            key, jnp.asarray(clean), jnp.asarray(segs), noise_type, 512, 128, True, SR,
            8.0, 0.35)
        draws = {k: torch.from_numpy(np.array(v)) for k, v in _jax_draws(key, noise_type,
                                                                           clean.shape).items()}
        ours = port_builders._corrupt_and_featurize(
            torch.from_numpy(clean), torch.from_numpy(segs), noise_type, 512, 128, True, SR,
            8.0, 0.35, **draws)
        for got, want in zip(ours, ref):
            assert got.shape == want.shape and got.dtype == torch.float32
            assert _rel(got.numpy(), want) < WAVE


def _listing(path):
    return sorted(os.listdir(path))


class TestBuildTestDataset:
    def test_cli_writes_what_jax_writes(self, wav_dirs, tmp_path):
        ours, ref = str(tmp_path / "port"), str(tmp_path / "jax")
        flags = ["--clean_dir", wav_dirs[0], "--noise_dir", wav_dirs[1], "--seed", "3"]
        port_create_cli.main(flags + ["--output_dir", ours, "--device", "cpu"])
        jax_create_cli.main(flags + ["--output_dir", ref])
        assert _listing(ours) == _listing(ref) == sorted(
            ["clean_audio.npy"] + [f"{kind}_{nt}.npy" for nt in NOISE_TYPES
                                   for kind in ("clean", "noisy", "noisy_audio")])
        n_frames = 1 + 12000 // 128
        for name in _listing(ref):
            a, b = np.load(os.path.join(ours, name)), np.load(os.path.join(ref, name))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, name
            if "audio" in name:
                assert a.shape == (6, 12000)
            else:
                assert a.shape == (6, 257, n_frames)
            # what the draws do not touch agrees: every clean stack, the
            # deterministic reverb, the tiled urban clip
            if name.startswith("clean") or "reverb" in name or "urban" in name:
                assert _rel(a, b) < WAVE, name

    def test_without_audio_artifacts(self, wav_dirs, tmp_path):
        out = port_builders.build_test_dataset(*wav_dirs, str(tmp_path), noise_types=("reverb",),
                                               save_audio=False, device="cpu")
        assert _listing(tmp_path) == ["clean_reverb.npy", "noisy_reverb.npy"]
        assert set(out) == {"reverb"} and out["reverb"][0].shape == (6, 257, 94)

    def test_no_clips(self, wav_dirs, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        assert port_builders.build_test_dataset(str(empty), wav_dirs[1], str(tmp_path / "o"),
                                                device="cpu") == {}


def _flax_unet():
    variables = random_flax_variables(12, **NARROW)
    model = UNet(**NARROW)
    return variables, fold_for_inference(load_flax_variables(model, variables).eval(),
                                         torch.float32)


def _flax_mask():
    variables = random_flax_variables(13, in_channels=3, out_channels=2, **NARROW)
    model = ComplexMaskUNet(mask_bound=2.0, residual=True, **NARROW)
    return variables, fold_for_inference(load_flax_variables(model, variables).eval(),
                                         torch.float32)


def _check_metrics(ours, ref, rel=REL, db=DB):
    assert set(ours) == set(ref)
    for k, want in ref.items():
        if "si_sdr" in k:
            assert abs(ours[k] - want) < db, (k, ours[k], want)
        else:
            assert abs(ours[k] - want) <= rel * abs(want), (k, ours[k], want)


_NUMBER = re.compile(r"^(.*?): (-?\d+\.(\d+))( dB)?$")


def _check_metrics_file(ours_path, ref_path, rel=REL, db=DB):
    """Same lines; each printed number within one unit of its last digit
    plus the metric's bound of the other package's."""
    ours, ref = open(ours_path).read().splitlines(), open(ref_path).read().splitlines()
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        ma, mb = _NUMBER.match(a), _NUMBER.match(b)
        if mb is None:
            assert a == b
            continue
        assert ma is not None and ma.group(1) == mb.group(1) and ma.group(4) == mb.group(4), a
        x, y = float(ma.group(2)), float(mb.group(2))
        bound = db if "SI-SDR" in mb.group(1) else rel * abs(y)
        assert abs(x - y) <= 10.0 ** -len(mb.group(3)) + bound, (a, b)


class TestSingleNoiseType:
    @pytest.mark.parametrize("noise_type,gl_mode", [("white", "reference_gl"),
                                                    ("reverb", "griffin_lim")])
    def test_matches_jax(self, npy_set, tmp_path, noise_type, gl_mode):
        variables, folded = _flax_unet()
        ours_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "jax")
        kw = dict(test_data_dir=npy_set, num_audio_examples=2, gl_mode=gl_mode,
                  eval_batch_size=4)  # 6 clips: a padded tail batch
        ref = jax_runner.test_single_noise_type(
            FlaxUNet(dtype=jnp.float32, **NARROW), variables, noise_type,
            output_dir=ref_dir, **kw)
        ours = port_runner.test_single_noise_type(folded, noise_type, output_dir=ours_dir,
                                                  device="cpu", **kw)
        assert set(ours) == {"total", "stft", "mel", "l1", "si_sdr", "si_sdr_noisy_phase",
                             "si_sdr_noisy_input", "pesq_noisy_input", "pesq_noisy_phase"}
        _check_metrics(ours, ref)
        assert _listing(ours_dir) == _listing(ref_dir) == sorted(
            [f"{noise_type}_metrics.txt"] + [f"{noise_type}_{kind}_{i}.{ext}" for i in range(2)
                                             for kind, ext in (("noisy", "wav"),
                                                               ("denoised", "wav"),
                                                               ("spectrogram", "png"))])
        _check_metrics_file(os.path.join(ours_dir, f"{noise_type}_metrics.txt"),
                            os.path.join(ref_dir, f"{noise_type}_metrics.txt"))

    def test_missing_set_is_skipped(self, tmp_path):
        _, folded = _flax_unet()
        assert port_runner.test_single_noise_type(folded, "urban", str(tmp_path),
                                                  str(tmp_path / "o"), device="cpu") is None


class TestNoiseTypeWaveform:
    @pytest.mark.parametrize("noise_type", NOISE_TYPES)
    def test_matches_jax_given_its_draws(self, wav_dirs, tmp_path, monkeypatch, noise_type):
        """The port's corruption is handed the draws JAX's makes from
        ``jax.random.key(seed)``; the tiled urban clip needs none."""
        seed = 4
        real = port_builders._corrupt_and_featurize

        def with_jax_draws(clean, *args, generator=None):
            draws = _jax_draws(jax.random.key(seed), args[1], tuple(clean.shape))
            return real(clean, *args, **{k: torch.from_numpy(np.array(v))
                                         for k, v in draws.items()})

        monkeypatch.setattr(port_builders, "_corrupt_and_featurize", with_jax_draws)
        variables, folded = _flax_mask()
        ours_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "jax")
        kw = dict(clean_dir=wav_dirs[0], noise_dir=wav_dirs[1], num_audio_examples=2,
                  seed=seed)
        ref = jax_runner.test_noise_type_waveform(
            FlaxMaskUNet(mask_bound=2.0, residual=True, dtype=jnp.float32, **NARROW),
            variables, noise_type, output_dir=ref_dir, **kw)
        ours = port_runner.test_noise_type_waveform(folded, noise_type, output_dir=ours_dir,
                                                    device="cpu", **kw)
        assert {"stoi", "stoi_noisy", "pesq", "pesq_noisy", "si_sdr30",
                "si_sdr_median"} <= set(ours)
        bounds = dict(rel=1e-3, db=1e-2) if noise_type == "reverb" else {}
        _check_metrics(ours, ref, **bounds)
        assert _listing(ours_dir) == _listing(ref_dir)
        _check_metrics_file(os.path.join(ours_dir, f"{noise_type}_metrics.txt"),
                            os.path.join(ref_dir, f"{noise_type}_metrics.txt"), **bounds)

    def test_unscorable_clips_drop_out(self, wav_dirs, monkeypatch):
        """STOI skips the burst, PESQ the silent clip; every other clip counts."""
        calls = {"stoi": [], "pesq": []}
        for name in calls:
            real = getattr(port_runner, name)

            def spy(c, a, fs, _real=real, _name=name):
                try:
                    out = _real(c, a, fs)
                except ValueError:
                    calls[_name].append(None)
                    raise
                calls[_name].append(out)
                return out

            monkeypatch.setattr(port_runner, name, spy)
        _, folded = _flax_mask()
        m = port_runner.test_noise_type_waveform(
            folded, "white", wav_dirs[0], wav_dirs[1], "unused", write_artifacts=False,
            device="cpu")
        for name, skipped in (("stoi", 4), ("pesq", 5)):
            assert len(calls[name]) == 12  # 6 noisy + 6 denoised clips
            assert [v is None for v in calls[name]].index(True) % 6 == skipped
            assert sum(v is None for v in calls[name]) == 2
            kept = [v for v in calls[name][6:] if v is not None]
            assert m[name] == pytest.approx(float(np.mean(kept)), rel=1e-12)

    def test_seeds_draw_other_corruptions(self, wav_dirs):
        _, folded = _flax_mask()
        runner = port_runner.DenoiserRunner(folded, device="cpu")
        kw = dict(write_artifacts=False, runner=runner)
        a = port_runner.test_noise_type_waveform(None, "white", *wav_dirs, "x", seed=0, **kw)
        b = port_runner.test_noise_type_waveform(None, "white", *wav_dirs, "x", seed=0, **kw)
        c = port_runner.test_noise_type_waveform(None, "white", *wav_dirs, "x", seed=1, **kw)
        assert a == b and a["si_sdr_noisy"] != c["si_sdr_noisy"]


def test_plot_comparison_skips_without_matplotlib(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    spec = np.ones((4, 5), np.float32)
    with pytest.warns(UserWarning, match="matplotlib unavailable"):
        port_runner._plot_comparison(spec, spec, spec, str(tmp_path / "x.png"))
    assert not (tmp_path / "x.png").exists()


def _export(path, variables, sidecar):
    export_model(path, variables["params"], variables["batch_stats"])
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(sidecar, f)


class TestTestCLI:
    def test_unet_specialists_write_what_jax_writes(self, npy_set, tmp_path):
        variables, _ = _flax_unet()
        saved = tmp_path / "saved"
        for nt in ("white", "reverb"):
            _export(str(saved / f"unet_denoiser_{nt}.ckpt"), variables, {"width_mult": 0.125})
        flags = ["--saved_models_dir", str(saved), "--test_data_dir", npy_set,
                 "--noise_types", "white", "urban", "reverb", "--num_audio_examples", "2",
                 "--precision", "f32", "--gl_mode", "griffin_lim"]
        from audiodenoiser_tpu.cli.test import main as jax_main

        ref = jax_main(flags + ["--output_dir", str(tmp_path / "jax"), "--mesh", "off"])
        ours = port_test_cli.main(flags + ["--output_dir", str(tmp_path / "port"),
                                           "--device", "cpu"])
        assert set(ours) == set(ref) == {"white", "reverb"}  # no urban specialist
        for nt in ours:
            _check_metrics(ours[nt], ref[nt])
        assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")

    def test_universal_mask_over_seeds(self, wav_dirs, tmp_path, capsys):
        variables, _ = _flax_mask()
        saved = tmp_path / "saved"
        _export(str(saved / "mask_denoiser_mixed.ckpt"), variables,
                {"width_mult": 0.125, "mask_bound": 2.0, "residual": True})
        out = tmp_path / "out"
        results = port_test_cli.main([
            "--model", "complex_mask", "--universal", "--n_seeds", "2",
            "--saved_models_dir", str(saved), "--clean_dir", wav_dirs[0],
            "--noise_dir", wav_dirs[1], "--output_dir", str(out), "--num_audio_examples", "1",
            "--precision", "f32", "--device", "cpu"])
        assert set(results) == set(NOISE_TYPES)
        assert _listing(out) == sorted(
            f"{nt}_{name}" for nt in NOISE_TYPES
            for name in ("metrics.txt", "metrics_multiseed.txt", "noisy_0.wav",
                         "denoised_0.wav"))
        for nt, m in results.items():
            assert all(np.isfinite(v) for v in m.values())
            assert {"si_sdr", "si_sdr_std", "stoi", "stoi_std", "pesq_std"} <= set(m)
            text = (out / f"{nt}_metrics_multiseed.txt").read_text()
            assert text.startswith(f"Multi-seed (2 corruption draws) waveform metrics for '{nt}'")
            assert "pesq_approx_noisy:" in text and "si_sdr:" in text
        assert "[launches]" not in capsys.readouterr().out  # counted on the GPU only

    def test_missing_models_are_skipped(self, tmp_path, capsys):
        flags = ["--saved_models_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                 "--device", "cpu"]
        assert port_test_cli.main(flags) == {}
        assert port_test_cli.main(flags + ["--universal", "--model", "complex_mask"]) == {}
        out = capsys.readouterr().out
        assert "not found. Skipping." in out and "Universal model 'mask_denoiser_mixed'" in out

    @pytest.mark.parametrize("flags,item", [(["--auto_route"], "A.11"),
                                            (["--auto_route", "--ep", "dense"], "A.11"),
                                            (["--mesh", "on"], "A.11"),
                                            (["--model_parallel", "2"], "A.11")])
    def test_unported_flags_name_their_item(self, flags, item, monkeypatch, tmp_path,
                                            request, capsys):
        """Every flag here is ported (ROADMAP A.11). ``--auto_route`` chooses
        its dispatch by the process group's world size, as JAX's by its
        device count: one process on four cards takes the host-bucketed
        dispatch (``--ep auto`` and ``dense`` alike), so it goes on to load
        the mixture. ``--mesh on`` in one process runs a world-size-1 mesh
        whose scores are the unmeshed run's, and ``--model_parallel 2``
        there stops with JAX's error."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
        if flags == ["--model_parallel", "2"]:
            with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
                port_test_cli.main(flags + ["--saved_models_dir", str(tmp_path),
                                            "--output_dir", str(tmp_path / "o"),
                                            "--device", "cpu"])
            return
        if flags == ["--mesh", "on"]:
            clean, noise = request.getfixturevalue("wav_dirs")
            saved = tmp_path / "saved"
            _export(str(saved / "mask_denoiser_mixed.ckpt"), _flax_mask()[0],
                    {"width_mult": 0.125, "mask_bound": 2.0, "residual": True})
            run = ["--model", "complex_mask", "--universal", "--noise_types", "white",
                   "--saved_models_dir", str(saved), "--clean_dir", clean, "--noise_dir",
                   noise, "--num_audio_examples", "1", "--precision", "f32", "--device", "cpu"]
            plain = port_test_cli.main(run + ["--output_dir", str(tmp_path / "plain")])
            meshed = port_test_cli.main(run + ["--output_dir", str(tmp_path / "mesh"), *flags])
            assert meshed == plain and set(meshed) == {"white"}
            assert ((tmp_path / "mesh" / "white_metrics.txt").read_text()
                    == (tmp_path / "plain" / "white_metrics.txt").read_text())
            return
        assert port_test_cli._ep_mesh(port_test_cli.parse_args(flags),
                                      torch.device("cuda")) is None
        with pytest.raises(FileNotFoundError, match="router checkpoint not found"):
            port_test_cli.main(flags + ["--saved_models_dir", str(tmp_path),
                                        "--output_dir", str(tmp_path / "o"), "--device", "cpu"])
        assert "Expert-parallel mesh" not in capsys.readouterr().out

    def test_auto_route_refuses_the_mesh_flags(self):
        with pytest.raises(SystemExit, match="builds its own expert-parallel mesh"):
            port_test_cli.parse_args(["--auto_route", "--mesh", "on"])


def _gap_table():
    """The mask model's waveform eval, port against JAX, by noise type: the
    denoised clips' relative L2 gap, clip by clip, and each metric's gap
    (relative; SI-SDR in dB), given JAX's draws."""
    import contextlib
    import io
    import tempfile

    from audiodenoiser_torch.data.wav_io import read_wav
    from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner

    tmp = tempfile.mkdtemp()
    clean_dir, noise_dir = os.path.join(tmp, "clean"), os.path.join(tmp, "noise")
    os.makedirs(clean_dir), os.makedirs(noise_dir)
    for i, c in enumerate(_clips()):
        write_wav(os.path.join(clean_dir, f"c{i}.wav"), c, SR)
    rng = np.random.default_rng(9)
    write_wav(os.path.join(noise_dir, "n0.wav"),
              (0.3 * rng.standard_normal(SR)).astype(np.float32), SR)
    variables, folded = _flax_mask()
    flax_model = FlaxMaskUNet(mask_bound=2.0, residual=True, dtype=jnp.float32, **NARROW)
    real, seed = port_builders._corrupt_and_featurize, 4
    clean = np.stack([c[:12000] for c in _clips()])
    # the eval's urban segments: the 1 s clip as read back, tiled to the clips
    written = read_wav(os.path.join(noise_dir, "n0.wav"), sample_rate=SR)[0]
    segs = np.broadcast_to(np.tile(written, 2)[:12000], clean.shape)
    for nt in NOISE_TYPES:
        key = jax.random.key(seed)
        noisy = np.array(jax_builders._corrupt_and_featurize(
            key, jnp.asarray(clean), jnp.asarray(segs), nt, 512, 128, True, SR, 8.0, 0.35)[0])
        ref = np.asarray(JaxRunner(flax_model, variables).denoise_audio(
            jnp.asarray(noisy), key, mode="complex_mask", bypass_db=40.0))
        ours = port_runner.DenoiserRunner(folded, device="cpu").denoise_audio(
            torch.from_numpy(noisy), bypass_db=40.0).numpy()
        per_clip = " ".join(f"{_rel(ours[i], ref[i]):.1e}" for i in range(len(clean)))

        def with_jax_draws(c, *args, generator=None):
            draws = _jax_draws(jax.random.key(seed), args[1], tuple(c.shape))
            return real(c, *args, **{k: torch.from_numpy(np.array(v)) for k, v in draws.items()})

        port_builders._corrupt_and_featurize = with_jax_draws
        kw = dict(clean_dir=clean_dir, noise_dir=noise_dir, seed=seed, write_artifacts=False)
        with contextlib.redirect_stdout(io.StringIO()):
            m_ref = jax_runner.test_noise_type_waveform(flax_model, variables, nt,
                                                         output_dir=tmp, **kw)
            m_ours = port_runner.test_noise_type_waveform(folded, nt, output_dir=tmp,
                                                          device="cpu", **kw)
        port_builders._corrupt_and_featurize = real
        gaps = {k: abs(m_ours[k] - v) / (1.0 if "si_sdr" in k else abs(v))
                for k, v in m_ref.items()}
        print(f"{nt}: denoised clips {per_clip}; metrics "
              + " ".join(f"{k} {v:.1e}" for k, v in gaps.items()), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    _gap_table()
