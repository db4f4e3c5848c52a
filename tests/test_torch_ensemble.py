"""The self-routing mixture of the port against the JAX package on the CPU:
``eval.ensemble`` (``windowed_logits``, ``MixtureOfDenoisers`` with its
power-of-two bucketed dispatch for both specialist families,
``load_mixture``, ``evaluate_routed``, ``evaluate_routed_waveform``) and
``cli.test --auto_route``.

Specialists are narrow seeded U-Nets (JAX's test widths, ``features=(4, 8,
16, 32), bottleneck=64``; width_mult 0.125 where a sidecar must rebuild
them), the mask ones of four different configurations; the router is a
seeded ``NoiseClassifier``. Both packages run fp32 with the same weights
and labels. Bounds: logits 1e-5 of max|JAX|; routed outputs 1e-5 relative
L2; metrics 1e-4 of the larger of their value and 1 (SI-SDR 1e-3 dB, as
tests/test_torch_eval.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_torch.data.builders as port_builders
from audiodenoiser_torch.cli import test as port_test_cli
from audiodenoiser_torch.data.wav_io import write_wav
from audiodenoiser_torch.eval import ensemble as port_ens
from audiodenoiser_torch.models import (
    NOISE_CLASSES,
    ComplexMaskUNet,
    NoiseClassifier,
    UNet,
    load_flax_variables,
    random_flax_variables,
    random_router_flax_variables,
    router_state_dict_from_flax,
)
from audiodenoiser_torch.train.checkpoints import export_model
from audiodenoiser_tpu.eval import ensemble as jax_ens
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMaskUNet
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models.router import NoiseClassifier as FlaxClassifier

THIN = dict(features=(4, 8, 16, 32), bottleneck=64)
NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)  # width_mult 0.125
MASK_CFGS = [dict(mask_bound=2.0, residual=False), dict(mask_bound=8.0, residual=True),
             dict(mask_bound=2.0, residual=True), dict(mask_bound=4.0, residual=False)]
LOGIT, OUT, REL, DB = 1e-5, 1e-5, 1e-4, 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _router(params):
    model = NoiseClassifier(dtype=torch.float32)
    model.load_state_dict(router_state_dict_from_flax(params), strict=True)
    return model


@pytest.fixture(scope="module")
def router_params():
    return random_router_flax_variables(9)["params"]


def _variables(family, widths=THIN):
    chans = dict(in_channels=3, out_channels=2) if family == "mask" else {}
    return [random_flax_variables(20 + i, **widths, **chans) for i in range(4)]


def _mixtures(family, router_params, widths=THIN):
    """The same experts and router in both packages."""
    jax_experts, experts = {}, {}
    for i, (nt, v) in enumerate(zip(NOISE_CLASSES, _variables(family, widths))):
        if family == "mask":
            jax_experts[nt] = (FlaxMaskUNet(dtype=jnp.float32, **widths, **MASK_CFGS[i]), v)
            experts[nt] = load_flax_variables(ComplexMaskUNet(**widths, **MASK_CFGS[i]), v)
        else:
            jax_experts[nt] = (FlaxUNet(dtype=jnp.float32, **widths), v)
            experts[nt] = load_flax_variables(UNet(**widths), v)
    ref = jax_ens.MixtureOfDenoisers(jax_experts, router_params,
                                     router_model=FlaxClassifier(dtype=jnp.float32),
                                     family=family)
    ours = port_ens.MixtureOfDenoisers(experts, _router(router_params), family=family,
                                       device="cpu")
    return ref, ours


@pytest.fixture(scope="module")
def magnitude(router_params):
    return _mixtures("magnitude", router_params)


@pytest.fixture(scope="module")
def mask(router_params):
    return _mixtures("mask", router_params)


def _specs(n, t, seed=0):
    return np.abs(np.random.default_rng(seed).standard_normal((n, 257, t))).astype(np.float32)


def _wavs(n, length, seed=1):
    return (0.2 * np.random.default_rng(seed).standard_normal((n, length))).astype(np.float32)


class TestRouting:
    @pytest.mark.parametrize("t", [150, 40])
    def test_windowed_logits_match_jax(self, router_params, t):
        """Two full windows (the tail dropped), and a clip shorter than one."""
        x = _specs(3, t)
        ref = np.asarray(jax_ens.windowed_logits(FlaxClassifier(dtype=jnp.float32),
                                                 router_params, jnp.asarray(x)[..., None]))
        ours = port_ens.windowed_logits(_router(router_params).eval(),
                                        torch.from_numpy(x)[:, None]).detach().numpy()
        assert ours.shape == (3, 4)
        assert np.abs(ours - ref).max() / np.abs(ref).max() < LOGIT

    def test_classify_waveform_matches_jax(self, magnitude):
        ref_mix, mix = magnitude
        wavs = _wavs(6, 6000)
        ref = np.asarray(ref_mix.classify_waveform(jnp.asarray(wavs)))
        ours = mix.classify_waveform(torch.from_numpy(wavs))
        assert ours.shape == (6,) and ours.dtype == torch.int64
        np.testing.assert_array_equal(ours.numpy(), ref)

    def test_refusals(self, mask, router_params):
        _, mix = mask
        with pytest.raises(ValueError, match="magnitude-family only"):
            mix.denoise(torch.zeros(1, 1, 64, 64))
        with pytest.raises(ValueError, match="missing experts"):
            port_ens.MixtureOfDenoisers({"white": UNet(**THIN)}, _router(router_params),
                                        device="cpu")


# 7 clips over the four experts: groups of 2, 1, 3 (padded to 4) and 1
LABELS = np.array([0, 1, 2, 3, 0, 2, 2])


class TestDispatch:
    def test_denoise_matches_jax(self, magnitude):
        ref_mix, mix = magnitude
        x = _specs(7, 48, seed=2)
        ref = np.asarray(ref_mix.denoise(jnp.asarray(x)[..., None], labels=LABELS))[..., 0]
        ours = mix.denoise(torch.from_numpy(x)[:, None], labels=torch.from_numpy(LABELS))
        assert ours.shape == (7, 1, 257, 48)
        assert _rel(ours[:, 0], ref) < OUT

    @pytest.mark.parametrize("family,bypass_db", [("magnitude", None), ("mask", None),
                                                  ("mask", 40.0)])
    def test_denoise_waveform_matches_jax(self, magnitude, mask, family, bypass_db):
        """Heterogeneous mask experts each run through their own module."""
        ref_mix, mix = magnitude if family == "magnitude" else mask
        wavs = _wavs(7, 4000, seed=3)
        ref = np.asarray(ref_mix.denoise_waveform(jnp.asarray(wavs), labels=LABELS,
                                                  bypass_db=bypass_db))
        ours = mix.denoise_waveform(torch.from_numpy(wavs), labels=LABELS, bypass_db=bypass_db)
        assert ours.shape == wavs.shape
        for i in range(len(wavs)):
            assert _rel(ours[i], ref[i]) < OUT, i

    def test_each_clip_is_its_expert_on_the_padded_group(self, mask):
        """A routed answer is its expert runner's on the zero-padded group."""
        _, mix = mask
        wavs = torch.from_numpy(_wavs(7, 3000, seed=4))
        out = mix.denoise_waveform(wavs, labels=LABELS)
        single = mix.denoise_waveform(wavs[0], labels=LABELS[:1])
        assert single.shape == (3000,)
        for e in range(4):
            idx = np.nonzero(LABELS == e)[0]
            group = torch.zeros((1 << (len(idx) - 1).bit_length(), 3000))
            group[: len(idx)] = wavs[idx]
            direct = mix.runners[e].denoise_audio(group)[: len(idx)]
            torch.testing.assert_close(out[idx], direct, rtol=0, atol=0)
        torch.testing.assert_close(single, out[0], rtol=0, atol=1e-6)


def _export_specialists(saved, family, variables):
    stem = "mask_denoiser" if family == "mask" else "unet_denoiser"
    for i, (nt, v) in enumerate(zip(NOISE_CLASSES, variables)):
        path = os.path.join(saved, f"{stem}_{nt}.ckpt")
        export_model(path, v["params"], v["batch_stats"])
        meta = {"width_mult": 0.125, **(MASK_CFGS[i] if family == "mask" else {})}
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(meta, f)


@pytest.fixture(scope="module")
def saved(tmp_path_factory, router_params):
    """Both families' narrow specialists and a port-written router."""
    d = str(tmp_path_factory.mktemp("saved_models"))
    _export_specialists(d, "magnitude", _variables("magnitude", NARROW))
    _export_specialists(d, "mask", _variables("mask", NARROW))
    export_model(os.path.join(d, "noise_router.ckpt"), router_params, {})
    return d


class TestLoadMixture:
    def test_reads_jax_and_port_router_exports(self, saved, router_params, tmp_path):
        from audiodenoiser_tpu.train.checkpoints import export_model as jax_export

        jax_export(str(tmp_path / "noise_router.ckpt"),
                   jax.tree_util.tree_map(jnp.asarray, router_params), {})
        with open(tmp_path / "noise_router.json", "w") as f:
            json.dump({"window": [256, 48]}, f)
        from_jax, window = port_ens.load_router(str(tmp_path / "noise_router.ckpt"))
        from_port, default = port_ens.load_router(os.path.join(saved, "noise_router.ckpt"))
        assert window == (256, 48) and default == (256, 64)
        assert from_jax.dtype == torch.bfloat16  # JAX's router computes in bf16
        a, b = from_jax.state_dict(), from_port.state_dict()
        assert sorted(a) == sorted(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        ref = jax_ens.load_mixture(saved, dtype=jnp.float32)  # JAX reads the port's files
        for layer in router_params:
            for name, arr in router_params[layer].items():
                np.testing.assert_array_equal(np.asarray(ref.router_params[layer][name]), arr)

    @pytest.mark.parametrize("stem,family", [("unet_denoiser", "magnitude"),
                                             ("mask_denoiser", "mask")])
    def test_builds_the_family(self, saved, stem, family):
        mix = port_ens.load_mixture(saved, dtype=torch.float32, stem=stem, device="cpu")
        assert mix.family == family and mix.router_window == (256, 64)
        assert [getattr(m, "mask_bound", None) for m in mix.expert_models] == (
            [c["mask_bound"] for c in MASK_CFGS] if family == "mask" else [None] * 4)
        with pytest.raises(FileNotFoundError, match="cli.train --model router"):
            port_ens.load_mixture(saved, router_name="absent.ckpt", device="cpu")


def _numbers(path):
    """Every ``name: value[ dB]`` number of a metrics file (the header's
    noise type is no number)."""
    out = []
    for line in open(path).read().splitlines()[1:]:
        if ": " in line and not line.startswith("#"):
            out.append(float(line.split(": ")[-1].split()[0]))
    return out


def _check_metrics(ours, ref):
    """SI-SDR within 1e-3 dB, every other metric within 1e-4 of the larger
    of its value and 1 (STOI near 0, on an uncorrelated clip, has no
    relative precision to speak of)."""
    assert set(ours) == set(ref)
    for k, v in ref.items():
        bound = DB if "si_sdr" in k else REL * max(abs(v), 1.0)
        assert abs(ours[k] - v) <= bound, (k, ours[k], v)


@pytest.fixture(scope="module")
def npy_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("test_processed")
    rng = np.random.default_rng(5)
    for nt in ("white", "urban"):
        for kind in ("clean", "noisy"):
            np.save(d / f"{kind}_{nt}.npy",
                    np.abs(rng.standard_normal((3, 257, 48))).astype(np.float32))
    return str(d)


@pytest.fixture(scope="module")
def wav_dirs(tmp_path_factory):
    """Two 1 s speech-like clips and a 0.5 s noise clip (tiled, so the urban
    segments need no draw)."""
    from audiodenoiser_torch.data.synth import synth_chunks

    root = tmp_path_factory.mktemp("wavs")
    (root / "clean").mkdir(), (root / "noise").mkdir()
    for i, clip in enumerate(synth_chunks(2, seed=8)):
        write_wav(str(root / "clean" / f"c{i}.wav"), clip[:8000], 8000)
    write_wav(str(root / "noise" / "n0.wav"), _wavs(1, 4000, seed=6)[0], 8000)
    return str(root / "clean"), str(root / "noise")


def _jax_draws(key, noise_type, shape):
    """The draws JAX's _corrupt_and_featurize makes from ``key``."""
    if noise_type == "white":
        keys = jax.random.split(key, shape[0])
        return {"noise": np.stack([np.asarray(jax.random.normal(k, shape[1:])) for k in keys])}
    if noise_type == "noise_cancellation":
        return {"gate": np.asarray(jax.random.bernoulli(key, 0.8, (shape[0], -(-shape[1] // 16000))))}
    return {}


class TestEvaluate:
    def test_evaluate_routed_matches_jax(self, magnitude, npy_set, tmp_path):
        ref_mix, mix = magnitude
        ref = jax_ens.evaluate_routed(ref_mix, npy_set, str(tmp_path / "jax"),
                                      noise_types=("white", "urban", "reverb"))
        ours = port_ens.evaluate_routed(mix, npy_set, str(tmp_path / "port"),
                                        noise_types=("white", "urban", "reverb"))
        assert set(ours) == {"white", "urban"}  # no reverb set
        for nt in ours:
            _check_metrics(ours[nt], ref[nt])
            a, b = (tmp_path / d / f"{nt}_routed_metrics.txt" for d in ("port", "jax"))
            assert a.read_text().splitlines()[0] == b.read_text().splitlines()[0]
            np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=2e-4, atol=1e-6)

    def test_evaluate_routed_waveform_matches_jax(self, mask, wav_dirs, tmp_path, monkeypatch):
        """The port's corruption is handed the draws JAX's makes from the
        key chain of ``seed``."""
        ref_mix, mix = mask
        seed, real = 3, port_builders._corrupt_and_featurize
        chain = {"key": jax.random.key(seed)}

        def with_jax_draws(clean, *args, generator=None):
            chain["key"], _, k_mix = jax.random.split(chain["key"], 3)
            draws = _jax_draws(k_mix, args[1], tuple(clean.shape))
            return real(clean, *args, **{k: torch.from_numpy(np.array(v))
                                         for k, v in draws.items()})

        monkeypatch.setattr(port_builders, "_corrupt_and_featurize", with_jax_draws)
        kw = dict(noise_types=("white", "urban", "reverb", "noise_cancellation"), seed=seed)
        ref = jax_ens.evaluate_routed_waveform(ref_mix, *wav_dirs, str(tmp_path / "jax"), **kw)
        ours = port_ens.evaluate_routed_waveform(mix, *wav_dirs, str(tmp_path / "port"), **kw)
        for nt in kw["noise_types"]:
            assert {"routing_accuracy", "stoi", "pesq", "si_sdr30"} <= set(ours[nt])
            _check_metrics(ours[nt], ref[nt])
            text = (tmp_path / "port" / f"{nt}_routed_metrics.txt").read_text()
            assert text.startswith(f"Auto-routed waveform metrics (mask) for noise type: {nt}")
            assert "PESQ-approx denoised" in text


class TestAutoRouteCLI:
    def test_magnitude_family_matches_jax_cli(self, saved, npy_set, tmp_path):
        """Both CLIs load the same files; their bf16 routers agree on every
        clip here (each top-2 margin is far above bf16's rounding)."""
        from audiodenoiser_tpu.cli.test import main as jax_main

        flags = ["--auto_route", "--saved_models_dir", saved, "--test_data_dir", npy_set,
                 "--precision", "f32", "--noise_types", "white", "urban"]
        ref = jax_main(flags + ["--output_dir", str(tmp_path / "jax"), "--ep", "off"])
        ours = port_test_cli.main(flags + ["--output_dir", str(tmp_path / "port"),
                                           "--device", "cpu"])
        mix = port_ens.load_mixture(saved, dtype=torch.float32, device="cpu")
        for nt in ("white", "urban"):
            logits = mix.logits(torch.from_numpy(np.load(os.path.join(npy_set,
                                                                      f"noisy_{nt}.npy")))[:, None])
            top2 = logits.sort(-1).values[:, -2:]
            assert bool(((top2[:, 1] - top2[:, 0]) > 2e-2 * logits.abs().max()).all())
            _check_metrics(ours[nt], ref[nt])
        assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))

    def test_mask_family_over_wavs(self, saved, wav_dirs, tmp_path):
        out = tmp_path / "out"
        results = port_test_cli.main([
            "--auto_route", "--model", "complex_mask", "--saved_models_dir", saved,
            "--clean_dir", wav_dirs[0], "--noise_dir", wav_dirs[1], "--output_dir", str(out),
            "--precision", "f32", "--device", "cpu", "--noise_types", "white", "reverb"])
        assert sorted(os.listdir(out)) == ["reverb_routed_metrics.txt",
                                           "white_routed_metrics.txt"]
        mix = port_ens.load_mixture(saved, dtype=torch.float32, stem="mask_denoiser",
                                    device="cpu")
        again = port_ens.evaluate_routed_waveform(mix, *wav_dirs, str(tmp_path / "again"),
                                                  noise_types=("white", "reverb"))
        for nt, m in results.items():
            assert all(np.isfinite(v) for v in m.values()) and 0 <= m["routing_accuracy"] <= 1
            assert m == again[nt]
