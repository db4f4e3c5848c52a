"""Port parity of the width-scaled compact family (``--width_mult``)
against the JAX package on the CPU: the widths and parameter counts of
both families from the models of both packages, ``fit`` at width 0.25,
``cli.train --width_mult`` and its sidecars for both families (the EMA
export's too, as JAX ``tests/test_width.py``), and ``--export_quantized``
against JAX's int8 export of the same tree.

Exact checks: widths, parameter counts, sidecars, the tree shapes of each
export and the bytes of the quantized export. The quantized export read
back through the port's loader is held to JAX's dequantization exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.models import ComplexMaskUNet, UNet, count_params
from audiodenoiser_torch.models.unet import scaled_widths, width_kwargs
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_torch.train.checkpoints import load_exported
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMask
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models.unet import scaled_widths as jax_scaled_widths
from audiodenoiser_tpu.train.checkpoints import export_model as jax_export_model
from audiodenoiser_tpu.train.checkpoints import load_exported as jax_load_exported

# JAX tests/test_width.py's counts for the magnitude family
UNET_PARAMS = {0.5: 7_765_409, 0.25: 1_943_761, 0.125: 487_145}


def _flax_count(model, in_ch):
    v = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, in_ch))))
    return sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(v["params"]))


def _flax_shapes(model, in_ch):
    v = jax.eval_shape(lambda: model.init(jax.random.key(0), jnp.zeros((1, 64, 64, in_ch))))
    return {group: jax.tree_util.tree_map(lambda a: tuple(a.shape), v[group])
            for group in ("params", "batch_stats")}


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)


class TestScaledWidths:
    @pytest.mark.parametrize("mult", [0.1, 0.125, 0.25, 0.3, 0.5, 0.7, 1.0, 1.3])
    def test_widths_match_jax(self, mult):
        assert scaled_widths(mult) == jax_scaled_widths(mult)
        feats, bottleneck = scaled_widths(mult)
        assert all(f % 8 == 0 for f in feats) and bottleneck % 8 == 0

    @pytest.mark.parametrize("family", ["unet", "complex_mask"])
    @pytest.mark.parametrize("mult", [0.5, 0.25, 0.125])
    def test_param_counts_match_jax(self, mult, family):
        kw = width_kwargs(mult)
        if family == "unet":
            ours, ref = count_params(UNet(**kw)), _flax_count(FlaxUNet(**kw), 1)
            assert ours == UNET_PARAMS[mult]
        else:
            ours, ref = count_params(ComplexMaskUNet(**kw)), _flax_count(FlaxMask(**kw), 3)
        assert ours == ref
        if (mult, family) == (0.25, "complex_mask"):
            assert ours == 1_944_066  # the distilled student of README's recipe

    def test_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            scaled_widths(0.0)
        assert width_kwargs(1.0) == {}


class TestFit:
    def test_fit_builds_the_scaled_unet(self, tmp_path):
        """``FitConfig.width_mult`` 0.25: the 1,943,761-parameter U-Net
        (JAX's count), trained and exported as a ``.ckpt`` whose tree has
        the shapes of JAX's UNet at that width."""
        rng = np.random.default_rng(0)
        x = np.abs(rng.standard_normal((2, 1, 64, 32))).astype(np.float32)
        cfg = port_loop.FitConfig(run_name="w", output_path=str(tmp_path), epochs=1,
                                  batch_size=2, precision="f32", width_mult=0.25,
                                  device="cpu")
        res = port_loop.fit(cfg, lambda e: iter([(x, 0.8 * x)]), lambda: iter([(x, 0.8 * x)]))
        model = res["state"].model
        assert model.features == (16, 32, 64, 128) and model.bottleneck_width == 256
        assert count_params(model) == UNET_PARAMS[0.25]
        assert np.isfinite(res["best_val"])
        payload = load_exported(res["best_path"])
        want = _flax_shapes(FlaxUNet(**width_kwargs(0.25)), 1)
        for group in ("params", "batch_stats"):
            assert _shapes(payload[group]) == want[group]


def _wavs(root):
    from audiodenoiser_torch.data.wav_io import write_wav

    (root / "clean").mkdir(parents=True)
    for i, chunk in enumerate(synth_chunks(6, seed=11).reshape(3, -1)):
        write_wav(str(root / "clean" / f"c{i}.wav"), chunk, 8000)


def _train(tmp_path, *flags):
    from audiodenoiser_torch.cli.train import main

    _wavs(tmp_path / "data")
    return main(["--base_dataset_path", str(tmp_path / "data"), "--pipeline", "on_device",
                 "--noise_type", "white", "--output_path", str(tmp_path / "runs"),
                 "--run_name", "widthrun", "--epochs", "1", "--steps_per_epoch", "2",
                 "--batch_size", "2", "--precision", "f32", "--device", "cpu", *flags])


class TestTrainCLI:
    @pytest.mark.parametrize("family,stem,meta", [
        ("unet", "unet_denoiser", {"width_mult": 0.125}),
        ("complex_mask", "mask_denoiser",
         {"mask_bound": 2.0, "si_sdr_weight": 0.5, "si_sdr_clamp": 30.0, "residual": True,
          "width_mult": 0.125}),
    ])
    def test_width_mult_trains_and_records_sidecar(self, tmp_path, family, stem, meta):
        """JAX's sidecar keys, beside the run's checkpoint and the export;
        the loaders of both packages rebuild the width-0.125 model."""
        from audiodenoiser_torch.eval.runner import load_model_for_noise
        from audiodenoiser_tpu.eval.runner import load_model_for_noise as jax_load

        saved = tmp_path / "sm"
        out = _train(tmp_path, "--model", family, "--width_mult", "0.125",
                     "--export_dir", str(saved))
        assert np.isfinite(out["best_val"])
        for sidecar in (os.path.splitext(out["best_path"])[0] + ".json",
                        saved / f"{stem}_white.json"):
            with open(sidecar) as f:
                assert json.load(f) == meta
        model = load_model_for_noise("white", str(saved), dtype=torch.float32, device="cpu",
                                     stem=stem, fold=False)
        assert model.features == (8, 16, 32, 64) and model.bottleneck_width == 128
        jmodel, _ = jax_load("white", str(saved), dtype=jnp.float32, stem=stem)
        assert tuple(jmodel.features) == (8, 16, 32, 64) and jmodel.bottleneck == 128

    def test_rate_sidecar_keeps_width(self, tmp_path):
        """A 16 kHz magnitude run at width 0.125: both keys, JAX's order."""
        out = _train(tmp_path, "--width_mult", "0.125", "--sample_rate", "16000")
        with open(os.path.splitext(out["best_path"])[0] + ".json") as f:
            assert json.load(f) == {"width_mult": 0.125, "sample_rate": 16000}

    def test_ema_export_gets_width_sidecar(self, tmp_path):
        """``--ema_decay`` exports ``best_model_ema.ckpt``; a width-scaled
        run stamps its sidecar too, or the EMA student cannot be loaded."""
        from audiodenoiser_torch.eval.runner import load_model_from_path

        out = _train(tmp_path, "--width_mult", "0.125", "--ema_decay", "0.9")
        ema_path = out["best_ema_path"]
        assert os.path.exists(ema_path)
        with open(os.path.splitext(ema_path)[0] + ".json") as f:
            assert json.load(f)["width_mult"] == 0.125
        model = load_model_from_path(ema_path, dtype=torch.float32, device="cpu",
                                     stem="unet_denoiser", fold=False)
        assert model.features == (8, 16, 32, 64)

    def test_export_quantized_matches_jax(self, tmp_path):
        """``--export_quantized``: the export's bytes equal JAX's
        ``export_model(..., quantize=True)`` of the run's best tree, and it
        loads back through ``load_model_from_path`` as JAX dequantizes it."""
        from audiodenoiser_torch.eval.runner import load_model_from_path
        from audiodenoiser_torch.models import state_dict_from_flax

        saved = tmp_path / "sm"
        out = _train(tmp_path, "--width_mult", "0.125", "--export_dir", str(saved),
                     "--export_quantized")
        dst = saved / "unet_denoiser_white.ckpt"
        best = jax_load_exported(out["best_path"])
        ref = tmp_path / "jax_int8.ckpt"
        jax_export_model(str(ref), best["params"], best["batch_stats"], quantize=True)
        ours = open(dst, "rb").read()
        assert ours == open(ref, "rb").read()
        assert len(ours) < os.path.getsize(out["best_path"]) / 2
        model = load_model_from_path(str(dst), dtype=torch.float32, device="cpu",
                                     stem="unet_denoiser", fold=False)
        want = state_dict_from_flax(jax.device_get(jax_load_exported(str(dst))))
        for name, t in model.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                assert torch.equal(t, want[name]), name
