"""The port's ``.ckpt`` exports (its own msgpack codec) against the JAX
package's Flax exports, the sidecar-driven loader, and the file order of
``load_model_for_noise``. Arrays are held bit-equal; forwards in fp32
within 1e-5 relative L2."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from audiodenoiser_torch.eval.runner import load_model_for_noise, load_model_from_path
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    UNet,
    fold_for_inference,
    load_flax_variables,
    random_flax_variables,
    scaled_widths,
    width_kwargs,
)
from audiodenoiser_torch.train import checkpoints as port_ckpt
from audiodenoiser_torch.train import msgpack_codec
from audiodenoiser_tpu.eval.runner import load_model_for_noise as jax_load_model_for_noise
from audiodenoiser_tpu.models.unet import scaled_widths as jax_scaled_widths
from audiodenoiser_tpu.train import checkpoints as jax_ckpt
from audiodenoiser_tpu.train.torch_export import save_pth

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)
TREES = {"unet": dict(in_channels=1, out_channels=1),
         "mask": dict(in_channels=3, out_channels=2)}


def _tree(kind, seed=0, **widths):
    return random_flax_variables(seed, **(widths or NARROW), **TREES[kind])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


class TestExportFormat:
    @pytest.mark.parametrize("quantize", [False, True])
    @pytest.mark.parametrize("kind", ["unet", "mask"])
    def test_jax_export_read_by_port(self, tmp_path, kind, quantize):
        v = _tree(kind)
        path = str(tmp_path / "m.ckpt")
        jax_ckpt.export_model(path, v["params"], v["batch_stats"], quantize=quantize)
        ours = port_ckpt.load_exported(path)
        ref = jax_ckpt.load_exported(path)
        _assert_bit_equal(ours, ref)
        if not quantize:
            _assert_bit_equal(ours, v)

    @pytest.mark.parametrize("quantize", [False, True])
    @pytest.mark.parametrize("kind", ["unet", "mask"])
    def test_port_export_read_by_jax(self, tmp_path, kind, quantize):
        """The port writes the very bytes Flax writes for the same tree."""
        v = _tree(kind, seed=1)
        ours, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
        port_ckpt.export_model(ours, v["params"], v["batch_stats"], quantize=quantize)
        jax_ckpt.export_model(ref, v["params"], v["batch_stats"], quantize=quantize)
        with open(ours, "rb") as f, open(ref, "rb") as g:
            assert f.read() == g.read()
        _assert_bit_equal(jax_ckpt.load_exported(ours), jax_ckpt.load_exported(ref))

    def test_chunked_arrays(self, tmp_path, monkeypatch):
        """Arrays above MAX_CHUNK_SIZE bytes go out as chunk maps: the
        writer's limit made small so that every kernel is chunked."""
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
        monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 256)
        v = _tree("mask", seed=2)
        ours, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
        jax_ckpt.export_model(ref, v["params"], v["batch_stats"])
        port_ckpt.export_model(ours, v["params"], v["batch_stats"])
        with open(ref, "rb") as f:
            raw = f.read()
        assert b"__msgpack_chunked_array__" in raw
        with open(ours, "rb") as f:
            assert f.read() == raw
        _assert_bit_equal(port_ckpt.load_exported(ref), v)
        monkeypatch.undo()  # the reader needs no limit
        _assert_bit_equal(jax_ckpt.load_exported(ours), v)

    @pytest.mark.parametrize("value", [
        None, True, False, 0, 127, 128, 255, 65536, 2 ** 33, -1, -32, -33, -200,
        -40000, -2 ** 40, 1.5, "x" * 31, "y" * 40, "z" * 300, b"\x00" * 300,
        {"k": [1, 2.5, "s"]}, list(range(20)), np.float32(2.5), np.int64(-3),
        np.arange(6, dtype=np.int16).reshape(2, 3)])
    def test_codec_matches_flax(self, value):
        """Each msgpack form the codec writes, against Flax's encoder and
        decoder: the same bytes, and each reads the other's."""
        tree = {"v": value}
        ref = serialization.msgpack_serialize(tree)
        assert msgpack_codec.serialize(tree) == ref
        back = msgpack_codec.restore(ref)["v"]
        if isinstance(value, (np.ndarray, np.generic)):
            assert back.dtype == np.asarray(value).dtype
            np.testing.assert_array_equal(back, value)
        else:
            assert back == value and type(back) is type(value)


class TestLoadModel:
    def test_widths_match_jax(self):
        for m in (0.25, 0.5, 1.0, 1.5):
            assert scaled_widths(m) == jax_scaled_widths(m)
        assert width_kwargs(1.0) == {}

    def test_sidecar_rebuilds_compact_residual_mask(self, tmp_path):
        feats, bottleneck = scaled_widths(0.25)
        v = _tree("mask", seed=3, features=feats, bottleneck=bottleneck)
        path = tmp_path / "mask_denoiser_mixed.ckpt"
        jax_ckpt.export_model(str(path), v["params"], v["batch_stats"])
        with open(tmp_path / "mask_denoiser_mixed.json", "w") as f:
            json.dump({"width_mult": 0.25, "mask_bound": 1.5, "residual": True}, f)
        folded = load_model_from_path(str(path), dtype=torch.float32, device="cpu")
        assert folded.features == feats
        assert (folded.mask_bound, folded.mask_residual) == (1.5, True)
        assert folded.convs["down0_conv0"].weight.shape[1] == 3
        assert folded.convs["out"].weight.shape[0] == 2
        jm, jv = jax_load_model_for_noise("mixed", str(tmp_path), dtype=jnp.float32,
                                          stem="mask_denoiser")
        x = np.random.default_rng(4).standard_normal((2, 40, 24, 3)).astype(np.float32)
        ref = np.asarray(jm.apply(jv, jnp.asarray(x), train=False))
        with torch.no_grad():
            ours = folded(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        rel = np.linalg.norm(ours.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-5, rel

    @pytest.mark.parametrize("meta", [{"s2d_stem": True}, {"s2d_skip": 8},
                                      {"attn_bottleneck": True}])
    def test_unported_variants_name_their_item(self, tmp_path, meta):
        v = _tree("unet")
        path = tmp_path / "unet_denoiser_white.ckpt"
        port_ckpt.export_model(str(path), v["params"], v["batch_stats"])
        with open(tmp_path / "unet_denoiser_white.json", "w") as f:
            json.dump(meta, f)
        with pytest.raises(NotImplementedError, match="ROADMAP A.10"):
            load_model_for_noise("white", str(tmp_path), device="cpu")

    def test_ckpt_wins_over_pth(self, tmp_path):
        """Both files present with different weights: the port serves the
        ``.ckpt``, as the JAX package does (it used to serve the ``.pth``)."""
        a, b = random_flax_variables(7), random_flax_variables(8)
        jax_ckpt.export_model(str(tmp_path / "unet_denoiser_white.ckpt"),
                              a["params"], a["batch_stats"])
        save_pth(b, str(tmp_path / "unet_denoiser_white.pth"))
        _, jv = jax_load_model_for_noise("white", str(tmp_path))
        _assert_bit_equal(jax.device_get(jv), a)  # JAX picks the .ckpt

        served = load_model_for_noise("white", str(tmp_path), dtype=torch.float32,
                                      device="cpu")
        x = torch.from_numpy(np.abs(np.random.default_rng(9).standard_normal(
            (1, 1, 33, 20))).astype(np.float32))

        def folded(v):
            return fold_for_inference(load_flax_variables(UNet(), v).eval(), torch.float32)

        with torch.no_grad():
            got, want, pth = served(x), folded(a)(x), folded(b)(x)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert not torch.allclose(got, pth)

    def test_pth_still_loads_alone(self, tmp_path):
        b = random_flax_variables(8)
        save_pth(b, str(tmp_path / "unet_denoiser_white.pth"))
        served = load_model_for_noise("white", str(tmp_path), dtype=torch.float32,
                                      device="cpu")
        assert served.mask_bound is None

    def test_mask_stem_ignores_pth(self, tmp_path):
        save_pth(random_flax_variables(8), str(tmp_path / "unet_denoiser_mixed.pth"))
        with pytest.raises(FileNotFoundError, match="mask_denoiser_mixed.ckpt"):
            load_model_for_noise("mixed", str(tmp_path), device="cpu", stem="mask_denoiser")

    def test_mask_tree_loads_strict(self):
        v = _tree("mask")
        model = load_flax_variables(ComplexMaskUNet(**NARROW), v)
        assert model.downconv1.conv.double_conv[0].weight.shape[1] == 3
        with pytest.raises(RuntimeError):
            load_flax_variables(UNet(**NARROW), v)  # a 1-channel U-Net refuses it
