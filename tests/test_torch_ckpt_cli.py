"""The checkpoint converters against the JAX package on the CPU:
``train.torch_export.save_pth`` / ``cli.export_checkpoint`` (``.ckpt`` ->
reference-layout ``.pth``) and ``train.torch_import.load_pth`` /
``cli.import_checkpoint`` (``.pth`` -> ``.ckpt``, optionally int8).

The conversions are transposes and flips, so everything is exact: the
port's ``.pth`` is tensor-equal to JAX's, its ``.ckpt`` byte-equal to
JAX's with and without ``--quantize``, and a round trip returns the bytes
it started from.
"""

import os

import numpy as np
import pytest
import torch

from audiodenoiser_torch.cli import export_checkpoint as port_export_cli
from audiodenoiser_torch.cli import import_checkpoint as port_import_cli
from audiodenoiser_torch.eval.runner import load_model_for_noise
from audiodenoiser_torch.models import UNet, random_flax_variables
from audiodenoiser_torch.train.checkpoints import INT8_FORMAT, export_model, load_exported
from audiodenoiser_torch.train.msgpack_codec import restore
from audiodenoiser_torch.train.torch_import import convert_state_dict, load_pth
from audiodenoiser_tpu.cli import export_checkpoint as jax_export_cli
from audiodenoiser_tpu.cli import import_checkpoint as jax_import_cli
from audiodenoiser_tpu.train import torch_import as jax_torch_import

NARROW = dict(features=(8, 16, 24, 32), bottleneck=48)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.fixture
def ckpt(tmp_path):
    """A ``.ckpt`` as ``fit`` writes it."""
    v = random_flax_variables(4)
    path = str(tmp_path / "unet_denoiser_white.ckpt")
    export_model(path, v["params"], v["batch_stats"])
    return path


class TestExport:
    def test_pth_is_tensor_equal_to_jax(self, ckpt, tmp_path):
        ours, ref = str(tmp_path / "ours.pth"), str(tmp_path / "ref.pth")
        port_export_cli.main([ckpt, ours])
        jax_export_cli.main([ckpt, ref])
        a = torch.load(ours, weights_only=True)
        b = torch.load(ref, weights_only=True)
        assert list(a) == list(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        UNet().load_state_dict(a, strict=True)

    def test_saved_models_dir(self, ckpt, tmp_path):
        d = os.path.dirname(ckpt)
        open(os.path.join(d, "mask_denoiser_mixed.ckpt"), "wb").close()  # not a U-Net export
        port_export_cli.main(["--saved_models_dir", d])
        assert sorted(f for f in os.listdir(d) if f.endswith(".pth")) == [
            "unet_denoiser_white.pth"]

    def test_needs_paths(self):
        with pytest.raises(SystemExit, match="SRC DST"):
            port_export_cli.main([])


class TestImport:
    @pytest.mark.parametrize("quantize", [False, True])
    def test_ckpt_is_byte_equal_to_jax(self, ckpt, tmp_path, quantize):
        pth = str(tmp_path / "m.pth")
        jax_export_cli.main([ckpt, pth])
        flag = ["--quantize"] if quantize else []
        ours, ref = str(tmp_path / "ours.ckpt"), str(tmp_path / "ref.ckpt")
        port_import_cli.main([pth, ours, *flag])
        jax_import_cli.main([pth, ref, *flag])
        assert _bytes(ours) == _bytes(ref)
        assert (restore(_bytes(ours)).get("format") == INT8_FORMAT) == quantize

    def test_round_trip_returns_the_bytes(self, ckpt, tmp_path):
        pth, back = str(tmp_path / "m.pth"), str(tmp_path / "back.ckpt")
        port_export_cli.main([ckpt, pth])
        port_import_cli.main([pth, back])
        assert _bytes(back) == _bytes(ckpt)

    def test_saved_models_dir_quantized_export_serves(self, ckpt, tmp_path):
        """--saved_models_dir converts each unet_denoiser_*.pth in place; the
        int8 export loads through the serving loader and stays within int8
        rounding of the float model."""
        d = os.path.dirname(ckpt)
        port_export_cli.main([ckpt, os.path.join(d, "unet_denoiser_urban.pth")])
        port_import_cli.main(["--saved_models_dir", d, "--quantize"])
        q = os.path.join(d, "unet_denoiser_urban.ckpt")
        assert restore(_bytes(q))["format"] == INT8_FORMAT
        assert len(_bytes(q)) < 0.3 * len(_bytes(ckpt))
        x = torch.rand(1, 1, 64, 32)
        with torch.no_grad():
            ours = load_model_for_noise("urban", d, dtype=torch.float32, device="cpu")(x)
            full = load_model_for_noise("white", d, dtype=torch.float32, device="cpu")(x)
        assert torch.isfinite(ours).all()
        assert float((ours - full).norm() / full.norm()) < 0.05

    @pytest.mark.parametrize("layout", ["tensors", "numpy", "no_num_batches_tracked"])
    def test_accepts_what_jax_accepts(self, tmp_path, layout):
        """A state_dict of tensors (a reference ``.pth``), of numpy arrays,
        or without ``num_batches_tracked``: the tree JAX's converter makes."""
        model = UNet(**NARROW)
        sd = model.state_dict()
        if layout == "numpy":
            sd = {k: v.numpy() for k, v in sd.items()}
        elif layout == "no_num_batches_tracked":
            sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
        ours = dict(_leaves(convert_state_dict(sd)))
        ref = dict(_leaves(jax_torch_import.convert_state_dict(
            {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in sd.items()})))
        assert list(ours) == list(ref)
        for k in ref:
            assert ours[k].dtype == np.float32 and np.array_equal(ours[k], ref[k]), k
        if layout == "tensors":
            path = str(tmp_path / "m.pth")
            torch.save(sd, path)
            assert all(np.array_equal(a, ref[k]) for k, a in _leaves(load_pth(path)))

    def test_exports_agree_with_load_exported(self, ckpt, tmp_path):
        pth = str(tmp_path / "m.pth")
        port_export_cli.main([ckpt, pth])
        for (ka, a), (kb, b) in zip(_leaves(load_pth(pth)), _leaves(load_exported(ckpt)),
                                    strict=True):
            assert ka == kb and np.array_equal(a, b), ka
