"""Port parity: ``audiodenoiser_torch.models`` (UNet, FoldedUNet, the Flax
weight carry-over) against the JAX package's Flax models on the CPU.

Weights are drawn once in the Flax tree layout and go to both sides:
as-is to Flax, through ``state_dict_from_flax`` to the port. The norm
ratio ``_rel`` is that of tests/test_folded.py; the bounds are 1e-5 in
fp32 and 0.02 in bf16 (the repo's own bf16 bound, test_folded.py:94).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs
from audiodenoiser_tpu.models.unet import _pad_to_match
from audiodenoiser_tpu.train.torch_export import export_state_dict, save_pth
from audiodenoiser_torch.models import (
    FoldedUNet,
    UNet,
    count_params,
    fold_for_inference,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.unet import pad_to_match

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(0, **NARROW)


@pytest.fixture(scope="module")
def port_unet(variables):
    model = UNet(**NARROW)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.eval()


def _flax_out(model, variables, x):
    return np.asarray(model.apply(variables, jnp.asarray(x)[..., None],
                                  train=False))[..., 0]


def _port_out(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)[:, None])[:, 0].float().numpy()


INPUTS = {
    "train_crop": (2, 32, 32),
    "odd_eval": (2, 33, 21),
    "whole_clip": (1, 257, 30),
}


class TestParamCount:
    def test_full_width_from_construction(self):
        assert count_params(UNet()) == 31_042_369

    def test_narrow_matches_flax_tree(self, variables):
        flax_count = sum(np.asarray(p).size for p in
                         jax.tree_util.tree_leaves(variables["params"]))
        assert count_params(UNet(**NARROW)) == flax_count


class TestConvert:
    def test_same_tensors_as_torch_export(self, variables):
        ours = state_dict_from_flax(variables)
        ref = export_state_dict(variables)
        assert set(ours) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
            assert ours[k].numpy().dtype == np.asarray(v).dtype

    def test_flax_initialised_tree_loads_strict(self):
        model = FlaxUNet(**NARROW)
        v = jax.device_get(model.init(jax.random.key(0), jnp.zeros((1, 32, 32, 1))))
        UNet(**NARROW).load_state_dict(state_dict_from_flax(v), strict=True)

    def test_save_pth_loads_strict(self, tmp_path):
        v = random_flax_variables(3)  # full width: save_pth's 4-level export
        path = str(tmp_path / "unet_denoiser_white.pth")
        save_pth(v, path)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model = UNet()
        model.load_state_dict(sd, strict=True)
        ours = state_dict_from_flax(v)
        for k, t in model.state_dict().items():
            torch.testing.assert_close(t, ours[k], rtol=0, atol=0)


class TestUNet:
    @pytest.mark.parametrize("name", list(INPUTS))
    def test_matches_flax_fp32(self, variables, port_unet, name):
        x = np.abs(np.random.default_rng(1).standard_normal(INPUTS[name])).astype(np.float32)
        ref = _flax_out(FlaxUNet(**NARROW), variables, x)
        ours = _port_out(port_unet, x)
        assert ours.shape == ref.shape == x.shape
        assert _rel(ours, ref) < 1e-5

    @pytest.mark.parametrize("dy,dx", [(0, 0), (1, 0), (0, 1), (1, 1), (3, 2)])
    def test_pad_to_match_puts_extra_bottom_right(self, dy, dx):
        x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)  # NHWC
        target = np.zeros((2, 3 + dy, 4 + dx, 5), np.float32)
        ref = np.asarray(_pad_to_match(jnp.asarray(x), jnp.asarray(target)))
        ours = pad_to_match(torch.from_numpy(x).permute(0, 3, 1, 2),
                            torch.from_numpy(target).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)

    def test_batchnorm_settings(self, port_unet):
        bn = port_unet.downconv1.conv.double_conv[1]
        assert bn.eps == 1e-5 and bn.momentum == 0.1  # Flax momentum=0.9


class TestFoldedUNet:
    @pytest.mark.parametrize("name", list(INPUTS))
    def test_fp32_fold_matches_flax(self, variables, port_unet, name):
        x = np.abs(np.random.default_rng(2).standard_normal(INPUTS[name])).astype(np.float32)
        ref = _flax_out(FlaxUNet(**NARROW), variables, x)
        fm, fv = fold_runner_inputs(FlaxUNet(**NARROW), variables, dtype=jnp.float32)
        flax_folded = _flax_out(fm, fv, x)
        ours = _port_out(fold_for_inference(port_unet, torch.float32), x)
        assert _rel(ours, ref) < 1e-5
        assert _rel(ours, flax_folded) < 1e-5

    @pytest.mark.parametrize("name", ["train_crop", "whole_clip"])
    def test_bf16_fold_matches_flax_bf16(self, variables, port_unet, name):
        x = np.abs(np.random.default_rng(3).standard_normal(INPUTS[name])).astype(np.float32)
        fm, fv = fold_runner_inputs(FlaxUNet(dtype=jnp.bfloat16, **NARROW), variables)
        assert fm.dtype == jnp.bfloat16
        ref = _flax_out(fm, fv, x)
        folded = fold_for_inference(port_unet)
        ours = _port_out(folded, x)
        assert ours.dtype == np.float32  # cast back to the input's dtype
        assert _rel(ours, ref) < 0.02, _rel(ours, ref)

    def test_kernels_cast_biases_f32(self, port_unet):
        folded = fold_for_inference(port_unet)
        assert isinstance(folded, FoldedUNet) and folded.dtype == torch.bfloat16
        convs = folded.convs
        assert convs["down0_conv0"].weight.dtype == torch.bfloat16
        assert convs["down0_conv0"].bias.dtype == torch.float32
        assert convs["up0_deconv"].weight.dtype == torch.bfloat16
        assert convs["out"].bias.dtype == torch.float32
        names = [n for n, _ in folded.named_buffers()]
        assert len(names) == 2 * (2 * 9 + 4 + 1)  # 18 convs, 4 deconvs, head
        assert not any("bn" in n or "running" in n for n in names)

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
    def test_cpu_takes_the_plain_route(self, port_unet, dtype):
        """On the CPU every folded conv, deconv and the head goes the plain
        way: 18 + 4 + 1 plain calls a forward, none fused."""
        from audiodenoiser_torch.models.folded import _Conv

        x = np.abs(np.random.default_rng(5).standard_normal((2, 32, 32))).astype(np.float32)
        before = (_Conv.fused_launches, _Conv.plain_launches)
        _port_out(fold_for_inference(port_unet, dtype), x)
        assert _Conv.fused_launches == before[0]
        assert _Conv.plain_launches == before[1] + 2 * 9 + 4 + 1

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
    @pytest.mark.parametrize("name,relu", [("down0_conv0", True), ("down1_conv1", True),
                                           ("bottleneck_conv0", True), ("up3_conv_conv0", True),
                                           ("out", False), ("up0_deconv", False)])
    def test_conv_is_plain_conv_bias_relu(self, port_unet, dtype, name, relu):
        """A folded layer on the CPU is bit for bit ``conv2d`` (or
        ``conv_transpose2d``) with the bias cast to the input's dtype, then
        ``relu`` where the layer takes one."""
        import torch.nn.functional as F

        conv = fold_for_inference(port_unet, dtype).convs[name]
        cin = conv.weight.shape[0 if conv.transpose else 1]
        x = (torch.from_numpy(np.random.default_rng(6).standard_normal((2, cin, 9, 7))
                              .astype(np.float32)).to(dtype)
             .contiguous(memory_format=torch.channels_last))
        b = conv.bias.to(dtype)
        if conv.transpose:
            want = F.conv_transpose2d(x, conv.weight, b, stride=2)
        else:
            want = F.conv2d(x, conv.weight, b, padding=conv.weight.shape[-1] // 2)
            want = F.relu(want) if relu else want
        with torch.no_grad():
            got = conv(x, relu=relu)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    @pytest.mark.parametrize("is_cuda,dtype,cudnn,fused", [
        (True, torch.bfloat16, True, True),
        (True, torch.float16, True, True),
        (True, torch.float32, True, False),
        (True, torch.bfloat16, False, False),
        (False, torch.bfloat16, True, False),
    ])
    def test_fused_route_rule(self, is_cuda, dtype, cudnn, fused):
        """The route depends on the device, the dtype and cuDNN's switch."""
        from types import SimpleNamespace

        from audiodenoiser_torch.models.folded import fused_route

        with torch.backends.cudnn.flags(enabled=cudnn):
            assert fused_route(SimpleNamespace(is_cuda=is_cuda, dtype=dtype)) is fused

    def test_fold_uses_running_stats_not_batch_stats(self, port_unet):
        """The fold reads eval BN: a train-mode model folds the same."""
        x = np.abs(np.random.default_rng(4).standard_normal((2, 32, 32))).astype(np.float32)
        a = _port_out(fold_for_inference(port_unet, torch.float32), x)
        port_unet.train()
        try:
            b = _port_out(fold_for_inference(port_unet, torch.float32), x)
        finally:
            port_unet.eval()
        np.testing.assert_array_equal(a, b)
