"""The port's attention bottleneck (``UNet(attn_bottleneck=True)``,
``models.unet.BottleneckAttention``) against the JAX package's, on the
same numpy-seeded inputs and converted weights. The output projection is
nonzero (``random_flax_variables``): with JAX's zero init the block is an
exact no-op and a parity test of it would prove nothing.

Tolerances: the sin/cos encoding bit-equal; fp32 forwards within 1e-5
relative L2 (the block measures about 3e-7); bf16 within 1e-2 of JAX's
bf16 block. Measured on the CPU at the widths below, the port's bf16 block
lies 2.8e-3 to 3.2e-3 from JAX's (4.4e-3 to 5.4e-3 on the attention's own
contribution, ``out - x``), about one bf16 rounding: JAX's bf16 block
itself lies 3.8e-3 to 4.3e-3 from its fp32 one. Gradients of one fp32
train step within 1e-4, as ``tests/test_torch_train.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.models import (
    BottleneckAttention,
    ComplexMaskUNet,
    UNet,
    flax_from_state_dict,
    fold_for_inference,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.unet import _sincos_2d
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_torch.train import mask as port_mask
from audiodenoiser_tpu.models import ComplexMaskUNet as JaxComplexMaskUNet
from audiodenoiser_tpu.models import UNet as JaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs
from audiodenoiser_tpu.models.unet import BottleneckAttention as JaxAttention
from audiodenoiser_tpu.models.unet import _sincos_2d as jax_sincos_2d
from audiodenoiser_tpu.train import loop as jax_loop
from audiodenoiser_tpu.train import mask as jax_mask

TOL = 1e-5
BF16_TOL = 1e-2
TINY = dict(features=(4, 8), bottleneck=16)
# gradients that are 0 but for rounding: a conv bias feeding train-mode
# BatchNorm, and the key's bias (it shifts every logit of a query's row
# alike, which the softmax cancels)
ZERO_GRAD = ("double_conv.0.bias", "double_conv.3.bias", "bottleneck_attn.key.bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _block(c, seed=0):
    """The attention subtree of a seeded tree and the port's block holding it."""
    v = random_flax_variables(seed, features=(8,), bottleneck=c, attn_bottleneck=True)
    block = BottleneckAttention(c)
    block.load_state_dict({k.split(".", 1)[1]: t for k, t in state_dict_from_flax(v).items()
                           if k.startswith("bottleneck_attn.")}, strict=True)
    return v["params"]["bottleneck_attn"], block


def _jax_block(params, x, dtype):
    """JAX's block on ``x`` in ``dtype``, jitted, as float32 numpy."""
    fn = jax.jit(lambda p, x: JaxAttention(dtype=dtype).apply({"params": p}, x))
    return np.asarray(fn(params, jnp.asarray(x, dtype)).astype(jnp.float32))


@pytest.mark.parametrize("h,w,dim", [(16, 7, 1024), (8, 3, 1024), (16, 4, 32), (5, 3, 12),
                                     (1, 1, 8)])
def test_sincos_bit_equal(h, w, dim):
    ours, ref = _sincos_2d(h, w, dim), jax_sincos_2d(h, w, dim)
    assert ours.dtype == ref.dtype == np.float32 and np.array_equal(ours, ref)


class TestBlock:
    @pytest.mark.parametrize("c,hw", [(32, (8, 4)), (256, (8, 3)), (1024, (16, 7))])
    def test_fp32_matches_jax(self, c, hw):
        params, block = _block(c)
        assert float(block.out.weight.detach().abs().sum()) > 0
        x = np.random.default_rng(1).standard_normal((2, *hw, c)).astype(np.float32)
        ref = _jax_block(params, x, jnp.float32)
        with torch.no_grad():
            got = _nhwc(block(_nchw(x)))
        assert _rel(got, ref) < TOL
        assert _rel(got - x, ref - x) < TOL  # the attention's own contribution

    @pytest.mark.parametrize("c,hw", [(32, (8, 4)), (1024, (16, 7))])
    def test_bf16_matches_jax(self, c, hw):
        params, block = _block(c, seed=2)
        x = np.random.default_rng(3).standard_normal((2, *hw, c)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        ref = _jax_block(params, xb, jnp.bfloat16)
        with torch.no_grad():
            out = block(_nchw(x).to(torch.bfloat16))
        assert out.dtype == torch.bfloat16
        got, xr = _nhwc(out), np.asarray(xb.astype(jnp.float32))
        assert _rel(got, ref) < BF16_TOL
        assert _rel(got - xr, ref - xr) < BF16_TOL

    def test_encoding_follows_the_shape(self):
        """The encoding is the one of each call's shape: two shapes one
        after the other each match JAX."""
        params, block = _block(32, seed=4)
        for hw in [(8, 4), (4, 2), (8, 4)]:
            x = np.random.default_rng(5).standard_normal((1, *hw, 32)).astype(np.float32)
            ref = _jax_block(params, x, jnp.float32)
            with torch.no_grad():
                assert _rel(_nhwc(block(_nchw(x))), ref) < TOL


class TestConverters:
    def test_round_trip(self):
        """Flax tree -> state_dict -> Flax tree is bit-equal, the attention's
        DenseGeneral kernels (c, heads, d) and (heads, d, c) included."""
        v = random_flax_variables(6, **TINY, attn_bottleneck=True)
        model = UNet(**TINY, attn_bottleneck=True)
        model.load_state_dict(state_dict_from_flax(v), strict=True)
        back = flax_from_state_dict(model.state_dict())
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
            assert a.shape == b.shape and np.array_equal(a, b)
        q = v["params"]["bottleneck_attn"]["mhsa"]["query"]
        assert q["kernel"].shape == (16, 4, 16) and q["bias"].shape == (4, 16)
        assert v["params"]["bottleneck_attn"]["mhsa"]["out"]["kernel"].shape == (4, 16, 16)

    def test_layout_matches_jax_init(self):
        for cls, jcls, cin in ((UNet, JaxUNet, 1), (ComplexMaskUNet, JaxComplexMaskUNet, 3)):
            model = cls(**TINY, attn_bottleneck=True)
            shapes = jax.eval_shape(lambda: jcls(**TINY, attn_bottleneck=True).init(
                jax.random.key(0), jnp.zeros((1, 32, 32, cin))))
            want = jax.tree_util.tree_map(lambda s: s.shape, shapes["params"])
            got = jax.tree_util.tree_map(lambda a: a.shape,
                                         flax_from_state_dict(model.state_dict())["params"])
            assert got == want

    def test_flax_like_init(self):
        """``init_flax_like``: LayerNorm 1/0, zero biases, a zero output
        projection (the block starts as a no-op), LeCun-scaled q/k/v."""
        model = port_loop.init_flax_like(UNet(features=(64,), bottleneck=1024,
                                              attn_bottleneck=True), 0)
        attn = model.bottleneck_attn
        assert torch.equal(attn.ln.weight, torch.ones(1024))
        assert not attn.ln.bias.any() and not attn.out.weight.any()
        for lin in (attn.query, attn.key, attn.value):
            assert not lin.bias.any()
            assert abs(float(lin.weight.detach().std()) * np.sqrt(1024) - 1.0) < 0.02
        x = torch.randn(2, 1024, 4, 2)
        with torch.no_grad():
            assert torch.equal(attn(x), x)


class TestModel:
    @pytest.mark.parametrize("family", ["unet", "mask"])
    def test_live_and_folded_match_jax(self, family):
        """Both families with the attention on, live BN and folded: fp32
        within 1e-5 of JAX's live model, the bf16 fold within 2e-2 of
        JAX's bf16 fold (``fold_runner_inputs``), as JAX's fold tests."""
        cin, cout = (1, 1) if family == "unet" else (3, 2)
        head = {} if family == "unet" else dict(mask_bound=8.0, residual=True)
        cls, jcls = (UNet, JaxUNet) if family == "unet" else (ComplexMaskUNet,
                                                              JaxComplexMaskUNet)
        v = random_flax_variables(7, **TINY, in_channels=cin, out_channels=cout,
                                  attn_bottleneck=True)
        model = cls(**TINY, **head, attn_bottleneck=True)
        model.load_state_dict(state_dict_from_flax(v), strict=True)
        model.eval()
        folded32 = fold_for_inference(model, torch.float32)
        folded16 = fold_for_inference(model, torch.bfloat16)
        assert folded32.attn is not None and folded32.attn.ln.weight.dtype == torch.float32
        jm = jcls(**TINY, **head, attn_bottleneck=True)
        jfm, jfv = fold_runner_inputs(jcls(**TINY, **head, attn_bottleneck=True,
                                           dtype=jnp.bfloat16), v)
        rng = np.random.default_rng(8)
        for shape in [(2, 64, 32), (1, 65, 33)]:
            x = rng.standard_normal((*shape, cin)).astype(np.float32)
            ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
                v, jnp.asarray(x)))
            with torch.no_grad():
                assert _rel(_nhwc(model(_nchw(x))), ref) < TOL
                assert _rel(_nhwc(folded32(_nchw(x))), ref) < TOL
                ref16 = np.asarray(jax.jit(lambda v, x: jfm.apply(v, x, train=False))(
                    jfv, jnp.asarray(x)))
                assert _rel(_nhwc(folded16(_nchw(x))), ref16) < 2e-2

    def test_train_step_gradients_match_jax(self):
        """One fp32 train step: losses within 1e-5, every parameter's
        gradient within 1e-4 (the attention's q/k/v/out and LayerNorm
        included), those whose gradient is 0 (``ZERO_GRAD``) at rounding
        level on both sides."""
        v = random_flax_variables(9, **TINY, attn_bottleneck=True)
        rng = np.random.default_rng(10)
        noisy = np.abs(rng.standard_normal((2, 32, 32, 1))).astype(np.float32)
        clean = (0.8 * noisy + 0.1 * rng.random((2, 32, 32, 1))).astype(np.float32)
        jstate = jax_loop.create_train_state(jax.random.key(0),
                                             JaxUNet(**TINY, attn_bottleneck=True),
                                             input_shape=(1, 32, 32, 1))
        jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
                                batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                                   v["batch_stats"]))
        losses, new_bs, grads = jax.jit(jax_loop._loss_and_updates)(
            jstate, jnp.asarray(noisy), jnp.asarray(clean))

        state = port_loop.create_train_state(0, UNet(**TINY, attn_bottleneck=True),
                                             variables=v, device="cpu")
        state, ours = port_loop.train_step(state, _nchw(noisy), _nchw(clean))
        for a, b in zip(ours, losses):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))
        ref = state_dict_from_flax({"params": jax.device_get(grads),
                                    "batch_stats": jax.device_get(new_bs)})
        norm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g))
                                  for g in jax.tree_util.tree_leaves(grads))))
        scale = min(1.0, 1.0 / norm)
        names = [n for n, _ in state.model.named_parameters()]
        assert {f"bottleneck_attn.{m}.weight" for m in ("query", "key", "value", "out")} \
            <= set(names)
        for name, p in state.model.named_parameters():
            if name.endswith(ZERO_GRAD):
                assert float(p.grad.abs().max()) < 1e-6 * scale * norm, name
                continue
            assert _rel(p.grad.numpy(), scale * ref[name].numpy()) < 1e-4, name

    def test_distillation_tap_is_before_the_attention(self):
        """With the attention on, the feature tap reads the ``bottleneck``
        DoubleConv's output, as JAX's ``capture_intermediates`` of the
        module named ``bottleneck`` does, not the attention's."""
        v = random_flax_variables(11, **TINY, in_channels=3, out_channels=2,
                                  attn_bottleneck=True)
        model = ComplexMaskUNet(**TINY, mask_bound=8.0, residual=True, attn_bottleneck=True)
        model.load_state_dict(state_dict_from_flax(v), strict=True)
        x = np.random.default_rng(12).standard_normal((2, 64, 32, 3)).astype(np.float32)
        jm = JaxComplexMaskUNet(**TINY, mask_bound=8.0, residual=True, attn_bottleneck=True)
        _, mut = jax.jit(lambda v, x: jm.apply(v, x, train=False, mutable=["intermediates"],
                                               capture_intermediates=jax_mask._tap_filter))(
            v, jnp.asarray(x))
        (ref,) = jax.tree_util.tree_leaves(mut["intermediates"])
        after = []
        model.bottleneck_attn.register_forward_hook(lambda *a: after.append(a[-1]))
        with torch.no_grad(), port_mask._tapped(model.eval(), True) as feats:
            model(_nchw(x))
        assert len(feats) == 1 and _rel(_nhwc(feats[0]), np.asarray(ref)) < TOL
        assert _rel(_nhwc(after[0]), np.asarray(ref)) > 1e-2
        assert not model.bottleneck._forward_hooks


def test_cli_train_mask_family_with_the_variants(tmp_path, monkeypatch):
    """Two CPU steps of ``cli.train --model complex_mask --attn_bottleneck
    --s2d_stem --s2d_skip 8`` (tiny widths): the mask factory gets the
    switches, the export has the variant's layers and both sidecars carry
    JAX's keys (``tests/test_torch_s2d.py`` loads such a sidecar)."""
    from audiodenoiser_torch.cli.train import main
    from audiodenoiser_torch.data.wav_io import write_wav
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.checkpoints import load_exported

    built = []

    def narrow(**kw):
        built.append(kw)
        return ComplexMaskUNet(**TINY, **kw)

    monkeypatch.setattr(port_mask, "ComplexMaskUNet", narrow)
    (tmp_path / "data" / "clean").mkdir(parents=True)
    for i, chunk in enumerate(synth_chunks(6, seed=11).reshape(3, -1)):
        write_wav(str(tmp_path / "data" / "clean" / f"c{i}.wav"), chunk, 8000)
    saved = tmp_path / "saved"
    out = main(["--base_dataset_path", str(tmp_path / "data"), "--model", "complex_mask",
                "--pipeline", "on_device", "--noise_type", "white", "--output_path",
                str(tmp_path / "runs"), "--run_name", "v", "--epochs", "1",
                "--steps_per_epoch", "2", "--batch_size", "2", "--precision", "f32",
                "--device", "cpu", "--export_dir", str(saved), "--attn_bottleneck",
                "--s2d_stem", "--s2d_skip", "8"])
    assert out["steps"] == 2
    assert built == [{"dtype": torch.float32, "mask_bound": 2.0, "residual": True,
                      "zero_out_init": True, "attn_bottleneck": True, "s2d_stem": True,
                      "s2d_skip": 8}]
    meta = {"mask_bound": 2.0, "si_sdr_weight": 0.5, "si_sdr_clamp": 30.0, "residual": True,
            "attn_bottleneck": True, "s2d_stem": True, "s2d_skip": 8}
    for sidecar in (tmp_path / "runs" / "v" / "checkpoints" / "best_model.json",
                    saved / "mask_denoiser_white.json"):
        with open(sidecar) as f:
            assert json.load(f) == meta
    params = load_exported(str(saved / "mask_denoiser_white.ckpt"))["params"]
    assert {"bottleneck_attn", "s2d_skip_conv", "s2d_refine"} <= set(params)
    assert params["s2d_refine"]["kernel"].shape == (3, 3, 16, 2)
