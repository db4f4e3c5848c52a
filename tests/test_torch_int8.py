"""The port's int8 compute (``models.int8``: ``prepare_int8``,
``Int8UNet``) against the JAX package's ``models/int8.py`` on the CPU, and
JAX ``tests/test_int8.py``'s gates repeated on the port.

- ``prepare_int8``'s int8 kernels equal JAX's element for element, every
  layer (the deconvolutions through ``models.convert``'s flip), apart from
  counted rounding ties at .5; the per-channel scales and the folded
  biases within 1 ulp (XLA fuses the fold's arithmetic differently).
- The forward within 1e-3 relative L2 of JAX's jitted ``Int8UNet`` on
  the same input and weights. The int32 products are exact on both sides,
  so only an activation's rounding that flips in ``x / s`` can part them:
  the port divides by 127 as written, and op by op JAX's forward equals
  it bit for bit, while under ``jax.jit`` XLA computes the scale as
  ``max|x| * (1/127)``, up to an ulp off the division (1.5e-4 apart at
  one of four seeds tried, 2.2e-7 at most at the others). JAX's forward
  is jitted to keep the file fast.
- JAX's gates: within 0.1 relative L2 of the fp32 forward, the combined
  loss within 5% of the fp32 one on a tiny net trained 20 steps, the
  output dtype follows the input, train mode refused, a run through
  ``DenoiserRunner`` in ``noisy_phase`` mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval.runner import DenoiserRunner
from audiodenoiser_torch.losses import combined_perceptual_loss
from audiodenoiser_torch.models import (
    Int8UNet,
    UNet,
    prepare_int8,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.int8 import _int_mm, quant_act
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_tpu.models import Int8UNet as JaxInt8UNet
from audiodenoiser_tpu.models import prepare_int8 as jax_prepare_int8

TINY = dict(features=(8, 16), bottleneck=32)
NARROW = dict(features=(8, 16, 24, 32), bottleneck=48)
WIDTHS = {2: TINY, 4: NARROW}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


@functools.lru_cache(maxsize=None)
def _pair(levels):
    """The port's and JAX's int8 preparation of one seeded tree, JAX's op by
    op (under ``jax.jit`` XLA fuses the fold's arithmetic, and a folded
    bias moves by up to 2 ulps)."""
    widths = WIDTHS[levels]
    v = random_flax_variables(1, **widths)
    model = UNet(**widths)
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    q = jax_prepare_int8(v["params"], v["batch_stats"], features=widths["features"])
    return prepare_int8(model.eval()), q, v


def _port_kernel(layer) -> np.ndarray:
    """A port layer's int8 matrix back in JAX's HWIO (deconv: flipped, as
    ``models.convert`` maps a Flax ConvTranspose kernel)."""
    w = layer.weight.numpy()
    if layer.kind == "deconv":
        k = w[: 4 * layer.cout, : layer.cin].reshape(2, 2, layer.cout, layer.cin)
        return k.transpose(0, 1, 3, 2)[::-1, ::-1]
    kh = 3 if layer.kind == "conv3" else 1
    k = w[: layer.cout, : kh * kh * layer.cin].reshape(layer.cout, kh, kh, layer.cin)
    return k.transpose(1, 2, 3, 0)


def _jax_layers(q, v, n):
    """(port layer name, JAX's quantized layer, JAX's float32 kernel before
    quantization) of every layer."""
    from audiodenoiser_tpu.models.int8 import _fold_conv_bn

    p, s = v["params"], v["batch_stats"]
    fold = jax.jit(_fold_conv_bn)

    def folded(block, j):
        return np.asarray(fold(p[block][f"conv{j}"], p[block][f"bn{j}"], s[block][f"bn{j}"])[0])

    for i in range(n):
        for j in range(2):
            yield f"down{i}_conv{j}", q[f"down{i}"][f"conv{j}"], folded(f"down{i}", j)
            yield f"up{i}_conv_conv{j}", q[f"up{i}_conv"][f"conv{j}"], folded(f"up{i}_conv", j)
        yield f"up{i}_deconv", q[f"up{i}_deconv"], p[f"up{i}_deconv"]["kernel"]
    for j in range(2):
        yield f"bottleneck_conv{j}", q["bottleneck"][f"conv{j}"], folded("bottleneck", j)
    yield "out", q["out"], p["out"]["kernel"]


class TestPrepare:
    @pytest.mark.parametrize("levels", [2, 4], ids=["two_levels", "four_levels"])
    def test_kernels_and_scales_match_jax(self, levels):
        ours, q, v = _pair(levels)
        ties = mismatches = 0
        for name, ref, kernel32 in _jax_layers(q, v, levels):
            layer = ours.layers[name]
            kernel = np.asarray(ref["kernel"])
            got = _port_kernel(layer)
            assert got.shape == kernel.shape, name
            n = layer.cout
            scale = layer.scale.numpy()[:n]
            jscale = np.asarray(ref["scale"])
            assert np.all(np.abs(scale - jscale) <= np.spacing(jscale)), name
            jbias = np.asarray(ref["bias"])
            assert np.all(np.abs(layer.bias.numpy()[:n] - jbias) <= np.spacing(np.abs(jbias))), name
            # k / scale within a few ulps of a .5 tie: either rounding is right
            ratio = np.abs(np.asarray(kernel32, np.float32) / jscale)
            tie = np.abs(ratio - np.floor(ratio) - 0.5) <= 4 * np.spacing(ratio)
            diff = got != kernel
            assert np.all(tie[diff]), name
            assert np.all(np.abs(got[diff].astype(int) - kernel[diff].astype(int)) == 1), name
            ties += int(tie.sum())
            mismatches += int(diff.sum())
        print(f"int8 kernels: {mismatches} of {ties} elements at a rounding tie differ")

    def test_variants_are_refused(self):
        with pytest.raises(NotImplementedError, match="plain magnitude U-Net"):
            prepare_int8(UNet(**TINY, s2d_stem=True))


class TestForward:
    @pytest.mark.parametrize("levels,shape", [(2, (2, 64, 32)), (4, (1, 65, 40))],
                             ids=["crop", "odd_four_levels"])
    def test_matches_jax(self, levels, shape):
        ours, q, _ = _pair(levels)
        x = np.abs(np.random.default_rng(3).standard_normal((*shape, 1))).astype(np.float32)
        ref = np.asarray(jax.jit(JaxInt8UNet(features=WIDTHS[levels]["features"]).apply)(
            q, jnp.asarray(x)))
        got = _nhwc(ours(_nchw(x)))
        assert got.shape == ref.shape and _rel(got, ref) < 1e-3

    def test_quantization_and_products_are_exact(self):
        """The activation quantizer is JAX's formula; ``_int_mm`` with the
        padded row count and K/N multiples of 8 is an exact int32 product."""
        rng = np.random.default_rng(4)
        x = torch.from_numpy(rng.standard_normal((3, 5, 7, 8)).astype(np.float32))
        xq, s = quant_act(x)
        assert float(s) == float(np.float32(float(x.abs().max())) / np.float32(127.0))
        assert int(xq.abs().max()) == 127 and xq.dtype == torch.int8
        a = torch.from_numpy(rng.integers(-127, 128, (9, 16)).astype(np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (8, 16)).astype(np.int8))
        assert torch.equal(_int_mm(a, w), a.int() @ w.int().t())


@pytest.fixture(scope="module")
def trained_tiny():
    """JAX ``tests/test_int8.py``'s fixture on the port: the tiny U-Net fit
    20 steps on |N(0, 1)| inputs with clean = 0.8 x noisy."""
    state = port_loop.create_train_state(0, UNet(**TINY), device="cpu")
    rng = np.random.default_rng(0)
    noisy = torch.from_numpy(np.abs(rng.standard_normal((4, 1, 32, 32))).astype(np.float32))
    clean = noisy * 0.8
    for _ in range(20):
        state, _ = port_loop.train_step(state, noisy, clean)
    return state.model.eval(), noisy, clean


class TestGates:
    def test_close_to_f32_forward(self, trained_tiny):
        model, noisy, _ = trained_tiny
        with torch.no_grad():
            f32 = model(noisy)
        i8 = prepare_int8(model)(noisy)
        assert _rel(i8.numpy(), f32.numpy()) < 0.1

    def test_eval_metric_delta_small(self, trained_tiny):
        """The combined perceptual loss against clean moves by under 5%
        when the int8 forward replaces the fp32 one."""
        model, noisy, clean = trained_tiny
        with torch.no_grad():
            loss_f = float(combined_perceptual_loss(model(noisy), clean).total)
        loss_q = float(combined_perceptual_loss(prepare_int8(model)(noisy), clean).total)
        assert abs(loss_q - loss_f) / max(abs(loss_f), 1e-9) < 0.05, (loss_q, loss_f)

    def test_output_dtype_follows_input(self, trained_tiny):
        model, noisy, _ = trained_tiny
        assert prepare_int8(model)(noisy.to(torch.bfloat16)).dtype == torch.bfloat16

    def test_train_mode_rejected(self, trained_tiny):
        model, noisy, _ = trained_tiny
        q8 = prepare_int8(model)
        assert isinstance(q8, Int8UNet) and not q8.training
        with pytest.raises(ValueError, match="inference-only"):
            q8.train()(noisy)

    def test_runs_through_denoiser_runner(self, trained_tiny):
        model, _, _ = trained_tiny
        runner = DenoiserRunner(prepare_int8(model), device="cpu")
        assert runner.mode == "noisy_phase"
        audio = torch.from_numpy(
            0.1 * np.random.default_rng(0).standard_normal((2, 4096)).astype(np.float32))
        out = runner.denoise_audio(audio)
        assert out.shape == audio.shape and bool(torch.isfinite(out).all())
