"""Port parity of K3's plain version and its autograd Function against the
JAX package's ``conv_transpose_2x2`` (Pallas, interpret mode) on the CPU.

The JAX kernel takes the Flax ConvTranspose kernel (2, 2, Cin, Cout); the
port takes the torch weight that ``state_dict_from_flax`` makes of it
(flip undone, (Cin, Cout, 2, 2)). Same inputs, made with numpy, on both
sides: forwards at atol 1e-5 (fp32), gradients of x, W and b at 1e-4.
On the CPU ``deconv_kernel`` takes the plain version; the CUDA kernel is
held against that plain version on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_tpu.ops.pallas import conv_transpose_2x2 as jax_deconv
from audiodenoiser_torch.models.convert import _deconv
from audiodenoiser_torch.ops.cuda import (
    conv_transpose_2x2,
    conv_transpose_2x2_plain,
    deconv_kernel,
)

SHAPES = [
    (3, 16, 4, 64, 32),   # bottleneck-like: tall channels, tiny W
    (2, 8, 7, 32, 16),    # odd W (the 257x126 eval shapes)
    (1, 4, 63, 16, 8),    # wide odd W, batch 1
    (9, 16, 4, 128, 64),  # batch not a multiple of the JAX tile
]


def _inputs(shape, seed=7):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    k = (rng.standard_normal((2, 2, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, k, bias


def _port(x, k, bias):
    """NHWC numpy + Flax kernel -> the port's channels_last x, torch weight, bias."""
    sd = {}
    _deconv({"kernel": k, "bias": bias}, sd, "up")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)  # a channels_last view
    return xt, sd["up.weight"], sd["up.bias"]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel(shape):
    x, k, bias = _inputs(shape)
    ref = np.asarray(jax_deconv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), True))
    xt, wt, bt = _port(x, k, bias)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    ours = conv_transpose_2x2_plain(xt, wt, bt)
    b, h, w, _, cout = shape
    assert ours.shape == (b, cout, 2 * h, 2 * w)
    assert ours.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(ours.permute(0, 2, 3, 1).numpy(), ref, atol=1e-5)
    # on the CPU the wrapper is the plain version and counts no launch
    before = deconv_kernel.launches
    torch.testing.assert_close(deconv_kernel(xt, wt, bt), ours, rtol=0, atol=0)
    assert deconv_kernel.launches == before


@pytest.mark.parametrize("shape", [(2, 8, 4, 16, 8), (1, 4, 7, 32, 16)])
def test_gradients_match_jax_custom_vjp(shape):
    x, k, bias = _inputs(shape, seed=8)

    def f_jax(x, k, b):
        return jnp.sum(jnp.sin(jax_deconv(x, k, b, True)))

    gx, gk, gb = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                                    jnp.asarray(bias))
    xt, wt, bt = _port(x, k, bias)
    xt, wt, bt = (t.clone().requires_grad_() for t in (xt, wt, bt))
    torch.sin(conv_transpose_2x2(xt, wt, bt)).sum().backward()
    _, g_w, g_b = _port(x, np.asarray(gk), np.asarray(gb))  # same flip as the weight
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), g_w.numpy(), atol=1e-4)
    np.testing.assert_allclose(bt.grad.numpy(), g_b.numpy(), atol=1e-4)


def test_function_matches_autograd_of_plain_and_torch():
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy(rng.standard_normal((2, 12, 5, 3)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((12, 6, 2, 2)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    grads = []
    for fn in (conv_transpose_2x2, conv_transpose_2x2_plain,
               lambda x, w, b: torch.nn.functional.conv_transpose2d(x, w, b, stride=2)):
        x, w, b = (t.clone().requires_grad_() for t in (x0, w0, b0))
        torch.sin(fn(x, w, b)).square().sum().backward()
        grads.append([t.grad for t in (x, w, b)])
    for other in grads[1:]:
        for a, r in zip(grads[0], other):
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_needs_input_grad_is_honoured():
    x = torch.randn(1, 4, 3, 3, requires_grad=True)
    w, b = torch.randn(4, 2, 2, 2), torch.randn(2, requires_grad=True)
    conv_transpose_2x2(x, w, b).sum().backward()
    assert x.grad is not None and b.grad is not None and w.grad is None


def test_bf16_rounds_once_after_the_fp32_bias():
    """bf16 in: fp32 products and bias, one rounding (B3's order); the JAX
    module's XLA fallback for Cout < 128 rounds first and adds a bf16 bias,
    which differs by bf16 rounding only."""
    x, k, bias = _inputs((2, 4, 5, 16, 8), seed=10)
    xt, wt, bt = _port(x, k, bias)
    xb = xt.to(torch.bfloat16)
    ours = conv_transpose_2x2_plain(xb, wt, bt)
    assert ours.dtype == torch.bfloat16
    exact = conv_transpose_2x2_plain(xb.float(), wt.to(torch.bfloat16).float(), bt)
    torch.testing.assert_close(ours, exact.to(torch.bfloat16), rtol=0, atol=0)
    ref = jax_deconv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(bias), True)
    np.testing.assert_allclose(ours.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("bad", ["kernel", "dtype", "channels"])
def test_rejects_what_it_does_not_take(bad):
    x, w, b = torch.zeros(1, 4, 3, 3), torch.zeros(4, 2, 2, 2), torch.zeros(2)
    if bad == "kernel":
        with pytest.raises(ValueError):
            deconv_kernel(x, torch.zeros(4, 2, 3, 3), b)
    elif bad == "dtype":
        with pytest.raises(TypeError):
            deconv_kernel(x.half(), w, b)
    else:
        with pytest.raises(ValueError):
            deconv_kernel(torch.zeros(1, 5, 3, 3), w, b)


def test_meta_device_raises():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        deconv_kernel(torch.zeros(1, 4, 3, 3, device=meta), torch.zeros(4, 2, 2, 2, device=meta),
                      torch.zeros(2, device=meta))


def test_build_lists_the_source():
    """K3 is built like K1/K2: its own plain-C source in csrc/, one nvcc."""
    from audiodenoiser_torch.ops.cuda import build

    assert {"stft_kernel", "istft_kernel", "deconv_kernel"} <= set(build.sources())
    src = (build.CSRC_DIR / "deconv_kernel.cu").read_text()
    assert 'extern "C" int deconv2x2_launch' in src and "torch/extension.h" not in src


def test_build_hashes_the_shared_headers(tmp_path):
    """Editing a csrc/*.cuh header changes every library's target name, so
    both the header's users and the rest build anew; editing one source
    changes only its own."""
    import shutil

    from audiodenoiser_torch.ops.cuda import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    names = build.sources()
    assert "fft.cuh" in {p.name for p in csrc.glob("*.cuh")}
    before = {n: build._target(n, csrc, tmp_path) for n in names}
    assert before == {n: build._target(n, csrc, tmp_path) for n in names}  # deterministic
    (csrc / "fft.cuh").write_text((csrc / "fft.cuh").read_text() + "\n// edited\n")
    after = {n: build._target(n, csrc, tmp_path) for n in names}
    assert all(after[n] != before[n] for n in names)
    (csrc / "deconv_kernel.cu").write_text((csrc / "deconv_kernel.cu").read_text() + "\n")
    again = {n: build._target(n, csrc, tmp_path) for n in names}
    assert [n for n in names if again[n] != after[n]] == ["deconv_kernel"]


UNET_SHAPES = [  # (Cin, Cout) of the four upsamplings
    (1024, 512), (512, 256), (256, 128), (128, 64)]


@pytest.mark.parametrize("cin,cout", UNET_SHAPES)
def test_dispatch_takes_wgmma_at_every_unet_layer(cin, cout):
    from audiodenoiser_torch.ops.cuda.deconv import deconv_variant

    assert deconv_variant(torch.bfloat16, cin, cout) == "wgmma"
    assert deconv_variant(torch.float32, cin, cout) == "fma"


@pytest.mark.parametrize("cin,cout,x_ptr", [(20, 6, 0), (16, 6, 0), (20, 8, 0), (64, 32, 8)])
def test_dispatch_takes_wmma_where_tma_cannot_address_rows(cin, cout, x_ptr):
    """Cin or Cout not a multiple of 8, or x not 16-byte aligned."""
    from audiodenoiser_torch.ops.cuda.deconv import deconv_variant

    assert deconv_variant(torch.bfloat16, cin, cout, x_ptr) == "wmma"
    assert deconv_variant(torch.float32, cin, cout, x_ptr) == "fma"


@pytest.mark.parametrize("k_major", [True, False])
def test_packed_weight_holds_the_plain_taps(k_major):
    from audiodenoiser_torch.ops.cuda.deconv import packed_weight

    rng = np.random.default_rng(11)
    wt = torch.from_numpy(rng.standard_normal((24, 16, 2, 2)).astype(np.float32))
    packed = packed_weight(wt, torch.bfloat16, k_major)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    taps = wt.to(torch.bfloat16)
    for di in (0, 1):
        for dj in (0, 1):
            rows = slice((di * 2 + dj) * 16, (di * 2 + dj + 1) * 16)
            tap = taps[:, :, di, dj]  # (Cin, Cout)
            got = packed[rows, :].t() if k_major else packed[:, rows]
            torch.testing.assert_close(got, tap, rtol=0, atol=0)
    assert packed.shape == ((64, 24) if k_major else (24, 64))


def test_packed_weight_is_cached_until_an_optimizer_step():
    from audiodenoiser_torch.ops.cuda.deconv import bias_f32, packed_weight

    layer = torch.nn.ConvTranspose2d(16, 8, 2, stride=2)
    packed = packed_weight(layer.weight, torch.bfloat16, True)
    b32 = bias_f32(layer.bias)
    assert packed_weight(layer.weight, torch.bfloat16, True) is packed
    assert bias_f32(layer.bias) is b32
    # another dtype or layout is its own entry
    assert packed_weight(layer.weight, torch.float32, False).dtype == torch.float32
    assert packed_weight(layer.weight, torch.bfloat16, True) is packed
    # foreach: the multi-tensor update torch takes by default on the card
    opt = torch.optim.AdamW(layer.parameters(), lr=0.1, foreach=True)
    layer(torch.randn(2, 16, 3, 3)).square().sum().backward()
    opt.step()
    again = packed_weight(layer.weight, torch.bfloat16, True)
    assert again is not packed and not torch.equal(again, packed)
    torch.testing.assert_close(
        again, layer.weight.detach().permute(2, 3, 1, 0).reshape(32, 16).to(torch.bfloat16),
        rtol=0, atol=0)
    assert bias_f32(layer.bias) is not b32
    torch.testing.assert_close(bias_f32(layer.bias), layer.bias.detach(), rtol=0, atol=0)
    assert packed_weight(layer.weight, torch.bfloat16, True) is again


def test_inference_tensors_are_packed_each_call():
    from audiodenoiser_torch.ops.cuda.deconv import packed_weight

    with torch.inference_mode():
        wt = torch.randn(8, 8, 2, 2)
        first = packed_weight(wt, torch.bfloat16, True)
        assert packed_weight(wt, torch.bfloat16, True) is not first
