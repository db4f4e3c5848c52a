"""The differentiable kernel iSTFT (``dsp.stft.istft(precision="kernel")``
under autograd, ``ops.cuda.istft_with_grad``) against ``jax.grad`` of the
JAX package's ``dsp.stft.istft``, on the CPU.

The JAX function is differentiated with respect to the real and imaginary
parts as two real arrays, so no complex-gradient convention enters. The
functional is a random linear one, ``sum(g * istft(spec))``. Tolerances:
1e-5 relative L2 against JAX (two FFT libraries), 1e-6 against autograd
through the port's own plain iSTFT; the imaginary DC and (even n_fft)
Nyquist parts, which the forward ignores, get exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_torch.dsp.stft as port_stft
from audiodenoiser_torch.dsp.window import hann_window
from audiodenoiser_torch.ops.cuda import istft_kernel, istft_with_grad, stft_kernel
from audiodenoiser_tpu.dsp import stft as jax_stft

N_FRAMES = 12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _case(n_fft, center, length, seed=0):
    """Spectrum parts, the functional's weights and the iSTFT's arguments."""
    hop = n_fft // 4
    rng = np.random.default_rng(seed)
    shape = (2, n_fft // 2 + 1, N_FRAMES)
    re, im = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    natural = (N_FRAMES - 1) * hop + n_fft - (2 * (n_fft // 2) if center else 0)
    out_len = {"none": natural, "shorter": natural - 37, "longer": natural + 41}[length]
    g = rng.standard_normal((2, out_len)).astype(np.float32)
    kw = dict(n_fft=n_fft, center=center, length=None if length == "none" else out_len)
    return re, im, g, hop, kw


def _port_grad(re, im, g, hop, kw, precision):
    spec = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).requires_grad_()
    y = port_stft.istft(spec, hop, precision=precision, **kw)
    (y * torch.from_numpy(g)).sum().backward()
    return spec.grad.real.numpy(), spec.grad.imag.numpy()


def _jax_grad(re, im, g, hop, kw):
    def f(r, i):
        return jnp.sum(jnp.asarray(g) * jax_stft.istft(r + 1j * i, hop, **kw))

    gr, gi = jax.grad(f, argnums=(0, 1))(jnp.asarray(re), jnp.asarray(im))
    return np.asarray(gr), np.asarray(gi)


@pytest.mark.parametrize("length", ["none", "shorter", "longer"])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("n_fft", [512, 2048, 255])
def test_kernel_istft_gradient_matches_jax(n_fft, center, length):
    re, im, g, hop, kw = _case(n_fft, center, length)
    ours = _port_grad(re, im, g, hop, kw, "kernel")
    ref = _jax_grad(re, im, g, hop, kw)
    for part, a, b in zip(("re", "im"), ours, ref):
        assert a.shape == b.shape == re.shape
        assert _rel(a, b) < 1e-5, part
    plain = _port_grad(re, im, g, hop, kw, "fft")
    for a, b in zip(ours, plain):
        assert _rel(a, b) < 1e-6
    # the forward ignores these parts: no gradient reaches them
    gi = ours[1]
    assert np.all(gi[:, 0] == 0)
    if n_fft % 2 == 0:
        assert np.all(gi[:, -1] == 0)
    else:  # the last bin of an odd n_fft is no Nyquist bin: it counts
        assert np.abs(gi[:, -1]).max() > 0


def test_gradient_through_strided_and_expanded_cotangents():
    """The cotangent reaching K2's backward may be strided (a slice of a
    longer output) or expanded (a mean): both give autograd's gradient
    through the plain iSTFT."""
    re, im, _, hop, kw = _case(512, True, "none", seed=3)
    spec0 = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    for reduce in (lambda y: y[:, ::3].sum(), lambda y: y.mean(), lambda y: y[1].abs().sum()):
        grads = []
        for precision in ("kernel", "fft"):
            spec = spec0.clone().requires_grad_()
            reduce(port_stft.istft(spec, hop, precision=precision, **kw)).backward()
            grads.append(spec.grad)
        assert _rel(torch.view_as_real(grads[0]), torch.view_as_real(grads[1])) < 1e-6


def test_gradient_after_an_inference_mode_call():
    """The window and envelope are cached per device: one first made under
    ``torch.inference_mode`` (a serving path) must still serve a gradient."""
    rng = np.random.default_rng(5)
    spec = torch.from_numpy(rng.standard_normal((2, 193, 7, 2)).astype(np.float32))
    spec = torch.view_as_complex(spec)  # n_fft 384: a window no other test caches
    with torch.inference_mode():
        port_stft.istft(spec, 96, n_fft=384, precision="kernel")
    leaf = spec.clone().requires_grad_()
    port_stft.istft(leaf, 96, n_fft=384, precision="kernel").square().sum().backward()
    assert torch.isfinite(leaf.grad).all() and float(leaf.grad.abs().max()) > 0


def test_function_alone_matches_kernel_forward():
    rng = np.random.default_rng(4)
    re = torch.from_numpy(rng.standard_normal((3, 257, 9)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((3, 257, 9)).astype(np.float32))
    w = torch.from_numpy(hann_window(512))
    with torch.no_grad():
        ref = istft_kernel(re, im, w, 512, 128)
    out = istft_with_grad(re.clone().requires_grad_(), im.clone().requires_grad_(), w, 512, 128)
    assert out.requires_grad
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)


def test_wrappers_refuse_an_input_that_needs_a_gradient():
    x = torch.randn(2, 2048, requires_grad=True)
    w = torch.from_numpy(hann_window(512))
    with pytest.raises(RuntimeError, match="A.8"):
        stft_kernel(x, w)
    with pytest.raises(RuntimeError, match="A.8"):
        port_stft.stft(x, precision="kernel")
    re = torch.randn(2, 257, 5, requires_grad=True)
    im = torch.randn(2, 257, 5)
    with pytest.raises(RuntimeError, match="A.8"):
        istft_kernel(re, im, w)
    with pytest.raises(RuntimeError, match="A.8"):
        istft_kernel(re.detach(), im, w.clone().requires_grad_())
    # without autograd, or on detached inputs, they run as before
    with torch.no_grad():
        assert stft_kernel(x, w).shape == (2, 257, 13)
        assert istft_kernel(re, im, w).shape == (2, 4 * 128 + 512)
        assert port_stft.istft(torch.complex(re, im), precision="kernel").shape == (2, 512)
    assert not stft_kernel(x.detach(), w).requires_grad
