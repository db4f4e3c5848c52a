"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
plain versions are held against the JAX package on the CPU in
``tests/test_torch_dsp.py``; this file closes the chain on the card. It
imports no JAX, so it runs where JAX is absent:

  python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("batch,length,n_fft,hop,win", [
    (256, 16512, 512, 128, "hann"),   # bench shape: 2 s clips, centre-padded
    (3, 25312, 512, 128, "hann"),     # 3.1 s: (L - n_fft) % hop != 0
    (2, 2048, 512, 128, "ones"),      # rectangular window
    (5, 3000, 400, 100, "hann"),      # n_fft not a power of two
    (1, 1000, 255, 64, "hann"),       # odd n_fft
])
def test_stft_kernel_matches_plain(dev, batch, length, n_fft, hop, win):
    from audiodenoiser_torch.dsp.stft import _resolve_window
    from audiodenoiser_torch.ops.cuda import stft_kernel, stft_plain

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, length)).astype(np.float32)).to(dev)
    w = torch.from_numpy(_resolve_window(win, n_fft, n_fft)).to(dev)
    before = stft_kernel.launches
    ours = stft_kernel(x, w, n_fft, hop)
    ref = stft_plain(x, w, n_fft, hop)
    torch.cuda.synchronize()
    assert stft_kernel.launches == before + 1
    assert ours.shape == ref.shape
    # fp32 direct DFT vs cuFFT: both within float rounding of the transform
    assert _max_rel(torch.view_as_real(ours), torch.view_as_real(ref)) < 1e-5


@pytest.mark.parametrize("batch,n_frames,n_fft,hop,strided", [
    (256, 126, 512, 128, True),   # bench shape, views of one complex tensor
    (3, 194, 512, 128, False),    # 3.1 s clips, separate re / im
    (2, 30, 512, 128, True),
    (4, 17, 400, 100, False),     # n_fft not a power of two
    (1, 9, 255, 64, True),        # odd n_fft: no Nyquist bin
    (2, 40, 512, 32, False),      # 15 halo frames, the most a block takes
])
def test_istft_kernel_matches_plain(dev, batch, n_frames, n_fft, hop, strided):
    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.ops.cuda import istft_kernel, istft_plain

    rng = np.random.default_rng(1)
    f = n_fft // 2 + 1
    spec = torch.from_numpy((rng.standard_normal((batch, f, n_frames))
                             + 1j * rng.standard_normal((batch, f, n_frames)))
                            .astype(np.complex64)).to(dev)
    parts = torch.view_as_real(spec)
    re, im = parts[..., 0], parts[..., 1]
    if not strided:
        re, im = re.contiguous(), im.contiguous()
    w = torch.from_numpy(hann_window(n_fft)).to(dev)
    before = istft_kernel.launches
    ours = istft_kernel(re, im, w, n_fft, hop)
    ref = istft_plain(re, im, w, n_fft, hop)
    torch.cuda.synchronize()
    assert istft_kernel.launches == before + 1
    assert ours.shape == ref.shape == (batch, (n_frames - 1) * hop + n_fft)
    assert _max_rel(ours, ref) < 1e-5


def test_kernels_reject_what_they_do_not_take(dev):
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel

    w = torch.ones(512, device=dev)
    with pytest.raises(TypeError):
        stft_kernel(torch.zeros(2, 4000, device=dev, dtype=torch.float64), w)
    with pytest.raises(ValueError):
        stft_kernel(torch.zeros(2, 4000, device=dev)[:, ::2], w)  # not contiguous
    with pytest.raises(ValueError):
        istft_kernel(torch.zeros(1, 257, 4, device=dev),
                     torch.zeros(1, 257, 4, device=dev), w, 512, 16)  # halo > 15


def test_runner_on_card_matches_cpu(dev):
    """The whole slice, fp32 on the card (kernels) against the CPU (plain)."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models import (
        UNet,
        fold_for_inference,
        random_flax_variables,
        state_dict_from_flax,
    )
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel

    sd = state_dict_from_flax(random_flax_variables(0, (8, 16, 32, 64), 128))
    rng = np.random.default_rng(2)
    audio = torch.from_numpy(
        np.clip(0.2 * rng.standard_normal((3, 6000)), -1, 1).astype(np.float32))
    outs = {}
    for d in ("cuda", "cpu"):
        model = UNet((8, 16, 32, 64), 128)
        model.load_state_dict(sd)
        runner = DenoiserRunner(fold_for_inference(model.eval(), torch.float32),
                                device=d)
        launched = (stft_kernel.launches, istft_kernel.launches)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            outs[d] = runner.denoise_audio(audio).cpu()
        if d == "cuda":
            assert stft_kernel.launches == launched[0] + 1
            assert istft_kernel.launches == launched[1] + 1
    rel = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    assert rel < 1e-4, rel


DECONV_SHAPES = [
    (16, 1024, 16, 4, 512),    # training step, batch 16, crop (256, 64)
    (16, 128, 128, 32, 64),
    (256, 1024, 16, 7, 512),   # bench eval shape: odd W
    (9, 128, 16, 4, 64),       # batch not a multiple of any tile
    (1, 16, 4, 63, 8),         # wide odd W, batch 1, narrow channels
    (2, 20, 3, 5, 6),          # Cin and 4*Cout not multiples of 8
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,cin,h,w,cout", DECONV_SHAPES)
def test_deconv_kernel_matches_plain(dev, dtype, b, cin, h, w, cout):
    from audiodenoiser_torch.ops.cuda import conv_transpose_2x2_plain, deconv_kernel

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32)).to(dev)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy((rng.standard_normal((cin, cout, 2, 2))
                           / np.sqrt(cin)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    before = deconv_kernel.launches
    ours = deconv_kernel(x, wt, bias)
    # the plain version in fp32 from the same (bf16-rounded) inputs
    ref = conv_transpose_2x2_plain(x.float(), wt.to(dtype).float(), bias)
    torch.cuda.synchronize()
    assert deconv_kernel.launches == before + 1
    assert ours.shape == (b, cout, 2 * h, 2 * w) and ours.dtype == dtype
    assert ours.is_contiguous(memory_format=torch.channels_last)
    # fp32: FMA order only; bf16: one rounding of the output
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _max_rel(ours.float(), ref) <= tol


def test_deconv_backward_matches_autograd_of_plain(dev):
    from audiodenoiser_torch.ops.cuda import conv_transpose_2x2, conv_transpose_2x2_plain

    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((3, 64, 8, 5)).astype(np.float32)).to(dev)
    w0 = torch.from_numpy(rng.standard_normal((64, 32, 2, 2)).astype(np.float32) * 0.1).to(dev)
    b0 = torch.from_numpy(rng.standard_normal(32).astype(np.float32)).to(dev)
    grads = []
    for fn in (conv_transpose_2x2, conv_transpose_2x2_plain):
        x = x0.clone().contiguous(memory_format=torch.channels_last).requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            torch.sin(fn(x, w, b)).sum().backward()
        grads.append((x.grad, w.grad, b.grad))
    for a, r in zip(*grads):
        assert ((a - r).norm() / r.norm()).item() < 1e-4


def test_deconv_kernel_rejects_what_it_does_not_take(dev):
    from audiodenoiser_torch.ops.cuda import deconv_kernel

    w, b = torch.zeros(8, 4, 2, 2, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        deconv_kernel(torch.zeros(2, 8, 4, 4, device=dev), w, b)
    with pytest.raises(TypeError):
        deconv_kernel(torch.zeros(2, 8, 4, 4, device=dev, dtype=torch.float16)
                      .contiguous(memory_format=torch.channels_last), w, b)


@pytest.mark.parametrize("batch,n_frames,n_fft,hop", [
    (256, 126, 512, 128),   # bench shape
    (3, 41, 512, 100),      # hop that does not divide n_fft
    (10, 20, 512, 512),     # no overlap
    (2, 7, 64, 100),        # hop past n_fft: gaps of zeros
])
def test_overlap_add_kernel_matches_plain(dev, batch, n_frames, n_fft, hop):
    from audiodenoiser_torch.ops.cuda import overlap_add_kernel, overlap_add_plain

    rng = np.random.default_rng(5)
    frames = torch.from_numpy(
        rng.standard_normal((batch, n_frames, n_fft)).astype(np.float32)).to(dev)
    before = overlap_add_kernel.launches
    ours = overlap_add_kernel(frames, hop)
    ref = overlap_add_plain(frames, hop)
    torch.cuda.synchronize()
    assert overlap_add_kernel.launches == before + 1
    assert ours.shape == ref.shape == (batch, (n_frames - 1) * hop + n_fft)
    assert _max_rel(ours, ref) < 1e-6


def test_overlap_add_kernel_rejects_what_it_does_not_take(dev):
    from audiodenoiser_torch.ops.cuda import overlap_add_kernel

    with pytest.raises(TypeError):
        overlap_add_kernel(torch.zeros(2, 4, 512, device=dev, dtype=torch.bfloat16), 128)
    with pytest.raises(ValueError):
        overlap_add_kernel(torch.zeros(2, 8, 512, device=dev)[:, ::2], 128)
    with pytest.raises(ValueError):
        overlap_add_kernel(torch.zeros(4, 512, device=dev), 128)


def test_mask_runner_on_card_matches_cpu(dev):
    """The complex-mask slice, fp32 on the card (kernels) against the CPU."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        fold_for_inference,
        load_flax_variables,
        random_flax_variables,
    )

    v = random_flax_variables(0, (8, 16, 32, 64), 128, in_channels=3, out_channels=2)
    rng = np.random.default_rng(6)
    audio = torch.from_numpy(
        np.clip(0.2 * rng.standard_normal((2, 5000)), -1, 1).astype(np.float32))
    outs = {}
    for d in ("cuda", "cpu"):
        model = load_flax_variables(ComplexMaskUNet(residual=True, features=(8, 16, 32, 64),
                                                    bottleneck=128), v)
        runner = DenoiserRunner(fold_for_inference(model.eval(), torch.float32), device=d)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            outs[d] = runner.denoise_audio(audio).cpu()
    rel = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    assert rel < 1e-4, rel
