"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
plain versions are held against the JAX package on the CPU in
``tests/test_torch_dsp.py``; this file closes the chain on the card. It
imports no JAX, so it runs where JAX is absent:

  python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import contextlib

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
    (1, 16512, 512, 128, "hann"),     # a 2 s stream window: B=1, T=126
    (8, 16512, 512, 128, "hann"),     # a tick of a pool of 8 streams
    (64, 16512, 512, 128, "hann"),    # a tick of a pool of 64
    (2, 2048, 512, 128, "ones"),      # rectangular window
    (4, 5000, 1024, 256, "hann"),     # another power of two
    (7, 9001, 256, 100, "hann"),      # odd log2(n_fft / 2): a radix-2 stage
    (5, 3000, 400, 100, "hann"),      # n_fft not a power of two
    (1, 1000, 255, 64, "hann"),       # odd n_fft
])
def test_stft_kernel_matches_plain(dev, batch, length, n_fft, hop, win):
    from audiodenoiser_torch.dsp.stft import _resolve_window
    from audiodenoiser_torch.ops.cuda import stft_kernel, stft_plain, variant_launches
    from audiodenoiser_torch.ops.cuda.stft import stft_entry

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((batch, length)).astype(np.float32)).to(dev)
    w = torch.from_numpy(_resolve_window(win, n_fft, n_fft)).to(dev)
    before = stft_kernel.launches, variant_launches(stft_kernel)
    ours = stft_kernel(x, w, n_fft, hop)
    ref = stft_plain(x, w, n_fft, hop)
    torch.cuda.synchronize()
    assert stft_kernel.launches == before[0] + 1
    entry = "fft" if n_fft & (n_fft - 1) == 0 else "direct"
    assert stft_entry(n_fft) == entry
    assert {k: v - before[1][k] for k, v in variant_launches(stft_kernel).items()} == {
        "fft": int(entry == "fft"), "direct": int(entry == "direct")}
    assert ours.shape == ref.shape
    # fp32 FFT or direct DFT vs cuFFT: both within float rounding of the transform
    assert _max_rel(torch.view_as_real(ours), torch.view_as_real(ref)) < 1e-5


@pytest.mark.parametrize("batch,n_frames,n_fft,hop,strided,edges", [
    (256, 126, 512, 128, True, False),  # bench shape, views of one complex tensor: 16 frames a block
    (3, 194, 512, 128, False, False),   # 3.1 s clips, separate re / im: 8 frames a block
    (2, 30, 512, 128, True, False),
    (4, 17, 400, 100, False, False),    # n_fft not a power of two: the direct entry
    (1, 9, 255, 64, True, False),       # odd n_fft: no Nyquist bin
    (2, 40, 512, 32, False, False),     # 15 halo frames, the most a block takes
    (1, 126, 512, 128, True, False),    # a 2 s stream window
    (8, 126, 512, 128, True, False),    # a tick of a pool of 8 streams
    (64, 126, 512, 128, True, False),   # a tick of a pool of 64
    (64, 100, 512, 128, False, False),  # T not a multiple of a block's 13 own frames
    (256, 126, 512, 128, True, True),   # large imaginary DC and Nyquist parts, ignored
    (16, 126, 512, 128, True, True),    # 8 frames a block
    (4, 126, 512, 128, False, True),    # separate re / im
    (3, 20, 1024, 256, True, False),    # odd log2(n_fft / 2): a radix-2 stage
    (5, 33, 256, 100, False, True),     # a radix-8 stage, hop not dividing n_fft
    (2, 12, 4096, 1024, True, False),   # a radix-8 stage; 4 frames a block fit shared memory
    (128, 40, 2048, 512, True, False),  # 16 frames would not fit shared memory: 8 a block
])
def test_istft_kernel_matches_plain(dev, batch, n_frames, n_fft, hop, strided, edges):
    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.ops.cuda import istft_kernel, istft_plain, variant_launches
    from audiodenoiser_torch.ops.cuda.istft import istft_entry

    rng = np.random.default_rng(1)
    f = n_fft // 2 + 1
    spec = (rng.standard_normal((batch, f, n_frames))
            + 1j * rng.standard_normal((batch, f, n_frames)))
    if edges:  # irfft and the Pallas bases ignore these; a kernel that used them would not
        spec[:, 0].imag = 50 * rng.standard_normal((batch, n_frames))
        spec[:, -1].imag = 50 * rng.standard_normal((batch, n_frames))
    spec = torch.from_numpy(spec.astype(np.complex64)).to(dev)
    parts = torch.view_as_real(spec)
    re, im = parts[..., 0], parts[..., 1]
    if not strided:
        re, im = re.contiguous(), im.contiguous()
    w = torch.from_numpy(hann_window(n_fft)).to(dev)
    before = istft_kernel.launches, variant_launches(istft_kernel)
    ours = istft_kernel(re, im, w, n_fft, hop)
    ref = istft_plain(re, im, w, n_fft, hop)
    torch.cuda.synchronize()
    assert istft_kernel.launches == before[0] + 1
    entry = "fft" if n_fft & (n_fft - 1) == 0 else "direct"
    assert istft_entry(n_fft) == entry
    assert {k: v - before[1][k] for k, v in variant_launches(istft_kernel).items()} == {
        "fft": int(entry == "fft"), "direct": int(entry == "direct")}
    assert ours.shape == ref.shape == (batch, (n_frames - 1) * hop + n_fft)
    assert _max_rel(ours, ref) < 1e-5


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (2048, 512), (255, 64)])
def test_istft_plain_ignores_imaginary_dc_and_nyquist(dev, n_fft, hop):
    """cuFFT's C2R takes its input as Hermitian and used these parts at
    n_fft 2048; the plain version drops them, as irfft on the CPU does."""
    from audiodenoiser_torch.dsp.window import hann_window
    from audiodenoiser_torch.ops.cuda import istft_plain

    rng = np.random.default_rng(3)
    f = n_fft // 2 + 1
    re = torch.from_numpy(rng.standard_normal((3, f, 20)).astype(np.float32)).to(dev)
    im = torch.from_numpy(rng.standard_normal((3, f, 20)).astype(np.float32)).to(dev)
    im_zeroed = im.clone()
    im_zeroed[:, 0] = 0
    im[:, 0] += 50
    if n_fft % 2 == 0:  # an odd n_fft has no Nyquist bin: its last bin counts
        im_zeroed[:, -1] = 0
        im[:, -1] -= 50
    w = torch.from_numpy(hann_window(n_fft)).to(dev)
    ours = istft_plain(re, im, w, n_fft, hop)
    ref = istft_plain(re, im_zeroed, w, n_fft, hop)
    assert _max_rel(ours, ref) < 1e-6
    cpu = istft_plain(re.cpu(), im.cpu(), w.cpu(), n_fft, hop)
    assert _max_rel(ours.cpu(), cpu) < 1e-5


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
    (16, 1024, 16, 4, 512),    # the four upsamplings of a training step, batch 16,
    (16, 512, 32, 8, 256),     # crop (256, 64)
    (16, 256, 64, 16, 128),
    (16, 128, 128, 32, 64),
    (256, 1024, 16, 7, 512),   # the four of a bench batch: odd W
    (256, 512, 32, 15, 256),
    (256, 256, 64, 31, 128),
    (256, 128, 128, 63, 64),
    (9, 128, 16, 4, 64),       # batch not a multiple of any tile
    (1, 16, 4, 63, 8),         # wide odd W, batch 1, narrow channels
    (2, 20, 3, 5, 6),          # Cin and 4*Cout not multiples of 8
    (16, 256, 16, 7, 128),     # the width-0.25 student's four upsamplings in a
    (16, 128, 32, 15, 64),     # mask step, batch 16 of 2 s clips
    (16, 64, 64, 31, 32),
    (16, 32, 128, 63, 16),
    (16, 1024, 8, 3, 512),     # the s2d pyramid's four upsamplings in a mask
    (16, 512, 16, 7, 256),     # step, batch 16 of 2 s clips (129 x 63 after
    (16, 256, 32, 15, 128),    # the stem)
    (16, 128, 64, 31, 64),
    (16, 1024, 8, 2, 512),     # ... and in a crop step, batch 16 of 256 x 64
    (16, 512, 16, 4, 256),     # crops (128 x 32 after the stem; M down to 256)
    (16, 256, 32, 8, 128),
    (16, 128, 64, 16, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,cin,h,w,cout", DECONV_SHAPES)
def test_deconv_kernel_matches_plain(dev, dtype, b, cin, h, w, cout):
    from audiodenoiser_torch.ops.cuda import (
        conv_transpose_2x2_plain,
        deconv_kernel,
        variant_launches,
    )

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32)).to(dev)
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    wt = torch.from_numpy((rng.standard_normal((cin, cout, 2, 2))
                           / np.sqrt(cin)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)).to(dev)
    before = deconv_kernel.launches, variant_launches(deconv_kernel)
    ours = deconv_kernel(x, wt, bias)
    # the plain version in fp32 from the same (bf16-rounded) inputs
    ref = conv_transpose_2x2_plain(x.float(), wt.to(dtype).float(), bias)
    torch.cuda.synchronize()
    assert deconv_kernel.launches == before[0] + 1
    # TMA + wgmma wherever Cin and Cout are multiples of 8 (every U-Net layer)
    variant = ("fma" if dtype == torch.float32
               else "wgmma" if cin % 8 == 0 and cout % 8 == 0 else "wmma")
    rose = {k: v - before[1][k] for k, v in variant_launches(deconv_kernel).items()}
    assert rose == {v: int(v == variant) for v in ("wgmma", "wmma", "fma")}
    assert ours.shape == (b, cout, 2 * h, 2 * w) and ours.dtype == dtype
    assert ours.is_contiguous(memory_format=torch.channels_last)
    # fp32: FMA order only; bf16: one rounding of the output
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _max_rel(ours.float(), ref) <= tol


BATCH_CONV_SHAPES = [  # the 18 ReLU'd convs of a folded U-Net forward on 256 x 2 s
    (256, 1, 64, 257, 126), (256, 64, 64, 257, 126),        # down0
    (256, 64, 128, 128, 63), (256, 128, 128, 128, 63),      # down1
    (256, 128, 256, 64, 31), (256, 256, 256, 64, 31),       # down2
    (256, 256, 512, 32, 15), (256, 512, 512, 32, 15),       # down3
    (256, 512, 1024, 16, 7), (256, 1024, 1024, 16, 7),      # bottleneck
    (256, 1024, 512, 32, 15), (256, 512, 512, 32, 15),      # up0, after the concat
    (256, 512, 256, 64, 31), (256, 256, 256, 64, 31),       # up1
    (256, 256, 128, 128, 63), (256, 128, 128, 128, 63),     # up2
    (256, 128, 64, 257, 126), (256, 64, 64, 257, 126),      # up3
]


@pytest.mark.parametrize("b,cin,cout,h,w", BATCH_CONV_SHAPES)
def test_fused_conv_matches_conv_bias_relu(dev, b, cin, cout, h, w):
    """A ReLU'd folded conv in bf16 on the card (cuDNN's fused conv + bias
    + ReLU) at each of the 18 shapes of a 256-clip batch, against the
    fp32 sum ``r`` of the same bf16 inputs (TF32 off) and against today's
    conv, bias add and ReLU. The fused output is one bf16 rounding of
    ``r`` (at most 2^-8 of |r|), allowed twice that for the fp32 sums in
    another order; the plain path rounds the conv output (2^-8 of
    |r - bias|) and again the sum, so the two lie within 2^-8 (3|r| +
    |bias|), allowed 2^-6 (|r| + |bias|). The absolute floor, 2^-16 of the
    largest |r|, is for sums that cancel to near zero. The fused output
    takes the plain one's layout (NCHW for the 1-channel stem, whose input
    and kernel cuDNN cannot tell from channels-last). The output's block is
    first filled with NaN, in a pool of its own so that the output gets
    that block: the fused op passes its own output as the epilogue's
    unused addend (scaled by 0), which must not be read."""
    import torch.nn.functional as F

    from audiodenoiser_torch.models.folded import _Conv

    g = torch.Generator(device=dev).manual_seed(cin * 4096 + cout + h)
    x = (torch.randn(b, cin, h, w, device=dev, generator=g).relu().to(torch.bfloat16)
         .contiguous(memory_format=torch.channels_last))
    conv = _Conv((torch.randn(cout, cin, 3, 3, device=dev, generator=g) * (2 / (9 * cin)) ** 0.5)
                 .to(torch.bfloat16), 0.1 * torch.randn(cout, device=dev, generator=g))
    bias = conv.bias.to(torch.bfloat16)
    with torch.no_grad():
        conv(x)  # plans built outside the pool
        pool = torch.cuda.MemPool()
        with torch.cuda.use_mem_pool(pool):
            poison = torch.full((b * cout * h * w,), float("nan"), device=dev,
                                dtype=torch.bfloat16)
            block = poison.data_ptr()
            del poison
            before = _Conv.fused_launches, _Conv.plain_launches
            got = conv(x)
        assert (_Conv.fused_launches, _Conv.plain_launches) == (before[0] + 1, before[1])
        assert got.data_ptr() == block and not torch.isnan(got).any()
        plain = F.relu(F.conv2d(x, conv.weight, bias, padding=1))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            r = F.conv2d(x.float(), conv.weight.float(), bias.float(), padding=1)
    assert got.shape == plain.shape and got.dtype == torch.bfloat16
    assert got.stride() == plain.stride()
    floor = 2.0 ** -16 * float(r.abs().max())
    got, plain, mag = got.float(), plain.float(), r.abs()
    assert bool(((got - r.relu()).abs() <= 2.0 ** -7 * mag + floor).all())
    near = 2.0 ** -6 * (mag + bias.float().abs()[:, None, None]) + floor
    assert bool(((got - plain).abs() <= near).all())


@pytest.mark.parametrize("variant,fused,plain", [
    ("plain", 18, 5),           # 18 ReLU'd convs; 4 deconvs and the head
    ("s2d_skip", 19, 6),        # + the refinement path's ReLU'd conv, its plain head
])
def test_folded_forward_takes_the_fused_route(dev, variant, fused, plain):
    """A bf16 ``FoldedUNet`` forward on the card counts each ReLU'd conv
    fused and the rest plain; fp32 and cuDNN off count every call plain.
    With cuDNN off (the plain route on the card) the bf16 forward lies
    within the repo's bf16 bound (0.02 relative L2) of the fused one."""
    from audiodenoiser_torch.models import UNet, fold_for_inference
    from audiodenoiser_torch.models.folded import _Conv

    kw = dict(s2d_stem=True, s2d_skip=16) if variant == "s2d_skip" else {}
    torch.manual_seed(0)
    model = UNet((16, 32, 64, 128), 256, **kw).eval().to(dev)
    x = torch.rand(2, 1, 257, 126, device=dev)
    outs = {}
    for dtype, cudnn, want in ((torch.bfloat16, True, (fused, plain)),
                               (torch.bfloat16, False, (0, fused + plain)),
                               (torch.float32, True, (0, fused + plain))):
        folded = fold_for_inference(model, dtype)
        before = _Conv.fused_launches, _Conv.plain_launches
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=cudnn):
            outs[dtype, cudnn] = folded(x).float()
        assert (_Conv.fused_launches - before[0], _Conv.plain_launches - before[1]) == want
    a, b = outs[torch.bfloat16, True], outs[torch.bfloat16, False]
    assert float((a - b).norm() / b.norm()) < 0.02


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


def test_deconv_weight_pack_follows_the_optimizer(dev):
    """The port's optimizer (clip + torch AdamW, foreach on the card) bumps
    each parameter's version, so K3 repacks the weight after every step."""
    from audiodenoiser_torch.models.unet import ConvTranspose2x2
    from audiodenoiser_torch.ops.cuda import conv_transpose_2x2_plain
    from audiodenoiser_torch.ops.cuda.deconv import packed_weight
    from audiodenoiser_torch.train.loop import make_optimizer

    torch.manual_seed(0)
    layer = ConvTranspose2x2(64, 32, kernel=True).to(dev)
    opt = make_optimizer(layer.parameters(), 1e-2)
    x = torch.randn(4, 64, 8, 5, device=dev).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    for _ in range(2):
        opt.zero_grad()
        layer(x).float().square().sum().backward()
        before = packed_weight(layer.weight, torch.bfloat16, True).clone()
        opt.step()
        wt = layer.weight.detach()
        packed = packed_weight(layer.weight, torch.bfloat16, True)
        assert not torch.equal(packed, before)
        assert torch.equal(packed, wt.permute(2, 3, 1, 0).reshape(128, 64).to(torch.bfloat16))
        with torch.no_grad():
            ours = layer(x).float()
        ref = conv_transpose_2x2_plain(x.float(), wt.to(torch.bfloat16).float(), layer.bias)
        assert _max_rel(ours, ref.detach()) <= 1e-2


def test_deconv_kernel_rejects_what_it_does_not_take(dev):
    from audiodenoiser_torch.ops.cuda import deconv_kernel

    w, b = torch.zeros(8, 4, 2, 2, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="channels_last"):
        deconv_kernel(torch.zeros(2, 8, 4, 4, device=dev), w, b)
    with pytest.raises(TypeError):
        deconv_kernel(torch.zeros(2, 8, 4, 4, device=dev, dtype=torch.float16)
                      .contiguous(memory_format=torch.channels_last), w, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch,n_frames,n_fft,hop", [
    (256, 126, 512, 128),   # bench shape
    (3, 41, 512, 100),      # hop that does not divide n_fft
    (10, 20, 512, 512),     # no overlap
    (2, 7, 64, 100),        # hop past n_fft: gaps of zeros
])
def test_overlap_add_kernel_matches_plain(dev, dtype, batch, n_frames, n_fft, hop):
    from audiodenoiser_torch.ops.cuda import overlap_add_kernel, overlap_add_plain

    rng = np.random.default_rng(5)
    frames = torch.from_numpy(
        rng.standard_normal((batch, n_frames, n_fft)).astype(np.float32)).to(dev).to(dtype)
    before = overlap_add_kernel.launches
    ours = overlap_add_kernel(frames, hop)
    ref = overlap_add_plain(frames, hop)
    torch.cuda.synchronize()
    assert overlap_add_kernel.launches == before + 1
    assert ours.shape == ref.shape == (batch, (n_frames - 1) * hop + n_fft)
    assert ours.dtype == ref.dtype == dtype
    # both sum in fp32 and round once: f32 sums in another order; in bf16 the
    # two fp32 sums can round to neighbouring bf16 values (one ulp: at most
    # 2**-7 of the value)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    assert _max_rel(ours.float(), ref.float()) <= tol


def test_overlap_add_kernel_rejects_what_it_does_not_take(dev):
    from audiodenoiser_torch.ops.cuda import overlap_add_kernel

    with pytest.raises(TypeError):
        overlap_add_kernel(torch.zeros(2, 4, 512, device=dev, dtype=torch.float64), 128)
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


def _mask_runner(d, seed=0):
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        fold_for_inference,
        load_flax_variables,
        random_flax_variables,
    )

    v = random_flax_variables(seed, (8, 16, 32, 64), 128, in_channels=3, out_channels=2)
    model = load_flax_variables(ComplexMaskUNet(residual=True, features=(8, 16, 32, 64),
                                                bottleneck=128), v)
    return DenoiserRunner(fold_for_inference(model.eval(), torch.float32), device=d)


def test_pool_on_card_matches_dedicated_sessions(dev):
    """A pool of 4 streams on the card, fp32, uneven packets: each slot
    against a dedicated session of its stream on the card (K1 and K2 at
    batch 4 against batch 1), and the pool's steps fewer than its hops."""
    from audiodenoiser_torch.eval.streaming import MultiStreamWola, StreamingDenoiser
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel

    runner = _mask_runner("cuda", seed=5)
    rng = np.random.default_rng(7)
    streams = [np.clip(0.2 * rng.standard_normal(6000 + 900 * i), -1, 1).astype(np.float32)
               for i in range(4)]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        pool = MultiStreamWola(runner, capacity=4, chunk_samples=4096)
        slots = [pool.open() for _ in streams]
        out = {s: [] for s in slots}
        before = stft_kernel.fft_launches, istft_kernel.fft_launches
        for start, stop in ((0, 1500), (1500, 5000), (5000, 9000)):
            got = pool.process({s: x[start + 300 * s: stop] for s, x in zip(slots, streams)
                                if start + 300 * s < stop})
            for s, o in got.items():
                out[s].append(o)
        for s in slots:
            out[s].append(pool.flush(s))
        assert stft_kernel.fft_launches - before[0] == pool.advances
        assert istft_kernel.fft_launches - before[1] == pool.advances
        streamer = StreamingDenoiser(runner, chunk_samples=4096)
        for s, x in zip(slots, streams):
            fed = np.concatenate([x[start + 300 * s: stop] for start, stop in
                                  ((0, 1500), (1500, 5000), (5000, 9000))
                                  if start + 300 * s < stop])
            sess = streamer.session()
            alone = np.concatenate([sess.process(fed), sess.flush()])
            got = np.concatenate(out[s])
            assert got.shape == fed.shape
            assert np.linalg.norm(got - alone) / np.linalg.norm(alone) < 1e-4
    assert pool.advances < sum(-(-(len(x) + 4096) // 2048) for x in streams)


def test_low_latency_session_on_card_matches_cpu(dev):
    """A 64 ms low-latency session over a 4096-sample window, fp32 on the
    card (K1, K2) against the CPU, ragged packets."""
    from audiodenoiser_torch.eval.streaming import LowLatencyStreamingDenoiser

    rng = np.random.default_rng(8)
    x = np.clip(0.2 * rng.standard_normal(7000), -1, 1).astype(np.float32)
    outs = {}
    for d in ("cuda", "cpu"):
        engine = LowLatencyStreamingDenoiser.from_latency_budget(_mask_runner(d, seed=6), 64,
                                                                 window_samples=4096)
        sess = engine.session()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            outs[d] = np.concatenate([sess.process(p) for p in np.array_split(x, 5)]
                                     + [sess.flush()])
    assert outs["cuda"].shape == x.shape
    rel = np.linalg.norm(outs["cuda"] - outs["cpu"]) / np.linalg.norm(outs["cpu"])
    assert rel < 1e-4, rel


def test_denoise_waveform_on_card_matches_cpu(dev):
    """``denoise_waveform`` in fp32 through the kernels on the card against
    the plain versions on the CPU: its mask makes the DC and Nyquist bins
    complex, which the plain iSTFT drops on both devices."""
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        denoise_waveform,
        load_flax_variables,
        random_flax_variables,
    )

    v = random_flax_variables(3, (8, 16, 32, 64), 128, in_channels=3, out_channels=2)
    rng = np.random.default_rng(4)
    audio = torch.from_numpy(np.clip(0.2 * rng.standard_normal((2, 7000)), -1, 1)
                             .astype(np.float32))
    outs = {}
    for d in ("cuda", "cpu"):
        model = load_flax_variables(ComplexMaskUNet(mask_bound=2.0, residual=True,
                                                    features=(8, 16, 32, 64),
                                                    bottleneck=128), v).eval().to(d)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            outs[d] = denoise_waveform(model, audio.to(d)).cpu()
    rel = (outs["cuda"] - outs["cpu"]).norm() / outs["cpu"].norm()
    assert rel < 1e-4, rel


@pytest.mark.parametrize("mode", ["reference", "correct"])
def test_griffin_lim_on_card_matches_cpu(dev, mode):
    """Griffin-Lim at 50 iterations through K1 and K2 on the card against the
    plain versions on the CPU, on one magnitude and one initial phase: K1
    launches n_iter times and K2 n_iter + 1, all through their FFT entries.
    Bounds as tests/test_torch_griffin_lim.py holds the CPU to JAX: 1e-4 in
    ``reference`` mode, 1e-3 in ``correct`` mode."""
    from audiodenoiser_torch.dsp.griffin_lim import griffin_lim, initial_phase
    from audiodenoiser_torch.dsp.stft import stft
    from audiodenoiser_torch.ops.cuda import (
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
        variant_launches,
    )
    from audiodenoiser_torch.data.synth import synth_chunks

    mag = stft(torch.from_numpy(synth_chunks(3, seed=5)), 512, 128).abs()
    theta = initial_phase(mag.shape, torch.Generator().manual_seed(1))
    reset_launch_counts()
    ours = griffin_lim(mag.to(dev), theta=theta.to(dev), n_iter=50, mode=mode,
                       length=16000, precision="kernel").cpu()
    assert variant_launches(stft_kernel) == {"fft": 50, "direct": 0}
    assert variant_launches(istft_kernel) == {"fft": 51, "direct": 0}
    ref = griffin_lim(mag, theta=theta, n_iter=50, mode=mode, length=16000,
                      precision="kernel")
    rel = (ours - ref).norm() / ref.norm()
    assert rel < {"reference": 1e-4, "correct": 1e-3}[mode], rel


@pytest.mark.parametrize("n_fft,hop", [(512, 128), (2048, 512)])
def test_istft_gradient_matches_autograd_of_plain(dev, n_fft, hop):
    """K2's gradient (K1 on the cotangent, scaled per bin) against autograd
    through the plain iSTFT on the card; the imaginary DC/Nyquist parts get
    exactly 0, and the backward is one K1 launch through its FFT entry."""
    from audiodenoiser_torch.dsp.stft import istft
    from audiodenoiser_torch.ops.cuda import (
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
        variant_launches,
    )

    rng = np.random.default_rng(7)
    f, t = n_fft // 2 + 1, 40
    parts = rng.standard_normal((3, f, t, 2)).astype(np.float32)
    parts[:, [0, -1], :, 1] = 50.0  # large imaginary DC/Nyquist parts, ignored
    spec0 = torch.view_as_complex(torch.from_numpy(parts)).to(dev)
    g = torch.from_numpy(rng.standard_normal((3, 6000)).astype(np.float32)).to(dev)
    grads = {}
    for precision in ("kernel", "fft"):
        spec = spec0.clone().requires_grad_()
        reset_launch_counts()
        y = istft(spec, hop, n_fft=n_fft, length=6000, precision=precision)
        (y * g).sum().backward()
        torch.cuda.synchronize()
        launches = (variant_launches(stft_kernel), variant_launches(istft_kernel))
        grads[precision] = torch.view_as_real(spec.grad)
        if precision == "kernel":
            assert launches == ({"fft": 1, "direct": 0}, {"fft": 1, "direct": 0})
        else:
            assert stft_kernel.launches == istft_kernel.launches == 0
    ours, ref = grads["kernel"], grads["fft"]
    assert _max_rel(ours, ref) < 1e-5
    assert float(ours[:, [0, -1], :, 1].abs().max()) == 0.0
    with pytest.raises(RuntimeError, match="A.8"):
        stft_kernel(g.clone().requires_grad_(), torch.ones(n_fft, device=dev), n_fft, hop)


def test_mask_step_on_card_matches_cpu(dev):
    """One fp32 mask train step (K1, K2 and its gradient, K3 both ways) on
    the card against the CPU's plain versions, from one weight tree and the
    same waveforms, at two levels: losses and the loss's gradient with
    respect to the mask within 1e-4 relative; every parameter gradient of
    the card within 1e-4 relative L2 of a float64 backward of the same
    cotangent (on the CPU the fp32 backward of this step lies further from
    it, so the CPU is not the arbiter of the U-Net's gradients; a conv bias
    feeding train-mode BN has a gradient of exactly 0 and is left out)."""
    from torch import nn

    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        random_flax_variables,
        state_dict_from_flax,
    )
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.data.synth import synth_chunks
    from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

    class Tap(nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            y = self.model(x)
            y.retain_grad()
            self.x, self.y = x, y
            return y

    widths = dict(features=(8, 16), bottleneck=32)
    v = random_flax_variables(2, **widths, in_channels=3, out_channels=2)
    clean = torch.from_numpy(synth_chunks(2, seed=6))
    noisy = (clean + 0.1 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(3))
             ).clamp(-1, 1)
    train_step, _ = make_mask_steps(0.5, 30.0)
    got = {}
    for d in ("cuda", "cpu"):
        model = ComplexMaskUNet(**widths, mask_bound=8.0, residual=True, pallas_deconv=True)
        state = create_mask_train_state(0, model, variables=v, device=d)
        state.model = tap = Tap(state.model)
        reset_launch_counts()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            state, losses = train_step(state, noisy.to(d), clean.to(d))
        if d == "cuda":
            torch.cuda.synchronize()
            assert (stft_kernel.launches, istft_kernel.launches) == (2, 1)
            assert deconv_kernel.launches == 2
        clip = min(1.0, 1.0 / float(state.grad_norm))  # the step scaled the gradients
        got[d] = ([float(x) for x in losses], tap.x.detach(), tap.y.grad.detach(),
                  {n: p.grad / clip for n, p in model.named_parameters()})
    (lc, x, g, grads), (lp, _, gp, _) = got["cuda"], got["cpu"]
    for a, b in zip(lc, lp):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert float((g.cpu() - gp).norm() / gp.norm()) < 1e-4
    ref = ComplexMaskUNet(**widths, mask_bound=8.0, residual=True, dtype=torch.float64)
    ref.load_state_dict(state_dict_from_flax(v))
    ref = ref.double().to(dev).train()
    ref(x.double()).backward(g.double())
    for name, p in ref.named_parameters():
        if not name.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            assert float((grads[name].double() - p.grad).norm() / p.grad.norm()) < 1e-4, name


def test_distilled_step_on_card_matches_autograd_of_plain(dev):
    """One fp32 distilled mask step (both teacher terms, SI-SDR on) on the
    card through K1, K2 and its gradient, and K3 in the student, against
    the same step through the plain versions (``torch.fft`` transforms,
    cuDNN's transposed convolutions) and autograd on the card, at two
    levels, the teacher twice the student's width, from one weight tree and
    the same waveforms: the losses within 1e-5 relative and the loss's
    gradient with respect to the mask within 1e-4 relative L2; then every
    parameter gradient of the kernel path within 1e-4 relative L2 of a
    float64 backward of the same input, mask cotangent and attention term
    (the arbiter of fp32 gradients, as in ``test_mask_step_on_card_matches_cpu``;
    a conv bias feeding train-mode BN has a gradient of rounding alone and
    is left out). The teacher's gradients stay untouched; K1 2, K2 1, K3 2
    launches."""
    from types import SimpleNamespace

    from torch import nn

    import audiodenoiser_torch.dsp.stft as stft_lib
    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        random_flax_variables,
        state_dict_from_flax,
    )
    from audiodenoiser_torch.ops.cuda import (
        deconv_kernel,
        istft_kernel,
        reset_launch_counts,
        stft_kernel,
    )
    from audiodenoiser_torch.train import mask as mask_lib
    from audiodenoiser_torch.data.synth import synth_chunks

    class Tap(nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model, self.bottleneck = model, model.bottleneck

        def forward(self, x):
            y = self.model(x)
            y.retain_grad()
            self.x, self.y = x, y
            return y

    student_w, teacher_w = dict(features=(8, 16), bottleneck=32), dict(features=(16, 32),
                                                                         bottleneck=64)
    sv = random_flax_variables(2, **student_w, in_channels=3, out_channels=2)
    tv = random_flax_variables(4, **teacher_w, in_channels=3, out_channels=2)
    clean = torch.from_numpy(synth_chunks(2, seed=6)).to(dev)
    noisy = (clean + 0.1 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(3))
             .to(dev)).clamp(-1, 1)
    plain = SimpleNamespace(
        stft=lambda *a, **kw: stft_lib.stft(*a, **{**kw, "precision": "fft"}),
        istft=lambda *a, **kw: stft_lib.istft(*a, **{**kw, "precision": "fft"}))

    def models(dtype, kernel=False):
        teacher = ComplexMaskUNet(**teacher_w, mask_bound=8.0, residual=True, dtype=dtype)
        teacher.load_state_dict(state_dict_from_flax(tv))
        model = ComplexMaskUNet(**student_w, mask_bound=8.0, residual=True,
                                pallas_deconv=kernel, dtype=dtype)
        model.load_state_dict(state_dict_from_flax(sv))
        return (model.to(dev, dtype).train(),
                teacher.to(dev, dtype).eval().requires_grad_(False))

    got = {}
    for kernel in (True, False):
        model, teacher = models(torch.float32, kernel)
        tap = Tap(model)
        reset_launch_counts()
        with pytest.MonkeyPatch.context() as mp:
            if not kernel:
                mp.setattr(mask_lib, "stft_lib", plain)
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                losses = mask_lib._mask_losses(tap, noisy, clean, 0.5, 30.0, teacher, 0.5, 1.0)
                losses.total.backward()
        torch.cuda.synchronize()
        launches = (stft_kernel.launches, istft_kernel.launches, deconv_kernel.launches)
        assert launches == ((2, 1, 2) if kernel else (0, 0, 0))
        assert all(p.grad is None for p in teacher.parameters())
        got[kernel] = ([float(x.detach()) for x in losses], tap.x.detach(), tap.y.grad,
                       {n: p.grad.double() for n, p in model.named_parameters()})
    (lk, x, g, grads), (lp, _, gp, _) = got[True], got[False]
    for a, b in zip(lk, lp):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert float((g - gp).norm() / gp.norm()) < 1e-4

    def attention(f):
        a = f.square().mean(dim=1)
        return a / (torch.linalg.vector_norm(a, dim=(-2, -1), keepdim=True) + 1e-8)

    model, teacher = models(torch.float64)
    with mask_lib._tapped(model, True) as s_feats, mask_lib._tapped(teacher, True) as t_feats:
        y = model(x.double())
        with torch.no_grad():
            teacher(x.double())
    feat = (attention(s_feats[0]) - attention(t_feats[0])).square().sum(dim=(-2, -1)).mean()
    ((y * g.double()).sum() + 1.0 * feat).backward()
    for name, p in model.named_parameters():
        if not name.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            err = float((grads[name] - p.grad).norm() / p.grad.norm())
            assert err < 1e-4, f"{name}: {err:.3e}"


def test_build_train_dataset_on_card_matches_cpu(dev, tmp_path):
    """``build_train_dataset`` on the card (K1 uncentred, twice a batch and
    noise type, through its FFT entry) against the CPU's plain version from
    the same wavs: the clean magnitudes and the reverb files (no draws)
    within 1e-5 of max |CPU|; every file set and shape equal."""
    import os

    from audiodenoiser_torch.data.builders import build_train_dataset
    from audiodenoiser_torch.data.wav_io import write_wav
    from audiodenoiser_torch.ops.cuda import reset_launch_counts, stft_kernel, variant_launches
    from audiodenoiser_torch.data.synth import synth_chunks

    clean, noise = tmp_path / "clean", tmp_path / "noise"
    clean.mkdir(), noise.mkdir()
    for i, c in enumerate(synth_chunks(10, seed=4).reshape(5, -1)):
        write_wav(str(clean / f"c{i}.wav"), c, 8000)
    write_wav(str(noise / "n.wav"), synth_chunks(1, seed=5)[0], 8000)
    sets = {}
    for d in ("cuda", "cpu"):
        reset_launch_counts()
        assert build_train_dataset(str(clean), str(noise), str(tmp_path / d), device=d,
                                   device_batch=4) == 10
        if d == "cuda":
            assert variant_launches(stft_kernel) == {"fft": 2 * 4 * 3, "direct": 0}
        sets[d] = {(nt, f): np.load(tmp_path / d / nt / f)
                   for nt in sorted(os.listdir(tmp_path / d))
                   for f in sorted(os.listdir(tmp_path / d / nt))}
    assert sorted(sets["cuda"]) == sorted(sets["cpu"])
    for key, ref in sets["cpu"].items():
        ours = sets["cuda"][key]
        assert ours.shape == ref.shape == (257, 122) and ours.dtype == np.float32
        if key[0] == "reverb" or key[1].startswith("clean"):
            assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max(), key


def _narrow_state(d, remat=False, **opt):
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.train.loop import create_train_state

    widths = dict(features=(16, 32), bottleneck=64)
    model = UNet(**widths, pallas_deconv=True, remat=remat)
    return create_train_state(0, model, learning_rate=1e-3, device=d,
                              variables=random_flax_variables(5, **widths), **opt)


def _spectra(n, seed):
    g = torch.Generator().manual_seed(seed)
    noisy = torch.rand((n, 2, 1, 64, 32), generator=g)
    return [(x, 0.8 * x) for x in noisy]


def test_remat_step_on_card_matches_plain(dev):
    """One fp32 step with remat against one without on the card: loss,
    gradients and running statistics within 1e-6 relative L2,
    ``num_batches_tracked`` 1 either way (the recompute folds no
    statistics). cuDNN is off, so that the two runs take the same kernels:
    with it on (deterministic) the first conv's weight gradient came out
    1.2e-6 apart at these widths. The conv biases that feed a train-mode
    BatchNorm have a gradient of rounding alone, which the card sums in no
    fixed order (it came out another way with cuDNN off too): they are held
    to be rounding, under 1e-4 of the largest gradient."""
    from audiodenoiser_torch.train.loop import train_step

    (noisy, clean), = _spectra(1, 0)
    got = []
    for remat in (False, True):
        state = _narrow_state(dev, remat)
        with torch.backends.cudnn.flags(enabled=False):
            state, losses = train_step(state, noisy.to(dev), clean.to(dev))
        got.append((float(losses.total), {n: p.grad.clone() for n, p in
                                          state.model.named_parameters()},
                    state.model.state_dict()))
    (l0, g0, s0), (l1, g1, s1) = got
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    top = max(float(g.abs().max()) for g in g0.values())
    for n in g0:
        if n.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            assert max(float(g0[n].abs().max()), float(g1[n].abs().max())) <= 1e-4 * top, n
        else:
            assert float((g1[n] - g0[n]).norm() / (g0[n].norm() + 1e-30)) <= 1e-6, n
    for k in s0:
        if k.endswith("num_batches_tracked"):
            assert int(s1[k]) == int(s0[k]) == 1, k
        elif "running" in k:
            assert float((s1[k] - s0[k]).norm() / (s0[k].norm() + 1e-30)) <= 1e-6, k


def test_accumulation_on_card_matches_cpu(dev):
    """Four fp32 micro-steps under grad_accum 2 with warm-up + cosine and an
    EMA of 0.9, card against CPU: parameters, statistics and EMA within
    1e-4 relative L2 (the fp32 step's standard), parameters bit-equal
    across each non-update micro-step on both."""
    from audiodenoiser_torch.train.loop import train_step

    opt = dict(schedule="cosine", warmup_steps=1, total_steps=4, grad_accum=2)
    got = {}
    for d in ("cuda", "cpu"):
        state = _narrow_state(d, **opt)
        params = list(state.model.parameters())
        ema = [p.detach().clone() for p in params]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for i, (noisy, clean) in enumerate(_spectra(4, 1)):
                before = [p.detach().clone() for p in params]
                state, _ = train_step(state, noisy.to(d), clean.to(d))
                with torch.no_grad():
                    torch._foreach_lerp_(ema, params, 0.1)
                if i % 2 == 0:
                    assert all(torch.equal(a, b) for a, b in zip(params, before))
        assert state.optimizer.updates == 2
        got[d] = ({k: v.float().cpu() for k, v in state.model.state_dict().items()},
                  [e.cpu() for e in ema])
    (sc, ec), (sp, ep) = got["cuda"], got["cpu"]
    for k in sp:
        if k.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            continue  # AdamW steps on rounding noise there (fed to train-mode BN)
        assert float((sc[k] - sp[k]).norm() / (sp[k].norm() + 1e-30)) <= 1e-4, k
    assert float(torch.cat([(a - b).flatten() for a, b in zip(ec, ep)]).norm()
                 / torch.cat([b.flatten() for b in ep]).norm()) <= 1e-4


def test_resume_on_card_matches_an_uninterrupted_fit(dev, tmp_path):
    """``fit`` for 2 epochs against 1 epoch and a resumed one, fp32 on the
    card with cuDNN deterministic, grad_accum 2 over 3 steps an epoch (an
    update spans the resume) and an EMA: weights, EMA and running variances
    within 1e-6 relative L2, the resumed history only epoch 1. Left out:
    the conv biases that feed a train-mode BatchNorm, whose gradient is
    rounding alone and whose AdamW step came out another way in the two
    runs at these widths (with cuDNN on and off), and the running means
    they shift (ROADMAP, "Not port faults")."""
    import os

    from audiodenoiser_torch.train.checkpoints import restore_train_state
    from audiodenoiser_torch.train.loop import FitConfig, fit

    data = [_spectra(3, 10 + e) for e in range(2)]
    val = _spectra(1, 20)

    def run(name, epochs, resume=False):
        cfg = FitConfig(run_name=name, output_path=str(tmp_path), epochs=epochs,
                        precision="f32", resume=resume, ema_decay=0.9, log_every=0)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                        allow_tf32=False):
            return fit(cfg, lambda e: iter(data[e]), lambda: iter(val),
                       state_factory=lambda: _narrow_state(dev, schedule="cosine",
                                                           warmup_steps=1, total_steps=6,
                                                           grad_accum=2))

    whole = run("whole", 2)
    run("split", 1)
    resumed = run("split", 2, resume=True)
    assert [h["epoch"] for h in resumed["history"]] == [1]
    a, b = (restore_train_state(os.path.join(tmp_path, r, "checkpoints", "train_state.pt"),
                                "cpu") for r in ("whole", "split"))
    bn_fed = ("double_conv.0.bias", "double_conv.3.bias")
    for key in ("model", "ema"):
        for k, t in a[key].items():
            if not t.is_floating_point():
                assert torch.equal(b[key][k], t), (key, k)
            elif not k.endswith((*bn_fed, "running_mean")):
                assert float((b[key][k] - t).norm() / (t.norm() + 1e-30)) <= 1e-6, (key, k)


def _router(d, dtype=torch.float32, seed=5):
    from audiodenoiser_torch.models import (
        NoiseClassifier,
        random_router_flax_variables,
        router_state_dict_from_flax,
    )

    model = NoiseClassifier(dtype=dtype)
    model.load_state_dict(router_state_dict_from_flax(random_router_flax_variables(seed)["params"]))
    return model.eval().to(d)


def _mixture(d, precision="kernel"):
    from audiodenoiser_torch.eval.ensemble import MixtureOfDenoisers
    from audiodenoiser_torch.models import (
        NOISE_CLASSES,
        UNet,
        fold_for_inference,
        load_flax_variables,
        random_flax_variables,
    )

    experts = {nt: fold_for_inference(load_flax_variables(
        UNet((8, 16, 32, 64), 128), random_flax_variables(60 + i, (8, 16, 32, 64), 128)).eval(),
        torch.float32) for i, nt in enumerate(NOISE_CLASSES)}
    return MixtureOfDenoisers(experts, _router(d), device=d, precision=precision)


def test_router_on_card_matches_cpu(dev):
    """The router's fp32 forward (SAME padding, fp32 GroupNorm) on the card
    against the CPU, at the training crop and a whole odd-sized clip."""
    rng = np.random.default_rng(6)
    for shape in ((8, 1, 256, 64), (3, 1, 257, 151)):
        x = torch.from_numpy(np.abs(rng.standard_normal(shape)).astype(np.float32) * 3)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            card = _router(dev)(x.to(dev)).cpu()
            cpu = _router("cpu")(x)
        assert _max_rel(card, cpu) < 1e-5


def test_classify_waveform_through_k1_matches_fft(dev):
    """The routed deployment's classifier: K1's magnitudes and cuFFT's give
    the same windowed logits, and K1 is launched once a call."""
    from audiodenoiser_torch.eval.ensemble import windowed_logits
    from audiodenoiser_torch.ops.cuda import stft_kernel

    rng = np.random.default_rng(7)
    wavs = torch.from_numpy(np.clip(0.3 * rng.standard_normal((16, 16000)), -1, 1)
                            .astype(np.float32)).to(dev)
    kernel, fft = _mixture(dev, "kernel"), _mixture(dev, "fft")
    before = stft_kernel.launches
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        labels = kernel.classify_waveform(wavs)
        assert stft_kernel.launches == before + 1
        ref = fft.classify_waveform(wavs)
        from audiodenoiser_torch.dsp.stft import stft

        logits = [windowed_logits(m.router, stft(wavs, 512, 128, precision=p).abs()[:, None])
                  for m, p in ((kernel, "kernel"), (fft, "fft"))]
    assert _max_rel(logits[0], logits[1]) < 1e-5
    torch.testing.assert_close(labels, ref, rtol=0, atol=0)


def test_routed_denoise_waveform_matches_direct_expert_calls(dev):
    """A routed batch on the card: each clip equals its expert runner's
    call on the zero-padded power-of-two group; K1 and K2 are launched once
    a group."""
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel

    mix = _mixture(dev)
    rng = np.random.default_rng(8)
    wavs = torch.from_numpy(np.clip(0.2 * rng.standard_normal((7, 6000)), -1, 1)
                            .astype(np.float32)).to(dev)
    labels = np.array([0, 1, 2, 3, 0, 2, 2])
    before = (stft_kernel.launches, istft_kernel.launches)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        out = mix.denoise_waveform(wavs, labels=labels)
        assert (stft_kernel.launches - before[0], istft_kernel.launches - before[1]) == (4, 4)
        for e in range(4):
            idx = np.nonzero(labels == e)[0]
            group = torch.zeros((1 << (len(idx) - 1).bit_length(), 6000), device=dev)
            group[: len(idx)] = wavs[idx]
            direct = mix.runners[e].denoise_audio(group)[: len(idx)]
            assert _max_rel(out[idx], direct) < 1e-6


MENU_NARROW = dict(features=(16, 32, 64, 128), bottleneck=256)


@pytest.mark.parametrize("family", ["unet", "mask"])
def test_variants_on_card_match_cpu(dev, family):
    """The s2d stem, its refinement path and the attention bottleneck
    together, fp32 with TF32 off, live BN and folded, card against CPU at
    an odd whole-clip shape (the pad, the crop and 8 x 3 tokens)."""
    import copy

    from audiodenoiser_torch.models import (
        ComplexMaskUNet,
        UNet,
        fold_for_inference,
        load_flax_variables,
        random_flax_variables,
    )

    menu = dict(s2d_stem=True, s2d_skip=16, attn_bottleneck=True)
    cin, cout = (1, 1) if family == "unet" else (3, 2)
    model = (UNet(**MENU_NARROW, **menu) if family == "unet" else
             ComplexMaskUNet(**MENU_NARROW, **menu, mask_bound=8.0, residual=True))
    load_flax_variables(model, random_flax_variables(3, **MENU_NARROW, in_channels=cin,
                                                     out_channels=cout, **menu))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, cin, 257, 126))
                         .astype(np.float32))
    for fold in (False, True):
        outs = []
        for d in ("cpu", dev):
            m = copy.deepcopy(model).eval()
            m = (fold_for_inference(m, torch.float32) if fold else m).to(d)
            with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                outs.append(m(x.to(d)).cpu())
        rel = ((outs[1] - outs[0]).norm() / outs[0].norm()).item()
        assert outs[1].shape == (2, cout, 257, 126) and rel < 1e-5, (fold, rel)


def test_int8_on_card_matches_cpu(dev):
    """``Int8UNet`` on the card against the CPU: every layer's int32
    products through ``torch._int_mm`` (the stem's K padded to 16, the
    head's N to 8) bit-equal on the same input, the forward within 1e-5."""
    from audiodenoiser_torch.models import (
        UNet,
        load_flax_variables,
        prepare_int8,
        random_flax_variables,
    )
    from audiodenoiser_torch.models.int8 import _int_mm

    model = load_flax_variables(UNet(**MENU_NARROW), random_flax_variables(5, **MENU_NARROW))
    q_cpu, q_dev = prepare_int8(model.eval()), prepare_int8(model.eval()).to(dev)
    x = torch.from_numpy(np.abs(np.random.default_rng(6).standard_normal((2, 1, 257, 63)))
                         .astype(np.float32))
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    for name in ("down0_conv0", "down0_conv1", "up0_deconv", "out"):
        layer = q_cpu.layers[name]
        h = torch.rand(2, 33, 17, layer.cin) if name != "down0_conv0" else nhwc
        a = layer.accumulate(h)[0]
        b = q_dev.layers[name].accumulate(h.to(dev))[0].cpu()
        assert torch.equal(a, b), name
    out_cpu, out_dev = q_cpu(x), q_dev(x.to(dev)).cpu()
    assert ((out_dev - out_cpu).norm() / out_cpu.norm()).item() < 1e-5
    ri = torch.randint(-127, 128, (9, 16), dtype=torch.int8)
    wi = torch.randint(-127, 128, (8, 16), dtype=torch.int8)
    assert torch.equal(_int_mm(ri.to(dev), wi.to(dev)).cpu(), ri.int() @ wi.int().t())


def test_k3_at_the_s2d_pyramid(dev):
    """The s2d stem's training shapes (batch 16, crop 256 x 64: the deepest
    upsampling at 8 x 2, M = 256) still take K3's wgmma variant in bf16,
    four launches a forward, within bf16 rounding of cuDNN's upsamplings."""
    from audiodenoiser_torch.models import UNet, load_flax_variables, random_flax_variables
    from audiodenoiser_torch.ops.cuda import deconv_kernel, reset_launch_counts, variant_launches

    v = random_flax_variables(7, s2d_stem=True, attn_bottleneck=True)
    x = torch.rand(16, 1, 256, 64, device=dev)
    outs = []
    for kernel in (True, False):
        model = UNet(dtype=torch.bfloat16, s2d_stem=True, attn_bottleneck=True,
                     pallas_deconv=kernel)
        model = load_flax_variables(model, v).to(dev).train()
        reset_launch_counts()
        outs.append(model(x).float())
        torch.cuda.synchronize()
        if kernel:
            assert deconv_kernel.launches == 4
            assert variant_launches(deconv_kernel)["wgmma"] == 4
    rel = ((outs[0] - outs[1]).norm() / outs[1].norm()).item()
    assert rel < 2e-2, rel


def _meshed_fit(dev, tmp_path, mesh_on):
    """One fp32 step of a narrow U-Net with K3 through ``fit``, with or
    without a world-size-1 mesh (NCCL), cuDNN deterministic."""
    from audiodenoiser_torch.models import UNet, random_flax_variables
    from audiodenoiser_torch.train.loop import FitConfig, create_train_state, fit

    widths = dict(features=(16, 32, 64, 128), bottleneck=256)
    rng = np.random.default_rng(31)
    noisy = torch.from_numpy(np.abs(rng.standard_normal((4, 1, 64, 32))).astype(np.float32))
    batch = (noisy, 0.8 * noisy)
    cfg = FitConfig(run_name=f"mesh_{mesh_on}", output_path=str(tmp_path), epochs=1,
                    batch_size=4, precision="f32", log_every=0, use_mesh=mesh_on)
    factory = lambda: create_train_state(0, UNet(**widths, pallas_deconv=True),
                                         variables=random_flax_variables(32, **widths))
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        res = fit(cfg, lambda e: iter([batch]), lambda: iter([batch]), state_factory=factory)
    state = res["state"]
    sd = state.layout.full_state_dict(state.model) if mesh_on else state.model.state_dict()
    return res["history"], {k: v.detach().cpu() for k, v in sd.items()}, state


def test_meshed_fit_step_on_card_matches_unmeshed(dev, tmp_path):
    """A world-size-1 mesh (NCCL) runs the unmeshed program: one fp32 step
    through ``fit`` gives the same losses and every tensor within 1e-6
    relative L2, through K3. The conv biases that feed a train-mode
    BatchNorm step on rounding noise whose sum cuDNN orders its own way
    between runs (ROADMAP): they move by at most 4 x lr."""
    plain_hist, plain, _ = _meshed_fit(dev, tmp_path, False)
    mesh_hist, meshed, state = _meshed_fit(dev, tmp_path, True)
    assert state.layout is not None and torch.distributed.get_backend() == "nccl"
    assert mesh_hist[0]["train"] == pytest.approx(plain_hist[0]["train"], rel=1e-6)
    assert meshed.keys() == plain.keys()
    for k, v in plain.items():
        if not v.is_floating_point():
            continue
        if k.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            assert float((meshed[k] - v).abs().max()) <= 4 * 1e-4, k
            continue
        rel = float((meshed[k] - v).norm() / (v.norm() + 1e-12))
        assert rel <= 1e-6, (k, rel)


def test_meshed_runner_on_card_matches_unmeshed(dev):
    """The folded bf16 runner on a world-size-1 mesh answers a batch of 5
    clips (and an unbatched one) as the unmeshed runner does, within 1e-6."""
    from audiodenoiser_torch.eval.bench import build_runner
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.parallel import make_mesh

    plain = build_runner(0, device="cuda", width_mult=0.25)
    meshed = DenoiserRunner(build_runner(0, device="cuda", width_mult=0.25).model,
                            device="cuda", mesh=make_mesh(device="cuda"))
    rng = np.random.default_rng(33)
    audio = torch.from_numpy(np.clip(0.2 * rng.standard_normal((5, 16000)), -1, 1)
                             .astype(np.float32)).to(dev)
    for x in (audio, audio[0]):
        want, got = plain.denoise_audio(x), meshed.denoise_audio(x)
        assert got.shape == want.shape == x.shape
        assert float((got - want).norm() / want.norm()) <= 1e-6


QUARTER = dict(features=(16, 32, 64, 128), bottleneck=256)  # width_mult 0.25


def _quarter_sd(seed):
    from audiodenoiser_torch.models import random_flax_variables, state_dict_from_flax

    return state_dict_from_flax(random_flax_variables(seed, **QUARTER))


@pytest.mark.parametrize("stages", [2, 4])
def test_pipelined_forward_on_card_matches_the_unet(dev, stages):
    """Every stage on ``cuda:0``: the pipelined fp32 forward within 1e-5
    relative L2 of the monolithic U-Net, cuDNN deterministic."""
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.parallel.pipeline import PipelinedDenoiser

    sd = _quarter_sd(70)
    x = torch.rand((6, 1, 257, 50), device=dev, generator=torch.Generator(dev).manual_seed(70))
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        mono = UNet(**QUARTER).to(dev).eval()
        mono.load_state_dict(sd)
        with torch.no_grad():
            want = mono(x)
        got = PipelinedDenoiser(sd, devices=[dev] * stages, **QUARTER)(x, microbatches=4)
    assert got.device.type == "cuda" and got.shape == want.shape
    assert float((got - want).norm() / want.norm()) <= 1e-5


def test_1f1b_step_on_card_matches_accumulation(dev):
    """One fp32 1F1B step at 3 stages on ``cuda:0`` (M 4 x 2) against the
    monolithic step with ``grad_accum`` 4: the loss within 1e-5 relative,
    every tensor within 1e-4 relative L2 but the BN-fed conv biases, within
    4 x lr."""
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.parallel.pipeline_train import PipelineTrainer
    from audiodenoiser_torch.train.loop import create_train_state, train_step

    lr, sd = 1e-4, _quarter_sd(71)
    gen = torch.Generator(dev).manual_seed(71)
    noisy = torch.rand((4, 2, 1, 64, 64), device=dev, generator=gen)
    clean = 0.8 * noisy
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        state = create_train_state(0, UNet(**QUARTER), learning_rate=lr, device=dev,
                                   grad_accum=4)
        state.model.load_state_dict(sd)
        losses = [float(train_step(state, noisy[m], clean[m])[1].total) for m in range(4)]
        trainer = PipelineTrainer([dev] * 3, micro_batch=2, n_micro=4, input_shape=(1, 64, 64),
                                  **QUARTER, learning_rate=lr)
        pstate, loss = trainer.step(trainer.init(sd), noisy, clean)
    assert float(loss) == pytest.approx(sum(losses) / 4, rel=1e-5)
    got, want = trainer.unpack_state(pstate), state.model.state_dict()
    for k, v in want.items():
        if not v.is_floating_point():
            continue
        diff = (got[k].to(dev) - v).float()
        if k.endswith(("double_conv.0.bias", "double_conv.3.bias")):
            assert float(diff.abs().max()) <= 4 * lr, k
        else:
            assert float(diff.norm() / v.float().norm()) <= 1e-4, k


def test_sharded_clip_on_card_is_the_padded_forward(dev):
    """A world-size-1 ('seq',) mesh (NCCL) runs the padded oracle's
    computation: a 20 s clip through ``denoise_waveform_sharded``, K1 and K2
    once each."""
    from audiodenoiser_torch.dsp import stft as stft_lib
    from audiodenoiser_torch.models import UNet
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel
    from audiodenoiser_torch.parallel.spatial import (
        denoise_waveform_sharded,
        make_seq_mesh,
        reference_padded_forward,
    )

    model = UNet(**QUARTER).to(dev).eval()
    model.load_state_dict(_quarter_sd(72))
    rng = np.random.default_rng(72)
    wav = torch.from_numpy(np.clip(0.2 * rng.standard_normal(20 * 8000), -1, 1)
                           .astype(np.float32)).to(dev)
    mesh = make_seq_mesh(device="cuda")
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                    allow_tf32=False):
        before = stft_kernel.launches, istft_kernel.launches
        got = denoise_waveform_sharded(model, wav, mesh)
        assert (stft_kernel.launches - before[0], istft_kernel.launches - before[1]) == (1, 1)
        with torch.no_grad():
            mag, phase = stft_lib.magphase(stft_lib.stft(wav, precision="kernel"))
            den = reference_padded_forward(model, mag)
            want = stft_lib.istft(den.clamp_min(0.0) * phase, 128, n_fft=512,
                                  length=wav.shape[-1], precision="kernel")
    assert got.shape == wav.shape
    assert float((got - want).norm() / want.norm()) <= 1e-5


MP_CONFIG = dict(dense_channel=64, num_tsconformers=4, n_fft=400, hop_length=100,
                 win_length=400, sample_rate=16000, compress_factor=0.3, beta=2.0, n_head=4,
                 conv_kernel=31, ffn_mult=4, conv_expansion=2)


@pytest.mark.parametrize("batch,samples", [(32, 160000), (3, 8000)])
def test_direct_entries_at_mpsenet_shape_match_torch_stft(dev, batch, samples):
    """K1 and K2 at n_fft 400 / hop 100 (their direct entries), with reflect
    centre padding, against ``torch.stft``/``torch.istft``: MP-SENet's
    transforms at the 10 s cell's shape and at 0.5 s."""
    from audiodenoiser_torch.dsp import stft as stft_lib
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel, variant_launches

    rng = np.random.default_rng(batch)
    x = torch.from_numpy((0.3 * rng.standard_normal((batch, samples))).astype(np.float32)).to(dev)
    w = torch.hann_window(400, periodic=True, device=dev)
    before = variant_launches(stft_kernel)["direct"], variant_launches(istft_kernel)["direct"]
    ours = stft_lib.stft(x, 400, 100, center=True, pad_mode="reflect", precision="kernel")
    ref = torch.stft(x, 400, 100, window=w, center=True, pad_mode="reflect",
                     return_complex=True)
    back = stft_lib.istft(ref, 100, n_fft=400, center=True, length=samples, precision="kernel")
    want = torch.istft(ref, 400, 100, window=w, center=True, length=samples)
    torch.cuda.synchronize()
    assert (variant_launches(stft_kernel)["direct"] - before[0],
            variant_launches(istft_kernel)["direct"] - before[1]) == (1, 1)
    assert ours.shape == ref.shape == (batch, 201, samples // 100 + 1)
    assert _max_rel(torch.view_as_real(ours), torch.view_as_real(ref)) < 1e-5
    assert _max_rel(back, want) < 1e-5


def _mp_case(dev, seed: int, rows: int, seconds: float):
    """Seeded, calibrated reference weights and ``rows`` clips of noisy
    harmonics, on the card."""
    from benchmark.reference import mpsenet as ref

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = ref.seeded_weights(MP_CONFIG, gen, dev)
    n = int(seconds * 16000)
    t = torch.arange(n, device=dev) / 16000
    f0 = 90 + 170 * torch.rand((rows + 4, 1), generator=gen, device=dev)
    clean = sum(torch.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 6))
    audio = 0.2 * (clean + 0.5 * torch.randn(clean.shape, generator=gen, device=dev))
    with _no_tf32():
        ref.calibrate(p, MP_CONFIG, audio[rows:, :16000])
    return p, audio[:rows]


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for matmuls and cuDNN inside the block, as the reference needs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mpsenet_runner_on_card_matches_the_reference(dev, dtype):
    """MP-SENet on the card against the float32 reference (TF32 off), on 2
    clips of 10 s. The model alone, on the reference's own magnitude and
    phase: float32 within 1e-4 (spectrum relative L2). Through
    ``DenoiserRunner`` (K1/K2 direct, SDPA, cuDNN), the waveform: float32
    within 1e-3 in each clip whose input phase plane agrees with the
    reference's; bfloat16 with the root mean square of the clips' errors
    under the cell's limit (``benchmark/limits/mpsenet2m.dns10s.json``).

    The published phase, ``atan2(im + 1e-10, re + 1e-5)``, jumps by 2 pi
    across the real line left of -1e-5, and by pi at -1e-5 on it (the DC
    and Nyquist bins, whose imaginary parts are 0): a bin that rounding
    puts on either side (a DC bin near -1e-5 in this case) reaches the
    network pi or 2 pi apart from two correct STFTs, and its clip moves by
    about 1%. Such a clip is left out of the waveform bound, and each bin
    whose phases lie more than 1 rad apart has to lie within rounding of
    that cut in the reference's spectrum."""
    import json
    from pathlib import Path

    from benchmark.reference import mpsenet as ref

    from audiodenoiser_torch.dsp import stft as stft_lib
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models.mpsenet import MPSENet, mag_pha

    p, audio = _mp_case(dev, 19, 2, 10.0)
    model = MPSENet().to(dev)
    model.load_state_dict(p)
    model = model.to(dtype).eval()
    with _no_tf32(), torch.no_grad():
        x = audio * ref.norm_factor(audio)
        mag, pha = ref.mag_pha_stft(x, MP_CONFIG)
        spec = torch.stft(x, 400, 100, window=torch.hann_window(400, device=dev),
                          center=True, pad_mode="reflect", return_complex=True)
        _, pha_port = mag_pha(stft_lib.stft(x, 400, 100, center=True, pad_mode="reflect",
                                            precision="kernel"), 400, 400)
        got_c, got_p = model(mag, pha)
        want_c, want_p = ref.forward(p, MP_CONFIG, mag, pha)
        got = DenoiserRunner(model, device=dev).denoise_audio(audio)
        want = ref.denoise(p, MP_CONFIG, audio)
    got_s = torch.polar(got_c.pow(1 / 0.3), got_p)
    want_s = torch.polar(want_c.pow(1 / 0.3), want_p)
    model_err = ((got_s - want_s).abs().square().sum((1, 2))
                 / want_s.abs().square().sum((1, 2))).sqrt()
    wave_err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    flipped = (pha_port - pha).abs() > 1.0
    print(f"[mpsenet] {dtype}: model {model_err.tolist()}, waveform {wave_err.tolist()}, "
          f"flipped input bins {flipped.nonzero().tolist()}")
    if dtype == torch.float32:
        assert float(model_err.max()) < 1e-4
        for b, f, t in flipped.nonzero().tolist():
            s, tol = spec[b, f, t], 1e-5 * float(spec[b].abs().max())
            assert float(s.real) + 1e-5 < tol and abs(float(s.imag)) < tol, (b, f, t, s)
        kept = ~flipped.flatten(1).any(1)
        assert bool(kept.any()) and float(wave_err[kept].max()) < 1e-3
    else:
        limits = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "limits"
                             / "mpsenet2m.dns10s.json").read_text())
        assert float(wave_err.square().mean().sqrt()) < limits["rms_rel_err"]


def test_mpsenet_attention_takes_a_fused_sdpa_kernel(dev):
    """The time attention at the cell's shape (32 clips of 10 s: 3,200
    sequences of 1,601 frames, 4 heads of 16) in bf16 runs through a fused
    SDPA kernel: no (N, 4, 1601, 1601) score tensor, which would take
    65.6 GB, is made."""
    from torch.profiler import ProfilerActivity, profile

    from audiodenoiser_torch.models.mpsenet import MultiheadAttention

    attn = MultiheadAttention(64, 4).to(dev, torch.bfloat16)
    x = torch.randn((3200, 1601, 64), device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        attn(x)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            attn(x)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    print(f"[mpsenet] attention kernels: {names}")
    assert any("flash" in n.lower() or "fmha" in n.lower() or "attention" in n.lower()
               for n in names), names
    assert torch.cuda.max_memory_allocated() - base < 4 * 2 ** 30


def _bf16_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of one bf16 ulp of the pair's larger
    magnitude plus 2**-20 of ``want``'s largest (16 float32 roundings): the
    float32 value both sides round once can cancel to near 0, where the
    kernel's fused multiply-add and the plain version's separate products
    differ by float32 rounding (an output of 1.5e-8 against an exact 0 is
    252 bf16 ulps), not by bf16's."""
    got, want = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    unit = torch.ldexp(torch.ones_like(got), e - 8) + 2.0 ** -20 * want.abs().max()
    return float(((got - want).abs() / unit).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (3200, 1601, 64),   # the MP-SENet cell's time half: 5,123,200 rows
    (1_000_003, 8),     # ragged row counts past one pass of the grid
    (1_000_003, 64),
    (100_003, 512),
    (1001, 24),         # widths whose last lanes are masked
    (4099, 264),
], ids=["cell", "ragged8", "ragged64", "ragged512", "masked24", "masked264"])
def test_layer_norm_kernel_matches_plain(dev, dtype, shape):
    """The row LayerNorm against its plain version on rows with means far
    from 0 and non-trivial weight and bias: bf16 within one ulp (both round
    a float32 result once) beside float32's rounding (``_bf16_gap``),
    float32 within 1e-5 of the largest output."""
    from audiodenoiser_torch.ops.cuda import layer_norm_kernel, layer_norm_plain, variant_launches

    c = shape[-1]
    gen = torch.Generator(device=dev).manual_seed(c)
    x = (torch.randn(shape, generator=gen, device=dev) * 3
         + 5 * torch.randn(shape[:-1] + (1,), generator=gen, device=dev)).to(dtype)
    w = (1 + 0.5 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    b = (0.3 * torch.randn(c, generator=gen, device=dev)).to(dtype)
    before = variant_launches(layer_norm_kernel)["kernel"]
    with torch.inference_mode():
        got = layer_norm_kernel(x, w, b, 1e-5)
        want = layer_norm_plain(x, w, b, 1e-5)
    torch.cuda.synchronize()
    assert variant_launches(layer_norm_kernel)["kernel"] == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    if dtype == torch.float32:
        assert _max_rel(got, want) <= 1e-5
    else:
        assert _bf16_gap(got, want) <= 1.0


def test_mpsenet_forward_takes_the_layer_norm_kernel_40_times(dev):
    from audiodenoiser_torch.models.mpsenet import MPSENet
    from audiodenoiser_torch.ops.cuda import layer_norm_kernel, reset_launch_counts, variant_launches

    torch.manual_seed(0)
    model = MPSENet().to(dev, torch.bfloat16).eval()
    mag, pha = torch.rand((2, 201, 50), device=dev), torch.rand((2, 201, 50), device=dev)
    reset_launch_counts()
    with torch.inference_mode():
        model(mag, pha)
    torch.cuda.synchronize()
    assert layer_norm_kernel.launches == 40
    assert variant_launches(layer_norm_kernel) == {"kernel": 40, "plain": 0}


def test_layer_norm_kernel_rejects_what_it_does_not_take(dev):
    from audiodenoiser_torch.ops.cuda import layer_norm_kernel

    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    half = torch.zeros(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        layer_norm_kernel(half, w.half(), b.half())
    with pytest.raises(TypeError):  # weights in another dtype than the input
        layer_norm_kernel(torch.zeros(4, 64, device=dev, dtype=torch.bfloat16), w, b)
    for c in (60, 520):
        with pytest.raises(ValueError):
            layer_norm_kernel(torch.zeros(4, c, device=dev), torch.ones(c, device=dev),
                              torch.zeros(c, device=dev))
    with pytest.raises(ValueError):
        layer_norm_kernel(torch.zeros(4, 128, device=dev)[:, ::2], w, b)
    with pytest.raises(RuntimeError):
        layer_norm_kernel(torch.zeros(4, 64, device=dev, requires_grad=True), w, b)
    with pytest.raises(RuntimeError):
        layer_norm_kernel(torch.zeros(4, 64, device=dev), torch.nn.Parameter(w), b)


def _conv_module_case(dev, dtype, n: int, length: int, seed: int, c: int = 128):
    """h (n, length, 2C) and the depthwise and BatchNorm parameters in
    ``dtype`` on the card, the running statistics far from (0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    h = rand(n, length, 2 * c, scale=2.0)
    var = (0.3 + torch.rand(c, generator=gen, device=dev)).to(dtype)
    return h, (rand(c, 1, 31, scale=0.2), rand(c, scale=0.1), rand(c, scale=0.3, shift=1.0),
               rand(c, scale=0.2), rand(c, scale=0.5), var)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,length", [
    (400, 1601),    # the time conformer's sequences (the cell has 3,200)
    (6000, 100),    # the frequency conformer's (the cell has 51,232)
    (2000, 1), (700, 16), (500, 31),   # a tile of 16, 8 and 5 whole sequences
    (90, 1608),     # 1,601 + 7: tiles that straddle sequences at other offsets
], ids=["time", "freq", "len1", "len16", "len31", "len1608"])
def test_conv_module_kernel_matches_plain(dev, dtype, n, length):
    """The conv module's kernel against its plain version: bf16 within one
    ulp (both round a float32 result once) beside float32's rounding
    (``_bf16_gap``); float32 within 1e-5 of the largest output (the
    kernel's ``expf`` and FMA-rounded sums against PyTorch's exp and
    separate products). The output's block is first filled with NaN, in a
    pool of its own so that the output gets that block: every output,
    those beside each sequence's edges too, must be written."""
    from audiodenoiser_torch.ops.cuda import conv_module_kernel, conv_module_plain, variant_launches

    h, params = _conv_module_case(dev, dtype, n, length, length)
    with torch.inference_mode():
        want = conv_module_plain(h, *params, 1e-5)
        pool = torch.cuda.MemPool()
        with torch.cuda.use_mem_pool(pool):
            poison = torch.full((n * length * 128,), float("nan"), device=dev, dtype=dtype)
            block = poison.data_ptr()
            del poison
            before = variant_launches(conv_module_kernel)["kernel"]
            got = conv_module_kernel(h, *params, 1e-5)
    torch.cuda.synchronize()
    assert variant_launches(conv_module_kernel)["kernel"] == before + 1
    assert got.data_ptr() == block and not torch.isnan(got).any()
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    if dtype == torch.float32:
        assert _max_rel(got, want) <= 1e-5
    else:
        assert _bf16_gap(got, want) <= 1.0


def test_mpsenet_forward_takes_the_conv_module_kernel_8_times(dev):
    from audiodenoiser_torch.models.mpsenet import MPSENet
    from audiodenoiser_torch.ops.cuda import conv_module_kernel, reset_launch_counts, variant_launches

    torch.manual_seed(0)
    model = MPSENet().to(dev, torch.bfloat16).eval()
    mag, pha = torch.rand((2, 201, 50), device=dev), torch.rand((2, 201, 50), device=dev)
    reset_launch_counts()
    with torch.inference_mode():
        model(mag, pha)
    torch.cuda.synchronize()
    assert conv_module_kernel.launches == 8
    assert variant_launches(conv_module_kernel) == {"kernel": 8, "plain": 0}


def test_conv_module_kernel_rejects_what_it_does_not_take(dev):
    from audiodenoiser_torch.ops.cuda import conv_module_kernel

    h, params = _conv_module_case(dev, torch.float32, 2, 20, 0)
    with pytest.raises(TypeError):
        conv_module_kernel(h.half(), *(p.half() for p in params))
    with pytest.raises(TypeError):  # parameters in another dtype than the input
        conv_module_kernel(h.bfloat16(), *params)
    with pytest.raises(ValueError):  # parameters on another device
        conv_module_kernel(h, params[0].cpu(), *params[1:])
    with pytest.raises(ValueError):  # C = 12, not a multiple of 8
        conv_module_kernel(h[..., :24].contiguous(), params[0][:12].contiguous(),
                           *(p[:12].contiguous() for p in params[1:]))
    with pytest.raises(ValueError):  # kernel size 15
        conv_module_kernel(h, params[0][..., :15].contiguous(), *params[1:])
    with pytest.raises(ValueError):  # a non-contiguous input
        conv_module_kernel(h.transpose(0, 1), *params)
    with pytest.raises(ValueError):  # a misaligned input
        conv_module_kernel(h.flatten()[2:2 + 2 * 19 * 256].view(2, 19, 256), *params)
    with pytest.raises(RuntimeError):
        conv_module_kernel(h.clone().requires_grad_(), *params)
    with pytest.raises(RuntimeError):
        conv_module_kernel(h, torch.nn.Parameter(params[0]), *params[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_conv_module_kernel_runs_on_each_card(dev, dtype):
    """The kernel opts in to its shared memory on every card it meets:
    launches on the first card, the second and the first again, each made
    while card 0 is the current one, match the plain version on their own
    card. The comparison runs with the launch's card current: with card 0
    current, ``_bf16_gap`` on card 1's tensors (its frexp and ldexp) ended
    in an illegal address (torch 2.11 on H100s), and the kernel's output
    alone read the same as the plain version's there."""
    from audiodenoiser_torch.ops.cuda import conv_module_kernel, conv_module_plain

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for index in (0, 1, 0):
        card = torch.device("cuda", index)
        h, params = _conv_module_case(card, dtype, 40, 100, index)
        with torch.inference_mode():
            got = conv_module_kernel(h, *params, 1e-5)
            want = conv_module_plain(h, *params, 1e-5)
        torch.cuda.synchronize(card)
        assert got.device == card
        with torch.cuda.device(card):
            if dtype == torch.float32:
                assert _max_rel(got, want) <= 1e-5
            else:
                assert _bf16_gap(got, want) <= 1.0


SM_CONFIG = dict(dense_channel=64, num_tfmamba=4, d_state=16, d_conv=4, expand=4, n_fft=400,
                 hop_length=100, win_length=400, sample_rate=16000, compress_factor=0.3, beta=2.0,
                 norm_eps=1e-5)


def _ssm_case(dev, dtype, n: int, length: int, seed: int, d: int = 256):
    """xz (n, length, 2d), the conv's parameters, x_proj and the scan's
    parameters in ``dtype`` on ``dev``, at mamba_ssm's initial distributions
    (the reference's seeded weights)."""
    import math

    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(shape, generator=gen, device=dev)

    dt = torch.exp(torch.rand(d, generator=gen, device=dev) * math.log(100.0) + math.log(1e-3))
    states = torch.arange(1, 17, device=dev, dtype=torch.float32)
    scan = ((torch.rand((d, 4), generator=gen, device=dev) * 2 - 1) * 0.5,
            dt + torch.log(-torch.expm1(-dt)), torch.log(states) + rand(d, 16, scale=0.1),
            rand(d, scale=0.1, shift=1.0))
    conv = (rand(d, 1, 4, scale=math.sqrt(0.5)), rand(d, scale=0.1))
    return (rand(n, length, 2 * d).to(dtype), tuple(t.to(dtype) for t in conv),
            rand(36, d, scale=math.sqrt(2 / d)).to(dtype), tuple(t.to(dtype) for t in scan))


def _into_nan(entry: str, inputs: tuple, like: torch.Tensor, reverse: bool) -> torch.Tensor:
    """The entry's kernel launched straight through its C interface into an
    output first filled with NaN: every output the kernel owes has to be
    written. ``inputs`` are the entry's tensors in the order of its C
    arguments; ``like`` the output's shape and dtype."""
    from audiodenoiser_torch.ops.cuda import build
    from audiodenoiser_torch.ops.cuda import ssm as ssm_ops

    out = torch.full_like(like, float("nan"))
    n, length, d = out.numel() // (out.shape[-2] * out.shape[-1]), out.shape[-2], out.shape[-1]
    launch = getattr(ssm_ops._lib(), f"ssm_{entry}_launch")
    rc = launch(*(t.data_ptr() for t in inputs), out.data_ptr(), int(out.dtype == torch.bfloat16),
                n, length, d, int(reverse), build.stream_handle(out.device))
    assert rc == 0
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("dtype,n,length,d", [
    (torch.bfloat16, 3200, 1601, 256),   # the SEMamba cell's time axis: 3,200 sequences
    (torch.bfloat16, 51232, 100, 256),   # ... and its frequency axis: 51,232
    (torch.float32, 200, 1601, 256),
    (torch.float32, 3000, 100, 256),
    (torch.bfloat16, 300, 1, 256),       # one token
    (torch.bfloat16, 70, 37, 72),        # a chunk and a run cut short, channels masked
], ids=["time", "freq", "time_f32", "freq_f32", "len1", "ragged"])
def test_ssm_kernels_match_plain(dev, dtype, n, length, d, reverse):
    """Both entries against their plain versions (float32, the scan one
    token a step), and launched again into outputs filled with NaN, which
    they must overwrite with the same values: bf16 within one ulp
    beside float32's rounding (``_bf16_gap``: both round a float32 result
    once); float32 within 1e-5 of the largest output (the SFU's ex2 and
    reciprocal, 2 and 1 ulps, against PyTorch's exp, over 1,601 steps:
    7.4e-7 read)."""
    from audiodenoiser_torch.ops.cuda import (
        ssm_conv,
        ssm_conv_plain,
        ssm_kernel,
        ssm_scan,
        ssm_scan_plain,
        variant_launches,
    )

    xz, conv, x_proj, scan = _ssm_case(dev, dtype, n, length, n + length, d)
    before = variant_launches(ssm_kernel)["kernel"]
    with torch.inference_mode():
        u = ssm_conv(xz, *conv, reverse)
        want_u = ssm_conv_plain(xz, *conv, reverse)
        x_dbl = torch.nn.functional.linear(u, x_proj)
        y = ssm_scan(u, xz, x_dbl, *scan, reverse)
        assert variant_launches(ssm_kernel)["kernel"] == before + 2
        assert torch.equal(_into_nan("conv", (xz, *conv), u, reverse), u)
        assert torch.equal(_into_nan("scan", (u, xz, x_dbl, *scan), y, reverse), y)
        want_y = ssm_scan_plain(u, xz, x_dbl, *scan, reverse)
    for got, want in ((u, want_u), (y, want_y)):
        assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
        if dtype == torch.float32:
            assert _max_rel(got, want) <= 1e-5
        else:
            assert _bf16_gap(got, want) <= 1.0


def test_semamba_forward_takes_the_ssm_kernel_32_times(dev):
    """16 conv and 16 scan launches a bf16 forward, none plain; the
    MP-SENet kernels none."""
    from audiodenoiser_torch.models.semamba import SEMamba
    from audiodenoiser_torch.ops.cuda import (
        conv_module_kernel,
        layer_norm_kernel,
        reset_launch_counts,
        ssm_kernel,
        variant_launches,
    )

    torch.manual_seed(0)
    model = SEMamba().to(dev, torch.bfloat16).eval()
    mag, pha = torch.rand((2, 201, 50), device=dev), torch.rand((2, 201, 50), device=dev)
    reset_launch_counts()
    with torch.inference_mode():
        model(mag, pha)
    torch.cuda.synchronize()
    assert ssm_kernel.launches == 32
    assert variant_launches(ssm_kernel) == {"kernel": 32, "plain": 0}
    assert layer_norm_kernel.launches == conv_module_kernel.launches == 0


def test_ssm_kernels_reject_what_they_do_not_take(dev):
    from audiodenoiser_torch.ops.cuda import ssm_conv, ssm_scan

    xz, conv, x_proj, scan = _ssm_case(dev, torch.float32, 4, 20, 0, d=64)
    with torch.no_grad():
        u = ssm_conv(xz, *conv)
        x_dbl = torch.nn.functional.linear(u, x_proj)
    with pytest.raises(TypeError):
        ssm_conv(xz.half(), *(t.half() for t in conv))
    with pytest.raises(TypeError):  # parameters in another dtype than the input
        ssm_conv(xz.bfloat16(), *conv)
    with pytest.raises(TypeError):
        ssm_scan(u.bfloat16(), xz.bfloat16(), x_dbl.bfloat16(), *scan)
    with pytest.raises(ValueError):  # parameters on another device
        ssm_scan(u, xz, x_dbl, scan[0].cpu(), *scan[1:])
    with pytest.raises(ValueError):  # D = 12, not a multiple of 8
        ssm_conv(xz[..., :24].contiguous(), conv[0][:12].contiguous(), conv[1][:12].contiguous())
    with pytest.raises(ValueError):  # kernel size 3
        ssm_conv(xz, conv[0][..., :3].contiguous(), conv[1])
    with pytest.raises(ValueError):  # 8 states
        ssm_scan(u, xz, torch.cat([x_dbl[..., :12], x_dbl[..., 20:28]], -1).contiguous(),
                 scan[0], scan[1], scan[2][:, :8].contiguous(), scan[3])
    with pytest.raises(ValueError):  # a non-contiguous input
        ssm_conv(xz.transpose(0, 1), *conv)
    with pytest.raises(ValueError):  # a misaligned input
        ssm_conv(xz.flatten()[2:2 + 4 * 19 * 128].view(4, 19, 128), *conv)
    with pytest.raises(RuntimeError):
        ssm_conv(xz.clone().requires_grad_(), *conv)
    with pytest.raises(RuntimeError):
        ssm_scan(u, xz, x_dbl, torch.nn.Parameter(scan[0]), *scan[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssm_kernels_run_on_each_card(dev, dtype):
    """Launches on the first card, the second and the first again, each
    while card 0 is the current one, match the plain versions on their own
    card (compared with that card current)."""
    from audiodenoiser_torch.ops.cuda import ssm_conv, ssm_conv_plain, ssm_scan, ssm_scan_plain

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for index in (0, 1, 0):
        card = torch.device("cuda", index)
        xz, conv, x_proj, scan = _ssm_case(card, dtype, 40, 100, index)
        with torch.inference_mode():
            u = ssm_conv(xz, *conv, True)
            x_dbl = torch.nn.functional.linear(u, x_proj)
            y = ssm_scan(u, xz, x_dbl, *scan, True)
            want_u = ssm_conv_plain(xz, *conv, True)
            want_y = ssm_scan_plain(u, xz, x_dbl, *scan, True)
        torch.cuda.synchronize(card)
        assert u.device == y.device == card
        with torch.cuda.device(card):
            for got, want in ((u, want_u), (y, want_y)):
                if dtype == torch.float32:
                    assert _max_rel(got, want) <= 1e-5
                else:
                    assert _bf16_gap(got, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_semamba_runner_on_card_matches_the_reference(dev, dtype):
    """SEMamba on the card against the float32 reference (TF32 off), on 2
    clips of 10 s. The model alone, on the reference's own magnitude and
    phase: float32 within 1e-4 (spectrum relative L2). Through
    ``DenoiserRunner`` (K1/K2 direct, the ssm kernels), the waveform:
    float32 within 1e-3 in each clip whose input phase plane agrees with
    the reference's (the published phase's cut, as in the MP-SENet test
    above); bfloat16 with the root mean square of the clips' errors under
    the cell's limit (``benchmark/limits/semamba2m.dns10s.json``)."""
    import json
    from pathlib import Path

    from benchmark.reference import semamba as ref

    from audiodenoiser_torch.dsp import stft as stft_lib
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models.mpsenet import mag_pha
    from audiodenoiser_torch.models.semamba import SEMamba

    gen = torch.Generator(device=dev).manual_seed(23)
    p = ref.seeded_weights(SM_CONFIG, gen, dev)
    n = 160000
    t = torch.arange(n, device=dev) / 16000
    f0 = 90 + 170 * torch.rand((2, 1), generator=gen, device=dev)
    clean = sum(torch.sin(2 * np.pi * h * f0 * t) / h for h in range(1, 6))
    audio = 0.2 * (clean + 0.5 * torch.randn(clean.shape, generator=gen, device=dev))
    model = SEMamba().to(dev)
    model.load_state_dict(p)
    model = model.to(dtype).eval()
    with _no_tf32(), torch.inference_mode():
        x = audio * ref.mp.norm_factor(audio)
        mag, pha = ref.mp.mag_pha_stft(x, SM_CONFIG)
        _, pha_port = mag_pha(stft_lib.stft(x, 400, 100, center=True, pad_mode="reflect",
                                            precision="kernel"), 400, 400)
        got_c, got_p = model(mag, pha)
        want_c, want_p = ref.forward(p, SM_CONFIG, mag, pha)
        got = DenoiserRunner(model, device=dev).denoise_audio(audio)
        want = ref.denoise(p, SM_CONFIG, audio)
    got_s = torch.polar(got_c.pow(1 / 0.3), got_p)
    want_s = torch.polar(want_c.pow(1 / 0.3), want_p)
    model_err = ((got_s - want_s).abs().square().sum((1, 2))
                 / want_s.abs().square().sum((1, 2))).sqrt()
    wave_err = (got - want).norm(dim=-1) / want.norm(dim=-1)
    flipped = (pha_port - pha).abs() > 1.0
    print(f"[semamba] {dtype}: model {model_err.tolist()}, waveform {wave_err.tolist()}, "
          f"flipped input bins {flipped.nonzero().tolist()}")
    if dtype == torch.float32:
        assert float(model_err.max()) < 1e-4
        kept = ~flipped.flatten(1).any(1)
        assert bool(kept.any()) and float(wave_err[kept].max()) < 1e-3
    else:
        limits = json.loads((Path(__file__).resolve().parents[1] / "benchmark" / "limits"
                             / "semamba2m.dns10s.json").read_text())
        assert float(wave_err.square().mean().sqrt()) < limits["rms_rel_err"]


# --- the complex-mask step's CUDA graph (train.step_graph) ---------------------------------

GRAPH_WIDTHS = dict(features=(16, 32), bottleneck=64)


def _graph_state(dev, **opt):
    """A bf16 residual mask model, as the deployment trains it, at two
    levels, from one seeded weight tree, with its optimizer on the card."""
    from audiodenoiser_torch.models import ComplexMaskUNet, random_flax_variables
    from audiodenoiser_torch.train.mask import create_mask_train_state

    v = random_flax_variables(5, **GRAPH_WIDTHS, in_channels=3, out_channels=2)
    model = ComplexMaskUNet(dtype=torch.bfloat16, mask_bound=8.0, residual=True,
                            **GRAPH_WIDTHS)
    return create_mask_train_state(0, model, variables=v, device=dev, **opt)


def _graph_batches(dev, n, batch=4, seed=0):
    """``n`` (noisy, clean) batches of 2 s from the ``mixed`` mixer on the card."""
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips

    bank = NoiseBank(synth_noise_clips(4, seed + 1), device=dev)
    mixer = OnDeviceMixer(synth_chunks(16, seed), "mixed", noise_bank=bank, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [mixer.sample_audio(gen, batch) for _ in range(n)]


def _graph_counts_since(before):
    from audiodenoiser_torch.ops.cuda import variant_launches
    from audiodenoiser_torch.train import step_graph

    return {k: v - before[k] for k, v in variant_launches(step_graph.counts).items()
            if v != before[k]}


def _states_equal(a, b) -> None:
    """Parameters, BatchNorm statistics and ``num_batches_tracked``, and
    AdamW's moments and step counts, bit for bit."""
    for (n, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for p, q in zip(a.optimizer.params, b.optimizer.params):
        sa, sb = a.optimizer.adamw.state[p], b.optimizer.adamw.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), key


@pytest.fixture
def deterministic():
    """cuDNN's deterministic kernels, so that two runs of one step agree
    bit for bit (its default backward weight gradients sum in any order)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        yield


def test_mask_step_graph_matches_the_eager_step(dev, deterministic):
    """Six steps of one batch stream through the graph (a warm-up, a
    capture, four replays) and through the eager step on a capturable
    optimizer: every step's losses and gradient norm, and then the
    parameters, BatchNorm statistics and AdamW's moments, bit-equal; K1
    and K2 counted 2 and 1 a step; what a step returned unchanged by later
    replays. Against the eager step on the non-capturable optimizer that
    an eager caller gets, the first step is bit-equal and the later ones
    part by AdamW's bias-correction rounding (printed)."""
    from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel, variant_launches
    from audiodenoiser_torch.train import step_graph
    from audiodenoiser_torch.train.mask import make_mask_steps

    batches = _graph_batches(dev, 6)
    train_step, _ = make_mask_steps(0.5, 30.0)
    graph, eager, plain = _graph_state(dev), _graph_state(dev), _graph_state(dev)
    eager.optimizer.make_capturable()
    before = variant_launches(step_graph.counts)
    kept = []
    for k, (noisy, clean) in enumerate(batches):
        launches = stft_kernel.launches, istft_kernel.launches
        _, got = train_step(graph, noisy, clean)
        assert (stft_kernel.launches - launches[0], istft_kernel.launches - launches[1]) == (2, 1)
        _, want = train_step.step(eager, noisy, clean)
        _, base = train_step.step(plain, noisy, clean)
        for a, b in zip(got, want):
            assert torch.equal(a, b), k
        assert torch.equal(graph.grad_norm, eager.grad_norm), k
        if k == 0:
            assert all(torch.equal(a, b) for a, b in zip(got, base))
        gaps = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(got, base)]
        print(f"[step graph] step {k}: losses {[float(x) for x in got]}, relative gaps to the "
              f"non-capturable eager step {gaps}")
        kept.append((got, graph.grad_norm, [float(x) for x in got], float(graph.grad_norm)))
    assert _graph_counts_since(before) == {"eager_warmup": 1, "capture": 1, "replay": 4}
    for got, norm, values, norm_value in kept:
        assert [float(x) for x in got] == values and float(norm) == norm_value
    assert graph.step == eager.step == 6
    assert graph.optimizer.updates == eager.optimizer.updates == 6
    _states_equal(graph, eager)
    for p, q in zip(graph.optimizer.params, eager.optimizer.params):
        assert p.grad is not None and torch.equal(p.grad, q.grad)
    worst = max(float((p - q).abs().max() / q.abs().max().clamp_min(1e-30))
                for p, q in zip(graph.optimizer.params, plain.optimizer.params))
    print(f"[step graph] the parameters after 6 steps against the non-capturable eager "
          f"step's: worst relative max gap {worst:.3e}")


def test_mask_step_graph_follows_a_schedule(dev, deterministic):
    """Warm-up and cosine decay over eight updates: the rate tensor holds
    each update's rate when it replays, and the run stays bit-equal to the
    eager step on a capturable optimizer; the resume state is the eager
    form."""
    from audiodenoiser_torch.train.mask import make_mask_steps

    batches = _graph_batches(dev, 8, seed=3)
    train_step, _ = make_mask_steps(0.5, 30.0)
    kw = dict(schedule="cosine", warmup_steps=2, total_steps=8)
    graph, eager = _graph_state(dev, **kw), _graph_state(dev, **kw)
    eager.optimizer.make_capturable()
    opt = graph.optimizer
    for noisy, clean in batches:
        rate = opt.schedule(opt.updates)
        train_step(graph, noisy, clean)
        train_step.step(eager, noisy, clean)
        assert float(opt.adamw.param_groups[0]["lr"]) == float(
            torch.tensor(rate, dtype=torch.float32))
        assert opt.state_dict()["adamw"]["param_groups"][0]["lr"] == rate
    _states_equal(graph, eager)
    sd = opt.state_dict()["adamw"]
    assert not sd["param_groups"][0]["capturable"]
    assert all(st["step"].device.type == "cpu" for st in sd["state"].values())


def test_mask_step_graph_runs_eagerly_where_it_must(dev):
    """A forward hook, a teacher and accumulation run eagerly, each under
    its reason; a new batch shape warms up and captures anew while the old
    shape's graph still replays; a hook that fired in an eager step fires
    there and not in a replay."""
    from audiodenoiser_torch.models import ComplexMaskUNet
    from audiodenoiser_torch.ops.cuda import variant_launches
    from audiodenoiser_torch.train import step_graph
    from audiodenoiser_torch.train.mask import make_mask_steps

    (b4, b4b), (b2, b2b) = _graph_batches(dev, 2), _graph_batches(dev, 2, batch=2, seed=1)
    train_step, _ = make_mask_steps(0.5, 30.0)
    state = _graph_state(dev)
    before = variant_launches(step_graph.counts)
    train_step(state, *b4)
    train_step(state, *b4b)
    fired = []
    handle = state.model.bottleneck.register_forward_hook(lambda *_: fired.append(1))
    train_step(state, *b4)
    handle.remove()
    assert fired == [1]
    train_step(state, *b4b)
    train_step(state, *b2)
    train_step(state, *b2b)
    train_step(state, *b4)
    train_step(state, *b2)
    assert fired == [1] and state.step == 8
    assert _graph_counts_since(before) == {"eager_warmup": 2, "capture": 2, "replay": 3,
                                           "eager_hook": 1}
    teacher = ComplexMaskUNet(dtype=torch.bfloat16, mask_bound=8.0, residual=True,
                              **GRAPH_WIDTHS).to(dev)
    distilled, _ = make_mask_steps(0.5, 30.0, teacher=teacher, distill_weight=0.5)
    accum = _graph_state(dev, grad_accum=2)
    before = variant_launches(step_graph.counts)
    for _ in range(2):
        distilled(state, *b4)
        train_step(accum, *b4)
    assert _graph_counts_since(before) == {"eager_teacher": 2, "eager_grad_accum": 2}
    assert accum.optimizer.updates == 1 and not accum.optimizer.graphs


def test_mixed_batches_and_replays_never_wait_for_the_device(dev):
    """Once warm, drawing a ``mixed`` batch and replaying the step make no
    host synchronisation, so the host queues the next step while the
    device runs this one (a host copy at every call, as the mixer's SNR
    level and reverb response once were, waits for the queued work)."""
    from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
    from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips
    from audiodenoiser_torch.train import step_graph
    from audiodenoiser_torch.train.mask import make_mask_steps

    bank = NoiseBank(synth_noise_clips(4, 1), device=dev)
    mixer = OnDeviceMixer(synth_chunks(16, 0), "mixed", noise_bank=bank, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    train_step, _ = make_mask_steps(0.5, 30.0)
    state = _graph_state(dev)
    for _ in range(3):  # a warm-up, a capture and a replay
        train_step(state, *mixer.sample_audio(gen, 4))
    torch.cuda.synchronize()
    replays = step_graph.counts.replay_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            train_step(state, *mixer.sample_audio(gen, 4))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert step_graph.counts.replay_launches - replays == 3
    assert bool(torch.isfinite(state.grad_norm))


def test_mask_step_graph_replay_is_one_span_the_profiler_sees(dev):
    """Under the CUDA profiler a replay is one ``adt.step_graph`` range and
    none of the eager phases, and the device runs the graph's kernels (the
    traced benchmark reads its idle share from them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audiodenoiser_torch.train.mask import make_mask_steps
    from audiodenoiser_torch.utils.profiling import FORWARD, STEP_GRAPH

    batches = _graph_batches(dev, 3)
    train_step, _ = make_mask_steps(0.5, 30.0)
    state = _graph_state(dev)
    for noisy, clean in batches[:2]:
        train_step(state, noisy, clean)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(state, *batches[2])
        torch.cuda.synchronize()
    events = prof.events()
    names = [e.name for e in events if e.device_type != DeviceType.CUDA]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    print(f"[step graph] a replay under the profiler: {len(kernels)} device operations, "
          f"{sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3:.3f} ms")
    assert names.count(STEP_GRAPH) == 1 and FORWARD not in names
    assert len(kernels) > 200
