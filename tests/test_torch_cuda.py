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
    from audiodenoiser_torch.train.bench import synth_chunks

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
    from audiodenoiser_torch.train.bench import synth_chunks
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


def test_build_train_dataset_on_card_matches_cpu(dev, tmp_path):
    """``build_train_dataset`` on the card (K1 uncentred, twice a batch and
    noise type, through its FFT entry) against the CPU's plain version from
    the same wavs: the clean magnitudes and the reverb files (no draws)
    within 1e-5 of max |CPU|; every file set and shape equal."""
    import os

    from audiodenoiser_torch.data.builders import build_train_dataset
    from audiodenoiser_torch.data.wav_io import write_wav
    from audiodenoiser_torch.ops.cuda import reset_launch_counts, stft_kernel, variant_launches
    from audiodenoiser_torch.train.bench import synth_chunks

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
