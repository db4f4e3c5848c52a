"""K2's wrapper logic on the CPU: which library entry a shape takes, how
many frames a block of the FFT entry computes, a numpy model of the FFT
entry's arithmetic (the Hermitian pack and the conjugate inverse FFT) and of
its segments (halo frames, one writer per output sample), and the plain
version against JAX's ``istft_pallas`` (interpret mode) at the shapes that
pick each entry. The CUDA entries themselves are held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.dsp.window import hann_window
from audiodenoiser_torch.ops.cuda import (
    istft_kernel,
    istft_plain,
    reset_launch_counts,
    variant_launches,
)
from audiodenoiser_torch.ops.cuda.istft import (
    frames_per_block_log2,
    halo_frames,
    istft_entry,
)
from audiodenoiser_torch.ops.cuda.stft import twiddle_table
from audiodenoiser_tpu.ops.pallas import istft_pallas


@pytest.mark.parametrize("n_fft", [2, 4, 64, 256, 512, 1024, 4096])
def test_power_of_two_takes_the_fft_entry(n_fft):
    assert istft_entry(n_fft) == "fft"


@pytest.mark.parametrize("n_fft", [400, 255, 3, 6, 300, 513])
def test_other_n_fft_takes_the_direct_entry(n_fft):
    assert istft_entry(n_fft) == "direct"


@pytest.mark.parametrize("batch,n_frames,n_fft,hop,sms,log_tt", [
    (256, 126, 512, 128, 132, 4),   # bench batch: 16 frames, 13 own, 2,560 blocks
    (1, 126, 512, 128, 132, 3),     # a 2 s stream window: 8 frames, 5 own, 26 blocks
    (3, 194, 512, 128, 132, 3),     # 3 clips of 3.1 s: 120 blocks of 8 frames
    (32, 126, 512, 128, 132, 4),    # 320 blocks of 16 frames
    (26, 126, 512, 128, 132, 3),    # 260 blocks of 16 frames: too few
    (2, 40, 512, 32, 132, 4),       # hop 32: 15 halo frames, only 16 will do
    (16, 126, 512, 128, 8, 4),      # few SMs: the largest tile
    (2, 10, 256, 300, 132, 3),      # hop past n_fft: no halo
    (1, 1, 2, 1, 132, 3),           # n_fft 2 at hop 1: one halo frame
])
def test_frames_per_block_keep_the_halo_and_spread_small_batches(
        batch, n_frames, n_fft, hop, sms, log_tt):
    assert frames_per_block_log2(batch, n_frames, n_fft, hop, sms) == log_tt
    halo = halo_frames(n_fft, hop)
    assert (1 << log_tt) > halo
    out_len = (n_frames - 1) * hop + n_fft
    blocks_of_16 = batch * -(-out_len // ((16 - halo) * hop))
    # 16 frames where they still give every SM two blocks, else 8, never H or fewer
    assert log_tt == (4 if blocks_of_16 >= 2 * sms else max(3, halo.bit_length()))


@pytest.mark.parametrize("n_fft,hop", [(512, 16), (512, 31), (256, 8)])
def test_frames_per_block_refuse_more_than_15_halo_frames(n_fft, hop):
    assert halo_frames(n_fft, hop) >= 16
    with pytest.raises(ValueError, match="halo frames"):
        frames_per_block_log2(4, 20, n_fft, hop)


def _packed_inverse(spec: np.ndarray, n_fft: int, tw: np.ndarray) -> np.ndarray:
    """The FFT entry's arithmetic on (..., n_fft//2 + 1) bins, as the kernel
    does it: the imaginary parts of DC and Nyquist dropped, bins k and M-k
    (k < max(M/2, 1)) packed pairwise into conj Z, conj Z[M/2] = 2 X[M/2],
    the forward M-point FFT, then x[2n] = Re / n_fft and x[2n+1] = -Im / n_fft."""
    m = n_fft // 2
    x = spec.copy()
    x[..., 0] = x[..., 0].real
    x[..., m] = x[..., m].real
    zc = np.zeros(spec.shape[:-1] + (m,), spec.dtype)
    for k in range(max(m // 2, 1)):
        a, c, w = x[..., k], x[..., m - k], tw[k]
        s, d = a + np.conj(c), a - np.conj(c)
        zc[..., k] = np.conj(s + 1j * np.conj(w) * d)
        if k != 0:
            zc[..., m - k] = np.conj(np.conj(s) + 1j * w * np.conj(d))
    if m // 2:
        zc[..., m // 2] = 2 * x[..., m // 2]
    y = np.fft.fft(zc, axis=-1)
    out = np.empty(spec.shape[:-1] + (n_fft,), np.float64)
    out[..., 0::2] = y.real / n_fft
    out[..., 1::2] = -y.imag / n_fft
    return out


@pytest.mark.parametrize("n_fft", [2, 4, 8, 16, 64, 512, 1024])
def test_hermitian_pack_and_conjugate_fft_invert_irfft(n_fft):
    rng = np.random.default_rng(n_fft)
    shape = (3, 5, n_fft // 2 + 1)
    # non-zero imaginary parts at DC and Nyquist, which irfft ignores
    spec = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    tw = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    ref = np.fft.irfft(spec, n=n_fft, axis=-1)
    # float64 arithmetic and twiddles: the formula itself, to rounding
    assert np.abs(_packed_inverse(spec, n_fft, tw) - ref).max() <= 1e-14 * np.abs(ref).max()
    # the float32 table the kernel reads (float64-computed, rounded once)
    tw32 = twiddle_table(n_fft, "cpu").numpy().astype(np.complex128)
    assert np.abs(_packed_inverse(spec, n_fft, tw32) - ref).max() <= 1e-6 * np.abs(ref).max()


def _fft_entry_model(re, im, window, n_fft, hop, log_tt):
    """The FFT entry's blocks in numpy: each computes TT frames from t_lo =
    j*P - H (P = TT - H), windows them, and writes its own P*hop output
    samples, each the sum of its frames in increasing t. Returns the output
    and how many blocks wrote each sample."""
    batch, _, n_frames = re.shape
    tt, halo = 1 << log_tt, halo_frames(n_fft, hop)
    seg_frames = tt - halo
    out_len = (n_frames - 1) * hop + n_fft
    tw = twiddle_table(n_fft, "cpu").numpy().astype(np.complex128)
    spec = (re.astype(np.float64) + 1j * im.astype(np.float64)).transpose(0, 2, 1)
    out = np.zeros((batch, out_len))
    writes = np.zeros((batch, out_len), int)
    for j in range(-(-out_len // (seg_frames * hop))):
        t_lo = j * seg_frames - halo
        ts = np.arange(t_lo, t_lo + tt)
        valid = (ts >= 0) & (ts < n_frames)
        blk = np.zeros((batch, tt, n_fft // 2 + 1), complex)
        blk[:, valid] = spec[:, ts[valid]]
        frames = _packed_inverse(blk, n_fft, tw) * window
        s0, s1 = j * seg_frames * hop, min((j + 1) * seg_frames * hop, out_len)
        l_first, l_last = max(0, -t_lo), min(tt, n_frames - t_lo) - 1
        for i in range(s1 - s0):
            # sample s0 + i = (c + t_lo + H)*hop + r, in frames t_lo + l
            c = _float_quotient(i, hop)
            r = i - c * hop
            d = _float_quotient(n_fft - 1 - r, hop) if r < n_fft else -1
            for lf in range(max(c + halo - d, l_first), min(c + halo, l_last) + 1):
                out[:, s0 + i] += frames[:, lf, (c + halo - lf) * hop + r]
            writes[:, s0 + i] += 1
    return out, writes


def _float_quotient(x, hop):
    """floor(x / hop) as the kernel takes it: (x + 0.5) * RN(1/hop) in float32."""
    return int(np.float32(np.float32(x) + np.float32(0.5)) * (np.float32(1) / np.float32(hop)))


@pytest.mark.parametrize("hop", [1, 3, 7, 100, 128, 255, 4097, 65535, 2 ** 18 - 1])
def test_float_quotient_is_floor_division(hop):
    # the kernel divides x < 16 * hop (and x < n_fft < 2**18) this way
    near = (np.arange(1, 17)[:, None] * hop + np.arange(-2, 3)[None, :]).ravel()
    xs = np.unique(np.concatenate([np.arange(min(16 * hop, 5000)), near]))
    xs = xs[(xs >= 0) & (xs < 16 * hop)]
    got = (xs.astype(np.float32) + np.float32(0.5)) * (np.float32(1) / np.float32(hop))
    assert (got.astype(np.int64) == xs // hop).all()


@pytest.mark.parametrize("batch,n_frames,n_fft,hop", [
    (2, 30, 512, 128),   # 3 halo frames
    (1, 17, 512, 100),   # hop does not divide n_fft: 5 halo frames
    (2, 9, 512, 32),     # 15 halo frames, the most a block takes
    (2, 6, 64, 80),      # hop past n_fft: gaps of zeros between frames
    (1, 5, 2, 1),        # the smallest transform: one complex point
])
def test_fft_entry_segments_match_plain(batch, n_frames, n_fft, hop):
    rng = np.random.default_rng(batch * n_frames + hop)
    f = n_fft // 2 + 1
    re = rng.standard_normal((batch, f, n_frames)).astype(np.float32)
    im = rng.standard_normal((batch, f, n_frames)).astype(np.float32)
    w = hann_window(n_fft).astype(np.float64)
    ref = istft_plain(torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(
        w.astype(np.float32)), n_fft, hop).numpy()
    least = halo_frames(n_fft, hop).bit_length()
    for log_tt in range(least, 5):
        out, writes = _fft_entry_model(re, im, w, n_fft, hop, log_tt)
        assert (writes == 1).all(), f"TT={1 << log_tt}: a sample written {writes.max()} times"
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), f"TT={1 << log_tt}"


@pytest.mark.parametrize("batch,n_frames,n_fft,hop", [
    (1, 126, 512, 128),   # a stream window: the FFT entry
    (3, 194, 512, 128),   # ragged clips: the FFT entry
    (2, 17, 400, 100),    # the direct entry
    (1, 9, 255, 64),      # odd n_fft, no Nyquist bin: the direct entry
])
def test_plain_matches_pallas_at_each_entrys_shapes(batch, n_frames, n_fft, hop):
    rng = np.random.default_rng(n_fft + n_frames)
    f = n_fft // 2 + 1
    re = rng.standard_normal((batch, f, n_frames)).astype(np.float32)
    im = rng.standard_normal((batch, f, n_frames)).astype(np.float32)
    w = hann_window(n_fft)
    before = dict(variant_launches(istft_kernel)), istft_kernel.launches
    y = istft_kernel(torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(w),
                     n_fft, hop)
    # on the CPU the wrapper takes the plain version and counts no launch
    assert (dict(variant_launches(istft_kernel)), istft_kernel.launches) == before
    torch.testing.assert_close(y, istft_plain(torch.from_numpy(re), torch.from_numpy(im),
                                              torch.from_numpy(w), n_fft, hop),
                               rtol=0, atol=0)
    ref = np.asarray(istft_pallas(jnp.asarray(re), jnp.asarray(im), jnp.asarray(w),
                                  n_fft, hop, interpret=True))
    assert y.shape == ref.shape == (batch, (n_frames - 1) * hop + n_fft)
    # the Pallas bases run at Precision.HIGHEST: fp32 against pocketfft's rounding
    assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_launch_counters_cover_both_entries():
    assert istft_kernel.variants == ("fft", "direct")
    istft_kernel.fft_launches, istft_kernel.direct_launches = 3, 1
    assert variant_launches(istft_kernel) == {"fft": 3, "direct": 1}
    reset_launch_counts()
    assert variant_launches(istft_kernel) == {"fft": 0, "direct": 0}
    assert istft_kernel.launches == 0
