"""K1's wrapper logic on the CPU: which library entry a shape takes, how
many frames a block of the FFT entry owns, the cached twiddle table, and the
plain version against JAX's ``stft_pallas`` (interpret mode) at the shapes
that pick each entry. The CUDA entries themselves are held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.dsp.window import hann_window
from audiodenoiser_torch.ops.cuda import stft_kernel, stft_plain, variant_launches
from audiodenoiser_torch.ops.cuda.stft import frames_per_block_log2, stft_entry, twiddle_table
from audiodenoiser_tpu.ops.pallas import stft_pallas


@pytest.mark.parametrize("n_fft", [2, 4, 64, 256, 512, 1024, 4096])
def test_power_of_two_takes_the_fft_entry(n_fft):
    assert stft_entry(n_fft) == "fft"


@pytest.mark.parametrize("n_fft", [400, 255, 3, 6, 300, 513])
def test_other_n_fft_takes_the_direct_entry(n_fft):
    assert stft_entry(n_fft) == "direct"


@pytest.mark.parametrize("batch,n_frames,sms,log_tt", [
    (256, 126, 132, 3),   # bench batch: 8 frames a block, 4,096 blocks
    (1, 126, 132, 0),     # a 2 s stream window: one frame a block, 126 blocks
    (3, 194, 132, 1),     # 3 clips of 3.1 s: 2 frames a block, 291 blocks
    (16, 126, 132, 2),    # the training mixer's batch: 4 frames a block
    (16, 126, 8, 3),      # few SMs: the largest tile
    (1, 1, 132, 0),
])
def test_frames_per_block_spread_small_batches(batch, n_frames, sms, log_tt):
    assert frames_per_block_log2(batch, n_frames, sms) == log_tt
    blocks = batch * -(-n_frames // (1 << log_tt))
    assert log_tt == 3 or blocks >= 2 * sms or log_tt == 0


@pytest.mark.parametrize("n_fft", [2, 8, 512, 4096])
def test_twiddle_table_is_float64_rounded_once(n_fft):
    tab = twiddle_table(n_fft, torch.device("cpu"))
    assert tab.dtype == torch.complex64 and tab.shape == (n_fft,)
    assert twiddle_table(n_fft, "cpu") is tab  # cached per (n_fft, device)
    ref = np.exp(-2j * np.pi * np.arange(n_fft) / n_fft)
    got = tab.numpy().astype(np.complex128)
    # each part within half a float32 ulp of a value of magnitude <= 1
    assert np.abs(got.real - ref.real).max() <= 2.0 ** -25
    assert np.abs(got.imag - ref.imag).max() <= 2.0 ** -25


@pytest.mark.parametrize("batch,length,n_fft,hop", [
    (1, 16512, 512, 128),   # a stream window: FFT entry with one frame a block
    (3, 25312, 512, 128),   # ragged: (L - n_fft) % hop != 0
    (2, 3000, 400, 100),    # the direct entry
])
def test_plain_matches_pallas_at_each_entrys_shapes(batch, length, n_fft, hop):
    rng = np.random.default_rng(n_fft + batch)
    x = rng.standard_normal((batch, length)).astype(np.float32)
    w = hann_window(n_fft)
    before = dict(variant_launches(stft_kernel)), stft_kernel.launches
    spec = stft_kernel(torch.from_numpy(x), torch.from_numpy(w), n_fft, hop)
    # on the CPU the wrapper takes the plain version and counts no launch
    assert (dict(variant_launches(stft_kernel)), stft_kernel.launches) == before
    torch.testing.assert_close(spec, stft_plain(torch.from_numpy(x), torch.from_numpy(w),
                                                n_fft, hop), rtol=0, atol=0)
    re, im = stft_pallas(jnp.asarray(x), jnp.asarray(w), n_fft, hop, interpret=True)
    ref = np.asarray(re) + 1j * np.asarray(im)
    assert spec.shape == ref.shape == (batch, n_fft // 2 + 1, 1 + (length - n_fft) // hop)
    # the Pallas bases run at Precision.HIGHEST: fp32 against cuFFT-like rounding
    assert np.abs(spec.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
