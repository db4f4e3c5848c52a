"""Port parity: ``audiodenoiser_torch.dsp`` and the plain versions of the
K1 (STFT) and K2 (iSTFT) kernels against the JAX package on the CPU.

The same numpy arrays, drawn from ``np.random.default_rng``, go to both
sides. On a CPU tensor ``stft_kernel`` / ``istft_kernel`` take their plain
versions, which is what these tests hold against JAX's Pallas kernels (in
interpret mode) and its ``precision="fft"`` path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_tpu.dsp.stft as JS
import audiodenoiser_torch.dsp.stft as TS
from audiodenoiser_tpu.dsp import window as JW
from audiodenoiser_tpu.ops.pallas import istft_pallas, stft_pallas
from audiodenoiser_torch.dsp import window as TW
from audiodenoiser_torch.ops.cuda import istft_kernel, stft_kernel


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _fft_bound(ref):
    # bound against the JAX fft path: atol = 1e-4 * max|ref|
    return 1e-4 * np.abs(ref).max()


class TestWindow:
    @pytest.mark.parametrize("n", [1, 2, 63, 400, 512])
    def test_hann_matches(self, n):
        for periodic in (True, False):
            np.testing.assert_array_equal(TW.hann_window(n, periodic),
                                          JW.hann_window(n, periodic))

    def test_pad_center_matches(self):
        w = JW.hann_window(300)
        np.testing.assert_array_equal(TW.pad_center(w, 512), JW.pad_center(w, 512))
        with pytest.raises(ValueError):
            TW.pad_center(w, 200)


class TestStftKernelPlain:
    """K1's plain version against ``stft_pallas(interpret=True)`` (the 5e-3
    bound of tests/test_pallas.py) and the JAX fft path."""

    @pytest.mark.parametrize("shape,window", [
        ((3, 16000), "hann"),
        ((2, 2048), "ones"),   # rectangular window
        ((2, 3100), "hann"),   # ragged: (L - n_fft) % hop != 0
    ])
    def test_matches_pallas_and_fft(self, rng, shape, window):
        x = rng.standard_normal(shape).astype(np.float32)
        w = JS._resolve_window(window, 512, 512)
        spec = stft_kernel(_t(x), _t(w), 512, 128).numpy()
        re, im = stft_pallas(jnp.asarray(x), jnp.asarray(w), 512, 128, interpret=True)
        t = 1 + (shape[1] - 512) // 128
        assert spec.shape == (shape[0], 257, t)
        np.testing.assert_allclose(spec.real, np.asarray(re), atol=5e-3)
        np.testing.assert_allclose(spec.imag, np.asarray(im), atol=5e-3)
        ref = np.asarray(JS.stft(jnp.asarray(x), 512, 128, window=window, center=False))
        np.testing.assert_allclose(spec, ref, atol=_fft_bound(ref))

    def test_rejects_unbatched_and_mismatched(self):
        with pytest.raises(ValueError):
            stft_kernel(torch.zeros(4000), torch.zeros(512))
        with pytest.raises(ValueError):
            stft_kernel(torch.zeros(2, 4000), torch.zeros(256))
        with pytest.raises(ValueError):
            stft_kernel(torch.zeros(2, 300), torch.zeros(512))
        with pytest.raises(TypeError):
            stft_kernel(torch.zeros(2, 4000, dtype=torch.float64), torch.zeros(512))


class TestIstftKernelPlain:
    """K2's plain version against ``istft_pallas(interpret=True)`` (the 1e-4
    bound of tests/test_pallas.py) and JAX's irfft + overlap-add."""

    @pytest.mark.parametrize("shape,window", [
        ((2, 257, 30), "hann"),
        ((3, 257, 20), "ones"),
        ((1, 257, 7), "hann"),
    ])
    def test_matches_pallas_and_fft(self, rng, shape, window):
        spec = (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)
        w = JS._resolve_window(window, 512, 512)
        ours = istft_kernel(_t(spec.real), _t(spec.imag), _t(w), 512, 128).numpy()
        pal = np.asarray(istft_pallas(jnp.asarray(spec.real), jnp.asarray(spec.imag),
                                      jnp.asarray(w), 512, 128, interpret=True))
        assert ours.shape == pal.shape == (shape[0], (shape[2] - 1) * 128 + 512)
        np.testing.assert_allclose(ours, pal, atol=1e-4)
        frames = np.fft.irfft(np.swapaxes(spec, -1, -2), n=512, axis=-1) * w
        ref = np.asarray(JS.overlap_add(jnp.asarray(frames.astype(np.float32)), 128))
        np.testing.assert_allclose(ours, ref, atol=_fft_bound(ref))

    def test_views_of_one_complex_tensor(self, rng):
        spec = (rng.standard_normal((2, 257, 9))
                + 1j * rng.standard_normal((2, 257, 9))).astype(np.complex64)
        parts = torch.view_as_real(_t(spec))
        w = _t(JW.hann_window(512))
        a = istft_kernel(parts[..., 0], parts[..., 1], w)
        b = istft_kernel(_t(spec.real), _t(spec.imag), w)
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def test_rejects_bad_freq_dim(self):
        with pytest.raises(ValueError):
            istft_kernel(torch.zeros(1, 100, 4), torch.zeros(1, 100, 4),
                         torch.zeros(512), 512, 128)
        with pytest.raises(ValueError):
            istft_kernel(torch.zeros(257, 4), torch.zeros(257, 4), torch.zeros(512))


class TestStft:
    @pytest.mark.parametrize("precision", ["fft", "kernel"])
    @pytest.mark.parametrize("center,pad_mode", [
        (True, "constant"), (True, "reflect"), (False, "constant")])
    def test_matches_jax(self, rng, precision, center, pad_mode):
        x = rng.standard_normal((2, 3, 3000)).astype(np.float32)
        ours = TS.stft(_t(x), 512, 128, center=center, pad_mode=pad_mode,
                       precision=precision).numpy()
        ref = np.asarray(JS.stft(jnp.asarray(x), 512, 128, center=center,
                                 pad_mode=pad_mode))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=_fft_bound(ref))

    @pytest.mark.parametrize("n_fft,hop,win_length", [(63, 32, None), (400, 100, 300),
                                                      (16, 8, None)])
    def test_odd_and_short_windows(self, rng, n_fft, hop, win_length):
        x = rng.standard_normal((2, 1000)).astype(np.float32)
        ours = TS.stft(_t(x), n_fft, hop, win_length=win_length).numpy()
        ref = np.asarray(JS.stft(jnp.asarray(x), n_fft, hop, win_length=win_length))
        assert ours.shape[-1] == TS.num_frames(1000, n_fft, hop) == ref.shape[-1]
        np.testing.assert_allclose(ours, ref, atol=_fft_bound(ref))

    @pytest.mark.parametrize("length,n_fft,hop,center", [
        (1000, 512, 128, True), (1000, 63, 32, True), (1000, 512, 128, False),
        (517, 16, 8, False)])
    def test_num_frames(self, length, n_fft, hop, center):
        assert TS.num_frames(length, n_fft, hop, center) == \
            JS.num_frames(length, n_fft, hop, center)

    @pytest.mark.parametrize("n_fft,hop,center,pad_mode", [
        (512, 128, True, "constant"), (512, 128, True, "reflect"), (512, 128, False, "constant"),
        (63, 32, True, "constant"), (400, 100, True, "constant")])
    def test_matmul_matches_jax(self, rng, n_fft, hop, center, pad_mode):
        """JAX's real-DFT-basis path against the port's, within 1e-5 of
        max|ref| (an n_fft-term fp32 sum a bin)."""
        x = rng.standard_normal((2, 3, 3000)).astype(np.float32)
        ours = TS.stft(_t(x), n_fft, hop, center=center, pad_mode=pad_mode,
                       precision="matmul").numpy()
        ref = np.asarray(JS.stft(jnp.asarray(x), n_fft, hop, center=center,
                                 pad_mode=pad_mode, precision="matmul"))
        assert ours.shape == ref.shape and ours.dtype == np.complex64
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    def test_rejects_unknown_precision(self):
        with pytest.raises(ValueError):
            TS.stft(torch.zeros(1, 2000), precision="pallas")
        with pytest.raises(ValueError):
            TS.istft(torch.zeros(1, 257, 4, dtype=torch.complex64), precision="pallas")
        # JAX's iSTFT has no matmul path: "matmul" takes the FFT one
        spec = torch.randn(1, 257, 6, dtype=torch.complex64)
        torch.testing.assert_close(TS.istft(spec, precision="matmul"),
                                   TS.istft(spec, precision="fft"), rtol=0, atol=0)


class TestMagphase:
    def test_zero_bins_get_unit_phase(self, rng):
        spec = (rng.standard_normal((2, 257, 6))
                + 1j * rng.standard_normal((2, 257, 6))).astype(np.complex64)
        spec[0, :10, 2] = 0  # zero magnitude
        spec[1, 5, :] = 1e-39 + 0j  # subnormal: below float32 tiny
        mag, phase = TS.magphase(_t(spec))
        jmag, jphase = JS.magphase(jnp.asarray(spec))
        np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), rtol=1e-6, atol=1e-30)
        np.testing.assert_allclose(phase.numpy(), np.asarray(jphase), atol=1e-6)
        assert (phase.numpy()[0, :10, 2] == 1).all()
        np.testing.assert_allclose((mag * phase).numpy(), spec, atol=1e-6)


class TestIstft:
    @pytest.mark.parametrize("precision", ["fft", "kernel"])
    @pytest.mark.parametrize("length", [None, 2900, 3000, 3333])
    def test_matches_jax_with_length(self, rng, precision, length):
        x = (0.2 * rng.standard_normal((2, 3000))).astype(np.float32)
        spec = np.asarray(JS.stft(jnp.asarray(x), 512, 128))
        ours = TS.istft(_t(spec), 128, length=length, precision=precision).numpy()
        ref = np.asarray(JS.istft(jnp.asarray(spec), 128, length=length))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    @pytest.mark.parametrize("center", [True, False])
    def test_roundtrip_and_envelope(self, rng, center):
        x = (0.2 * rng.standard_normal((3, 4096))).astype(np.float32)
        spec = TS.stft(_t(x), 512, 128, center=center)
        y = TS.istft(spec, 128, center=center, length=4096 if center else None)
        ref = np.asarray(JS.istft(JS.stft(jnp.asarray(x), 512, 128, center=center),
                                  128, center=center,
                                  length=4096 if center else None))
        if center:
            np.testing.assert_allclose(y.numpy(), ref, atol=1e-5)
            np.testing.assert_allclose(y.numpy(), x, atol=1e-4)
        else:
            # the edges divide by an envelope near zero, which magnifies
            # rounding a billionfold: compare where a full frame overlaps
            np.testing.assert_allclose(y.numpy()[:, 512:-512],
                                       ref[:, 512:-512], atol=1e-5)

    def test_wss_envelope_matches(self):
        w = JW.hann_window(512)
        a = TS._wss_envelope(512, 128, 20, w.tobytes(), 512)
        b = JS._wss_envelope(512, 128, 20, w.tobytes(), 512)
        np.testing.assert_array_equal(a, b)
        rect = np.ones(512, np.float32)
        np.testing.assert_array_equal(
            TS._wss_envelope(512, 200, 3, rect.tobytes(), 512),
            JS._wss_envelope(512, 200, 3, rect.tobytes(), 512))

    @pytest.mark.parametrize("hop", [128, 100])
    def test_overlap_add_matches(self, rng, hop):
        frames = rng.standard_normal((2, 3, 10, 512)).astype(np.float32)
        ours = TS.overlap_add(_t(frames), hop).numpy()
        ref = np.asarray(JS.overlap_add(jnp.asarray(frames), hop))
        assert ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=1e-5)

    def test_frame_signal_matches(self, rng):
        x = rng.standard_normal((2, 1300)).astype(np.float32)
        for n_fft, hop in ((512, 128), (400, 100), (300, 77)):
            np.testing.assert_array_equal(
                TS.frame_signal(_t(x), n_fft, hop).numpy(),
                np.asarray(JS.frame_signal(jnp.asarray(x), n_fft, hop)))
        with pytest.raises(ValueError):
            TS.frame_signal(_t(x[:, :100]), 512, 128)
