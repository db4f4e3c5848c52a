"""K4, the overlap-add op: its plain version against JAX's Pallas kernel
(interpret mode) and JAX's ``dsp.stft.overlap_add`` on the CPU, and the
wrapper's device and input rules. The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Bound: 1e-6 of max|ref| (sums of at most four float32
terms in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiodenoiser_tpu.dsp.stft as jax_stft
from audiodenoiser_torch.ops.cuda import overlap_add_kernel, overlap_add_plain
from audiodenoiser_tpu.ops.pallas import overlap_add_pallas


def _frames(batch, n_frames, n_fft=512, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, n_frames, n_fft)).astype(np.float32)


@pytest.mark.parametrize("batch", [3, 10])
@pytest.mark.parametrize("hop", [128, 100, 512])
def test_plain_matches_jax(batch, hop):
    """hop 100 does not divide 512; hop 512 has no overlap at all."""
    frames = _frames(batch, 9, seed=hop + batch)
    ours = overlap_add_plain(torch.from_numpy(frames), hop).numpy()
    pallas = np.asarray(overlap_add_pallas(jnp.asarray(frames), hop, interpret=True))
    xla = np.asarray(jax_stft.overlap_add(jnp.asarray(frames), hop))
    assert ours.shape == pallas.shape == xla.shape == (batch, 8 * hop + 512)
    for ref in (pallas, xla):
        assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("hop", [128, 100, 512])
def test_bf16_plain_matches_jax_within_bf16_roundings(hop):
    frames = _frames(3, 9, seed=hop)
    bf = torch.from_numpy(frames).to(torch.bfloat16)
    ours = overlap_add_plain(bf, hop)
    assert ours.dtype == torch.bfloat16
    pallas = overlap_add_pallas(jnp.asarray(bf.float().numpy(), jnp.bfloat16), hop, interpret=True)
    assert pallas.dtype == jnp.bfloat16
    ref = np.asarray(pallas.astype(jnp.float32))
    magnitudes = overlap_add_plain(bf.double().abs().float(), hop).double().numpy()
    roundings = -(-512 // hop) + 1
    err = np.abs(ours.float().numpy().astype(np.float64) - ref)
    assert ours.shape == (3, 8 * hop + 512)
    assert (err <= roundings * 2.0 ** -9 * magnitudes + 1e-30).all()


def test_kernel_returns_bf16_on_cpu():
    bf = torch.from_numpy(_frames(2, 5)).to(torch.bfloat16)
    out = overlap_add_kernel(bf, 128)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 4 * 128 + 512)
    torch.testing.assert_close(out, overlap_add_plain(bf, 128), rtol=0, atol=0)
    # one rounding of the float32 sum
    torch.testing.assert_close(out, overlap_add_plain(bf.float(), 128).to(torch.bfloat16),
                               rtol=0, atol=0)


def test_gaps_past_n_fft_are_zero():
    """hop > n_fft leaves samples no frame covers: zeros."""
    frames = _frames(2, 4, n_fft=64)
    out = overlap_add_kernel(torch.from_numpy(frames), 100).numpy()
    assert out.shape == (2, 3 * 100 + 64)
    for t in range(4):
        np.testing.assert_array_equal(out[:, t * 100: t * 100 + 64], frames[:, t])
    assert not out[:, 64:100].any()


def test_kernel_takes_plain_version_on_cpu():
    frames = torch.from_numpy(_frames(3, 41))
    before = overlap_add_kernel.launches
    out = overlap_add_kernel(frames, 100)
    torch.testing.assert_close(out, overlap_add_plain(frames, 100), rtol=0, atol=0)
    assert overlap_add_kernel.launches == before  # counts CUDA launches only


@pytest.mark.parametrize("fn", [overlap_add_kernel, overlap_add_plain])
def test_rejects_unbatched(fn):
    with pytest.raises(ValueError, match="batch, frames, n_fft"):
        fn(torch.zeros(10, 512), 128)


def test_kernel_rules():
    with pytest.raises(TypeError, match="float32"):
        overlap_add_kernel(torch.zeros(2, 4, 512, dtype=torch.float64), 128)
    with pytest.raises(ValueError, match="hop_length"):
        overlap_add_kernel(torch.zeros(2, 4, 512), 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        overlap_add_kernel(torch.zeros(2, 4, 512, device="meta"), 128)
