"""The port's sequence-parallel halos (``parallel.spatial``) against the JAX
package on the CPU.

Four gloo ranks (``tests/torch_parallel_worker.py``, spawned once in a
module fixture) denoise on 4- and 2-rank ``('seq',)`` meshes while this
process computes JAX's ``denoise_spec_sharded`` and
``denoise_waveform_sharded`` on as many virtual CPU devices. The U-Net is
full depth (the receptive field and the pooling alignment depend on it)
at JAX's thin test widths, its weights from ``random_flax_variables``.
Every sharded answer is held within 1e-5 relative L2 of JAX's; the
world-size-1 mesh runs in this process and equals the port's padded
forward.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.models import UNet, random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.parallel import spatial as port_sp
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.parallel import spatial as jax_sp
from tests.test_torch_parallel import collect, spawn

SMALL = dict(features=(8, 16, 32, 64), bottleneck=128)  # JAX's tests/test_spatial.py
TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


@pytest.fixture(scope="module")
def weights():
    variables = random_flax_variables(0, **SMALL)
    return jax.tree_util.tree_map(jnp.asarray, variables), state_dict_from_flax(variables)


def _model(sd):
    model = UNet(**SMALL).eval()
    model.load_state_dict(sd)
    return model


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return {"seq_clip": np.abs(rng.standard_normal((257, 177))).astype(np.float32),
            "seq_batch": np.abs(rng.standard_normal((2, 1, 64, 100))).astype(np.float32),
            "seq_wav": (rng.standard_normal(4 * 8000) * 0.1).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, weights, inputs):
    work = tmp_path_factory.mktemp("seq")
    variables, sd = weights
    torch.save({"seq_sd": sd, "seq_widths": SMALL,
                **{k: torch.from_numpy(v) for k, v in inputs.items()}}, work / "inputs.pt")
    procs = spawn("seq", 4, work)
    model = FlaxUNet(dtype=jnp.float32, **SMALL)
    ref = {}
    for n in (4, 2):
        mesh = jax_sp.make_seq_mesh(n)
        batch = jnp.asarray(inputs["seq_batch"].transpose(0, 2, 3, 1))
        ref[n] = {
            "clip": jax_sp.denoise_spec_sharded(model, variables, jnp.asarray(inputs["seq_clip"]),
                                                mesh, halo=96),
            "batch": jax_sp.denoise_spec_sharded(model, variables, batch, mesh,
                                                 halo=16).transpose(0, 3, 1, 2),
            "wave": jax_sp.denoise_waveform_sharded(model, variables,
                                                    jnp.asarray(inputs["seq_wav"]), mesh,
                                                    halo=96),
            "short": jax_sp.denoise_spec_sharded(model, variables,
                                                 jnp.asarray(inputs["seq_clip"][:, :40]), mesh,
                                                 halo=96)}
    return collect(procs, "seq", work), jax.device_get(ref)


def test_constants_are_jax():
    assert (port_sp.RECEPTIVE_RADIUS, port_sp.ALIGN, port_sp.SEQ_AXIS) == (
        jax_sp.RECEPTIVE_RADIUS, jax_sp.ALIGN, jax_sp.SEQ_AXIS)
    assert port_sp.RECEPTIVE_RADIUS == 2 * (1 + 2 + 4 + 8) + 2 * 16 + 2 * (8 + 4 + 2 + 1)


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("key", ["clip", "batch", "wave", "short"])
def test_sharded_matches_jax(runs, n, key):
    """(F, T) with an uneven length, the batched (B, C, F, T) layout at halo
    16, the waveform path and a clip shorter than a halo, each against
    JAX's sharded answer on as many devices."""
    ranks, ref = runs
    got = ranks[0][f"seq{n}"][key]
    want = np.asarray(ref[n][key])
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("n", [4, 2])
def test_every_rank_of_the_mesh_has_the_whole_answer(runs, n):
    ranks, _ = runs
    first = ranks[0][f"seq{n}"]
    for res in ranks[1:n]:
        assert all(torch.equal(res[f"seq{n}"][k], first[k]) for k in first)
    assert all(res[f"seq{n}"] is None for res in ranks[n:])  # off the mesh


@pytest.mark.parametrize("key", ["clip", "short"])
def test_sharded_is_the_padded_forward(runs, weights, inputs, key):
    """With a halo past the receptive field, four ranks give the oracle's
    computation, partitioned (the halo-16 batch is not exact, as in JAX)."""
    ranks, _ = runs
    spec = torch.from_numpy(inputs["seq_clip"])
    if key == "short":
        spec = spec[:, :40]
    want = port_sp.reference_padded_forward(_model(weights[1]), spec, halo=96)
    assert _rel(ranks[0]["seq4"][key], want) < TOL


@pytest.mark.parametrize("halo", [16, 96, 100])
def test_world_size_one_is_the_padded_forward(weights, inputs, halo):
    """One rank (a world-size-1 group of this process): no exchange, the
    clip is its own shard; the oracle is JAX's at the default halo."""
    variables, sd = weights
    mesh = port_sp.make_seq_mesh(1, device="cpu")
    spec = torch.from_numpy(inputs["seq_clip"])
    got = port_sp.denoise_spec_sharded(_model(sd), spec, mesh, halo=halo)
    want = port_sp.reference_padded_forward(_model(sd), spec, halo=halo)
    assert torch.equal(got, want)
    if halo != 96:
        return
    ref = jax_sp.reference_padded_forward(FlaxUNet(dtype=jnp.float32, **SMALL), variables,
                                          jnp.asarray(inputs["seq_clip"]), halo=halo)
    assert _rel(want, ref) < TOL


def test_rejects_other_layouts(weights):
    mesh = port_sp.make_seq_mesh(1, device="cpu")
    with pytest.raises(ValueError, match=r"expected \(F,T\) or \(B,C,F,T\)"):
        port_sp.denoise_spec_sharded(_model(weights[1]), torch.zeros(2, 64, 64), mesh)
    with pytest.raises(ValueError, match=r"expected a single \(samples,\) clip"):
        port_sp.denoise_waveform_sharded(_model(weights[1]), torch.zeros(2, 800), mesh)
