"""The port's ('data', 'model') mesh (``audiodenoiser_torch.parallel``)
against the JAX package's on the CPU.

Four gloo ranks (``tests/torch_parallel_worker.py``, which imports the
port only) run every scenario once, in a module fixture, while this
process computes JAX's side on the virtual CPU devices of
``tests/conftest.py``; each test then asserts one scenario. Weights come
from ``random_flax_variables`` through ``state_dict_from_flax``, inputs
from a numpy seed. The U-Net is ``features=(8, 128), bottleneck=256``:
its 128- and 256-channel layers are wide enough for the tp and fsdp rules.

Tolerances, after one fp32 step: losses and the global gradient norm rtol
1e-5 (the norm above the clip: the clip engaged); the weights 1e-5 and
the BatchNorm running statistics 1e-6 relative L2 per tensor. At these
widths and inputs the fp32 gradient is ill-conditioned: the unmeshed port
and JAX alike lie 1e-4 - 4e-3 relative L2 from a float64 backward on the
wide layers, and a first AdamW step moves a weight by about ``lr *
sign(g)``, so an element whose gradient is within rounding of 0 moves
2 x lr apart between any two summation orders. The weights are held at
the elements whose JAX gradient is at least 1% of its tensor's RMS (the
sign of a smaller one is not determined in fp32; ``_determined``), at lr
1e-5. The conv biases that
feed a train-mode BatchNorm are held apart: their whole gradient is
rounding noise on both sides (ROADMAP), so they are bounded by 4 x lr and
printed. Runner outputs within 1e-5 (JAX's own meshed-runner tolerance).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiodenoiser_torch.models import UNet, random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet
from audiodenoiser_torch.parallel import distributed as port_dist
from audiodenoiser_torch.parallel import mesh as port_mesh
from audiodenoiser_tpu.eval.runner import DenoiserRunner as JaxRunner
from audiodenoiser_tpu.models import ComplexMaskUNet as FlaxMask
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.parallel import mesh as jax_mesh
from audiodenoiser_tpu.train import loop as jax_loop
from audiodenoiser_tpu.train import mask as jax_mask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(features=(8, 128), bottleneck=256)
LR = 1e-5
BN_FED_BIASES = ("double_conv.0.bias", "double_conv.3.bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def spawn(suite: str, world: int, workdir: str):
    """Start ``world`` gloo ranks of ``tests/torch_parallel_worker.py``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    worker = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
    return [subprocess.Popen([sys.executable, worker, suite, str(r), str(world), str(port),
                              str(workdir)], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def collect(procs, suite: str, workdir: str, timeout: float = 240.0) -> list:
    """Every rank's results; fails with the ranks' output when one failed."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        tails = "\n".join(f"rank {r}: {p.communicate()[0][-2000:]}" for r, p in enumerate(procs))
        raise AssertionError(f"the {suite} ranks did not finish in {timeout} s\n{tails}")
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        path = os.path.join(workdir, f"{suite}_r{r}.pt")
        res = torch.load(path, weights_only=False) if os.path.exists(path) else {}
        if p.returncode or "error" in res:
            raise AssertionError(f"rank {r} failed: {res.get('error', '')}\n{out[-4000:]}")
        results.append(res)
    return results


def _jax_state(variables, model):
    state = jax_loop.create_train_state(jax.random.key(0), model, learning_rate=LR,
                                        input_shape=(1, 32, 32, 1))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    return state.replace(params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                            variables["batch_stats"]),
                         opt_state=state.tx.init(params))


def _after(state) -> dict:
    return state_dict_from_flax({"params": jax.device_get(state.params),
                                 "batch_stats": jax.device_get(state.batch_stats)})


def _clipped(grads, batch_stats) -> tuple[float, dict]:
    """optax's global norm of ``grads`` and the gradients clipped at 1.0,
    by torch name."""
    norm = float(optax.global_norm(grads))
    g = state_dict_from_flax({"params": jax.device_get(grads),
                              "batch_stats": jax.device_get(batch_stats)})
    return norm, {k: v * min(1.0, 1.0 / norm) for k, v in g.items()}


def _jax_step(variables, noisy, clean, mesh, fsdp=False):
    """JAX's ``train_step`` on ``mesh``: losses, global norm, clipped
    gradients, new state dict."""
    state = _jax_state(variables, FlaxUNet(**NARROW))
    _, _, grads = jax.jit(jax_loop._loss_and_updates)(state, _nhwc(noisy), _nhwc(clean))
    norm, clipped = _clipped(grads, state.batch_stats)
    state = jax_mesh.shard_train_state(_jax_state(variables, FlaxUNet(**NARROW)), mesh, fsdp)
    state, losses = jax_loop.train_step(state, jax_mesh.shard_batch(_nhwc(noisy), mesh),
                                        jax_mesh.shard_batch(_nhwc(clean), mesh))
    return [float(t) for t in losses], norm, clipped, _after(state)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    noisy = np.abs(rng.standard_normal((8, 1, 32, 32))).astype(np.float32)
    clean = (0.8 * noisy + 0.1 * rng.random((8, 1, 32, 32))).astype(np.float32)
    t = np.arange(4096) / 8000
    m_clean = np.stack([0.5 * np.sin(2 * np.pi * f * t) for f in (220, 330, 440, 550)])
    m_clean = m_clean.astype(np.float32)
    m_noisy = np.clip(m_clean + 0.1 * rng.standard_normal(m_clean.shape), -1, 1)
    m_noisy = m_noisy.astype(np.float32)
    variables = random_flax_variables(0, **NARROW)
    mask_vars = random_flax_variables(1, **NARROW, in_channels=3, out_channels=2)
    runner_vars = random_flax_variables(2, **NARROW)
    mags = np.abs(rng.standard_normal((5, 32, 32))).astype(np.float32)
    audio = np.clip(rng.standard_normal((3, 4000)) * 0.2, -1, 1).astype(np.float32)
    torch.save({"unet_sd": state_dict_from_flax(variables), "noisy": torch.from_numpy(noisy),
                "clean": torch.from_numpy(clean), "mask_sd": state_dict_from_flax(mask_vars),
                "mask_noisy": torch.from_numpy(m_noisy), "mask_clean": torch.from_numpy(m_clean),
                "runner_sd": state_dict_from_flax(runner_vars), "mags": torch.from_numpy(mags),
                "audio": torch.from_numpy(audio)}, work / "inputs.pt")
    procs = spawn("parallel", 4, work)

    # JAX's side while the ranks run
    ref = {}
    mesh4 = jax_mesh.make_mesh(4)
    ref["step"] = _jax_step(variables, noisy, clean, mesh4)
    ref["fsdp"] = _jax_step(variables, noisy, clean, mesh4, fsdp=True)
    # the ragged batch of 7, wrap-padded as JAX's fit places it, then eval
    idx = np.arange(8) % 7
    ref["ragged"] = _jax_step(variables, noisy[:7][idx], clean[:7][idx], mesh4)
    # the mask step on a 2 x 1 mesh
    mesh2 = jax_mesh.make_mesh(2, model_parallel=1)
    mstate = jax_mask.create_mask_train_state(
        jax.random.key(0), FlaxMask(**NARROW, mask_bound=8.0, residual=True),
        learning_rate=LR, input_shape=(1, 32, 32, 3))
    params = jax.tree_util.tree_map(jnp.asarray, mask_vars["params"])
    mstate = mstate.replace(params=params, opt_state=mstate.tx.init(params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                               mask_vars["batch_stats"]))
    mstate = jax_mesh.shard_train_state(mstate, mesh2)

    def mask_loss(params):
        total, _, _ = jax_mask._mask_losses(mstate, params, jnp.asarray(m_noisy),
                                            jnp.asarray(m_clean), train=True,
                                            si_sdr_weight=0.5, si_sdr_clamp=30.0)
        return total

    mgrads = jax.jit(jax.grad(mask_loss))(mstate.params)
    mclipped = _clipped(mgrads, mstate.batch_stats)
    mstate, mlosses = jax_mask.make_mask_steps(0.5, 30.0)[0](
        mstate, jax_mesh.shard_batch(jnp.asarray(m_noisy), mesh2),
        jax_mesh.shard_batch(jnp.asarray(m_clean), mesh2))
    ref["mask"] = ([float(t) for t in mlosses], *mclipped, _after(mstate))
    # JAX's meshed runner at 2 x 1 and 1 x 2
    flax_runner_vars = jax.tree_util.tree_map(jnp.asarray, runner_vars)
    for key, mp in (("runner_2x1", 1), ("runner_1x2", 2)):
        runner = JaxRunner(FlaxUNet(**NARROW), flax_runner_vars,
                           mesh=jax_mesh.make_mesh(2, model_parallel=mp))
        ref[key] = (np.asarray(runner.denoise_spectrogram(jnp.asarray(mags))),
                    np.asarray(runner.denoise_audio(jnp.asarray(audio), jax.random.key(0))))
    return collect(procs, "parallel", work), ref, work


# (1) the sharding rule, leaf by leaf through the converter's names


@pytest.mark.parametrize("family", ["unet", "mask"])
def test_param_spec_matches_jax_rule(family):
    """Every leaf of the full-width U-Net (31,042,369 parameters) and
    ComplexMaskUNet (31,043,586): the port's ``param_spec`` on the torch
    name and shape is JAX's ``_param_spec`` on the Flax leaf, its axes
    carried through the converter's layout change, for model sizes 1, 2, 4
    with fsdp off and on at data 1, 2, 4."""
    kw = {} if family == "unet" else dict(in_channels=3, out_channels=2)
    variables = random_flax_variables(0, **kw)
    model = UNet() if family == "unet" else ComplexMaskUNet()
    assert sum(p.numel() for p in model.parameters()) == (
        31_042_369 if family == "unet" else 31_043_586)
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(leaf), float(i), np.float32)
                  for i, (_, leaf) in enumerate(flat)])
    sd = state_dict_from_flax(tagged)
    checked = sharded = 0
    for name, t in sd.items():
        if "num_batches" in name:
            assert port_mesh.param_spec(name, t.shape, 4, 4) == ()
            continue
        _, leaf = flat[int(t.reshape(-1)[0])]
        # the flax axis that each torch dim came from
        if t.dim() == 4:
            src = (2, 3, 0, 1) if name.endswith(".up.weight") else (3, 2, 0, 1)
        else:
            src = tuple(range(t.dim()))
        for model_size in (1, 2, 4):
            for fsdp_size in (1, 2, 4):
                want = jax_mesh._param_spec((), leaf, model_size, fsdp_size)
                want = tuple(want) + (None,) * (len(np.shape(leaf)) - len(tuple(want)))
                got = port_mesh.param_spec(name, t.shape, model_size, fsdp_size)
                assert got == tuple(want[a] for a in src), (name, model_size, fsdp_size)
                checked += 1
                sharded += any(got)
    assert checked == 9 * (len(sd) - sum("num_batches" in k for k in sd)) and sharded > 0


# (2) the mesh's shape and its error


def test_make_mesh_shapes_match_jax(runs):
    shapes = runs[0][0]["mesh_shapes"]
    assert shapes["default"] == tuple(jax_mesh.make_mesh(4).shape.values()) == (2, 2)
    assert shapes["model4"] == tuple(jax_mesh.make_mesh(4, model_parallel=4).shape.values())
    assert shapes["one"] == tuple(jax_mesh.make_mesh(1).shape.values()) == (1, 1)
    with pytest.raises(ValueError) as err:
        jax_mesh.make_mesh(4, model_parallel=3)
    assert shapes["error"] == str(err.value)
    for n, mp in ((8, None), (8, 4), (6, None), (1, None), (3, None)):
        assert port_mesh.mesh_shape(n, mp) == tuple(jax_mesh.make_mesh(n, mp).shape.values())
    with pytest.raises(ValueError, match="8 devices not divisible by model_parallel=3"):
        port_mesh.mesh_shape(8, 3)


# (3) one dp 2 x tp 2 step and the fsdp steps against JAX's meshed train_step


def _determined(g) -> np.ndarray:
    """The elements whose gradient's sign fp32 determines here: at least 1%
    of the tensor's RMS (the wide layers' gradients lie up to 4e-3 relative
    L2 from float64)."""
    g = np.asarray(g, np.float64)
    return np.abs(g) >= 1e-2 * np.sqrt(np.mean(g * g))


def _check_weights(full, after, clipped, name):
    for k, want in after.items():
        if "num_batches" in k:
            continue
        if "running" in k:
            assert _rel(full[k], want) < 1e-6, (name, k)
        elif k.endswith(BN_FED_BIASES):
            gap = float((full[k] - want).abs().max())
            print(f"{name} {k}: max |port - JAX| {gap:.3e} (AdamW on rounding noise)")
            assert gap <= 4 * LR, (name, k)
        else:
            keep = _determined(clipped[k])
            assert keep.mean() >= 0.75, (name, k)  # the check covers most elements
            got = np.asarray(full[k])[keep]
            assert _rel(got, np.asarray(want)[keep]) < 1e-5, (name, k)


def _check_step(got, ref, name):
    losses, norm, clipped, after = ref
    for a, b in zip(got["losses"], losses):
        assert abs(a - b) <= 1e-5 * abs(b), (name, got["losses"], losses)
    assert norm > 1.0  # the clip engaged
    assert abs(got["grad_norm"] - norm) <= 1e-5 * norm
    _check_weights(got["full"], after, clipped, name)


def _same_statistics(results, name):
    """The running statistics are identical on every data rank of a slice."""
    by_slice = {}
    for r in results:
        by_slice.setdefault(r[name]["coord"][1], []).append(r[name]["running"])
    for group in by_slice.values():
        for other in group[1:]:
            for k, v in group[0].items():
                assert torch.equal(v, other[k]), (name, k)


def test_dp2_tp2_step_matches_jax(runs):
    results, ref, _ = runs
    _check_step(results[0]["step_2x2"], ref["step"], "2x2")
    _same_statistics(results, "step_2x2")


@pytest.mark.parametrize("scenario", ["fsdp_2x2", "fsdp_4x1"])
def test_fsdp_step_matches_jax(runs, scenario):
    results, ref, _ = runs
    _check_step(results[0][scenario], ref["fsdp"], scenario)
    _same_statistics(results, scenario)


# (4) a ragged batch


def test_ragged_batch_is_wrap_padded_as_jax(runs):
    """``fit`` on one batch of 7 on data 2 x model 2: the loss and the
    weights of JAX's step on the batch wrap-padded to 8."""
    results, ref, _ = runs
    got = results[0]["ragged"]
    losses, _, clipped, after = ref["ragged"]
    assert abs(got["history"][0]["train"] - losses[0]) <= 1e-5 * losses[0]
    _check_weights(got["full"], after, clipped, "ragged")


# (5) fsdp's per-rank bytes


@pytest.mark.parametrize("scenario,dp", [("fsdp_2x2", 2), ("fsdp_4x1", 4)])
def test_fsdp_holds_a_data_share_of_the_wide_kernels(runs, scenario, dp):
    """Each wide kernel, and each of its AdamW moments, takes 1/dp of its
    (tensor-parallel slice's) elements on every rank."""
    for r in runs[0]:
        wide = r[scenario]["wide"]
        assert len(wide) == 7  # the 3x3 and 2x2 kernels with 128 or more inputs
        for name, (local, whole, m1, m2) in wide.items():
            assert local * dp == whole and m1 == m2 == local, (name, local, whole)


# (6) the mask family


def test_mask_step_dp2_matches_jax(runs):
    results, ref, _ = runs
    losses, norm, clipped, after = ref["mask"]
    got = results[0]["mask_dp2"]
    assert results[2]["mask_dp2"] is None  # ranks 2-3 lie outside the 2 x 1 mesh
    assert results[1]["mask_dp2"]["losses"] == got["losses"]
    for a, b in zip(got["losses"], losses):
        assert abs(a - b) <= 1e-5 * abs(b), (got["losses"], losses)
    assert abs(got["grad_norm"] - norm) <= 1e-5 * norm
    _check_weights(got["full"], after, clipped, "mask")


# (8) the meshed runner


@pytest.mark.parametrize("scenario", ["runner_2x1", "runner_1x2"])
def test_meshed_runner_matches_jax(runs, scenario):
    """Spectrograms (5 over a 2-wide data axis: the pad and trim) and
    noisy-phase audio against JAX's meshed runner; Griffin-Lim and an
    unbatched clip against the port's unmeshed runner (JAX draws its
    phase from its own key)."""
    results, ref, _ = runs
    got = results[0][scenario]
    spec, audio = ref[scenario]
    assert got["spec"].shape == (5, 32, 32) and got["audio"].shape == (3, 4000)
    np.testing.assert_allclose(got["spec"].numpy(), spec, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["audio"].numpy(), audio, rtol=1e-5, atol=1e-5)
    assert got["sliced"] == (0 if scenario == "runner_2x1" else 37)
    torch.testing.assert_close(got["gl"], got["plain_gl"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["clip"], got["plain_clip"], rtol=1e-5, atol=1e-5)
    assert results[1][scenario]["audio"].equal(got["audio"])  # every rank gets every row


# (12) no launcher, no group


def test_maybe_initialize_is_a_no_op_without_a_launcher(runs, monkeypatch):
    assert runs[0][0]["init_noop"] == "False False"
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert port_dist.maybe_initialize("cpu") is torch.distributed.is_initialized()
    assert port_dist.world_size() >= 1 and port_dist.is_primary()


# (13) the multi-node layout


def test_hybrid_check_prints_hybrid_ok():
    from audiodenoiser_torch.parallel import launch_hybrid_check

    report = launch_hybrid_check(n_nodes=2, local_ranks=2)
    assert report.startswith("HYBRID_OK rank=0/4")
    assert "mesh={'data': 2, 'model': 2}" in report, report
