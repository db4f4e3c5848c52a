"""The port's stage pipeline and 1F1B training (``parallel.pipeline``,
``parallel.pipeline_train``, ``cli.train --pp_stages``) against the JAX
package on the CPU.

Weights come from ``random_flax_variables`` through ``state_dict_from_flax``,
inputs from a numpy seed; JAX's side runs on the virtual CPU devices of
``tests/conftest.py``, one a stage. Tolerances: the stage split and the
1F1B tables equal; the pipelined forward within 1e-5 relative L2; after
two fp32 1F1B steps the losses within 1e-5 relative, every weight and
running variance within 1e-4 relative L2 a tensor but the conv biases that
feed a train-mode BatchNorm, whose gradient is rounding noise on both sides
(ROADMAP C), within 4 x lr, and so the running means, which take that bias
in at the next step's forward. The data-parallel composition
runs on two gloo ranks (``tests/torch_parallel_worker.py``), spawned once.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from audiodenoiser_torch.losses import combined_perceptual_loss
from audiodenoiser_torch.models import UNet, random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.parallel import pipeline as port_pipe
from audiodenoiser_torch.parallel import pipeline_train as port_pt
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_tpu.parallel import pipeline as jax_pipe
from audiodenoiser_tpu.parallel import pipeline_train as jax_pt
from tests.test_torch_parallel import collect, spawn

SMALL = dict(features=(8, 16, 32, 64), bottleneck=128)  # JAX's tests/test_pipeline.py
TWO = dict(features=(4, 8), bottleneck=16)  # JAX's tests/test_pipeline_train.py
LR = 1e-4
BN_FED_BIASES = ("double_conv.0.bias", "double_conv.3.bias")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nhwc(x):
    """(..., C, F, T) -> (..., F, T, C)."""
    x = np.asarray(x)
    return jnp.asarray(np.moveaxis(x, -3, -1))


def _nchw(x):
    return np.moveaxis(np.asarray(x), -1, -3)


def _flax(seed, widths):
    return jax.tree_util.tree_map(jnp.asarray, random_flax_variables(seed, **widths))


# -- the stage split -------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8, 10])
def test_make_stages_matches_jax(n):
    ours = [s.spec for s in port_pipe.make_stages(n, **SMALL)]
    ref = [(s.downs, s.bottleneck, s.ups, s.out_channels)
           for s in jax_pipe.make_stages(n, **SMALL)]
    assert ours == ref


@pytest.mark.parametrize("n", [0, 11])
def test_make_stages_refuses_as_jax(n):
    with pytest.raises(ValueError) as ref:
        jax_pipe.make_stages(n, **SMALL)
    with pytest.raises(ValueError, match=str(ref.value).replace("[", r"\[")):
        port_pipe.make_stages(n, **SMALL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_split_variables_by_key_matches_jax(n):
    variables = random_flax_variables(0, **SMALL)
    sd = state_dict_from_flax(variables)
    ours = port_pipe.split_variables(sd, port_pipe.make_stages(n, **SMALL))
    ref = jax_pipe.split_variables(variables, jax_pipe.make_stages(n, **SMALL))
    for part, jpart in zip(ours, ref):
        # JAX's up{i} block holds up{i}_deconv and up{i}_conv
        assert {k.split(".")[0] for k in part} == {port_pipe.module_name(k.split("_")[0])
                                                  for k in jpart["params"]}
        assert all(part[k] is sd[k] for k in part)
    assert sorted(k for part in ours for k in part) == sorted(sd)


def test_stage_state_dicts_load_strict():
    """A stage's submodules carry ``UNet``'s names: every stage loads its
    slice of a ``UNet`` state dict with ``strict=True``."""
    sd = UNet(**SMALL).state_dict()
    stages = port_pipe.make_stages(4, **SMALL)
    for stage, part in zip(stages, port_pipe.split_variables(sd, stages)):
        stage.load_state_dict(part, strict=True)


# -- the pipelined forward --------------------------------------------------


@pytest.mark.parametrize("n_stages,micro,shape", [(2, 1, (5, 1, 64, 48)),
                                                  (4, 2, (2, 1, 257, 50)),
                                                  (4, 4, (5, 1, 64, 48))])
def test_pipelined_denoiser_matches_jax(n_stages, micro, shape):
    variables = _flax(1, SMALL)
    x = np.abs(np.random.default_rng(n_stages).standard_normal(shape)).astype(np.float32)
    ref = jax_pipe.PipelinedDenoiser(variables, devices=jax.devices()[:n_stages], **SMALL)
    want = _nchw(ref(_nhwc(x), microbatches=micro))
    pipe = port_pipe.PipelinedDenoiser(state_dict_from_flax(jax.device_get(variables)),
                                       devices=["cpu"] * n_stages, **SMALL)
    got = pipe(torch.from_numpy(x), microbatches=micro)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    mono = UNet(**SMALL).eval()
    mono.load_state_dict(state_dict_from_flax(jax.device_get(variables)))
    with torch.no_grad():
        assert _rel(got, mono(torch.from_numpy(x))) < 1e-6


def test_pipelined_denoiser_takes_a_module_and_caps_the_stages():
    model = UNet(**TWO).eval()
    pipe = port_pipe.PipelinedDenoiser(model, devices=["cpu"] * 9, **TWO)
    assert len(pipe.stages) == 6  # two levels: six blocks
    x = torch.rand(3, 1, 32, 32)
    with torch.no_grad():
        torch.testing.assert_close(pipe(x, microbatches=3), model(x), rtol=0, atol=1e-6)


# -- the 1F1B tables ---------------------------------------------------------


@pytest.mark.parametrize("S,M", [(1, 1), (1, 4), (2, 2), (2, 4), (3, 8), (4, 3), (4, 4),
                                 (4, 6), (4, 7), (8, 3)])
def test_schedule_1f1b_equals_jax(S, M):
    fwd, bwd = port_pt.schedule_1f1b(S, M)
    ref_fwd, ref_bwd = jax_pt.schedule_1f1b(S, M)
    np.testing.assert_array_equal(fwd, ref_fwd)
    np.testing.assert_array_equal(bwd, ref_bwd)
    assert fwd.dtype == ref_fwd.dtype == np.int32


@pytest.mark.parametrize("S,M", [(2, 4), (3, 5), (4, 3), (4, 4)])
def test_schedule_forward_equals_jax(S, M):
    got, ref = port_pt.schedule_forward(S, M), jax_pt.schedule_forward(S, M)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype


# -- the trainer --------------------------------------------------------------


IN = (1, 32, 32)  # (C, F, T); the port's loss needs at least 32 frames


def _batch(seed, n_micro, rows):
    rng = np.random.default_rng(seed)
    noisy = np.abs(rng.standard_normal((n_micro, rows, *IN))).astype(np.float32)
    clean = (0.8 * noisy + 0.1 * rng.random(noisy.shape)).astype(np.float32)
    return noisy, clean


def _jax_steps(variables, n_stages, noisy, clean, n_steps):
    mesh = Mesh(np.asarray(jax.devices()[:n_stages]), ("stage",))
    trainer = jax_pt.PipelineTrainer(mesh, micro_batch=noisy.shape[1], n_micro=noisy.shape[0],
                                     input_shape=(IN[1], IN[2], IN[0]), **TWO,
                                     learning_rate=LR)
    state = trainer.init(variables)
    losses = []
    for _ in range(n_steps):
        state, loss = trainer.step(state, _nhwc(noisy), _nhwc(clean))
        losses.append(float(loss))
    return trainer, state, losses


def _check_state(ours: dict, ref: dict, lr: float = LR):
    for k, want in ref.items():
        if not want.is_floating_point():
            continue
        got = ours[k]
        if k.endswith(BN_FED_BIASES + ("running_mean",)):
            assert float((got - want).abs().max()) <= 4 * lr, k
        else:
            assert _rel(got, want) < 1e-4, (k, _rel(got, want))


@pytest.fixture(scope="module")
def jax_runs():
    """Two fp32 1F1B steps of JAX's trainer at S = 2 and 4, M = 4."""
    variables = _flax(2, TWO)
    noisy, clean = _batch(3, 4, 2)
    out = {}
    for s in (2, 4):
        trainer, state, losses = _jax_steps(variables, s, noisy, clean, 2)
        out[s] = (losses, state_dict_from_flax(jax.device_get(trainer.unpack_state(state))),
                  np.asarray(trainer.forward(state, _nhwc(noisy))))
    return jax.device_get(variables), noisy, clean, out


@pytest.mark.parametrize("n_stages", [2, 4])
def test_trainer_steps_match_jax(jax_runs, n_stages):
    variables, noisy, clean, ref = jax_runs
    losses, after, _ = ref[n_stages]
    trainer = port_pt.PipelineTrainer(["cpu"] * n_stages, micro_batch=2, n_micro=4,
                                      input_shape=IN, **TWO, learning_rate=LR)
    state = trainer.init(state_dict_from_flax(variables))
    for step in range(2):
        state, loss = trainer.step(state, torch.from_numpy(noisy), torch.from_numpy(clean))
        assert abs(float(loss) - losses[step]) <= 1e-5 * abs(losses[step])
    assert state.step == 2
    _check_state(trainer.unpack_state(state), after)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipelined_forward_matches_jax(jax_runs, n_stages):
    """``forward`` after the two steps, eval-mode BatchNorm on the running
    statistics the steps left, against JAX's ``forward``."""
    variables, noisy, clean, ref = jax_runs
    _, after, want = ref[n_stages]
    trainer = port_pt.PipelineTrainer(["cpu"] * n_stages, micro_batch=2, n_micro=4,
                                      input_shape=IN, **TWO, learning_rate=LR)
    got = trainer.forward(trainer.init(after), torch.from_numpy(noisy))
    assert got.shape == noisy.shape
    assert _rel(got, _nchw(want)) < 1e-5


def _mono_step(sd, noisy, clean, lr=LR, dtype=torch.float32):
    """Sequential per-microbatch accumulation on the whole ``UNet``: the
    pipeline's semantics (BatchNorm on each microbatch, the mean loss)."""
    model = UNet(**TWO, dtype=dtype)
    model.load_state_dict(sd)
    state = port_loop.create_train_state(0, model, learning_rate=lr, device="cpu")
    state.model.load_state_dict(sd)
    state.model.train()
    total = 0.0
    for m in range(noisy.shape[0]):
        loss = combined_perceptual_loss(state.model(noisy[m]), clean[m]).total / noisy.shape[0]
        loss.backward()
        total += float(loss)
    norm = state.optimizer.step()
    return total, float(norm), state.model.state_dict()


@pytest.mark.parametrize("n_stages,n_micro", [(1, 1), (3, 5), (6, 2)])
def test_trainer_is_monolithic_accumulation(n_stages, n_micro):
    sd = state_dict_from_flax(random_flax_variables(4, **TWO))
    noisy, clean = (torch.from_numpy(a) for a in _batch(5, n_micro, 3))
    loss, norm, want = _mono_step(sd, noisy, clean)
    trainer = port_pt.PipelineTrainer(["cpu"] * n_stages, micro_batch=3, n_micro=n_micro,
                                      input_shape=IN, **TWO, learning_rate=LR)
    state, got = trainer.step(trainer.init(sd), noisy, clean)
    assert abs(float(got) - loss) <= 1e-6 * loss
    assert abs(float(state.grad_norm) - norm) <= 1e-5 * norm
    _check_state(trainer.unpack_state(state), want)


def test_trainer_refuses_a_batch_of_another_shape():
    trainer = port_pt.PipelineTrainer(["cpu"] * 2, micro_batch=2, n_micro=4, input_shape=IN,
                                      **TWO)
    state = trainer.init(UNet(**TWO).state_dict())
    with pytest.raises(ValueError, match=r"expected a batch of shape \(4, 2, 1, 32, 32\)"):
        trainer.step(state, torch.zeros(4, 3, *IN), torch.zeros(4, 3, *IN))


def test_pack_unpack_and_moments_round_trip():
    sd = state_dict_from_flax(random_flax_variables(6, **TWO))
    trainer = port_pt.PipelineTrainer(["cpu"] * 4, micro_batch=1, n_micro=2, input_shape=IN,
                                      **TWO)
    state = trainer.init(sd)
    got = trainer.unpack_state(state)
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    noisy, clean = (torch.from_numpy(a) for a in _batch(7, 2, 1))
    state, _ = trainer.step(state, noisy, clean)
    moments = trainer.optimizer_state(state)
    assert set(moments) == {n for n, p in UNet(**TWO).named_parameters()}
    # another stage count resumes the same state: the next step agrees
    other = port_pt.PipelineTrainer(["cpu"] * 3, micro_batch=1, n_micro=2, input_shape=IN,
                                    **TWO)
    resumed = other.pack_state(trainer.unpack_state(state), moments, state.step)
    a, la = trainer.step(state, noisy, clean)
    b, lb = other.step(resumed, noisy, clean)
    assert float(la) == pytest.approx(float(lb), rel=1e-6)
    sa, sb = trainer.unpack_state(a), other.unpack_state(b)
    assert all(_rel(sa[k], sb[k]) < 1e-6 for k in sa if sa[k].is_floating_point())


def test_bf16_stages_compute_in_bf16():
    sd = state_dict_from_flax(random_flax_variables(8, **TWO))
    noisy, clean = (torch.from_numpy(a) for a in _batch(9, 2, 2))
    trainer = port_pt.PipelineTrainer(["cpu"] * 2, micro_batch=2, n_micro=2, input_shape=IN,
                                      **TWO, dtype=torch.bfloat16)
    state, loss = trainer.step(trainer.init(sd), noisy, clean)
    ref, _, _ = _mono_step(sd, noisy, clean, dtype=torch.bfloat16)
    assert np.isfinite(float(loss)) and abs(float(loss) - ref) <= 1e-2 * ref
    assert all(p.dtype == torch.float32 for s in state.stages for p in s.parameters())


# -- data parallel: two gloo ranks, each a pipeline ----------------------------


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("pp")
    variables = random_flax_variables(10, **TWO)
    noisy, clean = _batch(11, 3, 4)  # 2 rows a data rank
    torch.save({"pp_sd": state_dict_from_flax(variables), "pp_noisy": torch.from_numpy(noisy),
                "pp_clean": torch.from_numpy(clean), "pp_widths": TWO, "pp_lr": LR},
               work / "inputs.pt")
    procs = spawn("pp", 2, work)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "stage"))
    trainer = jax_pt.PipelineTrainer(mesh, micro_batch=2, n_micro=3,
                                     input_shape=(IN[1], IN[2], IN[0]), **TWO, learning_rate=LR)
    state, loss = trainer.step(trainer.init(jax.tree_util.tree_map(jnp.asarray, variables)),
                               _nhwc(noisy), _nhwc(clean))
    start = trainer.init(jax.tree_util.tree_map(jnp.asarray, variables))
    ref = (float(loss), state_dict_from_flax(jax.device_get(trainer.unpack_state(state))),
           _nchw(trainer.forward(start, _nhwc(noisy))))
    return collect(procs, "pp", work), ref


def test_dp_pp_step_matches_jax(dp_runs):
    """('data', 'stage') 2 x 4 in JAX, two ranks of four CPU stages here:
    the gradients, the statistics and the loss averaged over the ranks."""
    ranks, (loss, after, _) = dp_runs
    for res in ranks:
        got = res["pp_dp2"]
        assert abs(got["loss"] - loss) <= 1e-5 * loss
        _check_state(got["state"], after)
    a, b = (r["pp_dp2"]["state"] for r in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_dp_pp_forward_gathers_the_rows(dp_runs):
    ranks, (_, _, want) = dp_runs
    for res in ranks:
        got = res["pp_dp2"]["forward"]
        assert got.shape == want.shape and _rel(got, want) < 1e-5


# -- cli.train --pp_stages ---------------------------------------------------------


def _npy_set(root, n=10, shape=(70, 40)):
    d = root / "white"
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(12)
    for i in range(n):
        clean = np.abs(rng.standard_normal(shape)).astype(np.float32)
        np.save(d / f"clean_chunk_{i}.npy", clean)
        np.save(d / f"noisy_chunk_{i}.npy",
                clean + 0.3 * np.abs(rng.standard_normal(shape)).astype(np.float32))
    return str(root)


def _tiny(dtype=torch.float32, remat=False, **kw):
    return UNet(**TWO, dtype=dtype)


def _argv(data, out, *extra):
    return ["--base_dataset_path", data, "--noise_type", "white", "--output_path", out,
            "--run_name", "pp", "--batch_size", "4", "--precision", "f32", "--device", "cpu",
            "--num_workers", "1", *extra]


def test_cli_pp_trains_exports_and_resumes(tmp_path, monkeypatch):
    from audiodenoiser_torch.cli.train import main
    from audiodenoiser_torch.train.checkpoints import load_exported

    monkeypatch.setattr(port_loop, "UNet", _tiny)
    data = _npy_set(tmp_path / "data")
    saved = tmp_path / "saved"
    out = str(tmp_path / "runs")
    first = main(_argv(data, out, "--pp_stages", "2", "--pp_microbatches", "2", "--epochs", "1",
                       "--export_dir", str(saved)))
    log = (tmp_path / "runs" / "pp" / "training.log").read_text()
    assert "1F1B pipeline-parallel run: mesh {'data': 1, 'stage': 2}, 2 microbatches x 2" in log
    assert first["history"][0]["epoch"] == 0 and first["steps"] == 2  # 9 rows: 4 + 4 + 1
    assert "dropping ragged final batch (1 < 4 rows)" in log
    assert os.path.exists(tmp_path / "runs" / "pp" / "checkpoints" / "pp_train_state.pt")
    # the export is the pipeline's weights, in the standard .ckpt
    full = first["trainer"].unpack_state(first["state"])
    tree = load_exported(str(saved / "unet_denoiser_white.ckpt"))
    loaded = UNet(**TWO)
    loaded.load_state_dict(state_dict_from_flax(tree))
    assert all(torch.equal(loaded.state_dict()[k], full[k]) for k in full
               if full[k].is_floating_point())
    second = main(_argv(data, out, "--pp_stages", "3", "--pp_microbatches", "2", "--epochs", "2",
                        "--resume"))
    assert [h["epoch"] for h in second["history"]] == [1]
    assert second["state"].step == 4 and np.isfinite(second["history"][0]["train"])


@pytest.mark.parametrize("extra,stop", [
    (["--model", "complex_mask", "--pipeline", "on_device"], None),
    (["--attn_bottleneck"], None), (["--s2d_stem"], None),
    (["--lr_schedule", "cosine"], None), (["--ema_decay", "0.9"], None), (["--fsdp"], None),
    (["--batch_size", "6"], "batch_size 6 must divide by pp_microbatches*data (4*1)")])
def test_cli_pp_refusals_are_jax(tmp_path, extra, stop):
    """JAX's refusals of ``--pp_stages``, word for word against JAX's CLI
    on the same files (JAX's at 8 stages: one data replica, as here)."""
    from audiodenoiser_torch.cli.train import main
    from audiodenoiser_tpu.cli.train import main as jax_main
    from audiodenoiser_torch.data.wav_io import write_wav

    data = _npy_set(tmp_path / "data")
    clean = tmp_path / "data" / "clean"
    clean.mkdir()
    write_wav(str(clean / "c.wav"), np.zeros(40000), 8000)
    argv = ["--base_dataset_path", data, "--noise_type", "white", "--output_path",
            str(tmp_path / "runs"), "--pp_stages", "8", *extra]
    with pytest.raises(SystemExit) as ref:
        jax_main(argv)
    with pytest.raises(SystemExit) as ours:
        main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(ref.value)
    if stop is not None:
        assert str(ours.value) == stop


@pytest.mark.parametrize("visible,stages,ok", [(1, 1, True), (1, 2, False), (8, 4, True),
                                               (6, 4, False)])
def test_pp_stages_take_the_first_cards(monkeypatch, visible, stages, ok):
    """On the card the stages are the process's first cards, which the
    stage count must divide (JAX's message, the card count for JAX's
    device count)."""
    from audiodenoiser_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if ok:
        got = train_cli._pp_devices(stages, torch.device("cuda"))
        assert got == [torch.device("cuda", i) for i in range(stages)]
    else:
        with pytest.raises(SystemExit,
                           match=f"--pp_stages {stages} does not divide {visible} devices"):
            train_cli._pp_devices(stages, torch.device("cuda"))
