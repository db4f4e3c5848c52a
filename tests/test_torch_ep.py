"""The port's expert-parallel routed dispatch (``eval.ensemble``:
``make_ep_mesh``, ``denoise_ep``, ``make_a2a_mesh``, ``denoise_ep_a2a``,
and ``cli.test --auto_route --ep``) against the JAX package on the CPU.

Four gloo ranks (``tests/torch_parallel_worker.py``, spawned once in a
module fixture) each forward through one of four seeded narrow
specialists (``random_flax_variables``, width 0.125) behind a seeded fp32
router, while this process runs JAX's mixture of the same weights on the
virtual CPU devices. Answers are held within 1e-5 relative L2 of JAX's on
the same labels (and of the port's host-bucketed dispatch), ``n_passes``
and ``capacity`` equal to JAX's, overflow included (a skewed label set
at capacity factor 1.0); the CLI's metrics within 1e-4, as
``tests/test_torch_ensemble.py``'s.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval import ensemble as port_ens
from audiodenoiser_torch.models import (
    NOISE_CLASSES,
    NoiseClassifier,
    UNet,
    random_flax_variables,
    random_router_flax_variables,
    router_state_dict_from_flax,
    state_dict_from_flax,
)
from audiodenoiser_torch.train.checkpoints import export_model
from audiodenoiser_tpu.eval import ensemble as jax_ens
from audiodenoiser_tpu.models import UNet as FlaxUNet
from audiodenoiser_tpu.models.router import NoiseClassifier as FlaxClassifier
from tests.test_torch_parallel import collect, spawn

NARROW = dict(features=(8, 16, 32, 64), bottleneck=128)  # width_mult 0.125
FACTORS = (1.0, 1.5, 4.0)
TOL, REL = 1e-5, 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nhwc(x):
    return jnp.asarray(np.asarray(x).transpose(0, 2, 3, 1))


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    variables = [random_flax_variables(30 + i, **NARROW) for i in range(4)]
    router = random_router_flax_variables(31)["params"]
    rng = np.random.default_rng(2)
    specs = np.abs(rng.standard_normal((10, 1, 257, 48))).astype(np.float32)
    labels = rng.integers(0, 4, 10)
    skewed = np.array([0, 0, 0, 1, 0, 0, 2, 0, 0, 3])  # expert 0 overflows its buckets
    saved = tmp_path_factory.mktemp("saved_models")
    for nt, v in zip(NOISE_CLASSES, variables):
        path = str(saved / f"unet_denoiser_{nt}.ckpt")
        export_model(path, v["params"], v["batch_stats"])
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump({"width_mult": 0.125}, f)
    export_model(str(saved / "noise_router.ckpt"), router, {})
    npy = tmp_path_factory.mktemp("test_processed")
    for nt in ("white", "urban"):
        for kind in ("clean", "noisy"):
            np.save(npy / f"{kind}_{nt}.npy",
                    np.abs(rng.standard_normal((6, 257, 48))).astype(np.float32))
    return variables, router, specs, labels, skewed, str(saved), str(npy)


def _port_mixture(variables, router):
    experts = {}
    for nt, v in zip(NOISE_CLASSES, variables):
        experts[nt] = UNet(**NARROW)
        experts[nt].load_state_dict(state_dict_from_flax(v))
    model = NoiseClassifier(dtype=torch.float32)
    model.load_state_dict(router_state_dict_from_flax(router), strict=True)
    return port_ens.MixtureOfDenoisers(experts, model, device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory, setup):
    variables, router, specs, labels, skewed, saved, npy = setup
    work = tmp_path_factory.mktemp("ep")
    torch.save({"ep_experts": [state_dict_from_flax(v) for v in variables],
                "ep_router": router_state_dict_from_flax(router), "ep_widths": NARROW,
                "ep_specs": torch.from_numpy(specs), "ep_labels": torch.from_numpy(labels),
                "ep_skewed": torch.from_numpy(skewed), "ep_saved": saved, "ep_npy": npy},
               work / "inputs.pt")
    procs = spawn("ep", 4, work)
    experts = {nt: (FlaxUNet(dtype=jnp.float32, **NARROW), jax.tree_util.tree_map(jnp.asarray, v))
               for nt, v in zip(NOISE_CLASSES, variables)}
    mix = jax_ens.MixtureOfDenoisers(experts, router,
                                     router_model=FlaxClassifier(dtype=jnp.float32))
    dense, a2a = jax_ens.make_ep_mesh(4), jax_ens.make_a2a_mesh()
    x = _nhwc(specs)
    ref = {"dense": mix.denoise_ep(x, dense, labels=labels),
           "dense_routed": mix.denoise_ep(x, dense), "a2a_routed": mix.denoise_ep_a2a(x, a2a),
           "mesh": (tuple(dense.shape.values()), tuple(a2a.shape.values()))}
    for factor in FACTORS:
        for name, lab in (("labels", labels), ("skewed", skewed)):
            stats = {}
            ref[f"a2a_{name}_{factor}"] = (mix.denoise_ep_a2a(x, a2a, factor, labels=lab,
                                                              stats=stats), stats)
    try:
        jax_ens.make_ep_mesh(6)
    except ValueError as e:
        ref["error"] = str(e)
    from audiodenoiser_tpu.cli.test import main as jax_main

    flags = ["--auto_route", "--saved_models_dir", saved, "--test_data_dir", npy,
             "--precision", "f32", "--noise_types", "white", "urban"]
    ref["cli"] = {ep: jax_main(flags + ["--output_dir", str(work / f"jax_{ep}"), "--ep", ep])
                  for ep in ("auto", "dense")}
    return collect(procs, "ep", work), jax.device_get(ref), work


@pytest.fixture(scope="module")
def bucketed(setup):
    """The port's host-bucketed dispatch in this process, on both label sets."""
    variables, router, specs, labels, skewed, _, _ = setup
    mix = _port_mixture(variables, router)
    x = torch.from_numpy(specs)
    return {"labels": mix.denoise(x, labels=labels), "skewed": mix.denoise(x, labels=skewed),
            "routed": mix.denoise(x)}


def test_meshes_are_jax(runs):
    ranks, ref, _ = runs
    assert ranks[0]["ep"]["mesh"] == ref["mesh"] == ((1, 4), (4,))
    assert ranks[0]["ep"]["error"] == ref["error"] == "6 devices not divisible by 4 experts"


@pytest.mark.parametrize("key", ["dense", "dense_routed"])
def test_dense_matches_jax(runs, bucketed, key):
    """The masked sum over the expert ranks, on given labels and on the
    router's, against JAX's one-hot ``psum`` and the bucketed dispatch."""
    ranks, ref, _ = runs
    got = ranks[0]["ep"][key]
    assert got.shape == (10, 1, 257, 48)
    assert _rel(got, _nchw(ref[key])) < TOL
    assert _rel(got, bucketed["labels" if key == "dense" else "routed"]) < 1e-6


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("name", ["labels", "skewed"])
def test_a2a_matches_jax(runs, bucketed, factor, name):
    ranks, ref, _ = runs
    got, stats = ranks[0]["ep"][f"a2a_{name}_{factor}"]
    want, want_stats = ref[f"a2a_{name}_{factor}"]
    assert stats == want_stats
    assert _rel(got, _nchw(want)) < TOL
    assert _rel(got, bucketed[name]) < 1e-6


def test_a2a_overflow_takes_more_passes(runs):
    """Three clips of expert 0 on rank 0 at capacity 1 take three passes."""
    ranks, _, _ = runs
    assert ranks[0]["ep"]["a2a_skewed_1.0"][1] == {"n_passes": 3, "capacity": 1}
    assert ranks[0]["ep"]["a2a_labels_4.0"][1]["n_passes"] == 1


def test_a2a_on_the_router_labels(runs, bucketed):
    ranks, ref, _ = runs
    got = ranks[0]["ep"]["a2a_routed"]
    assert _rel(got, _nchw(ref["a2a_routed"])) < TOL
    assert _rel(got, bucketed["routed"]) < 1e-6


def test_every_rank_has_the_whole_answer(runs):
    ranks, _, _ = runs
    first = ranks[0]["ep"]
    for res in ranks[1:]:
        for key, v in first.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(res["ep"][key], v), key
            elif isinstance(v, tuple) and isinstance(v[0], torch.Tensor):
                assert torch.equal(res["ep"][key][0], v[0]) and res["ep"][key][1] == v[1], key


def _numbers(path):
    out = {}
    with open(path) as f:
        for line in f.read().splitlines()[1:]:
            k, v = line.rsplit(":", 1)
            out[k] = float(v)
    return out


@pytest.mark.parametrize("ep", ["auto", "dense"])
def test_cli_auto_route_ep_matches_jax(runs, setup, ep, tmp_path):
    """``cli.test --auto_route --ep`` on the four ranks against JAX's CLI on
    eight devices (its a2a mesh over the first four; its dense one 2 x 4)
    and against the port's one-process host-bucketed run."""
    from audiodenoiser_torch.cli import test as port_test_cli

    ranks, ref, work = runs
    _, _, _, _, _, saved, npy = setup
    plain = port_test_cli.main(["--auto_route", "--saved_models_dir", saved, "--test_data_dir",
                                npy, "--precision", "f32", "--noise_types", "white", "urban",
                                "--device", "cpu", "--output_dir", str(tmp_path / "plain")])
    got = ranks[0]["ep_cli"][ep]
    assert set(got) == set(ref["cli"][ep]) == {"white", "urban"}
    for nt in got:
        for k, v in ref["cli"][ep][nt].items():
            assert abs(got[nt][k] - v) <= REL * max(1.0, abs(v)), (nt, k)
            assert abs(got[nt][k] - plain[nt][k]) <= REL * max(1.0, abs(v)), (nt, k)
        ours = _numbers(work / f"ep_{ep}" / f"{nt}_routed_metrics.txt")
        theirs = _numbers(work / f"jax_{ep}" / f"{nt}_routed_metrics.txt")
        assert ours.keys() == theirs.keys()
        assert all(abs(ours[k] - v) <= REL * max(1.0, abs(v)) for k, v in theirs.items())
    assert all(r["ep_cli"][ep] == got for r in ranks[1:])


def test_one_process_takes_the_bucketed_dispatch(setup, tmp_path, capsys, monkeypatch):
    """Fewer than four ranks: no expert mesh, whatever the card count (the
    decision reads the process group's world size)."""
    from audiodenoiser_torch.cli import test as port_test_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    _, _, _, _, _, saved, npy = setup
    args = port_test_cli.parse_args(["--auto_route", "--ep", "dense"])
    assert port_test_cli._ep_mesh(args, torch.device("cpu")) is None
    assert "Expert-parallel mesh" not in capsys.readouterr().out


def test_a2a_mesh_needs_four_ranks():
    with pytest.raises(ValueError, match=r"need 4 devices, have 1"):
        port_ens.make_a2a_mesh(device="cpu")
    with pytest.raises(ValueError, match=r"need 9 devices, have 8"):
        jax_ens.make_a2a_mesh(9)
