"""The port's space-to-depth variants (``UNet(s2d_stem=True)``, with and
without the ``s2d_skip`` refinement path) against the JAX package's, on
the same numpy-seeded inputs and converted weights (mirroring JAX
``tests/test_s2d.py``): the packing order, both families' forwards at the
training crop and at odd shapes, live BatchNorm in eval and train mode
(fp32 within 1e-5 relative L2), the residual mask's identity at init, the
parameter counts at full width (JAX's ``eval_shape``), fold parity (fp32
1e-5, bf16 2e-2 as JAX's test), an export with its sidecar through
``load_model_for_noise`` and a 2-step CPU ``cli.train --s2d_stem
--s2d_skip 8``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiodenoiser_torch.eval.runner import load_model_for_noise
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    UNet,
    count_params,
    depth_to_space,
    flax_from_state_dict,
    fold_for_inference,
    random_flax_variables,
    space_to_depth,
    state_dict_from_flax,
)
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_tpu.models import ComplexMaskUNet as JaxComplexMaskUNet
from audiodenoiser_tpu.models import UNet as JaxUNet
from audiodenoiser_tpu.models import fold_runner_inputs
from audiodenoiser_tpu.models.unet import depth_to_space as jax_depth_to_space
from audiodenoiser_tpu.models.unet import space_to_depth as jax_space_to_depth
from audiodenoiser_tpu.train import checkpoints as jax_ckpt

TINY = dict(features=(8, 16), bottleneck=32)
TOL = 1e-5
VARIANTS = {"s2d": dict(s2d_stem=True), "s2d_skip8": dict(s2d_stem=True, s2d_skip=8)}
FAMILIES = {"unet": (UNet, JaxUNet, 1, 1, {}),
            "mask": (ComplexMaskUNet, JaxComplexMaskUNet, 3, 2,
                     dict(mask_bound=8.0, residual=True))}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


def _apply(jm, v, x):
    """A JAX model's eval forward, jitted (one compile beats eager dispatch)."""
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))


def _pair(family, variant, seed=0, dtype=torch.float32, jax_dtype=jnp.float32):
    cls, jcls, cin, cout, head = FAMILIES[family]
    kw = VARIANTS[variant]
    v = random_flax_variables(seed, **TINY, in_channels=cin, out_channels=cout, **kw)
    ours = cls(**TINY, **kw, **head, dtype=dtype)
    ours.load_state_dict(state_dict_from_flax(v), strict=True)
    return ours, jcls(**TINY, **kw, **head, dtype=jax_dtype), v, cin


class TestS2DOps:
    def test_roundtrip_and_jax_channel_order(self):
        x = np.random.default_rng(0).standard_normal((2, 8, 6, 3)).astype(np.float32)
        packed = space_to_depth(_nchw(x))
        assert packed.shape == (2, 12, 4, 3)
        assert np.array_equal(_nhwc(packed), np.asarray(jax_space_to_depth(jnp.asarray(x))))
        back = depth_to_space(packed, 3)
        assert np.array_equal(_nhwc(back), x)
        assert np.array_equal(_nhwc(back), np.asarray(jax_depth_to_space(
            jax_space_to_depth(jnp.asarray(x)), 3)))

    def test_channel_order_row_major_phase(self):
        # pixel (2p+a, 2q+b, c) lands at channel (a*2 + b)*C + c; torch's
        # pixel_unshuffle packs c*4 + a*2 + b, which agrees only at C = 1
        x = torch.arange(2 * 4 * 2, dtype=torch.float32).reshape(1, 2, 2, 4)  # C = 2
        packed = space_to_depth(x)[0, :, 0, 0]
        assert packed.tolist() == [x[0, 0, 0, 0], x[0, 1, 0, 0], x[0, 0, 0, 1], x[0, 1, 0, 1],
                                   x[0, 0, 1, 0], x[0, 1, 1, 0], x[0, 0, 1, 1], x[0, 1, 1, 1]]
        assert not torch.equal(space_to_depth(x), torch.nn.functional.pixel_unshuffle(x, 2))


class TestForward:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    @pytest.mark.parametrize("family", list(FAMILIES))
    @pytest.mark.parametrize("shape", [(2, 256, 64), (1, 33, 17)])
    def test_eval_matches_jax(self, family, variant, shape):
        ours, jm, v, cin = _pair(family, variant)
        x = np.random.default_rng(1).standard_normal((*shape, cin)).astype(np.float32)
        ref = _apply(jm, v, x)
        with torch.no_grad():
            got = _nhwc(ours.eval()(_nchw(x)))
        assert got.shape == ref.shape == (*shape, FAMILIES[family][3])
        assert _rel(got, ref) < TOL

    @pytest.mark.parametrize("variant", list(VARIANTS))
    @pytest.mark.parametrize("family", list(FAMILIES))
    def test_train_mode_matches_jax(self, family, variant):
        """Live BatchNorm on the batch: the output and the running
        statistics it folds (at an odd shape, so the pad is inside)."""
        ours, jm, v, cin = _pair(family, variant, seed=2)
        x = np.random.default_rng(3).standard_normal((3, 65, 34, cin)).astype(np.float32)
        ref, updates = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
        with torch.no_grad():
            got = _nhwc(ours.train()(_nchw(x)))
        assert _rel(got, np.asarray(ref)) < TOL
        stats = flax_from_state_dict(ours.state_dict())["batch_stats"]
        leaves = jax.tree_util.tree_leaves_with_path(updates["batch_stats"])
        for path, leaf in leaves:
            node = stats
            for p in path:
                node = node[p.key]
            assert _rel(node, np.asarray(leaf)) < TOL, path


class TestInit:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    def test_residual_mask_identity_at_init(self, variant):
        """``zero_out_init`` zeroes the last conv (``s2d_refine`` with the
        refinement path, the 1x1 head otherwise): a fresh residual mask
        model is an exact pass-through, as JAX's."""
        model = port_loop.init_flax_like(ComplexMaskUNet(
            **TINY, **VARIANTS[variant], mask_bound=8.0, residual=True, zero_out_init=True), 0)
        if variant == "s2d_skip8":
            assert model.head is model.s2d_refine
            assert float(model.out.weight.detach().abs().sum()) > 0
        assert float(model.head.weight.detach().abs().sum()) == 0.0
        x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 3, 64, 32))
                             .astype(np.float32))
        with torch.no_grad():
            mask = model.eval()(x)
        assert mask.shape == (2, 2, 64, 32)
        assert torch.equal(mask[:, 0], torch.ones_like(mask[:, 0]))
        assert torch.equal(mask[:, 1], torch.zeros_like(mask[:, 1]))

    def test_layout_matches_jax_init(self):
        """The port's Flax tree has JAX's parameter names and shapes."""
        for family in FAMILIES:
            for variant in VARIANTS:
                ours, jm, _, cin = _pair(family, variant)
                shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0),
                                                        jnp.zeros((1, 64, 64, cin))))
                want = jax.tree_util.tree_map(lambda s: s.shape, shapes["params"])
                got = jax.tree_util.tree_map(
                    lambda a: a.shape, flax_from_state_dict(ours.state_dict())["params"])
                assert got == want, (family, variant)


# full-width parameter counts, as JAX's eval_shape gives them
FULL_COUNTS = [
    ("unet", {}, 31_042_369),
    ("unet", dict(s2d_stem=True), 31_044_292),
    ("unet", dict(s2d_stem=True, s2d_skip=16), 31_048_641),
    ("unet", dict(attn_bottleneck=True), 32_094_785),
    ("mask", dict(s2d_stem=True, s2d_skip=16), 31_053_826),
    ("mask", dict(attn_bottleneck=True), 32_096_002),
]


class TestParamCounts:
    @pytest.mark.parametrize("family,kw,count", FULL_COUNTS,
                             ids=[f"{f}-{'-'.join(k) or 'plain'}" for f, k, _ in FULL_COUNTS])
    def test_full_width_counts_match_jax(self, family, kw, count):
        cls, jcls, cin, _, _ = FAMILIES[family]
        assert count_params(cls(**kw)) == count
        shapes = jax.eval_shape(lambda: jcls(**kw).init(jax.random.key(0),
                                                        jnp.zeros((1, 64, 64, cin))))
        assert sum(int(np.prod(s.shape)) for s in
                   jax.tree_util.tree_leaves(shapes["params"])) == count

    def test_delta_vs_plain(self):
        # stem 3x3x(4-1)x64 = +1728, head (1x1x64x3 + 3) = +195
        assert count_params(UNet(s2d_stem=True)) - count_params(UNet()) == 1728 + 195


class TestFold:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    @pytest.mark.parametrize("family", list(FAMILIES))
    def test_fold_parity_including_odd_shape(self, family, variant):
        """fp32: the port's fold against JAX's live model within 1e-5;
        bf16: the port's bf16 fold against JAX's bf16 fold within 2e-2."""
        ours, jm, v, cin = _pair(family, variant, seed=4)
        folded32 = fold_for_inference(ours.eval(), torch.float32)
        folded16 = fold_for_inference(ours.eval(), torch.bfloat16)
        assert folded32.s2d_stem and folded32.s2d_skip == VARIANTS[variant].get("s2d_skip", 0)
        _, jm16, _, _ = _pair(family, variant, seed=4, jax_dtype=jnp.bfloat16)
        jfm, jfv = fold_runner_inputs(jm16, v)
        rng = np.random.default_rng(5)
        for shape in [(2, 64, 32), (1, 257, 33)]:
            x = rng.standard_normal((*shape, cin)).astype(np.float32)
            ref = _apply(jm, v, x)
            got = _nhwc(folded32(_nchw(x)))
            assert got.shape == ref.shape and _rel(got, ref) < TOL
            ref16 = np.asarray(jax.jit(lambda v, x: jfm.apply(v, x, train=False))(
                jfv, jnp.asarray(x)))
            assert _rel(_nhwc(folded16(_nchw(x))), ref16) < 2e-2


class TestSidecar:
    @pytest.mark.parametrize("stem,family,meta", [
        ("unet_denoiser", "unet", {"s2d_stem": True, "width_mult": 0.25}),
        ("mask_denoiser", "mask", {"mask_bound": 8.0, "residual": True, "s2d_stem": True,
                                   "s2d_skip": 8, "width_mult": 0.25}),
    ])
    def test_export_load_roundtrip(self, tmp_path, stem, family, meta):
        """A JAX export and its sidecar: ``load_model_for_noise`` rebuilds
        the variant at width 0.25 and serves JAX's forward."""
        from audiodenoiser_torch.models import width_kwargs
        from audiodenoiser_tpu.eval.runner import load_model_for_noise as jax_load

        _, _, cin, cout, _ = FAMILIES[family]
        kw = {k: meta[k] for k in ("s2d_stem", "s2d_skip") if k in meta}
        v = random_flax_variables(6, **width_kwargs(0.25), in_channels=cin, out_channels=cout,
                                  **kw)
        path = tmp_path / f"{stem}_mixed.ckpt"
        jax_ckpt.export_model(str(path), v["params"], v["batch_stats"])
        with open(tmp_path / f"{stem}_mixed.json", "w") as f:
            json.dump(meta, f)
        ours = load_model_for_noise("mixed", str(tmp_path), dtype=torch.float32, device="cpu",
                                    stem=stem)
        assert ours.s2d_stem and ours.s2d_skip == meta.get("s2d_skip", 0)
        jm, jv = jax_load("mixed", str(tmp_path), dtype=jnp.float32, stem=stem)
        x = np.abs(np.random.default_rng(7).standard_normal((1, 65, 40, cin))).astype(np.float32)
        ref = _apply(jm, jv, x)
        with torch.no_grad():
            assert _rel(_nhwc(ours(_nchw(x))), ref) < TOL


def test_cli_train_s2d_skip(tmp_path, monkeypatch):
    """Two CPU steps of ``cli.train --s2d_stem --s2d_skip 8`` (magnitude
    family, narrow widths): the run builds the variant, its export and
    sidecar carry JAX's keys and load back into it; ``--s2d_skip``
    without ``--s2d_stem`` is refused with JAX's message."""
    from audiodenoiser_torch.cli.train import main
    from audiodenoiser_torch.train.checkpoints import load_exported

    built = []

    def narrow(dtype=torch.float32, remat=False, **kw):
        built.append(kw)
        return UNet(**TINY, dtype=dtype, remat=remat, **kw)

    monkeypatch.setattr(port_loop, "UNet", narrow)
    data = tmp_path / "npy"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        clean = np.abs(rng.standard_normal((64, 32))).astype(np.float32)
        np.save(data / f"clean_chunk_{i}.npy", clean)
        np.save(data / f"noisy_chunk_{i}.npy", clean + 0.3 * np.abs(rng.standard_normal(
            (64, 32))).astype(np.float32))
    saved = tmp_path / "saved"
    out = main(["--base_dataset_path", str(data), "--noise_type", "white", "--epochs", "1",
                "--batch_size", "3", "--precision", "f32", "--device", "cpu",
                "--output_path", str(tmp_path / "runs"), "--run_name", "s", "--s2d_stem",
                "--s2d_skip", "8", "--export_dir", str(saved)])
    assert out["steps"] == 2 and built == [{"attn_bottleneck": False, "s2d_stem": True,
                                            "s2d_skip": 8}]
    meta = {"width_mult": 1.0, "s2d_stem": True, "s2d_skip": 8}
    for sidecar in (os.path.splitext(out["best_path"])[0] + ".json",
                    saved / "unet_denoiser_white.json"):
        with open(sidecar) as f:
            assert json.load(f) == meta
    params = load_exported(str(saved / "unet_denoiser_white.ckpt"))["params"]
    assert params["s2d_refine"]["kernel"].shape == (3, 3, 16, 1)
    assert params["down0"]["conv0"]["kernel"].shape == (3, 3, 4, TINY["features"][0])
    with pytest.raises(SystemExit, match="--s2d_skip requires --s2d_stem"):
        main(["--base_dataset_path", str(data), "--noise_type", "white", "--s2d_skip", "8"])


def test_distillation_across_s2d_and_plain_is_refused():
    """The feature term compares bottleneck maps, which an s2d student and a
    plain teacher have at different sizes: JAX fails on it, the port
    refuses it with a plain message (no resize)."""
    from audiodenoiser_torch.train import mask as port_mask

    teacher = ComplexMaskUNet(**TINY, mask_bound=2.0, residual=True).eval().requires_grad_(False)
    student = port_mask.create_mask_train_state(0, ComplexMaskUNet(
        **TINY, s2d_stem=True, residual=True, zero_out_init=True), device="cpu")
    rng = np.random.default_rng(9)
    clean = torch.from_numpy(0.2 * rng.standard_normal((1, 8000)).astype(np.float32))
    step = port_mask.make_mask_steps(0.5, 30.0, teacher=teacher, distill_feat_weight=1.0)[0]
    with pytest.raises(ValueError, match="the feature term needs one size"):
        step(student, clean + 0.1, clean)
