"""The complex-mask step's CUDA graph (``train.step_graph``) on the CPU.

On the CPU every call of the wrapped train step runs eagerly, counted as
``eager_cpu``, and gives the eager step's results bit for bit. What a
capture needs of the optimizer (``ClippedAdamW.make_capturable``) leaves
what an eager caller reads as it was: ``state_dict`` writes the eager form
(step counts on the host, the rate a float), which round-trips through
``train.checkpoints`` and resumes to the same updates, and the model's
export is unchanged. The hook test that decides eligibility and the
identity mask's cache are held here too; the graph itself runs on the
card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from audiodenoiser_torch.data.synth import synth_chunks
from audiodenoiser_torch.models import flax_from_state_dict
from audiodenoiser_torch.models.complex_mask import ComplexMaskUNet, _identity_mask, mask_head
from audiodenoiser_torch.ops.cuda import variant_launches
from audiodenoiser_torch.train import checkpoints as port_ckpt
from audiodenoiser_torch.train import loop as port_loop
from audiodenoiser_torch.train import mask as port_mask
from audiodenoiser_torch.train import step_graph

TINY = dict(features=(4, 8), bottleneck=16)
CLIP = 4096  # a hop multiple of 33 frames: the mask step's loss needs 32


def _batch(seed=0, rows=2):
    clean = torch.from_numpy(synth_chunks(rows, seed=seed)[:, :CLIP])
    noise = torch.randn(clean.shape, generator=torch.Generator().manual_seed(seed + 1))
    return (clean + 0.1 * noise).clamp(-1, 1), clean


def _state(**opt):
    model = ComplexMaskUNet(mask_bound=8.0, residual=True, **TINY)
    return port_mask.create_mask_train_state(0, model, device="cpu", **opt)


def _counts_since(before):
    return {k: v - before[k] for k, v in variant_launches(step_graph.counts).items()
            if v != before[k]}


@pytest.mark.parametrize("si_sdr_weight", [0.0, 0.5])
def test_cpu_steps_are_the_eager_steps(si_sdr_weight):
    train_step, _ = port_mask.make_mask_steps(si_sdr_weight, 30.0)
    assert isinstance(train_step, step_graph.GraphedStep)
    wrapped, eager = _state(), _state()
    before = variant_launches(step_graph.counts)
    for k in range(3):
        noisy, clean = _batch(k)
        _, got = train_step(wrapped, noisy, clean)
        _, want = train_step.step(eager, noisy, clean)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(wrapped.grad_norm, eager.grad_norm)
    assert _counts_since(before) == {"eager_cpu": 3}
    assert wrapped.step == eager.step == 3 and wrapped.optimizer.updates == 3
    for (n, a), b in zip(wrapped.model.state_dict().items(), eager.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert not wrapped.optimizer.graphs
    assert not any(g["capturable"] for g in wrapped.optimizer.adamw.param_groups)


def test_counts_read_like_the_kernels_counters():
    counts = variant_launches(step_graph.counts)
    reasons = {f"eager_{r}" for r in step_graph.EAGER_REASONS}
    assert set(counts) == {"capture", "replay"} | reasons
    assert step_graph.counts.launches == sum(counts.values())


def test_a_cpu_call_is_eager_whatever_else_applies():
    """The device is tested first: a teacher, accumulation and a hook on the
    CPU count as ``cpu``."""
    state = _state(grad_accum=2)
    state.model.register_forward_hook(lambda *_: None)
    step = port_mask.make_mask_steps(0.5, 30.0, teacher=ComplexMaskUNet(**TINY),
                                     distill_weight=0.5)[0]
    assert step.eager_reason(state, *_batch()) == "cpu"


@pytest.mark.parametrize("where", ["forward", "forward_pre", "submodule", "full_backward",
                                   "global_forward", "parameter", "post_accumulate"])
def test_every_kind_of_hook_is_seen(where):
    model = ComplexMaskUNet(**TINY)
    assert not step_graph._hooked(model)
    sub = model.bottleneck
    hooks = {
        "forward": lambda: model.register_forward_hook(lambda *_: None),
        "forward_pre": lambda: model.register_forward_pre_hook(lambda *_: None),
        "submodule": lambda: sub.register_forward_hook(lambda *_: None),
        "full_backward": lambda: sub.register_full_backward_hook(lambda *_: None),
        "global_forward": lambda: torch.nn.modules.module.register_module_forward_hook(
            lambda *_: None),
        "parameter": lambda: model.head.weight.register_hook(lambda g: g),
        "post_accumulate": lambda: model.head.weight.register_post_accumulate_grad_hook(
            lambda p: None),
    }
    handle = hooks[where]()
    try:
        assert step_graph._hooked(model)
    finally:
        handle.remove()
    assert not step_graph._hooked(model)


@pytest.mark.parametrize("opt_kw", [{}, dict(schedule="cosine", warmup_steps=1, total_steps=9),
                                    dict(schedule="constant", warmup_steps=3)],
                         ids=["constant", "cosine", "warmup"])
def test_capturable_optimizer_saves_and_resumes_as_the_eager_one(tmp_path, opt_kw):
    """Three eager steps; the optimizer made capturable writes the same
    resume state as before, every leaf bit-equal, through
    ``train.checkpoints``; both states resume to the same two updates; the
    model's JAX-layout export is the model's own."""
    train_step = port_mask.make_mask_steps(0.5, 30.0)[0].step
    state = _state(**opt_kw)
    for k in range(3):
        train_step(state, *_batch(k))
    eager_sd = state.optimizer.state_dict()
    state.optimizer.make_capturable()
    state.optimizer.make_capturable()  # once done, a no-op
    group = state.optimizer.adamw.param_groups[0]
    assert group["capturable"]
    assert torch.is_tensor(group["lr"]) == bool(opt_kw)
    capt_sd = state.optimizer.state_dict()
    assert capt_sd["adamw"]["param_groups"] == eager_sd["adamw"]["param_groups"]
    for i, st in eager_sd["adamw"]["state"].items():
        for key, t in st.items():
            got = capt_sd["adamw"]["state"][i][key]
            assert got.device == t.device and got.dtype == t.dtype and torch.equal(got, t), key
    path = str(tmp_path / "train_state.pt")
    port_ckpt.save_train_state(path, {"model": state.model.state_dict(), "optimizer": capt_sd})
    restored = port_ckpt.restore_train_state(path)
    resumed = []
    for sd in (eager_sd, restored["optimizer"]):
        again = _state(**opt_kw)
        again.model.load_state_dict(restored["model"])
        again.optimizer.load_state_dict(sd)
        for k in range(3, 5):
            train_step(again, *_batch(k))
        resumed.append(again)
    for a, b in zip(*(r.model.state_dict().values() for r in resumed)):
        assert torch.equal(a, b)
    tree = flax_from_state_dict(state.model.state_dict())
    path = str(tmp_path / "m.ckpt")
    port_ckpt.export_model(path, tree["params"], tree["batch_stats"])
    loaded = port_ckpt.load_exported(path)
    for key in ("params", "batch_stats"):
        got, want = (torch.utils._pytree.tree_leaves(t[key]) for t in (loaded, tree))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_load_rate_fills_a_capturable_rate_tensor():
    p = torch.nn.Parameter(torch.ones(4))
    opt = port_loop.make_optimizer([p], 1e-2, schedule="cosine", warmup_steps=2,
                                   total_steps=10)
    opt.make_capturable()
    lr = opt.adamw.param_groups[0]["lr"]
    for updates in (0, 1, 5):
        opt.updates = updates
        opt.load_rate()
        assert opt.adamw.param_groups[0]["lr"] is lr  # filled in place: a graph reads it
        want = opt.schedule(updates)
        assert float(lr) == float(torch.tensor(want, dtype=torch.float32))
        assert opt.state_dict()["adamw"]["param_groups"][0]["lr"] == want


def test_loading_a_state_drops_the_graphs():
    opt = _state().optimizer
    opt.graphs["a captured step"] = object()
    opt.load_state_dict(opt.state_dict())
    assert opt.graphs == {}


def test_identity_mask_is_made_once_and_adds_as_before():
    out = torch.randn(2, 2, 5, 3, generator=torch.Generator().manual_seed(0))
    old = 8.0 * torch.tanh(out) + torch.tensor([1.0, 0.0])[:, None, None]
    with torch.inference_mode():  # first asked for by a served model
        mask_head(out, 8.0, True)
    got = mask_head(out.requires_grad_(), 8.0, True)
    assert torch.equal(got.detach(), old)
    got.sum().backward()  # the cached constant is not an inference tensor
    assert _identity_mask(torch.float32, out.device) is _identity_mask(torch.float32, out.device)
