"""ROADMAP C.2 on the CPU: the fp32 gradients of a two-level (8, 16)/32
complex-mask train step against a float64 evaluation.

The step's fp32 gradients lay 3.2e-4 (over all tensors) and 2.1e-3 (the
worst tensor) from a float64 backward that ran a forward of its own.
The cause is no inaccurate op: two ReLU pre-activations of the second
up level lie within fp32 rounding of zero, so that float64 forward takes
another branch there. Held to the fp32 forward's own branches, the CPU's
gradients meet 1e-4 per tensor, with torch's BatchNorm kernel as it is.

One fp32 step of the residual mask model (bound 8, SI-SDR weight 0.5,
clamp 30 dB) on two clips of the ``mixed`` mixer runs once per module; it
records every BatchNorm's input and output cotangent, every ReLU's mask
and every max-pool's indices.

- Each train-mode ``BatchNorm2d`` alone (torch's CPU kernel), on the
  step's own channels_last tensors: its input, weight and bias gradients
  within 1e-5 relative L2 of the same module in float64.
- The whole U-Net's parameter gradients for the step's input and output
  cotangent, within 1e-4 per tensor of a float64 backward that takes the
  same branches: the fp32 forward's ReLU masks and max-pool choices. A
  float64 forward of its own may take another branch where a
  pre-activation lies within fp32 rounding of zero; the backward of that
  other piecewise-linear function is no arbiter of this one's rounding.

``python -m tests.test_torch_batchnorm`` prints the same comparisons for
the port's BatchNorm and for one written as tensor ops with autograd over
them, each against the float64 backward on the fp32 branches and against
one with a forward of its own, and the number of ReLU elements whose
branch differs.
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.data.pipeline import NoiseBank, OnDeviceMixer
from audiodenoiser_torch.models import (
    ComplexMaskUNet,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.unet import BatchNorm2d, Down
from audiodenoiser_torch.data.synth import synth_chunks, synth_noise_clips
from audiodenoiser_torch.train.mask import create_mask_train_state, make_mask_steps

TWO_LEVELS = dict(features=(8, 16), bottleneck=32)
N_BN = 10  # two DoubleConvs a level, the bottleneck's and two up levels'
# conv biases that feed a train-mode BatchNorm: their exact gradient is 0
BN_FED_BIASES = ("double_conv.0.bias", "double_conv.3.bias")
BN_TOL = 1e-5
STEP_TOL = 1e-4


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _model(variables, dtype=torch.float32):
    """The two-level residual mask model; in fp32 with the K3 path as the
    step trains it (its plain version on the CPU)."""
    model = ComplexMaskUNet(**TWO_LEVELS, mask_bound=8.0, residual=True,
                            pallas_deconv=dtype == torch.float32, dtype=dtype)
    model.load_state_dict(state_dict_from_flax(variables))
    return model


def _batch():
    bank = NoiseBank(synth_noise_clips(6, 5), device="cpu")
    mixer = OnDeviceMixer(synth_chunks(8, 4), "mixed", noise_bank=bank, device="cpu")
    return mixer.sample_audio(torch.Generator().manual_seed(6), 2)


class _Tap(nn.Module):
    """Keeps the U-Net's input and the gradient at its output."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, x):
        y = self.model(x)
        y.retain_grad()
        self.x, self.y = x, y
        return y


def run_step(batch_norm=None) -> dict:
    """One fp32 two-level mask step on the CPU and what it recorded.
    ``batch_norm(module, x)``, when given, replaces the train-mode
    BatchNorm's forward (the report's ``tensor_op_batch_norm``)."""
    variables = random_flax_variables(0, **TWO_LEVELS, in_channels=3, out_channels=2)
    model = _model(variables)
    rec = {"bn": [], "relu": [], "pool": []}

    def on_bn(mod, inp, out):
        entry = {"module": mod, "x": inp[0].detach().clone()}
        out.register_hook(lambda g: entry.__setitem__("g", g.detach().clone()))
        rec["bn"].append(entry)

    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(on_bn)
            if batch_norm is not None:
                m.forward = lambda x, m=m: batch_norm(m, x)
        elif isinstance(m, nn.ReLU):
            m.register_forward_hook(lambda mod, i, out: rec["relu"].append(out > 0))
        elif isinstance(m, Down):
            m.register_forward_hook(lambda mod, i, out: rec["pool"].append(
                F.max_pool2d(out[0], 2, return_indices=True)[1]))
    state = create_mask_train_state(0, model, variables=variables, device="cpu")
    state.model = tap = _Tap(state.model)
    noisy, clean = _batch()
    state, _ = make_mask_steps(0.5, 30.0)[0](state, noisy, clean)
    clip = min(1.0, 1.0 / float(state.grad_norm))  # the step scaled the gradients by it
    rec.update(variables=variables, x=tap.x.detach(), g=tap.y.grad.detach(),
               grads={n: p.grad.detach() / clip for n, p in model.named_parameters()})
    return rec


def float64_grads(rec, same_branch: bool = True) -> dict:
    """The U-Net's float64 parameter gradients for the step's input and
    output cotangent; with ``same_branch``, through the fp32 forward's ReLU
    masks and max-pool indices."""
    model = _model(rec["variables"], torch.float64).double().train()
    if same_branch:
        masks, pools = list(rec["relu"]), list(rec["pool"])
        for m in model.modules():
            if isinstance(m, nn.ReLU):
                m.inplace = False
                m.register_forward_hook(lambda mod, i, out: i[0] * masks.pop(0))
            elif isinstance(m, Down):
                def take(mod, i, out):
                    skip, idx = out[0], pools.pop(0)
                    return skip, skip.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)
                m.register_forward_hook(take)
    model(rec["x"].double()).backward(rec["g"].double())
    return {n: p.grad for n, p in model.named_parameters()}


def step_errors(grads, ref) -> tuple[dict, float]:
    """Relative L2 by tensor, and over all tensors together, leaving out
    the BatchNorm-fed conv biases."""
    names = [n for n in ref if not n.endswith(BN_FED_BIASES)]
    by_name = {n: _rel(grads[n], ref[n]) for n in names}
    diff = sum(float((grads[n].double() - ref[n]).square().sum()) for n in names)
    return by_name, (diff / sum(float(ref[n].square().sum()) for n in names)) ** 0.5


def _bare(module):
    """A train-mode copy of a recorded BatchNorm without the recording."""
    bn = copy.deepcopy(module).train()
    bn._forward_hooks.clear()
    bn.__dict__.pop("forward", None)
    return bn


def bn_errors(entry, batch_norm=None) -> tuple[float, float, float]:
    """One recorded BatchNorm's input, weight and bias gradients in fp32
    (the port's module, or ``batch_norm``) against the module in float64."""
    grads = {}
    for dtype in (torch.float32, torch.float64):
        bn = _bare(entry["module"]).to(dtype)
        x = entry["x"].detach().to(dtype).requires_grad_(True)
        y = batch_norm(bn, x) if batch_norm is not None and dtype == torch.float32 else bn(x)
        y.backward(entry["g"].to(dtype))
        grads[dtype] = (x.grad, bn.weight.grad, bn.bias.grad)
    return tuple(_rel(a, b) for a, b in zip(grads[torch.float32], grads[torch.float64]))


def tensor_op_batch_norm(module, x):
    """Train-mode batch normalisation as tensor ops with autograd over
    them, the alternative the report measures beside torch's kernel."""
    var, mean = torch.var_mean(x, (0, 2, 3), correction=0, keepdim=True)
    return ((x - mean) * torch.rsqrt(var + module.eps) * module.weight[:, None, None]
            + module.bias[:, None, None])


@pytest.fixture(scope="module")
def step():
    rec = run_step()
    assert len(rec["bn"]) == N_BN and all("g" in e for e in rec["bn"])
    return rec


@pytest.mark.parametrize("i", range(N_BN))
def test_batchnorm_alone_matches_float64(step, i):
    entry = step["bn"][i]
    assert entry["x"].is_contiguous(memory_format=torch.channels_last)
    errs = bn_errors(entry)
    assert max(errs) <= BN_TOL, dict(zip(("dx", "dw", "db"), errs))


def test_mask_step_gradients_match_float64_per_tensor(step):
    by_name, overall = step_errors(step["grads"], float64_grads(step))
    worst = max(by_name, key=by_name.get)
    assert by_name[worst] <= STEP_TOL, (worst, by_name[worst], overall)


def test_running_statistics_stay_flax(step):
    """The CPU's tensor-op path keeps Flax's update of the running
    statistics: 0.9 of the old value plus 0.1 of the biased batch ones."""
    entry = step["bn"][0]
    bn = _bare(entry["module"])
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    bn(entry["x"])
    var, mean = torch.var_mean(entry["x"], (0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.9 * mean0 + 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 * var0 + 0.1 * var)


def relu_branch_flips(rec) -> list:
    """By ReLU, the elements on which a float64 forward of its own takes
    another branch than the step's fp32 forward."""
    model = _model(rec["variables"], torch.float64).double().train()
    masks = []
    for m in model.modules():
        if isinstance(m, nn.ReLU):
            m.register_forward_hook(lambda mod, i, out: masks.append(out > 0))
    with torch.no_grad():
        model(rec["x"].double())
    return [int((a != b).sum()) for a, b in zip(rec["relu"], masks)]


def report() -> None:
    for label, batch_norm in (("BatchNorm2d (torch's kernel)", None),
                              ("tensor ops", tensor_op_batch_norm)):
        rec = run_step(batch_norm)
        errs = [bn_errors(e, batch_norm) for e in rec["bn"]]
        print(f"{label}: each BatchNorm alone vs float64, worst dx {max(e[0] for e in errs):.3e} "
              f"dw {max(e[1] for e in errs):.3e} db {max(e[2] for e in errs):.3e}")
        for same_branch in (True, False):
            by_name, overall = step_errors(rec["grads"], float64_grads(rec, same_branch))
            worst = max(by_name, key=by_name.get)
            print(f"  whole step vs float64 ({'the fp32 branches' if same_branch else 'its own forward'}): "
                  f"rel L2 {overall:.3e} over all, worst {worst} {by_name[worst]:.3e}")
        print(f"  ReLU elements on another branch in float64, by ReLU: {relu_branch_flips(rec)} "
              f"of {[m.numel() for m in rec['relu']]}")


if __name__ == "__main__":
    report()
