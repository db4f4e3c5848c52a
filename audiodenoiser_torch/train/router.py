"""Training of the noise router (port of ``train/router.py``).

The labelled stream comes from the on-device mixer
(``OnDeviceMixer.sample_labeled``): every step corrupts a fresh clean
batch with a per-example random corruption, featurizes it through K1 on
the card, and keeps the corruption index as the class label. The step is
softmax cross-entropy with integer labels under the port's
``make_optimizer`` (global-norm clip, then AdamW), as the JAX package's.
The random draws come from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.models.convert import router_state_dict_from_flax
from audiodenoiser_torch.models.router import NoiseClassifier
from audiodenoiser_torch.train.loop import SeedLike, TrainState, _generator, make_optimizer

# the held-out batches' stream, disjoint from every training seed's
HELD_OUT_SEED = 10_000_000


@torch.no_grad()
def init_router_flax_like(model: nn.Module, seed: SeedLike = 0) -> nn.Module:
    """Flax's default initialisers from a seeded generator: LeCun-normal
    kernels (truncated at two standard deviations, fan-in scaled), zero
    biases, GroupNorm scale 1 and bias 0. Not Flax's bits: the same
    distribution."""
    gen = _generator(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            # the stddev of a unit normal truncated to [-2, 2]
            m.weight.copy_(w * math.sqrt(1.0 / fan_in) / 0.87962566103423978)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.reset_parameters()
    return model


def create_router_state(seed: SeedLike = 0, model: Optional[NoiseClassifier] = None,
                        learning_rate: float = 1e-3, params: Optional[dict] = None,
                        device: DeviceLike = None, **opt_kwargs) -> TrainState:
    """A router on ``device`` (the card unless told otherwise) with its
    optimizer. ``params``, a Flax-layout tree, sets the weights; otherwise
    they are drawn with Flax's initialisers from ``seed``."""
    model = NoiseClassifier() if model is None else model
    if params is not None:
        model.load_state_dict(router_state_dict_from_flax(params), strict=True)
    else:
        init_router_flax_like(model, seed)
    model = model.to(resolve_device(device))
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), learning_rate,
                                                            **opt_kwargs))


def _logits_loss(model: nn.Module, specs: torch.Tensor, labels: torch.Tensor):
    logits = model(specs)
    loss = F.cross_entropy(logits, labels.long())
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def router_train_step(state: TrainState, specs: torch.Tensor, labels: torch.Tensor):
    """One update in place; returns ``(state, loss, accuracy)`` as device
    scalars (no host synchronisation)."""
    opt = state.optimizer
    opt.zero_grad()
    loss, acc = _logits_loss(state.model.train(), specs, labels)
    loss.backward()
    opt.step()
    state.step += 1
    return state, loss.detach(), acc


@torch.no_grad()
def router_eval_step(state: TrainState, specs: torch.Tensor, labels: torch.Tensor):
    """``(loss, accuracy)`` of the current weights, no update."""
    return _logits_loss(state.model.eval(), specs, labels)


def fit_router(mixer, steps: int = 600, batch_size: int = 64, learning_rate: float = 1e-3,
               seed: int = 0, log_every: int = 100, log=print,
               model: Optional[NoiseClassifier] = None) -> tuple[TrainState, float]:
    """Train a router on ``mixer`` (``noise_type='mixed'``), on its device.

    Returns ``(state, held_out_accuracy)``: the accuracy is the mean over 4
    fresh batches drawn from a generator that training never used."""
    state = create_router_state(seed, model, learning_rate, device=mixer.device)
    gen = torch.Generator(device=mixer.device).manual_seed(seed)
    for step in range(steps):
        noisy, _, labels = mixer.sample_labeled(gen, batch_size)
        state, loss, acc = router_train_step(state, noisy, labels)
        if log_every and (step + 1) % log_every == 0:
            log(f"router step {step + 1}/{steps}: "
                f"loss {float(loss):.4f} acc {float(acc):.3f}")
    held_out = torch.Generator(device=mixer.device).manual_seed(HELD_OUT_SEED + seed)
    accs = []
    for _ in range(4):
        noisy, _, labels = mixer.sample_labeled(held_out, batch_size)
        accs.append(router_eval_step(state, noisy, labels)[1])
    return state, float(torch.stack(accs).mean())
