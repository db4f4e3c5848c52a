"""Training loop (port of ``train/loop.py``, single device).

The reference recipe: AdamW(lr=1e-4, torch defaults) on every parameter,
global-norm gradient clipping at 1.0, a 90/10 split, per-epoch train and
validation means, scalar logs and a best-validation export. One
``train_step`` runs the forward in train mode, the combined loss, the
backward, the clip, the AdamW update and the BatchNorm running-stat
update. Batches are (B, 1, F, T) float32, from ``.npy`` pairs
(``data.dataset``) or synthesized on the card (``data.pipeline``).
``fit`` also runs another family's ``(train_step, eval_step)`` pair: the
complex-mask steps of ``train.mask`` on raw waveform batches.

The optimizer takes JAX's schedules (constant with a linear warm-up, or
warm-up plus cosine decay) and gradient accumulation (``optax.MultiSteps``);
``fit`` adds an EMA of the weights, ``remat``, and a resume state written
every ``ckpt_every`` epochs (``train.checkpoints``).

Not ported yet: the device mesh and FSDP (ROADMAP A.11); width_mult, the
s2d stem and the attention bottleneck (A.10).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional, Union

import numpy as np
import torch
from torch import nn

from audiodenoiser_torch.device import DeviceLike, device_name, resolve_device
from audiodenoiser_torch.losses import CombinedLossOutput, combined_perceptual_loss
from audiodenoiser_torch.models.convert import flax_from_state_dict, state_dict_from_flax
from audiodenoiser_torch.models.unet import UNet
from audiodenoiser_torch.train import checkpoints as ckpt_lib
from audiodenoiser_torch.train.logging_utils import ScalarWriter, setup_logger

SeedLike = Union[int, torch.Generator]


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(clip_norm), adamw(lr))``, inside
    ``optax.MultiSteps(every_k_schedule=grad_accum)`` when ``grad_accum`` > 1.

    The clip is optax's: ``g * clip_norm / ||g||`` only when ``||g|| >
    clip_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm and scales
    always). AdamW is torch's with betas (0.9, 0.999), eps 1e-8 and
    the weight decay on every parameter, BatchNorm included, as optax's
    ``adamw`` without a mask; the two updates are the same algebra.

    ``schedule`` maps the count of updates made to the learning rate
    (``learning_rate_schedule``; None: constant). With ``grad_accum`` k the
    backward passes sum into ``.grad``: ``step`` counts a micro-step and
    touches nothing until the k-th, which scales the sum by 1/k (one
    ``_foreach_mul_``), clips the mean and updates. The parameters and the
    AdamW moments stay bit-equal over the k-1 other micro-steps, and the
    schedule counts updates, not micro-steps, as ``optax.MultiSteps`` does.
    """

    def __init__(self, params, learning_rate: float, weight_decay: float = 0.01,
                 clip_norm: float = 1.0, schedule: Optional[Callable[[int], float]] = None,
                 grad_accum: int = 1):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be at least 1, got {grad_accum}")
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.schedule = schedule
        self.grad_accum = int(grad_accum)
        self.micro_step = 0  # backward passes summed into .grad since the last update
        self.updates = 0     # updates made: the schedule's count
        self.adamw = torch.optim.AdamW(self.params, lr=learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """One micro-step; on an update, clip and update and return the
        global norm of the mean gradient (before the clip), else None."""
        self.micro_step += 1
        if self.micro_step < self.grad_accum:
            return None
        self.micro_step = 0
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.grad_accum > 1:
            torch._foreach_mul_(grads, 1.0 / self.grad_accum)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # no host sync: the scale is 1 unless the norm exceeds the clip
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        if self.schedule is not None:
            for group in self.adamw.param_groups:
                group["lr"] = self.schedule(self.updates)
        self.adamw.step()
        self.updates += 1
        return norm

    def state_dict(self) -> dict:
        """AdamW's moments and step, the update count, the micro-step and,
        between updates, the summed gradients."""
        grads = [p.grad.detach().clone() if p.grad is not None else None
                 for p in self.params] if self.micro_step else []
        return {"adamw": self.adamw.state_dict(), "updates": self.updates,
                "micro_step": self.micro_step, "grads": grads}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.updates = int(state["updates"])
        self.micro_step = int(state["micro_step"])
        self.zero_grad()
        for p, g in zip(self.params, state["grads"]):
            p.grad = None if g is None else g.to(p.device, p.dtype)


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule: held at ``init`` when ``steps`` <= 0."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def learning_rate_schedule(learning_rate: float, schedule: str = "constant",
                           warmup_steps: int = 0,
                           total_steps: int = 0) -> Optional[Callable[[int], float]]:
    """The JAX package's schedules as a function of the update count: None
    for a constant rate; "constant" with ``warmup_steps`` is
    ``optax.linear_schedule(0, lr, warmup_steps)`` (the first update at lr
    0); "cosine" is ``warmup_cosine_decay_schedule(0, lr, max(1, warmup),
    decay_steps=total_steps)``, the warm-up counted inside ``total_steps``
    and the rate ending at 0."""
    if schedule == "constant":
        if not warmup_steps:
            return None
        return lambda count: _linear(0.0, learning_rate, warmup_steps, count)
    if schedule != "cosine":
        raise ValueError(f"unknown schedule {schedule!r}")
    if total_steps <= 0:
        raise ValueError("cosine schedule requires total_steps > 0")
    warm = max(1, warmup_steps)
    decay = total_steps - warm
    if decay <= 0:
        raise ValueError("The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay}.")

    def lr(count: int) -> float:
        if count < warm:
            return _linear(0.0, learning_rate, warm, count)
        return learning_rate * 0.5 * (1.0 + math.cos(math.pi * min(count - warm, decay) / decay))

    return lr


def make_optimizer(params, learning_rate: float, weight_decay: float = 0.01,
                   clip_norm: float = 1.0, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0,
                   grad_accum: int = 1) -> ClippedAdamW:
    """clip_by_global_norm(clip_norm) -> AdamW on the ``schedule``
    (``learning_rate_schedule``), accumulating ``grad_accum`` micro-steps
    an update (JAX ``train/loop.py::make_optimizer``)."""
    lr = learning_rate_schedule(learning_rate, schedule, warmup_steps, total_steps)
    return ClippedAdamW(params, learning_rate, weight_decay, clip_norm, lr, grad_accum)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ClippedAdamW
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None  # of the last update, before the clip

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _generator(seed: SeedLike) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


@torch.no_grad()
def init_flax_like(model: nn.Module, seed: SeedLike = 0) -> nn.Module:
    """Flax's default initialisers from a seeded generator: LeCun-normal
    (truncated at two standard deviations, fan-in of kh*kw*Cin) for conv
    and transposed-conv kernels, zero biases, BatchNorm scale 1, bias 0,
    statistics 0 and 1; the 1x1 head's kernel zero for a model built with
    ``zero_out_init``. Not Flax's bits: the same distribution."""
    gen = _generator(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            cin = m.in_channels
            fan_in = cin * m.kernel_size[0] * m.kernel_size[1]
            # the stddev of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            m.weight.copy_(w * std)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    if getattr(model, "zero_out_init", False):
        model.out.weight.zero_()
    return model


def create_train_state(seed: SeedLike = 0, model: Optional[nn.Module] = None,
                       learning_rate: float = 1e-4, weight_decay: float = 0.01,
                       clip_norm: float = 1.0, variables: Optional[dict] = None,
                       device: DeviceLike = None, **opt_kwargs) -> TrainState:
    """A model on ``device`` (the card unless told otherwise) with its
    optimizer. ``variables``, a Flax-layout tree (``random_flax_variables``
    or a Flax ``init``), sets the weights; otherwise they are drawn with
    Flax's initialisers from ``seed``. ``opt_kwargs`` (``schedule``,
    ``warmup_steps``, ``total_steps``, ``grad_accum``) go to
    ``make_optimizer``."""
    device = resolve_device(device)
    model = UNet() if model is None else model
    if variables is not None:
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
    else:
        init_flax_like(model, seed)
    model = model.to(device)
    tx = make_optimizer(model.parameters(), learning_rate, weight_decay, clip_norm, **opt_kwargs)
    return TrainState(model=model, optimizer=tx)


def apply_update(state: TrainState, losses: CombinedLossOutput):
    """The backward of ``losses.total`` and the optimizer's micro-step (the
    clip and AdamW on an update), in place; returns ``(state, losses)`` with
    the losses detached, as device scalars (no host synchronisation). The
    gradients are zeroed only before the first micro-step of an update."""
    opt = state.optimizer
    if opt.micro_step == 0:
        opt.zero_grad()
    losses.total.backward()
    norm = opt.step()
    if norm is not None:
        state.grad_norm = norm
    state.step += 1
    return state, CombinedLossOutput(*(t.detach() for t in losses))


def train_step(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor):
    """One update in place; returns ``(state, losses)``."""
    out = state.model.train()(noisy)
    return apply_update(state, combined_perceptual_loss(out, clean))


@torch.no_grad()
def eval_step(state: TrainState, noisy: torch.Tensor,
              clean: torch.Tensor) -> CombinedLossOutput:
    """Eval-mode forward (running BN statistics, no update) and the loss."""
    out = state.model.eval()(noisy)
    return combined_perceptual_loss(out, clean)


@dataclass
class FitConfig:
    run_name: str = ""
    output_path: str = "./training_outputs_unet"
    epochs: int = 50
    batch_size: int = 16
    learning_rate: float = 1e-4
    seed: int = 0
    precision: str = "bf16"  # "bf16" | "f32"
    resume: bool = False  # restore checkpoints/train_state.pt and go on
    log_every: int = 50
    lr_schedule: str = "constant"  # "constant" | "cosine"
    warmup_steps: int = 0
    total_steps: int = 0  # required for cosine decay
    grad_accum: int = 1
    remat: bool = False
    ckpt_every: int = 1  # write the resume state every N epochs (and after the last)
    ema_decay: Optional[float] = None  # e.g. 0.999: track, validate and export an EMA
    device: Optional[str] = None  # None: the card
    extra_config: dict = field(default_factory=dict)


def _epoch_mean(losses: list) -> float:
    if not losses:
        return float("nan")
    return float(torch.stack([l.total.float() for l in losses]).mean())


def _export_best(path: str, model: nn.Module, params: Optional[dict] = None) -> None:
    """``model`` as the JAX package's ``.ckpt``, its parameters replaced by
    ``params`` (name -> tensor) when given; BatchNorm statistics are the
    model's own."""
    sd = model.state_dict()
    if params is not None:
        sd = {**sd, **params}
    tree = flax_from_state_dict(sd)
    ckpt_lib.export_model(path, tree["params"], tree["batch_stats"])


@contextlib.contextmanager
def _swapped(params: list, values: list):
    """``params`` hold ``values`` inside the block, their own after it."""
    with torch.no_grad():
        live = [p.detach().clone() for p in params]
        torch._foreach_copy_(params, values)
    try:
        yield
    finally:
        with torch.no_grad():
            torch._foreach_copy_(params, live)


def fit(config: FitConfig,
        train_batches: Callable[[int], Iterator[tuple[Any, Any]]],
        val_batches: Callable[[], Iterator[tuple[Any, Any]]],
        state_factory: Optional[Callable[[], TrainState]] = None,
        steps: Optional[tuple[Callable, Callable]] = None) -> dict:
    """Run the training loop; returns a summary dict.

    ``train_batches(epoch)`` / ``val_batches()`` yield (noisy, clean)
    batches, numpy arrays or tensors: (B, 1, F, T) magnitudes for the
    default steps, what ``steps`` takes otherwise. ``state_factory``
    supplies the model and optimizer (how a ``UNet(pallas_deconv=True)``
    reaches training); by default a full-width ``UNet`` in the configured
    precision and ``remat``, initialised from ``config.seed``, with the
    configured schedule and accumulation. ``steps`` is a ``(train_step,
    eval_step)`` pair (``train.mask.make_mask_steps``); by default the
    magnitude U-Net's.

    The best model is exported as ``checkpoints/best_model.ckpt`` (the JAX
    package's ``.ckpt``) with its ``.val.json``. With ``ema_decay`` an fp32
    exponential moving average of the parameters moves after every step
    call (micro-steps included, as JAX's), is validated each epoch with the
    live BatchNorm statistics, and its best is exported as
    ``best_model_ema.ckpt``. ``checkpoints/train_state.pt`` (model,
    optimizer, EMA, epoch, best losses, global step) is written every
    ``ckpt_every`` epochs and after the last; ``resume`` restores it and
    runs the epochs after it, the history holding only those.
    """
    run_name = config.run_name or f"UNET_Run_{int(time.time())}"
    run_dir = os.path.join(config.output_path, run_name)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = setup_logger(os.path.join(run_dir, "training.log"))
    logger.info(f"--- Starting U-NET Run: {run_name} ---")
    cfg_dump = {**config.__dict__}
    cfg_dump.pop("extra_config", None)
    cfg_dump.update(config.extra_config)
    logger.info(f"Full configuration: \n{json.dumps(cfg_dump, indent=2, default=str)}")

    if state_factory is not None:
        state = state_factory()
    else:
        dtype = torch.bfloat16 if config.precision == "bf16" else torch.float32
        state = create_train_state(config.seed, UNet(dtype=dtype, remat=config.remat),
                                   learning_rate=config.learning_rate,
                                   device=config.device, schedule=config.lr_schedule,
                                   warmup_steps=config.warmup_steps,
                                   total_steps=config.total_steps,
                                   grad_accum=config.grad_accum)
    device = state.device
    logger.info(f"Using device: {device_name(device)}")
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info(f"U-NET Model initialized. Trainable parameters: {n_params:,}")

    def place(x):
        return torch.as_tensor(x).to(device, dtype=torch.float32, non_blocking=True)

    step_fn, eval_fn = steps if steps is not None else (train_step, eval_step)
    names, params = zip(*state.model.named_parameters())
    params = list(params)
    best_path = os.path.join(ckpt_dir, "best_model.ckpt")
    best_ema_path = os.path.join(ckpt_dir, "best_model_ema.ckpt")
    resume_path = os.path.join(ckpt_dir, "train_state.pt")
    start_epoch, global_step = 0, 0
    best_val = best_ema_val = float("inf")
    ema = None
    if config.resume and os.path.exists(resume_path):
        restored = ckpt_lib.restore_train_state(resume_path, device)
        state.model.load_state_dict(restored["model"])
        state.optimizer.load_state_dict(restored["optimizer"])
        state.step = int(restored["step"])
        start_epoch = int(restored["epoch"]) + 1
        best_val = float(restored["best_val"])
        global_step = int(restored["global_step"])
        if config.ema_decay and "ema" in restored:
            ema = [restored["ema"][n].to(device, torch.float32) for n in names]
            best_ema_val = float(restored["best_ema_val"])
        # the resume state can be older than an export (ckpt_every): the
        # sidecars keep the exported losses authoritative; only after a
        # real restore, so a fresh run inherits no earlier run's floor
        best_val = ckpt_lib.best_val_floor(best_path, best_val)
        best_ema_val = ckpt_lib.best_val_floor(best_ema_path, best_ema_val)
        logger.info(f"Resumed from epoch {start_epoch} (best val {best_val:.6f})")
    if config.ema_decay and ema is None:
        ema = [p.detach().float().clone() for p in params]
    ema_weight = 1.0 - config.ema_decay if config.ema_decay else 0.0

    writer = ScalarWriter(os.path.join(run_dir, "tensorboard_logs"))
    exported_best = exported_best_ema = False
    history = []
    logger.info("--- Starting Training Loop ---")
    for epoch in range(start_epoch, config.epochs):
        t0 = time.perf_counter()
        log_t0 = t0
        steps_since_log = 0
        train_losses = []
        for noisy, clean in train_batches(epoch):
            state, losses = step_fn(state, place(noisy), place(clean))
            train_losses.append(losses)
            if ema is not None:
                with torch.no_grad():  # one fused pass over every parameter
                    torch._foreach_lerp_(ema, params, ema_weight)
            global_step += 1
            steps_since_log += 1
            if config.log_every and global_step % config.log_every == 0:
                now = time.perf_counter()
                sps = steps_since_log / max(now - log_t0, 1e-9)
                log_t0 = now
                steps_since_log = 0
                running = float(losses.total)  # the loop's only host sync
                writer.add_scalar("Loss/train_batch", running, global_step)
                logger.info(f"  step {global_step} (epoch {epoch + 1}) | "
                            f"loss {running:.6f} | {sps:.1f} steps/s")
        train_loss = _epoch_mean(train_losses)
        writer.add_scalar("Loss/train", train_loss, epoch)

        val_losses = [eval_fn(state, place(noisy), place(clean))
                      for noisy, clean in val_batches()]
        val_loss = _epoch_mean(val_losses)
        if not val_losses:
            logger.warning("Validation split is empty; using train loss for selection.")
            val_loss = train_loss
        writer.add_scalar("Loss/validation", val_loss, epoch)
        ema_val = None
        if ema is not None:
            with _swapped(params, ema):
                ema_losses = [eval_fn(state, place(noisy), place(clean))
                              for noisy, clean in val_batches()]
            ema_val = _epoch_mean(ema_losses) if ema_losses else val_loss
            writer.add_scalar("Loss/validation_ema", ema_val, epoch)
        dt = time.perf_counter() - t0
        logger.info(f"Epoch {epoch + 1}/{config.epochs} -> Train Loss: {train_loss:.6f} | "
                    f"Validation Loss: {val_loss:.6f}"
                    + (f" | EMA Val Loss: {ema_val:.6f}" if ema_val is not None else "")
                    + f" | {dt:.1f}s")
        if not np.isfinite(train_loss):
            logger.error("Non-finite training loss; aborting run.")
            raise FloatingPointError(f"training diverged at epoch {epoch} (loss={train_loss})")
        history.append({"epoch": epoch, "train": train_loss, "val": val_loss})

        if val_loss < best_val:
            best_val = val_loss
            _export_best(best_path, state.model)
            ckpt_lib.record_best_val(best_path, best_val, epoch)
            exported_best = True
            logger.info(f"New best model saved to {best_path} (Val Loss: {best_val:.6f})")
        if ema_val is not None and ema_val < best_ema_val:
            best_ema_val = ema_val
            _export_best(best_ema_path, state.model, dict(zip(names, ema)))
            ckpt_lib.record_best_val(best_ema_path, best_ema_val, epoch)
            exported_best_ema = True
            logger.info(f"New best EMA model saved to {best_ema_path} "
                        f"(EMA Val Loss: {best_ema_val:.6f})")
        if (epoch + 1) % max(1, config.ckpt_every) == 0 or epoch == config.epochs - 1:
            payload = {"model": state.model.state_dict(),
                       "optimizer": state.optimizer.state_dict(), "step": state.step,
                       "epoch": epoch, "best_val": best_val, "global_step": global_step}
            if ema is not None:
                payload["ema"] = dict(zip(names, ema))
                payload["best_ema_val"] = best_ema_val
            ckpt_lib.save_train_state(resume_path, payload)

    writer.close()
    logger.info("--- Training Finished ---")
    logger.info(f"Final best model saved at: {best_path}")
    result = {
        "best_val": best_val,
        "best_path": best_path,
        "run_dir": run_dir,
        "history": history,
        "state": state,
        # False when a resumed run never beat the restored best: the export
        # on disk is an earlier run's, and its sidecar must stay as it is
        "exported_best": exported_best,
        "steps": global_step,
    }
    if config.ema_decay:
        result.update(best_ema_val=best_ema_val, best_ema_path=best_ema_path,
                      exported_best_ema=exported_best_ema)
    return result
