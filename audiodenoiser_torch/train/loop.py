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

Not ported yet: the device mesh and FSDP (ROADMAP A.11); width_mult, the
s2d stem and the attention bottleneck (A.10); EMA, resume, gradient
accumulation, the cosine/warmup schedules and remat (A.12).
"""

from __future__ import annotations

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
    """optax ``chain(clip_by_global_norm(clip_norm), adamw(...))``.

    The clip is optax's: ``g * clip_norm / ||g||`` only when ``||g|| >
    clip_norm`` (``clip_grad_norm_`` adds 1e-6 to the norm and scales
    always). AdamW is torch's with betas (0.9, 0.999), eps 1e-8 and
    the weight decay on every parameter, BatchNorm included, as optax's
    ``adamw`` without a mask; the two updates are the same algebra.
    """

    def __init__(self, params, learning_rate: float, weight_decay: float = 0.01,
                 clip_norm: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.adamw = torch.optim.AdamW(self.params, lr=learning_rate,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip and update; returns the global gradient norm (before the clip)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # no host sync: the scale is 1 unless the norm exceeds the clip
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                            self.clip_norm / norm)
        torch._foreach_mul_(grads, scale)
        self.adamw.step()
        return norm


def make_optimizer(params, learning_rate: float, weight_decay: float = 0.01,
                   clip_norm: float = 1.0) -> ClippedAdamW:
    """clip_by_global_norm(clip_norm) -> AdamW, at a constant learning rate
    (the cosine/warmup schedules are ROADMAP A.12)."""
    return ClippedAdamW(params, learning_rate, weight_decay, clip_norm)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ClippedAdamW
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None  # of the last step, before the clip

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
                       device: DeviceLike = None) -> TrainState:
    """A model on ``device`` (the card unless told otherwise) with its
    optimizer. ``variables``, a Flax-layout tree (``random_flax_variables``
    or a Flax ``init``), sets the weights; otherwise they are drawn with
    Flax's initialisers from ``seed``."""
    device = resolve_device(device)
    model = UNet() if model is None else model
    if variables is not None:
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
    else:
        init_flax_like(model, seed)
    model = model.to(device)
    tx = make_optimizer(model.parameters(), learning_rate, weight_decay, clip_norm)
    return TrainState(model=model, optimizer=tx)


def apply_update(state: TrainState, losses: CombinedLossOutput):
    """The backward of ``losses.total``, the clip and AdamW, in place;
    returns ``(state, losses)`` with the losses detached, as device
    scalars (no host synchronisation)."""
    state.optimizer.zero_grad()
    losses.total.backward()
    state.grad_norm = state.optimizer.step()
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
    log_every: int = 50
    device: Optional[str] = None  # None: the card
    extra_config: dict = field(default_factory=dict)


def _epoch_mean(losses: list) -> float:
    if not losses:
        return float("nan")
    return float(torch.stack([l.total.float() for l in losses]).mean())


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
    precision, initialised from ``config.seed``. ``steps`` is a
    ``(train_step, eval_step)`` pair (``train.mask.make_mask_steps``);
    by default the magnitude U-Net's.

    The best model is exported as ``checkpoints/best_model.ckpt`` (the JAX
    package's ``.ckpt``) for the complex-mask family, a model with a
    ``mask_bound``, and as the reference-layout ``best_model.pth`` for the
    magnitude U-Net.
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
        state = create_train_state(config.seed, UNet(dtype=dtype),
                                   learning_rate=config.learning_rate,
                                   device=config.device)
    device = state.device
    logger.info(f"Using device: {device_name(device)}")
    n_params = sum(p.numel() for p in state.model.parameters())
    logger.info(f"U-NET Model initialized. Trainable parameters: {n_params:,}")

    def place(x):
        return torch.as_tensor(x).to(device, dtype=torch.float32, non_blocking=True)

    step_fn, eval_fn = steps if steps is not None else (train_step, eval_step)
    masked = getattr(state.model, "mask_bound", None) is not None
    writer = ScalarWriter(os.path.join(run_dir, "tensorboard_logs"))
    best_path = os.path.join(ckpt_dir, "best_model.ckpt" if masked else "best_model.pth")
    best_val = float("inf")
    exported_best = False
    history = []
    global_step = 0
    logger.info("--- Starting Training Loop ---")
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        log_t0 = t0
        steps_since_log = 0
        train_losses = []
        for noisy, clean in train_batches(epoch):
            state, losses = step_fn(state, place(noisy), place(clean))
            train_losses.append(losses)
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
        dt = time.perf_counter() - t0
        logger.info(f"Epoch {epoch + 1}/{config.epochs} -> Train Loss: {train_loss:.6f} | "
                    f"Validation Loss: {val_loss:.6f} | {dt:.1f}s")
        if not np.isfinite(train_loss):
            logger.error("Non-finite training loss; aborting run.")
            raise FloatingPointError(f"training diverged at epoch {epoch} (loss={train_loss})")
        history.append({"epoch": epoch, "train": train_loss, "val": val_loss})

        if val_loss < best_val:
            best_val = val_loss
            if masked:
                tree = flax_from_state_dict(state.model.state_dict())
                ckpt_lib.export_model(best_path, tree["params"], tree["batch_stats"])
            else:
                ckpt_lib.export_pth(best_path, state.model)
            ckpt_lib.record_best_val(best_path, best_val, epoch)
            exported_best = True
            logger.info(f"New best model saved to {best_path} (Val Loss: {best_val:.6f})")

    writer.close()
    logger.info("--- Training Finished ---")
    logger.info(f"Final best model saved at: {best_path}")
    return {
        "best_val": best_val,
        "best_path": best_path,
        "run_dir": run_dir,
        "history": history,
        "state": state,
        "exported_best": exported_best,
        "steps": global_step,
    }
