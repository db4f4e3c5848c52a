"""Training: optimizer, train/eval steps, the fit loop, exports and logs."""

from audiodenoiser_torch.train.checkpoints import (
    export_model,
    load_exported,
    restore_train_state,
    save_train_state,
)
from audiodenoiser_torch.train.loop import (
    TrainState,
    create_train_state,
    eval_step,
    fit,
    train_step,
)

__all__ = ["TrainState", "create_train_state", "train_step", "eval_step", "fit",
           "export_model", "load_exported", "save_train_state", "restore_train_state"]
