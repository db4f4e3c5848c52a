"""Model zoo of the port: live-BN U-Net, its BN-folded form, weight carry-over."""

from audiodenoiser_torch.models.convert import random_flax_variables, state_dict_from_flax
from audiodenoiser_torch.models.folded import FoldedUNet, fold_for_inference
from audiodenoiser_torch.models.unet import UNet, count_params

__all__ = ["UNet", "FoldedUNet", "fold_for_inference", "count_params",
           "state_dict_from_flax", "random_flax_variables"]
