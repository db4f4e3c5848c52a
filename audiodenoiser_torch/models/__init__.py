"""Model zoo of the port: live-BN U-Net, the complex-mask U-Net, their
BN-folded form, weight carry-over."""

from audiodenoiser_torch.models.complex_mask import (
    ComplexMaskUNet,
    apply_mask,
    denoise_waveform,
    spectrogram_features,
)
from audiodenoiser_torch.models.convert import (
    load_flax_variables,
    random_flax_variables,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.folded import FoldedUNet, fold_for_inference
from audiodenoiser_torch.models.unet import UNet, count_params, scaled_widths, width_kwargs

__all__ = ["UNet", "ComplexMaskUNet", "FoldedUNet", "fold_for_inference", "count_params",
           "scaled_widths", "width_kwargs", "spectrogram_features", "apply_mask",
           "denoise_waveform", "state_dict_from_flax", "random_flax_variables",
           "load_flax_variables"]
