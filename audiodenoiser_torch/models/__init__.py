"""Model zoo of the port: live-BN U-Net, the complex-mask U-Net, their
BN-folded form, the noise router, weight carry-over."""

from audiodenoiser_torch.models.complex_mask import (
    ComplexMaskUNet,
    apply_mask,
    denoise_waveform,
    spectrogram_features,
)
from audiodenoiser_torch.models.convert import (
    flax_from_state_dict,
    load_flax_variables,
    random_flax_variables,
    random_router_flax_variables,
    router_flax_from_state_dict,
    router_state_dict_from_flax,
    state_dict_from_flax,
)
from audiodenoiser_torch.models.folded import FoldedUNet, fold_for_inference
from audiodenoiser_torch.models.router import NOISE_CLASSES, NoiseClassifier
from audiodenoiser_torch.models.unet import (
    DoubleConv,
    UNet,
    count_params,
    scaled_widths,
    width_kwargs,
)

__all__ = ["UNet", "DoubleConv", "ComplexMaskUNet", "FoldedUNet", "fold_for_inference", "count_params",
           "scaled_widths", "width_kwargs", "spectrogram_features", "apply_mask",
           "denoise_waveform", "state_dict_from_flax", "flax_from_state_dict", "random_flax_variables",
           "load_flax_variables", "NOISE_CLASSES", "NoiseClassifier",
           "router_state_dict_from_flax", "router_flax_from_state_dict",
           "random_router_flax_variables"]
