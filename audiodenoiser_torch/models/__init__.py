"""Model zoo of the port: live-BN U-Net and its variants (s2d stem,
refinement path, attention bottleneck), the complex-mask U-Net, their
BN-folded form, int8 compute, the noise router, weight carry-over."""

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
from audiodenoiser_torch.models.int8 import Int8UNet, prepare_int8
from audiodenoiser_torch.models.router import NOISE_CLASSES, NoiseClassifier
from audiodenoiser_torch.models.unet import (
    BottleneckAttention,
    DoubleConv,
    UNet,
    count_params,
    depth_to_space,
    scaled_widths,
    space_to_depth,
    width_kwargs,
)

__all__ = ["UNet", "DoubleConv", "BottleneckAttention", "space_to_depth", "depth_to_space",
           "ComplexMaskUNet", "FoldedUNet", "fold_for_inference", "Int8UNet", "prepare_int8",
           "count_params",
           "scaled_widths", "width_kwargs", "spectrogram_features", "apply_mask",
           "denoise_waveform", "state_dict_from_flax", "flax_from_state_dict", "random_flax_variables",
           "load_flax_variables", "NOISE_CLASSES", "NoiseClassifier",
           "router_state_dict_from_flax", "router_flax_from_state_dict",
           "random_router_flax_variables"]
