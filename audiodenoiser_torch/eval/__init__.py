"""The fused denoise runner, metrics, streaming, routing and the benches."""

from audiodenoiser_torch.eval.metrics import si_sdr
from audiodenoiser_torch.eval.runner import (
    DenoiserRunner,
    load_model_for_noise,
    test_single_noise_type,
)

__all__ = ["si_sdr", "DenoiserRunner", "load_model_for_noise", "test_single_noise_type"]
