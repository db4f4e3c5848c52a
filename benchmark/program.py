"""The system under test, built from a configuration and the benchmark's
weights through the port's public entry points, and the control that a
``--control`` run puts in its place."""

from __future__ import annotations

import torch


def build_model(config: dict, weights: dict, device, dtype: torch.dtype):
    """The configuration's live-BN model, computing in ``dtype``, with the
    benchmark's weights, on ``device``."""
    from audiodenoiser_torch.models import ComplexMaskUNet, UNet

    kw = dict(features=tuple(config["features"]), bottleneck=int(config["bottleneck"]),
              dtype=dtype)
    with torch.device(device):
        if config["model"] == "complex_mask":
            model = ComplexMaskUNet(mask_bound=float(config["mask_bound"]),
                                    residual=bool(config["mask_residual"]),
                                    zero_out_init=bool(config["mask_residual"]), **kw)
        else:
            model = UNet(**kw)
    model.load_state_dict(weights, strict=True)
    return model


def serving_runner(config: dict, weights: dict, device, control: bool = False):
    """``DenoiserRunner`` over the BN-folded model in the configuration's
    serving dtype (K1 and K2 on the card). The control: the program's own
    int8 compute (``prepare_int8``) over the float32 model."""
    from audiodenoiser_torch.eval.runner import DenoiserRunner
    from audiodenoiser_torch.models import fold_for_inference, prepare_int8

    dtype = getattr(torch, config["serve_dtype"])
    kw = dict(n_fft=int(config["n_fft"]), hop_length=int(config["hop_length"]),
              device=device)
    if control:
        model = build_model(config, weights, device, torch.float32).eval()
        return DenoiserRunner(prepare_int8(model), **kw)
    model = build_model(config, weights, device, dtype).eval()
    return DenoiserRunner(fold_for_inference(model, dtype), **kw)
