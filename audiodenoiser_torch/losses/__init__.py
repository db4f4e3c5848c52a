"""The combined spectral training loss and its terms."""

from audiodenoiser_torch.losses.spectral import (
    CombinedLossOutput,
    combined_perceptual_loss,
    l1_loss,
    mel_loss,
    multi_scale_stft_loss,
)

__all__ = ["CombinedLossOutput", "combined_perceptual_loss", "l1_loss", "mel_loss",
           "multi_scale_stft_loss"]
