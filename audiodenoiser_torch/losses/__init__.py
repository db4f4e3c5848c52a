"""The combined spectral training loss."""

from audiodenoiser_torch.losses.spectral import CombinedLossOutput, combined_perceptual_loss

__all__ = ["CombinedLossOutput", "combined_perceptual_loss"]
