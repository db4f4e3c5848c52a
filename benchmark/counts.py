"""The yardstick: operations and bytes worked out from a configuration's
shapes, and the card's published peaks. Nothing here asks the program
what it ran, so a change that adds or removes work inside the program
cannot move these counts.

FLOPs count the multiply-adds of every convolution (2 per multiply-add)
at the shapes the architecture computes: a 2x2 max-pool floors an odd
side, and each upsampling is zero-padded back to its skip's size, so the
decoder's convolutions run at the encoder's sizes. Training counts 3x the
forward (forward, and the backward's two products); recompute is not
counted.

Bytes of the STFT and iSTFT entries: each input byte read once and each
output byte written once, float32 audio and complex64 spectra.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def frames(samples: int, hop: int) -> int:
    """STFT frames of a centre-padded clip: 1 + samples // hop."""
    return 1 + samples // hop


def spectrogram_shape(config: dict, samples: int) -> tuple[int, int]:
    """(freq, time) of a clip's magnitude, after the runner's pad to a hop multiple."""
    hop = int(config["hop_length"])
    padded = samples + (-samples) % hop
    return int(config["n_fft"]) // 2 + 1, frames(padded, hop)


def unet_forward_flops(config: dict, height: int, width: int) -> int:
    """FLOPs of one forward of the configuration's U-Net on one
    (height, width) input."""
    feats, bottleneck = list(config["features"]), int(config["bottleneck"])
    k2 = int(config["kernel_size"]) ** 2
    d2 = int(config["deconv_kernel"]) ** 2
    total, sizes = 0, []
    c, h, w = int(config["in_channels"]), height, width
    for f in feats:
        total += 2 * (c * f + f * f) * k2 * h * w
        sizes.append((h, w))
        c, h, w = f, h // 2, w // 2
    total += 2 * (c * bottleneck + bottleneck * bottleneck) * k2 * h * w
    c = bottleneck
    for f, (sh, sw) in zip(reversed(feats), reversed(sizes)):
        total += 2 * c * f * d2 * h * w  # transposed conv over the input's pixels
        h, w = sh, sw
        total += 2 * (2 * f * f + f * f) * k2 * h * w
        c = f
    total += 2 * c * int(config["out_channels"]) * h * w
    return total


def clip_flops(config: dict, samples: int) -> int:
    """FLOPs of the U-Net's forward on one clip of ``samples``."""
    return unet_forward_flops(config, *spectrogram_shape(config, samples))


def train_step_flops(config: dict, samples: int, batch: int) -> int:
    """FLOPs of one training step: 3x the forward over the batch."""
    return 3 * batch * clip_flops(config, samples)


def stft_bytes(config: dict, rows: int, samples: int) -> int:
    """Bytes the STFT entry must move: float32 audio in, complex64 out."""
    f, t = spectrogram_shape(config, samples)
    return rows * samples * 4 + rows * f * t * 8


def istft_bytes(config: dict, rows: int, samples: int) -> int:
    """The reverse of ``stft_bytes``: complex64 in, float32 audio out."""
    return stft_bytes(config, rows, samples)


def bound_seconds(n_bytes: int) -> float:
    return n_bytes / PEAK_HBM_BYTES_PER_S
