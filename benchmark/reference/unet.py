"""The configurations' U-Net as plain functions of a state_dict (the
reference model's names, ``benchmark.inputs.weight_layout``), and the two
serving modes around it.

The network: four levels of [Conv3x3 (pad 1) -> BatchNorm -> ReLU] x 2,
each followed by a 2x2 max-pool (an odd side floors); a bottleneck of the
same block; four levels of a 2x2 stride-2 transposed conv, zero-padded to
the skip's size (the odd row or column at the bottom or right), the skip
concatenated first, and the block; a 1x1 head. A complex-mask model
bounds its two head channels, ``bound * tanh``, plus the identity mask
(1, 0) when it is residual.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import dsp

BN_EPS = 1e-5


def round_int8(t: torch.Tensor, keep_dim=None) -> torch.Tensor:
    """``t`` rounded to symmetric int8, ``absmax / 127`` a step, over the
    whole tensor or per index of ``keep_dim``; the gradient passes straight
    through."""
    a = t.detach().abs()
    if keep_dim is None:
        amax = a.amax()
    else:
        amax = a.amax(dim=[d for d in range(t.dim()) if d != keep_dim], keepdim=True)
    scale = amax.clamp_min(torch.finfo(torch.float32).tiny) / 127.0
    q = torch.clamp(torch.round(t.detach() / scale), -127, 127) * scale
    return t + (q - t.detach())


def _conv(x, w, b, precision, transpose=False):
    if precision == "int8":  # per-tensor inputs, kernels per output channel
        x, w = round_int8(x), round_int8(w, 1 if transpose else 0)
    if transpose:
        return F.conv_transpose2d(x, w, b, stride=2)
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2)


def _double(p, prefix, x, train, precision):
    for ci, bi in ((0, 1), (3, 4)):
        c, n = f"{prefix}.double_conv.{ci}", f"{prefix}.double_conv.{bi}"
        x = _conv(x, p[f"{c}.weight"], p[f"{c}.bias"], precision)
        if train == "calibrate":  # the running statistics become the batch's
            var, mean = torch.var_mean(x, (0, 2, 3), correction=0)
            p[f"{n}.running_mean"].copy_(mean)
            p[f"{n}.running_var"].copy_(var)
        if train is True:  # the batch's statistics, the biased variance
            x = F.batch_norm(x, None, None, p[f"{n}.weight"], p[f"{n}.bias"], True, 0.0,
                             BN_EPS)
        else:
            x = F.batch_norm(x, p[f"{n}.running_mean"], p[f"{n}.running_var"],
                             p[f"{n}.weight"], p[f"{n}.bias"], False, 0.0, BN_EPS)
        x = F.relu(x)
    return x


def _pad_to(x, skip):
    dy = skip.shape[-2] - x.shape[-2]
    dx = skip.shape[-1] - x.shape[-1]
    return F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


def forward(p: dict, config: dict, x: torch.Tensor, train=False,
            precision: str = "fp32") -> torch.Tensor:
    """(N, in_channels, F, T) float32 -> the head's (N, out_channels, F, T),
    through the mask transform for a complex-mask configuration. ``train``:
    BatchNorm on the batch's statistics; ``"calibrate"``: each BatchNorm's
    running statistics set to the batch's on the way, then used."""
    levels = len(config["features"])
    skips = []
    for i in range(1, levels + 1):
        x = _double(p, f"downconv{i}.conv", x, train, precision)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = _double(p, "bottleneck", x, train, precision)
    for i, skip in enumerate(reversed(skips), start=1):
        up = _conv(x, p[f"upconv{i}.up.weight"], p[f"upconv{i}.up.bias"], precision,
                   transpose=True)
        x = _double(p, f"upconv{i}.conv", torch.cat([skip, _pad_to(up, skip)], dim=1),
                    train, precision)
    x = _conv(x, p["out.weight"], p["out.bias"], precision)
    if config["model"] == "complex_mask":
        x = float(config["mask_bound"]) * torch.tanh(x)
        if config["mask_residual"]:
            x = x + torch.tensor([1.0, 0.0], device=x.device)[:, None, None]
    return x


def masked_spectrum(p: dict, config: dict, spec: torch.Tensor, train=False,
                    precision: str = "fp32", with_head: bool = False):
    """The denoised spectrum of complex (N, F, T) ``spec`` in the
    configuration's mode: ``noisy_phase`` (the magnitude through the
    network, clamped at zero, the noisy phase back on) or ``complex_mask``
    (features [mag, cos, sin], the mask times the spectrum); with
    ``with_head`` also the network's output (the mask)."""
    mag, phase = dsp.magphase(spec)
    if config["mode"] == "noisy_phase":
        head = forward(p, config, mag[:, None], train, precision)
        out = head[:, 0].clamp_min(0.0) * phase
    else:
        head = forward(p, config, torch.stack([mag, phase.real, phase.imag], dim=1), train,
                       precision)
        out = torch.complex(head[:, 0], head[:, 1]) * spec
    return (out, head) if with_head else out


@torch.no_grad()
def denoise(p: dict, config: dict, audio: torch.Tensor, precision: str = "fp32",
            block: int = 16) -> torch.Tensor:
    """(N, samples) noisy audio -> denoised audio, eval-mode BatchNorm, in
    blocks of ``block`` rows. A clip is zero-padded to a hop multiple and
    the result cut back."""
    n_fft, hop = int(config["n_fft"]), int(config["hop_length"])
    n = audio.shape[-1]
    padded = F.pad(audio.float(), (0, (-n) % hop))
    outs = []
    for s in range(0, padded.shape[0], block):
        spec = dsp.stft(padded[s:s + block], n_fft, hop)
        rec = masked_spectrum(p, config, spec, precision=precision)
        outs.append(dsp.istft(rec, n_fft, hop, padded.shape[-1])[:, :n])
    return torch.cat(outs)
