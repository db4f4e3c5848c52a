"""SEMamba in plain float32 PyTorch: the reference that the port's model
and its ``mag_pha`` serving mode are held to.

R. Chao, W.-H. Cheng, M. La Quatra, S. M. Siniscalchi, C.-H. H. Yang,
S.-W. Fu, Y. Tsao, "An Investigation of Incorporating Mamba for Speech
Enhancement", IEEE SLT 2024, arXiv:2405.06573; the published code's
``models/generator.py`` and ``models/mamba_block.py``, with
``recipes/SEMamba_advanced/SEMamba_advanced.yaml``; the Mamba mixer and
``Block`` as mamba_ssm (v1) has them, its ``selective_scan_ref`` for the
scan. SEMamba is MP-SENet's generator with each TS-Conformer replaced by a
TF-Mamba block, so the dense encoder, the two decoders, the STFT, the
per-clip normalisation and their departures are this package's MP-SENet
reference's (``reference/mpsenet.py``), called as they are. The network is
written as functions of a state_dict under the published generator's names
(``weight_layout``). It imports nothing but torch and that package's
``mpsenet`` and ``exact_float32``; the benchmark's check and the port's
tests (``tests/test_torch_semamba.py`` on the CPU, the card tests) use this
file. ``denoise`` runs its matmuls and convolutions in full float32 (TF32
off, ``exact_float32``).

Each TF-Mamba block runs, as published, a bidirectional ``MambaBlock``
along time over (B*F', T, C) and one along frequency over (B*T, F', C);
a direction is mamba_ssm's ``Block`` with one layer, ``mixer(RMSNorm(x)) +
x``; the backward direction runs on ``flip(x)`` and its answer is flipped
back; the two are concatenated and merged by ``ConvTranspose1d(2C, C, 1)``
inside the half's residual. The mixer: ``in_proj`` (no bias), the causal
depthwise conv (k = d_conv, the sequence padded by d_conv - 1 zeros on the
left) and SiLU, ``x_proj`` (no bias) to (dt, B, C), ``delta = softplus(dt_proj(dt))``
(threshold 20), the recurrence ``h = exp(delta A) h + delta B u`` with
``A = -exp(A_log)`` one token at a time (its factors formed a chunk of
tokens at a time),
``y = C h + D u``, ``y * silu(z)``, ``out_proj`` (no bias). RMSNorm is
``x * rsqrt(mean(x^2) + eps) * weight``.

Departures from the published code:

- those of the MP-SENet reference for the shared parts (a clip zero-padded
  to a multiple of the hop and cut back, the normalisation's floor, the
  zeroed imaginary parts of bins that are real in exact arithmetic);
- the model takes the uncompressed magnitude and compresses it itself, as
  the port's MP-SENet does (the published recipe compresses in its STFT
  helper before the call): the same arithmetic;
- mamba_ssm's fused CUDA and Triton kernels (the causal conv, the
  selective scan, the fused add + RMSNorm) are written out as the plain
  operations they compute;
- PCS post-processing, optional in the paper, is left out; dropout is
  left out (inference; the published Mamba blocks have none).

The seeded weights (``seeded_weights``) use mamba_ssm's published initial
distributions for the parameters of the scan, so that the decays are those
of a real model: ``A_log = log(1..d_state) + 0.1 N``, ``D = 1 + 0.1 N``,
``dt_proj`` weights uniform in +-dt_rank^-0.5, ``dt_proj`` bias the inverse
softplus of a log-uniform draw in [1e-3, 1e-1]; the rest as the MP-SENet
reference draws them, RMSNorm scales ``1 + 0.1 N``. There is no
BatchNorm, so nothing to calibrate.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import exact_float32
from benchmark.reference import mpsenet as mp

RMS_EPS = 1e-5
DT_MIN, DT_MAX = 1e-3, 1e-1
STATE_ELEMENTS = 1 << 22  # at most this many scan states held at once


def dims(config: dict) -> tuple[int, int, int, int, int]:
    """(C, d_inner, d_state, d_conv, dt_rank) of the configuration."""
    c = int(config["dense_channel"])
    return (c, int(config["expand"]) * c, int(config["d_state"]), int(config["d_conv"]),
            math.ceil(c / 16))


def _direction_names(prefix: str, config: dict) -> list:
    c, di, s, k, r = dims(config)
    m = f"{prefix}.mixer"
    return [(f"{m}.A_log", (di, s), "a_log"), (f"{m}.D", (di,), "d_skip"),
            (f"{m}.in_proj.weight", (2 * di, c), "linear"),
            (f"{m}.conv1d.weight", (di, 1, k), "conv"), (f"{m}.conv1d.bias", (di,), "bias"),
            (f"{m}.x_proj.weight", (r + 2 * s, di), "linear"),
            (f"{m}.dt_proj.weight", (di, r), "dt_weight"), (f"{m}.dt_proj.bias", (di,), "dt_bias"),
            (f"{m}.out_proj.weight", (c, di), "linear"),
            (f"{prefix}.norm.weight", (c,), "norm_scale")]


def weight_layout(config: dict) -> list:
    """(name, shape, kind) of every state_dict entry, in the published
    generator's order: the encoder's, the TF-Mamba blocks', the decoders'."""
    c = int(config["dense_channel"])
    shared = mp.weight_layout({**config, "num_tsconformers": 0})
    cut = next(i for i, (name, _, _) in enumerate(shared) if name.startswith("mask_decoder."))
    blocks = []
    for i in range(int(config["num_tfmamba"])):
        for half in ("time_mamba", "freq_mamba"):
            for way in ("forward_blocks", "backward_blocks"):
                blocks += _direction_names(f"TSMamba.{i}.{half}.{way}.0", config)
        for merge in ("tlinear", "flinear"):
            blocks += [(f"TSMamba.{i}.{merge}.weight", (2 * c, c, 1), "deconv"),
                       (f"TSMamba.{i}.{merge}.bias", (c,), "bias")]
    return shared[:cut] + blocks + shared[cut:]


def parameter_count(config: dict) -> int:
    return sum(math.prod(s) for _, s, _ in weight_layout(config))


def _uniform(x: torch.Tensor) -> torch.Tensor:
    """A standard normal draw mapped to a uniform one on (0, 1)."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def seeded_weights(config: dict, gen: torch.Generator, device) -> dict:
    """float32 weights from one normal draw (module docstring)."""
    layout = weight_layout(config)
    draw = torch.randn(sum(math.prod(s) for _, s, _ in layout), generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, kind in layout:
        n = math.prod(shape)
        x = draw[pos:pos + n].view(shape)
        pos += n
        if kind in ("conv", "linear"):
            x = x * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "deconv":
            x = x * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
        elif kind in ("bias", "norm_shift"):
            x = 0.1 * x
        elif kind in ("norm_scale", "slope", "d_skip"):
            x = 1.0 + 0.1 * x
        elif kind == "prelu":
            x = 0.25 + 0.05 * x
        elif kind == "a_log":
            states = torch.arange(1, shape[1] + 1, dtype=x.dtype, device=device)
            x = torch.log(states) + 0.1 * x
        elif kind == "dt_weight":
            x = (2.0 * _uniform(x) - 1.0) * shape[1] ** -0.5
        elif kind == "dt_bias":
            dt = torch.exp(_uniform(x) * (math.log(DT_MAX) - math.log(DT_MIN))
                           + math.log(DT_MIN))
            x = dt + torch.log(-torch.expm1(-dt))  # the inverse of softplus
        out[name] = x.clone()
    return out


def rms_norm(x, weight):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS) * weight


def selective_scan(u, delta, a, b, c, d_skip, z):
    """mamba_ssm's ``selective_scan_ref`` over (N, L, d_inner) with B and C
    (N, L, d_state). The recurrence runs one token at a time; ``exp(delta
    A)`` and ``delta B u`` are formed, and the states kept for ``C h``, for
    a chunk of tokens at a time, as many as ``STATE_ELEMENTS`` states
    allow, so that the (N, L, d_inner, d_state) tensor is never held."""
    n, length, d = u.shape
    step = max(1, STATE_ELEMENTS // (n * d * a.shape[1]))
    h = u.new_zeros(n, d, a.shape[1])
    ys = []
    for t0 in range(0, length, step):
        part = slice(t0, t0 + step)
        decay = torch.exp(delta[:, part, :, None] * a)
        push = (delta[:, part] * u[:, part])[..., None] * b[:, part, None, :]
        states = torch.empty_like(decay)
        for t in range(decay.shape[1]):
            h = torch.addcmul(push[:, t], decay[:, t], h, out=states[:, t])
        ys.append(torch.einsum("ntds,nts->ntd", states, c[:, part]))
    y = torch.cat(ys, dim=1) + u * d_skip
    return y * F.silu(z)


def mixer(p, prefix, x, config):
    """The Mamba mixer over (N, L, C)."""
    _, di, s, k, r = dims(config)
    xz = F.linear(x, p[f"{prefix}.in_proj.weight"])
    xs, z = xz[..., :di], xz[..., di:]
    # the published conv pads k - 1 on both sides and keeps the first L
    # outputs: the same as padding the left alone
    u = F.conv1d(F.pad(xs.transpose(1, 2), (k - 1, 0)), p[f"{prefix}.conv1d.weight"],
                 p[f"{prefix}.conv1d.bias"], groups=di)
    u = F.silu(u).transpose(1, 2)
    dt, b, c = F.linear(u, p[f"{prefix}.x_proj.weight"]).split([r, s, s], dim=-1)
    delta = F.softplus(F.linear(dt, p[f"{prefix}.dt_proj.weight"], p[f"{prefix}.dt_proj.bias"]))
    a = -torch.exp(p[f"{prefix}.A_log"])
    y = selective_scan(u, delta, a, b, c, p[f"{prefix}.D"], z)
    return F.linear(y, p[f"{prefix}.out_proj.weight"])


def direction(p, prefix, x, config):
    """mamba_ssm's ``Block`` with one layer and no residual in: the mixer
    of the RMS-normalised input, plus the input."""
    return mixer(p, f"{prefix}.mixer", rms_norm(x, p[f"{prefix}.norm.weight"]), config) + x


def mamba_block(p, prefix, x, config):
    """The published bidirectional ``MambaBlock``: (N, L, C) -> (N, L, 2C)."""
    y_fwd = direction(p, f"{prefix}.forward_blocks.0", x, config)
    y_bwd = torch.flip(direction(p, f"{prefix}.backward_blocks.0", torch.flip(x, [1]), config),
                       [1])
    return torch.cat([y_fwd, y_bwd], dim=-1)


def _merge(p, prefix, y):
    """``ConvTranspose1d(2C, C, 1)`` on the (N, 2C, L) layout, as published."""
    return F.conv_transpose1d(y.transpose(1, 2), p[f"{prefix}.weight"],
                              p[f"{prefix}.bias"]).transpose(1, 2)


def time_half(p, i, x, config):
    """The time half of TF-Mamba block i over (B*F', T, C), its residual in."""
    y = mamba_block(p, f"TSMamba.{i}.time_mamba", x, config)
    return _merge(p, f"TSMamba.{i}.tlinear", y) + x


def freq_half(p, i, x, config):
    """The frequency half of TF-Mamba block i over (B*T, F', C), its residual in."""
    y = mamba_block(p, f"TSMamba.{i}.freq_mamba", x, config)
    return _merge(p, f"TSMamba.{i}.flinear", y) + x


def tf_block(p, i, x, config):
    """TF-Mamba block i over (B, C, T, F'): time, then frequency."""
    b, c, t, f = x.shape
    x = time_half(p, i, x.permute(0, 3, 2, 1).reshape(b * f, t, c), config)
    x = freq_half(p, i, x.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c), config)
    return x.view(b, t, f, c).permute(0, 3, 1, 2)


def forward(p, config, mag, pha):
    """(B, F, T) magnitude and phase -> (compressed denoised magnitude,
    denoised phase), each (B, F, T)."""
    mag_c = mag.pow(float(config["compress_factor"]))
    x = torch.stack([mag_c, pha], dim=1).transpose(2, 3)  # (B, 2, T, F)
    x = mp.dense_encoder(p, x)
    for i in range(int(config["num_tfmamba"])):
        x = tf_block(p, i, x, config)
    return mag_c * mp.mask_decoder(p, x, config), mp.phase_decoder(p, x)


@torch.no_grad()
def denoise(p, config, audio, block: int = 8):
    """(B, samples) noisy audio -> denoised audio, as the published
    inference does it, in blocks of ``block`` clips, TF32 off."""
    with exact_float32():
        return _denoise(p, config, audio, block)


def _denoise(p, config, audio, block):
    hop = int(config["hop_length"])
    n = audio.shape[-1]
    outs = []
    for s in range(0, audio.shape[0], block):
        x = audio[s:s + block].float()
        norm = mp.norm_factor(x)
        x = F.pad(x * norm, (0, (-n) % hop))
        mag, pha = mp.mag_pha_stft(x, config)
        mag_c, pha_hat = forward(p, config, mag, pha)
        outs.append(mp.mag_pha_istft(mag_c, pha_hat, config, x.shape[-1])[:, :n] / norm)
    return torch.cat(outs)
