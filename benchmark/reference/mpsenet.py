"""MP-SENet in plain float32 PyTorch: the reference that the port's model
and its ``mag_pha`` serving mode are held to.

Y.-X. Lu, Y. Ai, Z.-H. Ling, "MP-SENet: A Speech Enhancement Model with
Parallel Denoising of Magnitude and Phase Spectra", Interspeech 2023,
arXiv:2305.13686; the published code's ``models/generator.py``,
``models/conformer.py`` and ``inference.py``. The network is written as
functions of a state_dict under the published generator's names
(``weight_layout``); the STFT is ``torch.stft``/``torch.istft`` with a
periodic Hann window and reflect centre padding, and the attention is
``softmax(Q K^T / sqrt(d)) V`` written out, over blocks of sequences so
that no block's scores pass ``SCORE_ELEMENTS``. It imports nothing but
torch; the benchmark's check and the port's tests
(``tests/test_torch_mpsenet.py`` on the CPU, the card tests) use this file.

Departures from the published code:

- attention runs batch-first along the axis the paper names: over the T
  frames of each (clip, bin) in the time conformer and over the bins of
  each (clip, frame) in the frequency conformer (the published code hands
  (B*F, T, C) to a sequence-first ``nn.MultiheadAttention``);
- a clip is zero-padded to a multiple of the hop after its normalisation
  and the answer cut back to the clip (the published inference neither
  pads nor passes ``length``);
- the per-clip normalisation ``sqrt(n / sum(x^2))`` takes the mean square
  at least float32's smallest normal, so a silent clip comes back silent
  instead of as NaN;
- the imaginary parts that are 0 in exact arithmetic are set to 0 before
  the phase is taken: the DC and Nyquist bins' (a real signal has none)
  and, with an even n_fft and window padding, frame 0's (the reflected
  frame and the Hann window are symmetric about the frame's centre, so
  its spectrum is real). Left to rounding, their sign picks +pi or -pi at
  each bin of negative real part, and two correct STFTs disagree there;
- the imaginary parts of the DC and Nyquist bins are zeroed before the
  iSTFT: a real signal has none, and not every C2R transform ignores them;
- dropout is left out (inference).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IN_EPS = 1e-5     # InstanceNorm2d
LN_EPS = 1e-5     # LayerNorm
BN_EPS = 1e-5     # BatchNorm1d
SCORE_ELEMENTS = 1 << 28  # at most this many attention scores at once


def _cip_names(prefix: str, cin: int, cout: int, kernel) -> list:
    return [(f"{prefix}.0.weight", (cout, cin, *kernel), "conv"),
            (f"{prefix}.0.bias", (cout,), "bias"),
            (f"{prefix}.1.weight", (cout,), "norm_scale"),
            (f"{prefix}.1.bias", (cout,), "norm_shift"),
            (f"{prefix}.2.weight", (cout,), "prelu")]


def _dense_names(prefix: str, c: int, depth: int = 4) -> list:
    out = []
    for i in range(depth):
        out += _cip_names(f"{prefix}.dense_block.{i}", c * (i + 1), c, (3, 3))
    return out


def _ln_names(prefix: str, c: int) -> list:
    return [(f"{prefix}.weight", (c,), "norm_scale"), (f"{prefix}.bias", (c,), "norm_shift")]


def _ffm_names(prefix: str, c: int, hid: int) -> list:
    return [*_ln_names(f"{prefix}.ffm.0", c),
            (f"{prefix}.ffm.1.weight", (hid, c), "linear"),
            (f"{prefix}.ffm.1.bias", (hid,), "bias"),
            (f"{prefix}.ffm.4.weight", (c, hid), "linear"),
            (f"{prefix}.ffm.4.bias", (c,), "bias")]


def _conformer_names(prefix: str, config: dict) -> list:
    c = int(config["dense_channel"])
    hid = c * int(config["ffn_mult"])
    inner = c * int(config["conv_expansion"])
    k = int(config["conv_kernel"])
    return [
        *_ffm_names(f"{prefix}.ffm1", c, hid),
        (f"{prefix}.attn.attn.in_proj_weight", (3 * c, c), "linear"),
        (f"{prefix}.attn.attn.in_proj_bias", (3 * c,), "bias"),
        (f"{prefix}.attn.attn.out_proj.weight", (c, c), "linear"),
        (f"{prefix}.attn.attn.out_proj.bias", (c,), "bias"),
        *_ln_names(f"{prefix}.attn.layernorm", c),
        *_ln_names(f"{prefix}.ccm.ccm.0", c),
        (f"{prefix}.ccm.ccm.2.weight", (2 * inner, c, 1), "conv"),
        (f"{prefix}.ccm.ccm.2.bias", (2 * inner,), "bias"),
        (f"{prefix}.ccm.ccm.4.weight", (inner, 1, k), "conv"),
        (f"{prefix}.ccm.ccm.4.bias", (inner,), "bias"),
        *_ln_names(f"{prefix}.ccm.ccm.5", inner),
        (f"{prefix}.ccm.ccm.5.running_mean", (inner,), "running_mean"),
        (f"{prefix}.ccm.ccm.5.running_var", (inner,), "running_var"),
        (f"{prefix}.ccm.ccm.5.num_batches_tracked", (), "count"),
        (f"{prefix}.ccm.ccm.7.weight", (c, inner, 1), "conv"),
        (f"{prefix}.ccm.ccm.7.bias", (c,), "bias"),
        *_ffm_names(f"{prefix}.ffm2", c, hid),
        *_ln_names(f"{prefix}.post_ln", c),
    ]


def weight_layout(config: dict) -> list:
    """(name, shape, kind) of every state_dict entry, in the published
    generator's order."""
    c = int(config["dense_channel"])
    n_freq = int(config["n_fft"]) // 2 + 1
    out = _cip_names("dense_encoder.dense_conv_1", 2, c, (1, 1))
    out += _dense_names("dense_encoder.dense_block", c)
    out += _cip_names("dense_encoder.dense_conv_2", c, c, (1, 3))
    for i in range(int(config["num_tsconformers"])):
        for half in ("time_conformer", "freq_conformer"):
            out += _conformer_names(f"TSConformer.{i}.{half}", config)
    out += _dense_names("mask_decoder.dense_block", c)
    out += [("mask_decoder.mask_conv.0.weight", (c, c, 1, 3), "deconv"),
            ("mask_decoder.mask_conv.0.bias", (c,), "bias"),
            ("mask_decoder.mask_conv.1.weight", (1, c, 1, 1), "conv"),
            ("mask_decoder.mask_conv.1.bias", (1,), "bias"),
            ("mask_decoder.mask_conv.2.weight", (1,), "norm_scale"),
            ("mask_decoder.mask_conv.2.bias", (1,), "norm_shift"),
            ("mask_decoder.mask_conv.3.weight", (1,), "prelu"),
            ("mask_decoder.mask_conv.4.weight", (1, 1, 1, 1), "conv"),
            ("mask_decoder.mask_conv.4.bias", (1,), "bias"),
            ("mask_decoder.lsigmoid.slope", (n_freq, 1), "slope")]
    out += _dense_names("phase_decoder.dense_block", c)
    out += [("phase_decoder.phase_conv.0.weight", (c, c, 1, 3), "deconv"),
            ("phase_decoder.phase_conv.0.bias", (c,), "bias"),
            ("phase_decoder.phase_conv.1.weight", (c,), "norm_scale"),
            ("phase_decoder.phase_conv.1.bias", (c,), "norm_shift"),
            ("phase_decoder.phase_conv.2.weight", (c,), "prelu"),
            ("phase_decoder.phase_conv_r.weight", (1, c, 1, 1), "conv"),
            ("phase_decoder.phase_conv_r.bias", (1,), "bias"),
            ("phase_decoder.phase_conv_i.weight", (1, c, 1, 1), "conv"),
            ("phase_decoder.phase_conv_i.bias", (1,), "bias")]
    return out


def parameter_count(config: dict) -> int:
    return sum(math.prod(s) for _, s, kind in weight_layout(config)
               if kind not in ("running_mean", "running_var", "count"))


def seeded_weights(config: dict, gen: torch.Generator, device) -> dict:
    """float32 weights from one normal draw: He-scaled convolutions and
    linears (fan-in; a transposed conv's is its input channels times its
    kernel), biases 0.1 N, norm scales 1 + 0.1 N and shifts 0.1 N, PReLU
    slopes 0.25 + 0.05 N, learnable-sigmoid slopes 1 + 0.1 N; BatchNorm's
    running statistics 0 and 1 until ``calibrate`` sets them."""
    layout = weight_layout(config)
    total = sum(math.prod(s) for _, s, kind in layout if kind != "count")
    draw = torch.randn(total, generator=gen, device=device)
    out, pos = {}, 0
    for name, shape, kind in layout:
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        x = draw[pos:pos + n].view(shape)
        pos += n
        if kind in ("conv", "linear"):
            x = x * math.sqrt(2.0 / math.prod(shape[1:]))
        elif kind == "deconv":
            x = x * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
        elif kind in ("bias", "norm_shift"):
            x = 0.1 * x
        elif kind in ("norm_scale", "slope"):
            x = 1.0 + 0.1 * x
        elif kind == "prelu":
            x = 0.25 + 0.05 * x
        elif kind == "running_mean":
            x = torch.zeros_like(x)
        elif kind == "running_var":
            x = torch.ones_like(x)
        out[name] = x.clone()
    return out


def _cip(p, prefix, x, stride=(1, 1), dilation=(1, 1), padding=(0, 0), transpose=False):
    w, b = p[f"{prefix}.0.weight"], p[f"{prefix}.0.bias"]
    if transpose:
        x = F.conv_transpose2d(x, w, b, stride=stride)
    else:
        x = F.conv2d(x, w, b, stride=stride, padding=padding, dilation=dilation)
    x = F.instance_norm(x, weight=p[f"{prefix}.1.weight"], bias=p[f"{prefix}.1.bias"],
                        eps=IN_EPS)
    return F.prelu(x, p[f"{prefix}.2.weight"])


def dense_block(p, prefix, x, depth=4):
    skip = x
    for i in range(depth):
        d = 2 ** i
        x = _cip(p, f"{prefix}.dense_block.{i}", skip, dilation=(d, 1), padding=(d, 1))
        skip = torch.cat([x, skip], dim=1)
    return x


def dense_encoder(p, x):
    """(B, 2, T, F) -> (B, C, T, (F - 3) // 2 + 1)."""
    x = _cip(p, "dense_encoder.dense_conv_1", x)
    x = dense_block(p, "dense_encoder.dense_block", x)
    return _cip(p, "dense_encoder.dense_conv_2", x, stride=(1, 2))


def _ln(p, prefix, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{prefix}.weight"], p[f"{prefix}.bias"], LN_EPS)


def _ffm(p, prefix, x):
    y = F.linear(_ln(p, f"{prefix}.ffm.0", x), p[f"{prefix}.ffm.1.weight"],
                 p[f"{prefix}.ffm.1.bias"])
    return F.linear(F.silu(y), p[f"{prefix}.ffm.4.weight"], p[f"{prefix}.ffm.4.bias"])


def attention(q, k, v, scale):
    """softmax(q k^T * scale) v over (N, H, L, d), in blocks of sequences."""
    n, h, length, _ = q.shape
    block = max(1, SCORE_ELEMENTS // (h * length * length))
    out = []
    for s in range(0, n, block):
        scores = torch.matmul(q[s:s + block], k[s:s + block].transpose(-1, -2)) * scale
        out.append(torch.matmul(torch.softmax(scores, dim=-1), v[s:s + block]))
    return torch.cat(out)


def mhsa(p, prefix, x, n_head, scale=None):
    """Self-attention over (N, L, C), batch-first; ``scale`` defaults to
    1/sqrt(head dim)."""
    n, length, c = x.shape
    d = c // n_head
    qkv = F.linear(x, p[f"{prefix}.in_proj_weight"], p[f"{prefix}.in_proj_bias"])
    q, k, v = qkv.view(n, length, 3, n_head, d).permute(2, 0, 3, 1, 4)
    y = attention(q, k, v, 1.0 / math.sqrt(d) if scale is None else scale)
    y = y.transpose(1, 2).reshape(n, length, c)
    return F.linear(y, p[f"{prefix}.out_proj.weight"], p[f"{prefix}.out_proj.bias"])


def conv_module(p, prefix, x, train=False):
    """LN -> pointwise -> GLU -> depthwise -> BatchNorm1d -> SiLU -> pointwise
    over (N, L, C). ``train="calibrate"``: the BatchNorm's running
    statistics are set to this batch's (the biased variance), then used."""
    y = _ln(p, f"{prefix}.0", x).transpose(1, 2)
    y = F.glu(F.conv1d(y, p[f"{prefix}.2.weight"], p[f"{prefix}.2.bias"]), dim=1)
    w = p[f"{prefix}.4.weight"]
    y = F.conv1d(y, w, p[f"{prefix}.4.bias"], padding=(w.shape[-1] - 1) // 2,
                 groups=w.shape[0])
    bn = f"{prefix}.5"
    if train == "calibrate":
        var, mean = torch.var_mean(y, (0, 2), correction=0)
        p[f"{bn}.running_mean"].copy_(mean)
        p[f"{bn}.running_var"].copy_(var)
    y = F.batch_norm(y, p[f"{bn}.running_mean"], p[f"{bn}.running_var"], p[f"{bn}.weight"],
                     p[f"{bn}.bias"], False, 0.0, BN_EPS)
    y = F.conv1d(F.silu(y), p[f"{prefix}.7.weight"], p[f"{prefix}.7.bias"])
    return y.transpose(1, 2)


def conformer(p, prefix, x, config, train=False):
    """One conformer over (N, L, C)."""
    x = x + 0.5 * _ffm(p, f"{prefix}.ffm1", x)
    x = x + mhsa(p, f"{prefix}.attn.attn", _ln(p, f"{prefix}.attn.layernorm", x),
                 int(config["n_head"]))
    x = x + conv_module(p, f"{prefix}.ccm.ccm", x, train)
    x = x + 0.5 * _ffm(p, f"{prefix}.ffm2", x)
    return _ln(p, f"{prefix}.post_ln", x)


def ts_block(p, i, x, config, train=False):
    """TS-Conformer block i over (B, C, T, F): time, then frequency, each
    inside the block's residual."""
    b, c, t, f = x.shape
    x = x.permute(0, 3, 2, 1).reshape(b * f, t, c)
    x = conformer(p, f"TSConformer.{i}.time_conformer", x, config, train) + x
    x = x.view(b, f, t, c).permute(0, 2, 1, 3).reshape(b * t, f, c)
    x = conformer(p, f"TSConformer.{i}.freq_conformer", x, config, train) + x
    return x.view(b, t, f, c).permute(0, 3, 1, 2)


def mask_decoder(p, x, config):
    """(B, C, T, F') -> the (B, F, T) mask ``beta * sigmoid(slope_f * y)``."""
    x = dense_block(p, "mask_decoder.dense_block", x)
    x = F.conv_transpose2d(x, p["mask_decoder.mask_conv.0.weight"],
                           p["mask_decoder.mask_conv.0.bias"], stride=(1, 2))
    x = F.conv2d(x, p["mask_decoder.mask_conv.1.weight"], p["mask_decoder.mask_conv.1.bias"])
    x = F.instance_norm(x, weight=p["mask_decoder.mask_conv.2.weight"],
                        bias=p["mask_decoder.mask_conv.2.bias"], eps=IN_EPS)
    x = F.prelu(x, p["mask_decoder.mask_conv.3.weight"])
    x = F.conv2d(x, p["mask_decoder.mask_conv.4.weight"], p["mask_decoder.mask_conv.4.bias"])
    y = x[:, 0].transpose(1, 2)  # (B, F, T)
    return float(config["beta"]) * torch.sigmoid(p["mask_decoder.lsigmoid.slope"] * y)


def phase_decoder(p, x):
    """(B, C, T, F') -> the (B, F, T) phase ``atan2(i, r)``."""
    x = dense_block(p, "phase_decoder.dense_block", x)
    x = _cip(p, "phase_decoder.phase_conv", x, stride=(1, 2), transpose=True)
    r = F.conv2d(x, p["phase_decoder.phase_conv_r.weight"], p["phase_decoder.phase_conv_r.bias"])
    i = F.conv2d(x, p["phase_decoder.phase_conv_i.weight"], p["phase_decoder.phase_conv_i.bias"])
    return torch.atan2(i[:, 0], r[:, 0]).transpose(1, 2)


def forward(p, config, mag, pha, train=False):
    """(B, F, T) magnitude and phase -> (compressed denoised magnitude,
    denoised phase), each (B, F, T)."""
    mag_c = mag.pow(float(config["compress_factor"]))
    x = torch.stack([mag_c, pha], dim=1).transpose(2, 3)  # (B, 2, T, F)
    x = dense_encoder(p, x)
    for i in range(int(config["num_tsconformers"])):
        x = ts_block(p, i, x, config, train)
    return mag_c * mask_decoder(p, x, config), phase_decoder(p, x)


def _window(config, device):
    n_fft, win = int(config["n_fft"]), int(config["win_length"])
    w = torch.hann_window(win, periodic=True, device=device)
    left = (n_fft - win) // 2
    return F.pad(w, (left, n_fft - win - left))


def mag_pha_stft(audio, config):
    """The published ``mag_pha_stft`` before compression: (B, samples) ->
    magnitude ``sqrt(re^2 + im^2 + 1e-9)`` and phase
    ``atan2(im + 1e-10, re + 1e-5)``, each (B, F, T)."""
    spec = torch.stft(audio, int(config["n_fft"]), int(config["hop_length"]),
                      window=_window(config, audio.device), center=True, pad_mode="reflect",
                      return_complex=True)
    n_fft, win = int(config["n_fft"]), int(config["win_length"])
    re, im = spec.real, spec.imag.clone()
    im[:, 0] = 0
    if n_fft % 2 == 0:
        im[:, -1] = 0
        if (n_fft - win) % 2 == 0:
            im[..., 0] = 0
    return torch.sqrt(re * re + im * im + 1e-9), torch.atan2(im + 1e-10, re + 1e-5)


def mag_pha_istft(mag_c, pha, config, length):
    """Decompress, polar to complex, iSTFT to ``length`` samples."""
    mag = mag_c.pow(1.0 / float(config["compress_factor"]))
    spec = torch.polar(mag, pha)
    spec[:, 0] = spec[:, 0].real.to(spec.dtype)
    spec[:, -1] = spec[:, -1].real.to(spec.dtype)
    return torch.istft(spec, int(config["n_fft"]), int(config["hop_length"]),
                       window=_window(config, spec.device), center=True, length=length)


def norm_factor(audio):
    """(B, samples) -> (B, 1): ``sqrt(n / sum(x^2))``."""
    mean_sq = audio.square().mean(-1, keepdim=True)
    return torch.rsqrt(mean_sq.clamp_min(torch.finfo(torch.float32).tiny))


@torch.no_grad()
def denoise(p, config, audio, block: int = 4):
    """(B, samples) noisy audio -> denoised audio, as the published
    inference does it, in blocks of ``block`` clips."""
    hop = int(config["hop_length"])
    n = audio.shape[-1]
    outs = []
    for s in range(0, audio.shape[0], block):
        x = audio[s:s + block].float()
        norm = norm_factor(x)
        x = F.pad(x * norm, (0, (-n) % hop))
        mag, pha = mag_pha_stft(x, config)
        mag_c, pha_hat = forward(p, config, mag, pha)
        outs.append(mag_pha_istft(mag_c, pha_hat, config, x.shape[-1])[:, :n] / norm)
    return torch.cat(outs)


@torch.no_grad()
def calibrate(p, config, audio):
    """Set every BatchNorm's running statistics, in place, to the batch
    statistics of ``audio`` (B, samples) on its way through the network."""
    x = audio.float()
    mag, pha = mag_pha_stft(x * norm_factor(x), config)
    forward(p, config, mag, pha, train="calibrate")
