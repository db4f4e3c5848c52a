"""The complex-mask training step: losses, gradient, global-norm clip and
AdamW, in float32 over a state_dict.

The objective (the deployment's recipe): the combined perceptual loss on
|S_hat| against |S_clean| (0.4 multi-scale STFT L1 + 0.4 mel L1 + 0.2 L1,
the first two on the spectrogram averaged over frequency, as the original
recipe computes them), plus 0.5 x the reconstructed waveform's L1, minus
``si_sdr_weight`` x the batch's mean SI-SDR over 20 dB, each clip's SI-SDR
clamped at ``si_sdr_clamp``. The clip scales the gradient by
``clip / ||g||`` only when ``||g||`` exceeds it; AdamW has betas (0.9,
0.999), eps 1e-8 and decoupled weight decay on every parameter.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import dsp
from benchmark.reference.unet import masked_spectrum

FFT_SIZES, HOPS = (63, 32, 16), (16, 8, 4)
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def multi_scale_stft(pred_wave, target_wave):
    loss = 0.0
    for n_fft, hop in zip(FFT_SIZES, HOPS):
        ones = torch.ones(n_fft, device=pred_wave.device)
        pm = torch.stft(pred_wave, n_fft, hop, window=ones, center=True, pad_mode="constant",
                        return_complex=True).abs()
        tm = torch.stft(target_wave, n_fft, hop, window=ones, center=True,
                        pad_mode="constant", return_complex=True).abs()
        loss = loss + (pm - tm).abs().mean()
    return loss / len(FFT_SIZES)


def mel_bank(n_freqs: int, n_mels: int, sample_rate: int) -> np.ndarray:
    """HTK triangular filters from 0 to sample_rate / 2, no norm."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2)
    f = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    diff = f[1:] - f[:-1]
    slopes = f[None, :] - freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / diff[:-1], slopes[:, 2:] / diff[1:]))
    return fb.astype(np.float32)


def mel(wave, sample_rate=8000, n_fft=63, hop=16, n_mels=64):
    """Power mel spectrogram: a periodic Hann window, reflect padding."""
    window = torch.hann_window(n_fft, periodic=True, device=wave.device)
    p = torch.stft(wave, n_fft, hop, window=window, center=True, pad_mode="reflect",
                   return_complex=True).abs() ** 2
    fb = torch.from_numpy(mel_bank(n_fft // 2 + 1, n_mels, sample_rate)).to(wave.device)
    return torch.einsum("bft,fm->bmt", p, fb)


def perceptual(pred, target):
    """(B, F, T) magnitudes -> the combined loss."""
    pw, tw = pred.mean(dim=-2), target.mean(dim=-2)
    s = multi_scale_stft(pw, tw)
    m = (mel(pw) - mel(tw)).abs().mean()
    l1 = (pred - target).abs().mean()
    return 0.4 * s + 0.4 * m + 0.2 * l1


def si_sdr(est, ref, eps=1e-8):
    ref_e = (ref ** 2).sum(-1, keepdim=True)
    target = (est * ref).sum(-1, keepdim=True) / (ref_e + eps) * ref
    noise = est - target
    return 10.0 * torch.log10((target ** 2).sum(-1) / ((noise ** 2).sum(-1) + eps) + eps)


def losses(params: dict, config: dict, traffic: dict, noisy, clean, precision="fp32"):
    """(total, scale, head): the objective, the sum of its terms'
    magnitudes, and the network's output (the mask)."""
    n_fft, hop = int(config["n_fft"]), int(config["hop_length"])
    b = noisy.shape[0]
    with torch.no_grad():
        spec_all = dsp.stft(torch.cat([noisy, clean]), n_fft, hop)
    spec, clean_mag = spec_all[:b], spec_all[b:].abs()
    s_hat, head = masked_spectrum(params, config, spec, train=True, precision=precision,
                                  with_head=True)
    spectral = perceptual(s_hat.abs(), clean_mag)
    y_hat = dsp.istft(s_hat, n_fft, hop, clean.shape[-1])
    wave = 0.5 * (y_hat - clean).abs().mean()
    sdr = si_sdr(y_hat, clean).clamp(max=float(traffic["si_sdr_clamp"]))
    reward = float(traffic["si_sdr_weight"]) * sdr.mean() / 20.0
    total = spectral + wave - reward
    return total, (spectral.abs() + wave.abs() + reward.abs()).detach(), head.detach()


def adamw_step(params: dict, grads: dict, moments: dict, step: int, lr: float,
               weight_decay: float) -> None:
    """One AdamW update of ``params`` in place (torch's algebra)."""
    b1, b2 = BETAS
    bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    for name, g in grads.items():
        m, v = moments.setdefault(name, (torch.zeros_like(g), torch.zeros_like(g)))
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        p = params[name]
        p.mul_(1.0 - lr * weight_decay)
        p.sub_(lr * (m / bc1) / ((v / bc2).sqrt() + ADAM_EPS))


def train_steps(weights: dict, param_names: list, config: dict, traffic: dict, batches,
                precision: str = "fp32") -> dict:
    """Follow the program's first steps from the same weights on the same
    (noisy, clean) batches: each step's loss and term scale, the first
    step's clipped gradient by parameter and its mask, and the parameters
    after the last step."""
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    moments, out = {}, {"loss": [], "scale": []}
    lr, wd, clip = (float(traffic[k]) for k in ("learning_rate", "weight_decay", "clip_norm"))
    for step, (noisy, clean) in enumerate(batches, start=1):
        leaves = [params[n].requires_grad_(True) for n in param_names]
        total, scale, head = losses(params, config, traffic, noisy, clean, precision)
        grads = torch.autograd.grad(total, leaves)
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
            factor = 1.0 if float(norm) < clip else clip / float(norm)
            clipped = {n: g * factor for n, g in zip(param_names, grads)}
            for n in param_names:
                params[n] = params[n].detach()
            adamw_step(params, clipped, moments, step, lr, wd)
        out["loss"].append(float(total.detach()))
        out["scale"].append(float(scale))
        if step == 1:
            out["grad"], out["mask"] = clipped, head
        del total, grads
    out["params"] = {n: params[n].detach() for n in param_names}
    return out


def leaf_gaps(program: dict, reference: dict, names: list) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of that leaf's reference norm and the median leaf's."""
    ref = {n: float(reference[n].norm()) for n in names}
    median = float(np.median(list(ref.values())))
    return {n: abs(float(program[n].norm()) - ref[n]) / max(ref[n], median, 1e-30)
            for n in names}


def cos_gaps(program: dict, reference: dict, names: list) -> dict:
    """Each leaf's 1 - cosine between the program's tensor and the
    reference's: 0 where they point the same way, 1 where they are
    orthogonal, whatever their norms."""
    return {n: 1.0 - float(torch.nn.functional.cosine_similarity(
        program[n].flatten().float(), reference[n].flatten().float(), dim=0, eps=1e-30))
        for n in names}


def whole_cos_gap(program: dict, reference: dict, names: list) -> float:
    """1 - cosine between all of ``names``'s leaves taken as one vector."""
    a = torch.cat([program[n].flatten().float() for n in names])
    b = torch.cat([reference[n].flatten().float() for n in names])
    return 1.0 - float(torch.nn.functional.cosine_similarity(a, b, dim=0, eps=1e-30))


def worst(gaps: dict) -> tuple[float, str]:
    name = max(gaps, key=lambda n: gaps[n] if math.isfinite(gaps[n]) else math.inf)
    return gaps[name], name


def moved_leaves(ref_grad: dict, names: list, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is more than ``share`` of the
    median leaf's: a conv bias that feeds train-mode BatchNorm has a
    gradient of nought up to rounding, which AdamW turns into an lr-sized
    step of either sign, so its change is left out."""
    norms = {n: float(ref_grad[n].norm()) for n in names}
    median = float(np.median(list(norms.values())))
    return [n for n in names if norms[n] > share * median]
