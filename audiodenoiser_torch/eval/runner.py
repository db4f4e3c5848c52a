"""The fused denoise paths and the evaluation drivers (port of
``eval/runner.py``).

``DenoiserRunner.denoise_audio`` runs one path for every model family:
the family's per-clip gain, zero padding to a hop multiple, the
centre-padded STFT through the K1 kernel, the family's model inputs, the
model, the family's complex spectrogram (or Griffin-Lim), one iSTFT, the
trim and the gain taken off. The families (``_FAMILIES``):

- magnitude (a ``UNet``): ``magphase``, the model on the magnitude; in
  ``noisy_phase`` the magnitude clamped at zero times the noisy phase, in
  ``griffin_lim`` / ``reference_gl`` through ``dsp.griffin_lim`` in its
  ``correct`` / ``reference`` mode, every transform through K1 and K2;
- complex mask (a ``ComplexMaskUNet``): ``[mag, cos, sin]`` features, the
  model's bounded complex mask times the noisy spectrogram;
- MP-SENet (``mag_pha``, at its own STFT sizes): each clip scaled to unit
  RMS, reflect centre padding, magnitude and phase (``mpsenet.mag_pha``),
  the model's outputs back to a spectrogram (``mpsenet.polar_spectrum``).

On a ('data', 'model') mesh (``mesh=``, ``parallel.make_mesh``) the model
is laid out by ``parallel.shard_variables`` (the wide convs channel-
parallel over ``model``), a batch is zero-padded to a multiple of the data
axis, each data rank runs its block of rows through K1 -> model -> K2,
and the rows are all-gathered and trimmed; an unbatched clip runs whole on
every rank, as JAX's meshed runner does. In a meshed service
(``parallel.follow``) the leader's calls are replayed on every rank.

On a CUDA device K1 and K2 launch; on the CPU their plain versions run.
``precision="fft"`` takes the ``torch.fft`` versions instead and
``"matmul"`` the real-DFT-basis STFT (``dsp.stft``), as JAX's
``precision`` chooses its lowering.

``load_model_for_noise`` / ``load_model_from_path`` read the JAX
package's ``{stem}_{noise}.ckpt`` exports with their ``.json`` sidecars,
and the reference's ``unet_denoiser_{noise}.pth``, and fold the model for
inference; a sidecar ``{"model": "mpsenet", ...}`` beside a torch
state_dict (or the published ``{"generator": state_dict}``) loads
MP-SENet. ``test_single_noise_type`` evaluates a magnitude model on the
test set's ``.npy`` artifacts, ``test_noise_type_waveform`` any model in
the waveform domain; both write the reference's artifact names.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

import audiodenoiser_torch.dsp.stft as stft_lib
import audiodenoiser_torch.models.mpsenet as mpsenet
from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.dsp.griffin_lim import griffin_lim, initial_phase
from audiodenoiser_torch.eval.metrics import pesq, si_sdr, stoi
from audiodenoiser_torch.losses.spectral import combined_perceptual_loss
from audiodenoiser_torch.models.complex_mask import (ComplexMaskUNet, apply_mask,
                                                     spectrogram_features)
from audiodenoiser_torch.models.convert import load_flax_variables
from audiodenoiser_torch.models.folded import fold_for_inference
from audiodenoiser_torch.models.unet import UNet, width_kwargs
from audiodenoiser_torch.train.checkpoints import load_exported
from audiodenoiser_torch.utils.profiling import ISTFT, MODEL, STFT, span

# Griffin-Lim reconstruction modes of a magnitude model, by griffin_lim mode
GL_MODES = {"griffin_lim": "correct", "reference_gl": "reference"}
MODES = ("noisy_phase", "complex_mask", "mag_pha", *GL_MODES)


class _Family(NamedTuple):
    """What one model family does that the others do not (module docstring)."""

    name: str                  # as a refused mode names it
    modes: tuple               # the modes it serves, its own first
    sizes: tuple               # n_fft, hop, win_length: a U-Net's defaults, MP-SENet's own
    pad_mode: str              # K1's centre padding
    gain: Optional[Callable]   # audio -> a per-clip gain put on before K1, taken off after K2
    inputs: Callable           # spec -> (the model's arguments, what spectrum keeps)
    spectrum: Callable         # (y, spec, kept) -> the complex spectrogram for K2


def _magnitude_inputs(spec: torch.Tensor):
    mag, phase = stft_lib.magphase(spec)
    return (mag[:, None],), phase


_FAMILIES = (
    _Family("magnitude", ("noisy_phase", *GL_MODES), (512, 128, None), "constant", None,
            _magnitude_inputs, lambda y, spec, phase: y[:, 0].float().clamp_min(0.0) * phase),
    _Family("complex-mask", ("complex_mask",), (512, 128, None), "constant", None,
            # (N, 3, F, T) features in NHWC memory; the (N, 2, F, T) mask back
            lambda spec: ((spectrogram_features(spec).permute(0, 3, 1, 2),), None),
            lambda y, spec, _: apply_mask(y.float().permute(0, 2, 3, 1), spec)),
    # the model's own sizes, inputs and spectrum: DenoiserRunner fills them in
    _Family("MP-SENet", ("mag_pha",), None, "reflect", mpsenet.unit_rms_gain, None, None),
)


def identity_bypass(out: torch.Tensor, orig: torch.Tensor,
                    thresh_db: float) -> torch.Tensor:
    """Return ``orig`` verbatim for clips whose change energy
    ``10*log10(||out-orig||^2 / ||orig||^2)`` is below ``-thresh_db``:
    clips the model itself judged clean pass through bit-exactly."""
    diff = torch.sum(torch.square(out - orig), dim=-1)
    ref = torch.sum(torch.square(orig), dim=-1)
    change_db = 10.0 * torch.log10(diff / (ref + 1e-12) + 1e-20)
    return torch.where((change_db < -thresh_db)[..., None], orig, out)


def batch_metric_mean(fn, clean, audio, sample_rate) -> float:
    """Mean of a per-clip metric over a batch, skipping each clip that
    ``fn`` cannot score (STOI and PESQ raise ValueError on clips too short
    or silent). Raises ValueError only when no clip is scorable."""
    vals = []
    for i in range(clean.shape[0]):
        try:
            vals.append(fn(clean[i], audio[i], sample_rate))
        except ValueError:
            continue
    if not vals:
        raise ValueError("no clip scorable")
    return float(np.mean(vals))


def _for_inference(model: nn.Module, dtype: torch.dtype, device: torch.device,
                   fold: bool) -> nn.Module:
    """``model`` folded to ``dtype``, or with ``fold=False`` the live-BN
    eval model computing in ``dtype``, on ``device``."""
    if fold:
        return fold_for_inference(model.eval(), dtype).to(device)
    model.dtype = dtype
    return model.eval().to(device)


def load_model_from_path(path: str, dtype: torch.dtype = torch.bfloat16,
                         device: DeviceLike = None,
                         stem: str = "mask_denoiser", fold: bool = True) -> nn.Module:
    """Load a ``.ckpt`` export by path and fold it for inference on
    ``device`` (``fold=False``: the live-BN eval model). Its ``.json``
    sidecar, when there is one, rebuilds the architecture: ``width_mult``,
    the variants ``attn_bottleneck``, ``s2d_stem`` and ``s2d_skip``, and
    for ``stem="mask_denoiser"`` the mask head's ``mask_bound`` (default
    2.0) and ``residual``. A sidecar ``{"model": "mpsenet", ...}`` (the
    rest ``MPSENet``'s arguments, its STFT sizes and sample rate among
    them) makes ``path`` a torch state_dict of MP-SENet, or the published
    ``{"generator": state_dict}``, served in ``dtype`` (nothing to fold)."""
    device = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(f"Model file not found: {path}")
    meta = {}
    sidecar = os.path.splitext(path)[0] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    if meta.get("model") == "mpsenet":
        model = mpsenet.MPSENet(**{k: v for k, v in meta.items() if k != "model"})
        mpsenet.load_state(model, torch.load(path, map_location="cpu", weights_only=True))
        print(f"Loaded MP-SENet from: {path}")
        return model.to(device=device, dtype=dtype).eval()
    kwargs = width_kwargs(float(meta.get("width_mult", 1.0)))
    kwargs.update({k: True for k in ("attn_bottleneck", "s2d_stem") if meta.get(k)})
    if meta.get("s2d_skip"):
        kwargs["s2d_skip"] = int(meta["s2d_skip"])
    if stem == "mask_denoiser":
        model = ComplexMaskUNet(mask_bound=float(meta.get("mask_bound", 2.0)),
                                residual=bool(meta.get("residual", False)), **kwargs)
    else:
        model = UNet(**kwargs)
    load_flax_variables(model, load_exported(path))
    print(f"Loaded model from: {path}")
    return _for_inference(model, dtype, device, fold)


def load_model_for_noise(noise_type: str, saved_models_dir: str = "./saved_models",
                         dtype: torch.dtype = torch.bfloat16,
                         device: DeviceLike = None,
                         stem: str = "unet_denoiser", fold: bool = True) -> nn.Module:
    """Load the model for ``noise_type`` and fold it for inference on
    ``device``, picking files in the JAX package's order:
    ``{stem}_{noise_type}.ckpt`` if it exists, else (for the magnitude
    U-Net, ``stem="unet_denoiser"``) the reference
    ``unet_denoiser_{noise_type}.pth``. Use ``stem="mask_denoiser"`` for
    the complex-mask family, ``stem="mpsenet"`` for MP-SENet's torch
    state_dict ``mpsenet_{noise_type}.pth`` with its sidecar."""
    device = resolve_device(device)
    ext = ".pth" if stem == "mpsenet" else ".ckpt"
    path = os.path.join(saved_models_dir, f"{stem}_{noise_type}{ext}")
    pth_path = os.path.join(saved_models_dir, f"unet_denoiser_{noise_type}.pth")
    if os.path.exists(path) or stem != "unet_denoiser" or not os.path.exists(pth_path):
        return load_model_from_path(path, dtype, device, stem, fold)
    model = UNet()
    model.load_state_dict(torch.load(pth_path, map_location="cpu", weights_only=True),
                          strict=True)
    print(f"Loaded model for noise type '{noise_type}' from: {pth_path}")
    return _for_inference(model, dtype, device, fold)


class DenoiserRunner:
    """Spectrogram and waveform denoising through ``model`` on ``device``.

    ``model`` is moved to ``device``, and its family (module docstring) is
    chosen once. A U-Net's ``n_fft`` and ``hop_length`` default to 512 and
    128; MP-SENet runs at its own. ``precision`` is the STFT and iSTFT path
    of ``dsp.stft``: ``"kernel"`` (K1 and K2), ``"fft"`` or ``"matmul"``.
    ``mesh`` lays the model out on a device mesh, in place (module
    docstring); the runner's results are the unmeshed runner's.
    """

    def __init__(self, model: nn.Module, n_fft: Optional[int] = None,
                 hop_length: Optional[int] = None, device: DeviceLike = None,
                 precision: str = "kernel", mesh=None):
        if precision not in stft_lib.PRECISIONS:
            raise ValueError(f"precision must be one of {stft_lib.PRECISIONS}, "
                             f"got {precision!r}")
        self.precision = precision
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        magnitude, mask, mp = _FAMILIES
        if not isinstance(model, mpsenet.MPSENet):
            self._family = mask if getattr(model, "mask_bound", None) is not None else magnitude
        elif n_fft not in (None, model.n_fft) or hop_length not in (None, model.hop_length):
            raise ValueError(
                f"MP-SENet runs at n_fft={model.n_fft}, hop_length={model.hop_length}")
        elif mesh is not None:
            raise NotImplementedError("MP-SENet is served without a mesh")
        else:
            self._family = mp._replace(
                sizes=(model.n_fft, model.hop_length, model.win_length),
                inputs=lambda spec: (mpsenet.mag_pha(spec, model.n_fft, model.win_length), None),
                spectrum=lambda y, spec, _: mpsenet.polar_spectrum(*y, model.compress_factor))
        self.mode = self._family.modes[0]
        default_n_fft, default_hop, self.win_length = self._family.sizes
        self.n_fft = default_n_fft if n_fft is None else n_fft
        self.hop = default_hop if hop_length is None else hop_length
        self.mesh = mesh
        self.calls = None
        if mesh is not None:
            from audiodenoiser_torch.parallel import follow
            from audiodenoiser_torch.parallel.mesh import shard_variables

            shard_variables(self.model, mesh)
            self.calls = follow.register(self)

    def _rows(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """``x`` zero-padded to a multiple of the data axis, this data
        rank's block of its rows, and the real row count."""
        from audiodenoiser_torch.parallel.mesh import shard_batch

        n = x.shape[0]
        pad = (-n) % self.mesh.size(0)
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        return shard_batch(x, self.mesh), n

    def _gathered(self, y: torch.Tensor, n: int) -> torch.Tensor:
        from audiodenoiser_torch.parallel.mesh import gather_rows

        return gather_rows(y, self.mesh)[:n]

    def denoise_spectrogram(self, noisy_mag: torch.Tensor) -> torch.Tensor:
        """(N, F, T) magnitudes -> (N, F, T) denoised magnitudes."""
        if self._family.name != "magnitude":
            raise ValueError("denoise_spectrogram needs a magnitude model")
        x = torch.as_tensor(noisy_mag, dtype=torch.float32).to(self.device)
        if self.calls is not None:
            return self.calls.lead(self, "_spectrogram", x)
        return self._spectrogram(x)

    @torch.inference_mode()
    def _spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return self.model(x[:, None])[:, 0].float()
        rows, n = self._rows(x)
        return self._gathered(self.model(rows[:, None])[:, 0].float(), n)

    def denoise_audio(self, audio, mode: Optional[str] = None, center: bool = True,
                      bypass_db: Optional[float] = None, gl_iters: int = 50,
                      generator: Optional[torch.Generator] = None,
                      theta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(..., samples) noisy audio -> denoised audio of the same shape,
        on the runner's device. ``mode`` defaults to the runner's own.

        The clip is zero-padded to a hop multiple first: the iSTFT of a
        centre-padded STFT reconstructs only ``floor(n/hop)*hop`` samples.
        ``bypass_db`` enables :func:`identity_bypass`. The Griffin-Lim modes
        run ``gl_iters`` iterations from the initial phase ``theta`` (the
        padded clips' (N, F, T)), else one drawn from ``generator``, else
        from a CPU generator seeded with 0: one phase for every call, as the
        JAX service's constant key.
        """
        mode = self.mode if mode is None else mode
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        if mode not in self._family.modes:
            need = next(f.name for f in _FAMILIES if mode in f.modes)
            raise NotImplementedError(
                f"mode {mode!r} needs a {need} model; this runner's model serves {self.mode!r}")
        audio = torch.as_tensor(audio, dtype=torch.float32).to(self.device)
        if self.mesh is not None and mode in GL_MODES and theta is None:
            # the unmeshed draw for the whole batch, made here (a follower
            # cannot) and cut into the ranks' rows with the clips
            n = audio.shape[-1] + ((-audio.shape[-1]) % self.hop if center else 0)
            shape = (audio.numel() // audio.shape[-1], self.n_fft // 2 + 1, n // self.hop + 1)
            theta = initial_phase(shape, generator or torch.Generator().manual_seed(0),
                                  self.device)
        if self.calls is not None:
            return self.calls.lead(self, "_audio", audio, mode, center, bypass_db,
                                   gl_iters, None, theta)
        return self._audio(audio, mode, center, bypass_db, gl_iters, generator, theta)

    @torch.inference_mode()
    def _audio(self, audio: torch.Tensor, mode: str, center: bool,
               bypass_db: Optional[float], gl_iters: int,
               generator: Optional[torch.Generator],
               theta: Optional[torch.Tensor]) -> torch.Tensor:
        orig = audio
        n = audio.shape[-1]
        gain = self._family.gain
        if gain is not None:
            with span(STFT):
                scale = gain(audio)
                audio = audio * scale
        rem = (-n) % self.hop
        if rem and center:
            audio = F.pad(audio, (0, rem))
        if self.mesh is None or audio.dim() < 2:
            out = self._reconstruct(audio, center, mode, gl_iters, generator, theta)
        else:
            lead = audio.shape[:-1]
            rows, b = self._rows(audio.reshape(-1, audio.shape[-1]))
            if theta is not None:
                theta = self._rows(theta.reshape(-1, *theta.shape[-2:]).to(self.device))[0]
            out = self._reconstruct(rows, center, mode, gl_iters, generator, theta)
            out = self._gathered(out, b).reshape(*lead, -1)
        if rem and center:
            out = out[..., :n]
        if gain is not None:
            with span(ISTFT):
                out = out / scale
        if bypass_db is not None:
            out = identity_bypass(out, orig, bypass_db)
        return out

    def _reconstruct(self, audio: torch.Tensor, center: bool, mode: str, gl_iters: int,
                     generator: Optional[torch.Generator],
                     theta: Optional[torch.Tensor]) -> torch.Tensor:
        lead, n = audio.shape[:-1], audio.shape[-1]
        with span(STFT):
            spec = stft_lib.stft(audio.reshape(-1, n), self.n_fft, self.hop,
                                 win_length=self.win_length, center=center,
                                 pad_mode=self._family.pad_mode, precision=self.precision)
            x, kept = self._family.inputs(spec)
        with span(MODEL):
            y = self.model(*x)
        if mode in GL_MODES:
            den = y[:, 0].float().clamp_min(0.0)  # magnitudes are non-negative
            if theta is None and generator is None:
                generator = torch.Generator().manual_seed(0)
            out = griffin_lim(den, generator, n_fft=self.n_fft, hop_length=self.hop,
                              n_iter=gl_iters, mode=GL_MODES[mode], length=n,
                              theta=theta, precision=self.precision)
        else:
            with span(ISTFT):
                out = stft_lib.istft(self._family.spectrum(y, spec, kept), self.hop,
                                     win_length=self.win_length, n_fft=self.n_fft,
                                     center=center, length=n, precision=self.precision)
        return out.reshape(*lead, n)


def _plot_comparison(noisy, denoised, clean, path):
    """The reference's three-panel magma spectrogram PNG; warns and skips
    when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        warnings.warn("matplotlib unavailable; skipping spectrogram PNGs")
        return

    plt.figure(figsize=(12, 6))
    panels = [(noisy, "Noisy"), (denoised, "Denoised"), (clean, "Clean")]
    for pos, (spec, title) in enumerate(panels, start=1):
        plt.subplot(1, 3, pos)
        plt.title(f"{title} Spectrogram")
        plt.imshow(spec, aspect="auto", origin="lower", cmap="magma")
        plt.colorbar(format="%+2.0f dB")
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def _loss_lines(metrics: dict) -> str:
    """The metrics files' four loss lines, each ending in a newline."""
    names = (("Total", "total"), ("STFT", "stft"), ("Mel", "mel"), ("L1", "l1"))
    return "".join(f"{name} Loss: {metrics[key]:.6f}\n" for name, key in names)


def _mean_si_sdr(estimate, reference, device) -> float:
    est = torch.as_tensor(estimate, dtype=torch.float32).to(device)
    ref = torch.as_tensor(reference, dtype=torch.float32).to(device)
    return float(si_sdr(est, ref).mean())


@torch.inference_mode()
def test_single_noise_type(
    model: nn.Module,
    noise_type: str,
    test_data_dir: str,
    output_dir: str,
    sample_rate: int = 8000,
    n_fft: int = 512,
    hop_length: int = 128,
    num_audio_examples: int = 5,
    gl_mode: str = "reference_gl",
    seed: int = 0,
    compute_si_sdr: bool = True,
    eval_batch_size: int = 64,
    device: DeviceLike = None,
    mesh=None,
) -> Optional[dict]:
    """Per-noise-type evaluation of a magnitude model on the test set's
    ``clean_{nt}.npy`` / ``noisy_{nt}.npy`` (and, when present,
    ``clean_audio.npy`` / ``noisy_audio_{nt}.npy``). Writes
    ``{nt}_noisy_{i}.wav``, ``{nt}_denoised_{i}.wav`` (Griffin-Lim in
    ``gl_mode``, both from one initial phase drawn with ``seed``),
    ``{nt}_metrics.txt`` and ``{nt}_spectrogram_{i}.png``; returns the
    metrics: the combined loss and its parts, and the SI-SDR and PESQ
    extensions. With ``mesh`` the model's batches run meshed and only rank 0
    writes."""
    from audiodenoiser_torch.data.wav_io import write_wav
    from audiodenoiser_torch.parallel.distributed import is_primary

    write = mesh is None or is_primary()

    print(f"\n=== Testing model on noise type: {noise_type} ===")
    clean_path = os.path.join(test_data_dir, f"clean_{noise_type}.npy")
    noisy_path = os.path.join(test_data_dir, f"noisy_{noise_type}.npy")
    if not (os.path.exists(clean_path) and os.path.exists(noisy_path)):
        print(f"Skipping {noise_type}, missing {clean_path} or {noisy_path}")
        return None

    clean = np.load(clean_path)  # (N, F, T)
    noisy = np.load(noisy_path)
    n = len(noisy)
    print(f"Found {n} test samples for noise type '{noise_type}'")
    os.makedirs(output_dir, exist_ok=True)

    runner = DenoiserRunner(model, n_fft, hop_length, device=device, mesh=mesh)
    dev = runner.device
    gl = dict(n_fft=n_fft, hop_length=hop_length, n_iter=50,
              mode=GL_MODES[gl_mode], precision="kernel")
    k = min(num_audio_examples, n)
    # one initial phase for both reconstructions, as JAX's two calls share a key
    theta = initial_phase((k, *noisy.shape[1:]), torch.Generator().manual_seed(seed), dev)

    if k > 0:
        noisy_audio = griffin_lim(torch.from_numpy(noisy[:k]).to(dev), theta=theta,
                                  **gl).cpu().numpy()
        for i in range(k if write else 0):
            write_wav(os.path.join(output_dir, f"{noise_type}_noisy_{i}.wav"),
                      noisy_audio[i], sample_rate)

    # batched, the tail padded to a whole batch so the model sees one shape
    if n <= eval_batch_size:
        denoised = runner.denoise_spectrogram(torch.from_numpy(noisy)).cpu().numpy()
    else:
        outs = []
        for s in range(0, n, eval_batch_size):
            chunk = noisy[s : s + eval_batch_size]
            pad = eval_batch_size - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]), chunk.dtype)])
            out = runner.denoise_spectrogram(torch.from_numpy(chunk)).cpu().numpy()
            outs.append(out[: eval_batch_size - pad])
        denoised = np.concatenate(outs, axis=0)

    total, s, m, l1 = combined_perceptual_loss(
        torch.from_numpy(denoised)[:, None].to(dev), torch.from_numpy(clean)[:, None].to(dev))
    metrics = {"total": float(total), "stft": float(s), "mel": float(m), "l1": float(l1)}
    print(f"\nLoss metrics for noise type '{noise_type}':\n{_loss_lines(metrics)}", end="")

    def zero_phase_audio(mags):
        spec = torch.from_numpy(mags).to(dev).to(torch.complex64)
        return stft_lib.istft(spec, hop_length, n_fft=n_fft, center=True, precision="kernel")

    if compute_si_sdr and k > 0:
        # a spectral proxy: zero-phase iSTFTs of the magnitudes
        metrics["si_sdr"] = _mean_si_sdr(zero_phase_audio(denoised[:k]),
                                         zero_phase_audio(clean[:k]), dev)
        print(f"SI-SDR (mag-only recon): {metrics['si_sdr']:.3f} dB")

    # with the test set's waveforms: denoised magnitude + the noisy phase,
    # one iSTFT, scored against the real clean waveform
    na_path = os.path.join(test_data_dir, f"noisy_audio_{noise_type}.npy")
    ca_path = os.path.join(test_data_dir, "clean_audio.npy")
    if compute_si_sdr and os.path.exists(na_path) and os.path.exists(ca_path):
        noisy_audio = np.load(na_path)
        clean_audio_true = np.load(ca_path)
        naud = torch.from_numpy(noisy_audio).to(dev)
        spec = stft_lib.stft(naud, n_fft, hop_length, center=True, precision="kernel")
        _, phase = stft_lib.magphase(spec)
        mag = torch.from_numpy(denoised).to(dev)
        t = min(mag.shape[-1], phase.shape[-1])
        rec = mag[..., :t].clamp_min(0.0) * phase[..., :t]
        recon = stft_lib.istft(rec, hop_length, n_fft=n_fft, center=True,
                               length=naud.shape[-1], precision="kernel").cpu().numpy()
        # the artifact spectrograms fix the frame count, so the iSTFT covers
        # only (T-1)*hop samples: score both signals on the covered region
        covered = max(hop_length, (denoised.shape[-1] - 1) * hop_length)
        covered = min(covered, recon.shape[-1])
        metrics["si_sdr_noisy_phase"] = _mean_si_sdr(
            recon[..., :covered], clean_audio_true[..., :covered], dev)
        metrics["si_sdr_noisy_input"] = _mean_si_sdr(
            noisy_audio[..., :covered], clean_audio_true[..., :covered], dev)
        print(f"SI-SDR (noisy-phase recon vs clean waveform): "
              f"{metrics['si_sdr_noisy_input']:.3f} -> "
              f"{metrics['si_sdr_noisy_phase']:.3f} dB")
        try:
            metrics["pesq_noisy_input"] = batch_metric_mean(
                pesq, clean_audio_true[:, :covered], noisy_audio[:, :covered], sample_rate)
            metrics["pesq_noisy_phase"] = batch_metric_mean(
                pesq, clean_audio_true[:, :covered], recon[:, :covered], sample_rate)
            print(f"PESQ-approx (noisy-phase recon vs clean waveform): "
                  f"{metrics['pesq_noisy_input']:.3f} -> "
                  f"{metrics['pesq_noisy_phase']:.3f}")
        except ValueError as e:
            print(f"PESQ skipped: {e}")

    if not write:
        return metrics
    with open(os.path.join(output_dir, f"{noise_type}_metrics.txt"), "w") as f:
        f.write(f"Perceptual metrics for noise type '{noise_type}':\n{_loss_lines(metrics)}")
        if "si_sdr" in metrics:
            f.write(f"SI-SDR (mag-only recon): {metrics['si_sdr']:.3f} dB\n")
        if "si_sdr_noisy_phase" in metrics:
            f.write(f"SI-SDR (noisy input): {metrics['si_sdr_noisy_input']:.3f} dB\n")
            f.write(f"SI-SDR (noisy-phase recon): {metrics['si_sdr_noisy_phase']:.3f} dB\n")
        if "pesq_noisy_phase" in metrics:
            f.write(f"PESQ-approx (noisy input): {metrics['pesq_noisy_input']:.3f}\n")
            f.write(f"PESQ-approx (noisy-phase recon): {metrics['pesq_noisy_phase']:.3f}\n")

    if k > 0:
        den = torch.from_numpy(np.maximum(denoised[:k], 0.0)).to(dev)
        den_audio_gl = griffin_lim(den, theta=theta, **gl).cpu().numpy()
        for i in range(k):
            write_wav(os.path.join(output_dir, f"{noise_type}_denoised_{i}.wav"),
                      den_audio_gl[i], sample_rate)

    for i in range(k):
        _plot_comparison(noisy[i], denoised[i], clean[i],
                         os.path.join(output_dir, f"{noise_type}_spectrogram_{i}.png"))
    return metrics


@torch.inference_mode()
def test_noise_type_waveform(
    model: Optional[nn.Module],
    noise_type: str,
    clean_dir: str,
    noise_dir: str,
    output_dir: str,
    mode: str = "complex_mask",
    sample_rate: int = 8000,
    n_fft: int = 512,
    hop_length: int = 128,
    snr_db: float = 8.0,
    reverb_wet_level: float = 0.35,
    num_audio_examples: int = 5,
    seed: int = 0,
    bypass_db: Optional[float] = 40.0,
    write_artifacts: bool = True,
    runner: Optional[DenoiserRunner] = None,
    device: DeviceLike = None,
) -> Optional[dict]:
    """Waveform-domain evaluation: corrupt the clean wavs on the device
    (draws from a generator seeded with ``seed``), denoise through the
    runner's fused path in ``mode`` (K1, model, K2), and score the combined
    spectral loss, SI-SDR (mean, clamped at 30 dB, median), STOI and PESQ.
    Writes ``{nt}_metrics.txt`` and example wavs unless ``write_artifacts``
    is off (and on any rank but 0 of a meshed runner). ``bypass_db`` (None
    or <= 0 disables) applies :func:`identity_bypass`. ``runner`` is reused
    when given, else one is built for ``model`` on ``device``."""
    from audiodenoiser_torch.data.builders import _corrupt_and_featurize
    from audiodenoiser_torch.data.pipeline import NoiseBank
    from audiodenoiser_torch.data.wav_io import load_wav_list, read_wav, write_wav

    print(f"\n=== Waveform eval ({mode}) on noise type: {noise_type} ===")
    clean_files = load_wav_list(clean_dir)
    if not clean_files:
        print(f"Skipping {noise_type}, no wavs in {clean_dir}")
        return None
    if runner is None:
        runner = DenoiserRunner(model, n_fft, hop_length, device=device)
    dev = runner.device
    clips = [read_wav(f, sample_rate=sample_rate)[0] for f in clean_files]
    min_len = min(len(c) for c in clips)
    clean = torch.from_numpy(np.stack([c[:min_len] for c in clips])).to(dev)
    noise_files = load_wav_list(noise_dir) if os.path.isdir(noise_dir) else []
    gen = torch.Generator(device=dev).manual_seed(seed)
    if noise_files and noise_type == "urban":
        segs = NoiseBank([read_wav(f, sample_rate=sample_rate)[0] for f in noise_files],
                         target_len=min_len, device=dev).sample(gen, clean.shape[0])
    else:
        segs = torch.zeros_like(clean)
    noisy_audio, clean_mag, _ = _corrupt_and_featurize(
        clean, segs, noise_type, n_fft, hop_length, True, sample_rate, snr_db,
        reverb_wet_level, generator=gen)

    if bypass_db is not None and bypass_db <= 0:
        bypass_db = None
    den_audio = runner.denoise_audio(noisy_audio, mode=mode, bypass_db=bypass_db)
    den_mag = stft_lib.stft(den_audio, n_fft, hop_length, center=True, precision="kernel").abs()

    total, s, m, l1 = combined_perceptual_loss(den_mag[:, None], clean_mag[:, None])
    sdr_n_clips = si_sdr(noisy_audio, clean).cpu().numpy()
    sdr_d_clips = si_sdr(den_audio, clean).cpu().numpy()
    sdr_noisy = float(sdr_n_clips.mean())
    sdr_den = float(sdr_d_clips.mean())
    # SI-SDR is unbounded on clips a stochastic corruption left untouched,
    # so the robust aggregates stand beside the mean: a per-clip clamp at
    # 30 dB and the median
    clamp = 30.0
    metrics = {
        "total": float(total), "stft": float(s), "mel": float(m),
        "l1": float(l1), "si_sdr_noisy": sdr_noisy, "si_sdr": sdr_den,
        "si_sdr30_noisy": float(np.minimum(sdr_n_clips, clamp).mean()),
        "si_sdr30": float(np.minimum(sdr_d_clips, clamp).mean()),
        "si_sdr_median_noisy": float(np.median(sdr_n_clips)),
        "si_sdr_median": float(np.median(sdr_d_clips)),
    }
    print(f"Total Loss: {metrics['total']:.6f}")
    print(f"SI-SDR: {sdr_noisy:.3f} dB (noisy) -> {sdr_den:.3f} dB (denoised)")
    print(f"SI-SDR (clamped@30): {metrics['si_sdr30_noisy']:.3f} -> "
          f"{metrics['si_sdr30']:.3f} dB | median: "
          f"{metrics['si_sdr_median_noisy']:.3f} -> {metrics['si_sdr_median']:.3f} dB")
    clean_np, noisy_np, den_np = (a.cpu().numpy() for a in (clean, noisy_audio, den_audio))
    try:  # per-clip degenerate inputs drop out of the mean
        metrics["stoi_noisy"] = batch_metric_mean(stoi, clean_np, noisy_np, sample_rate)
        metrics["stoi"] = batch_metric_mean(stoi, clean_np, den_np, sample_rate)
        print(f"STOI: {metrics['stoi_noisy']:.4f} (noisy) -> {metrics['stoi']:.4f} (denoised)")
    except ValueError as e:  # every clip too short or silent
        print(f"STOI skipped: {e}")
    try:
        metrics["pesq_noisy"] = batch_metric_mean(pesq, clean_np, noisy_np, sample_rate)
        metrics["pesq"] = batch_metric_mean(pesq, clean_np, den_np, sample_rate)
        print(f"PESQ-approx: {metrics['pesq_noisy']:.3f} (noisy) -> "
              f"{metrics['pesq']:.3f} (denoised)")
    except ValueError as e:  # every clip shorter than the 64 ms minimum
        print(f"PESQ skipped: {e}")

    from audiodenoiser_torch.parallel.distributed import is_primary

    if not write_artifacts or (runner.mesh is not None and not is_primary()):
        return metrics  # multi-seed repeats, a follower rank: metrics only
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, f"{noise_type}_metrics.txt"), "w") as f:
        f.write(f"Waveform-domain metrics ({mode}) for noise type '{noise_type}':\n"
                f"{_loss_lines(metrics)}")
        for label, key, fmt in (("SI-SDR", "si_sdr", "{:.3f} dB"),
                                ("SI-SDR clamped@30", "si_sdr30", "{:.3f} dB"),
                                ("SI-SDR median", "si_sdr_median", "{:.3f} dB"),
                                ("STOI", "stoi", "{:.4f}"), ("PESQ-approx", "pesq", "{:.3f}")):
            if key in metrics:  # STOI and PESQ only where some clip was scorable
                f.write(f"{label} noisy: {fmt.format(metrics[key + '_noisy'])}\n"
                        f"{label} denoised: {fmt.format(metrics[key])}\n")
        if "pesq" in metrics:
            f.write(
                "# PESQ-approx is a calibrated approximation of ITU-T "
                "P.862, valid for\n# internal deltas only — NOT comparable "
                "to published P.862 scores.\n"
            )
    k = min(num_audio_examples, clean.shape[0])
    for i in range(k):
        write_wav(os.path.join(output_dir, f"{noise_type}_noisy_{i}.wav"),
                  noisy_np[i], sample_rate)
        write_wav(os.path.join(output_dir, f"{noise_type}_denoised_{i}.wav"),
                  den_np[i], sample_rate)
    return metrics
