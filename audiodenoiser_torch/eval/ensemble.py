"""Self-routing mixture of denoisers (port of ``eval/ensemble.py``,
host-bucketed dispatch).

A ``NoiseClassifier`` predicts each clip's corruption and the clip goes
through that specialist: the rows are grouped by predicted expert, each
group is zero-padded to the next power of two, forwarded once through its
expert and scattered back. Every clip is forwarded exactly once.
Waveforms go through each expert's ``DenoiserRunner``: K1, the model and
K2 on the card (noisy-phase reconstruction for the magnitude family, the
complex mask for the mask family); the router reads the noisy magnitudes
of the same K1 STFT, scored in training-shaped windows
(``windowed_logits``).

Experts may differ in configuration (mask sidecars with other
``mask_bound``/``residual``): each runs through its own module.

Expert parallelism (magnitude family), over the process group's ranks,
each forwarding through one specialist (rank r through expert r mod 4):

- ``denoise_ep`` on a ``('data', 'expert')`` mesh (``make_ep_mesh``):
  every rank forwards its data block through its expert, keeps the rows
  routed to it (a mask by label) and the expert ranks sum (the
  counterpart of JAX's one-hot ``psum``). Dense: each clip is computed by
  every expert.
- ``denoise_ep_a2a`` on a 1-D ``('expert',)`` mesh (``make_a2a_mesh``):
  each rank buckets its still-pending clips by expert, at most
  ``capacity = ceil(b_loc * capacity_factor / E)`` a bucket, one
  ``all_to_all_single`` ships every bucket to its expert's rank, the
  expert forwards the ``E * capacity`` rows it received and a second one
  ships them home. Clips past a bucket's capacity stay pending for another
  pass of the same exchange; their data never leaves the device.

Every rank passes the whole batch and gets the whole answer; a rank
outside the mesh receives it from rank 0.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

import audiodenoiser_torch.dsp.stft as stft_lib
from audiodenoiser_torch.device import DeviceLike, resolve_device
from audiodenoiser_torch.eval.runner import DenoiserRunner, identity_bypass
from audiodenoiser_torch.models.router import NOISE_CLASSES, NoiseClassifier

ROUTER_WINDOW = (256, 64)  # OnDeviceMixer's default training crop
DATA_AXIS = "data"
EXPERT_AXIS = "expert"
_MESHES: dict = {}


def _mesh_over(shape: tuple, names: tuple, device: DeviceLike):
    """A ``DeviceMesh`` of ``shape`` over the process group's first ranks."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from audiodenoiser_torch.parallel import distributed

    kind = distributed.ensure_process_group(device)
    key = (kind, shape, names)
    if key not in _MESHES:
        n = int(np.prod(shape))
        _MESHES[key] = (init_device_mesh(kind, shape, mesh_dim_names=names)
                        if n == dist.get_world_size()
                        else DeviceMesh(kind, torch.arange(n).reshape(shape),
                                        mesh_dim_names=names))
    return _MESHES[key]


def make_ep_mesh(n_devices: Optional[int] = None, n_experts: int = len(NOISE_CLASSES),
                 device: DeviceLike = None):
    """A ``('data', 'expert')`` mesh over the first ``n_devices`` ranks
    (default all), the trailing axis the expert count: consecutive ranks
    hold different experts, each expert row shards the batch. ``device``
    picks the group's backend (None: the card)."""
    from audiodenoiser_torch.parallel import distributed

    distributed.ensure_process_group(device)
    n = dist.get_world_size() if n_devices is None else n_devices
    if n % n_experts != 0:
        raise ValueError(f"{n} devices not divisible by {n_experts} experts")
    return _mesh_over((n // n_experts, n_experts), (DATA_AXIS, EXPERT_AXIS), device)


def make_a2a_mesh(n_experts: int = len(NOISE_CLASSES), device: DeviceLike = None):
    """A 1-D ``('expert',)`` mesh over the first ``n_experts`` ranks, for
    the all-to-all dispatch."""
    from audiodenoiser_torch.parallel import distributed

    distributed.ensure_process_group(device)
    have = dist.get_world_size()
    if have < n_experts:
        raise ValueError(f"need {n_experts} devices, have {have}")
    return _mesh_over((n_experts,), (EXPERT_AXIS,), device)


def _share(out: Optional[torch.Tensor], mesh, shape: tuple, device) -> torch.Tensor:
    """The answer on every rank of the group: ranks outside ``mesh``
    receive rank 0's."""
    if mesh.mesh.numel() == dist.get_world_size():
        return out
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=device)
    dist.broadcast(out, src=0)
    return out


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended up to ``rows``."""
    if rows == x.shape[0]:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])


def _gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _labels(labels) -> np.ndarray:
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    return np.asarray(labels)


def windowed_logits(router: nn.Module, specs: torch.Tensor,
                    window: Sequence[int] = ROUTER_WINDOW) -> torch.Tensor:
    """Router logits in the training distribution's shape: (B, C, F, T)
    magnitudes are cropped (or zero-padded) to the window's height, cut
    into ``T // width`` consecutive windows (one zero-padded window when
    the clip is shorter), and each clip's window logits are averaged."""
    b, c, f, t = specs.shape
    fw, tw = window
    x = specs[:, :, : min(f, fw)]
    if x.shape[2] < fw:
        x = torch.nn.functional.pad(x, (0, 0, 0, fw - x.shape[2]))
    n_win = max(1, t // tw)
    x = x[..., : n_win * tw]
    if x.shape[3] < tw:
        x = torch.nn.functional.pad(x, (0, tw - x.shape[3]))
    wins = x.reshape(b, c, fw, n_win, tw).permute(0, 3, 1, 2, 4).reshape(b * n_win, c, fw, tw)
    return router(wins).reshape(b, n_win, -1).mean(dim=1)


class MixtureOfDenoisers:
    """Router-dispatched specialist ensemble.

    Args:
      experts: ``noise_type -> model`` for every name in ``NOISE_CLASSES``
        (folded or live-BN, each of its own configuration).
      router: the trained ``NoiseClassifier``.
      family: ``"magnitude"`` or ``"mask"``.
      router_window: the router's training crop (its ``.json`` sidecar).
      precision: the STFT/iSTFT path (``"kernel"``: K1 and K2 on the card).
      mesh: lays each expert out on this device mesh (``DenoiserRunner``'s
        ``mesh``); the router stays whole on every rank.
    """

    def __init__(self, experts: Mapping[str, nn.Module], router: NoiseClassifier,
                 family: str = "magnitude", n_fft: int = 512, hop_length: int = 128,
                 router_window: Sequence[int] = ROUTER_WINDOW, device: DeviceLike = None,
                 precision: str = "kernel", mesh=None):
        missing = [nt for nt in NOISE_CLASSES if nt not in experts]
        if missing:
            raise ValueError(f"missing experts for {missing}")
        if family not in ("magnitude", "mask"):
            raise ValueError(f"unknown family {family!r}")
        self.family = family
        self.n_fft = n_fft
        self.hop = hop_length
        self.precision = precision
        self.device = resolve_device(device)
        self.router = router.to(self.device).eval()
        self.router_window = tuple(router_window)
        self.expert_models = [experts[nt].to(self.device).eval() for nt in NOISE_CLASSES]
        # one fused waveform path per expert, each through its own module
        self.runners = [DenoiserRunner(m, n_fft, hop_length, device=self.device,
                                       precision=precision, mesh=mesh)
                        for m in self.expert_models]

    @torch.inference_mode()
    def logits(self, specs: torch.Tensor, windowed: bool = True) -> torch.Tensor:
        """(B, 1, F, T) magnitudes -> (B, 4) float32 router logits."""
        specs = torch.as_tensor(specs, dtype=torch.float32).to(self.device)
        if windowed:
            return windowed_logits(self.router, specs, self.router_window)
        return self.router(specs)

    def classify(self, specs: torch.Tensor, windowed: bool = True) -> torch.Tensor:
        """(B, 1, F, T) magnitudes -> (B,) predicted corruption indices;
        ``windowed=False`` scores the whole spectrogram at once."""
        return self.logits(specs, windowed).argmax(-1)

    @torch.inference_mode()
    def classify_waveform(self, wavs: torch.Tensor) -> torch.Tensor:
        """(B, samples) waveforms -> (B,) predicted corruption indices: the
        centred STFT's magnitude (K1 on the card), then the windowed vote."""
        wavs = torch.as_tensor(wavs, dtype=torch.float32).to(self.device)
        mag = stft_lib.stft(wavs, self.n_fft, self.hop, center=True,
                            precision=self.precision).abs()
        return self.classify(mag[:, None])

    @torch.inference_mode()
    def _bucketed_dispatch(self, labels, xs: torch.Tensor, fwds) -> torch.Tensor:
        """Group rows by routed expert, pad each group with zero rows to the
        next power of two, forward it once through its expert's ``fwds``
        entry and scatter the real rows back."""
        labels = _labels(labels)
        out = torch.empty_like(xs)
        for e in range(len(NOISE_CLASSES)):
            idx = np.nonzero(labels == e)[0]
            if idx.size == 0:
                continue
            sub = xs[torch.from_numpy(idx).to(xs.device)]
            pad = _next_pow2(idx.size) - idx.size
            if pad:
                sub = torch.cat([sub, sub.new_zeros((pad, *sub.shape[1:]))])
            out[torch.from_numpy(idx).to(xs.device)] = fwds[e](sub)[: idx.size].to(out.dtype)
        return out

    def denoise(self, specs: torch.Tensor, labels=None) -> torch.Tensor:
        """Routed denoise of (B, 1, F, T) magnitude spectrograms, each clip
        through its predicted specialist (``labels``, when given, skip the
        router). Magnitude family only."""
        if self.family != "magnitude":
            raise ValueError("spectrogram-level dispatch is magnitude-family only; "
                             "use denoise_waveform for the mask family")
        specs = torch.as_tensor(specs, dtype=torch.float32).to(self.device)
        if labels is None:
            labels = self.classify(specs)
        fwds = [lambda x, m=m: m(x).float() for m in self.expert_models]
        return self._bucketed_dispatch(labels, specs, fwds)

    def denoise_waveform(self, wavs: torch.Tensor, labels=None,
                         bypass_db: Optional[float] = None) -> torch.Tensor:
        """Routed waveform-in/waveform-out denoising for either family:
        each group through its expert runner's fused path. ``bypass_db``
        applies ``identity_bypass`` to the routed output."""
        wavs = torch.as_tensor(wavs, dtype=torch.float32).to(self.device)
        squeeze = wavs.dim() == 1
        if squeeze:
            wavs = wavs[None]
        if labels is None:
            labels = self.classify_waveform(wavs)
        fwds = [r.denoise_audio for r in self.runners]
        out = self._bucketed_dispatch(labels, wavs, fwds)
        if bypass_db is not None:
            out = identity_bypass(out, wavs, bypass_db)
        return out[0] if squeeze else out

    def _ep_batch(self, specs, labels, rows: int):
        """The batch and its labels on the device, zero rows (label 0)
        appended up to ``rows``; the router runs on the padded batch when no
        labels are given, as JAX's."""
        specs = _padded(torch.as_tensor(specs, dtype=torch.float32).to(self.device), rows)
        if labels is None:
            return specs, self.classify(specs)
        labels = torch.as_tensor(_labels(labels), dtype=torch.int64).to(self.device)
        return specs, _padded(labels, rows)

    def _check_ep(self, n_experts: int, who: str) -> None:
        if self.family != "magnitude":
            raise ValueError(f"{who} is magnitude-family only")
        if n_experts != len(NOISE_CLASSES):
            raise ValueError(f"mesh 'expert' axis is {n_experts}, need {len(NOISE_CLASSES)}")

    @torch.inference_mode()
    def denoise_ep(self, specs: torch.Tensor, mesh, labels=None) -> torch.Tensor:
        """Expert-parallel dense dispatch over a ``('data', 'expert')`` mesh:
        (B, 1, F, T) magnitudes -> the routed denoise, on every rank."""
        self._check_ep(mesh.size(1), "denoise_ep")
        dp = mesh.size(0)
        b = specs.shape[0]
        b_pad = -(-b // dp) * dp
        out = None
        if mesh.get_coordinate() is not None:
            specs_p, labels_p = self._ep_batch(specs, labels, b_pad)
            d, e = mesh.get_coordinate()
            rows = slice(d * (b_pad // dp), (d + 1) * (b_pad // dp))
            y = self.expert_models[e](specs_p[rows]).float()
            y = y * (labels_p[rows] == e).to(y.dtype)[:, None, None, None]
            dist.all_reduce(y, group=mesh.get_group(EXPERT_AXIS))
            out = _gather_rows(y, mesh.get_group(DATA_AXIS), dp)[:b]
        return _share(out, mesh, tuple(specs.shape), self.device)

    def _a2a_pass(self, x, lab, pending, mesh, capacity: int):
        """One capacity-bucketed all-to-all exchange: this rank's pending
        clips to their experts' ranks and back. Returns the answers of the
        clips that got a slot (0 elsewhere) and which those were."""
        n_experts = mesh.size()
        onehot = ((lab[:, None] == torch.arange(n_experts, device=lab.device)[None])
                  & pending[:, None]).to(torch.int64)
        # the position of each clip in its label's bucket (pending clips only)
        rank = onehot.cumsum(0).gather(1, lab[:, None])[:, 0] - 1
        valid = pending & (rank < capacity)
        # a clip without a slot lands in a scratch slot past the buckets
        slot = torch.where(valid, rank.clamp_min(0), torch.full_like(rank, capacity))
        send = x.new_zeros((n_experts, capacity + 1, *x.shape[1:]))
        send[lab, slot] = x
        send = send[:, :capacity].contiguous()
        recv = torch.empty_like(send)
        group = mesh.get_group()
        dist.all_to_all_single(recv, send, group=group)  # recv[j]: rank j's bucket for me
        expert = self.expert_models[mesh.get_local_rank()]
        y = expert(recv.reshape(n_experts * capacity, *x.shape[1:])).float()
        y = y.reshape(n_experts, capacity, *y.shape[1:]).contiguous()
        back = torch.empty_like(y)
        dist.all_to_all_single(back, y, group=group)
        out = back[lab, rank.clamp(0, capacity - 1)]
        return torch.where(valid[:, None, None, None], out, torch.zeros_like(out)), valid

    @torch.inference_mode()
    def denoise_ep_a2a(self, specs: torch.Tensor, mesh, capacity_factor: float = 1.5,
                       labels=None, stats: Optional[dict] = None) -> torch.Tensor:
        """Capacity-based all-to-all expert dispatch over a 1-D
        ``('expert',)`` mesh: each clip forwarded by one expert rank; every
        pass forwards ``n_experts * capacity`` rows a rank, and clips past
        a bucket's capacity wait for the next pass. ``stats`` receives
        ``n_passes`` and ``capacity``."""
        n_experts = mesh.size()
        self._check_ep(n_experts, "denoise_ep_a2a")
        b = specs.shape[0]
        b_pad = -(-b // n_experts) * n_experts
        b_loc = b_pad // n_experts
        # ceil(b_loc * factor / E), as JAX's: no float-to-int undersizing
        capacity = max(1, int(np.ceil(b_loc * capacity_factor / n_experts)))
        out = None
        if mesh.get_coordinate() is not None:
            specs_p, labels_p = self._ep_batch(specs, labels, b_pad)
            rows = slice(mesh.get_local_rank() * b_loc, (mesh.get_local_rank() + 1) * b_loc)
            x, lab = specs_p[rows], labels_p[rows]
            # padded rows start done, so they never take a slot
            pending = (torch.arange(b_pad, device=x.device) < b)[rows]
            total = torch.zeros_like(x)
            n_passes = 0
            # the worst case routes every local clip to one expert
            max_passes = int(np.ceil(b_loc / capacity)) + 1
            left = torch.tensor([int(pending.any())], device=x.device)
            dist.all_reduce(left, op=dist.ReduceOp.MAX, group=mesh.get_group())
            while bool(left) and n_passes < max_passes:
                y, valid = self._a2a_pass(x, lab, pending, mesh, capacity)
                total += y
                pending &= ~valid
                n_passes += 1
                left = torch.tensor([int(pending.any())], device=x.device)
                dist.all_reduce(left, op=dist.ReduceOp.MAX, group=mesh.get_group())
            if stats is not None:
                stats["n_passes"] = n_passes
                stats["capacity"] = capacity
            if bool(left):  # pragma: no cover - defensive
                raise RuntimeError("a2a dispatch failed to converge")
            out = _gather_rows(total, mesh.get_group(), n_experts)[:b]
        return _share(out, mesh, tuple(specs.shape), self.device)


def load_router(path: str, dtype: torch.dtype = torch.bfloat16) -> tuple[NoiseClassifier, tuple]:
    """A ``noise_router.ckpt`` export (Flax layout, read with the port's
    msgpack codec) as a ``NoiseClassifier`` computing in ``dtype``, and the
    training window its ``.json`` sidecar records ((256, 64) without one)."""
    from audiodenoiser_torch.models.convert import router_state_dict_from_flax
    from audiodenoiser_torch.train.checkpoints import load_exported

    if not os.path.exists(path):
        raise FileNotFoundError(f"router checkpoint not found: {path} "
                                "(train it with cli.train --model router)")
    router = NoiseClassifier(dtype=dtype)
    router.load_state_dict(router_state_dict_from_flax(load_exported(path)["params"]),
                           strict=True)
    window = ROUTER_WINDOW
    sidecar = os.path.splitext(path)[0] + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            window = tuple(json.load(f).get("window", window))
    return router, window


def load_mixture(saved_models_dir: str = "./saved_models",
                 dtype: torch.dtype = torch.bfloat16,
                 router_name: str = "noise_router.ckpt", stem: str = "unet_denoiser",
                 n_fft: int = 512, hop_length: int = 128, fold: bool = True,
                 device: DeviceLike = None, precision: str = "kernel",
                 router_dtype: torch.dtype = torch.bfloat16, mesh=None) -> MixtureOfDenoisers:
    """A ``MixtureOfDenoisers`` from a saved_models directory: the four
    specialists ``{stem}_{nt}.ckpt`` (``load_model_for_noise``, folded
    unless ``fold=False``; ``stem='mask_denoiser'`` routes the mask family)
    and the router ``noise_router.ckpt`` with its sidecar's window. The
    router computes in bf16, as the JAX package's, unless
    ``router_dtype`` says otherwise; ``mesh`` lays the experts out on a
    device mesh."""
    from audiodenoiser_torch.eval.runner import load_model_for_noise

    device = resolve_device(device)
    router, window = load_router(os.path.join(saved_models_dir, router_name), router_dtype)
    experts = {nt: load_model_for_noise(nt, saved_models_dir, dtype=dtype, device=device,
                                        stem=stem, fold=fold)
               for nt in NOISE_CLASSES}
    family = "mask" if stem == "mask_denoiser" else "magnitude"
    return MixtureOfDenoisers(experts, router, family=family, n_fft=n_fft,
                              hop_length=hop_length, router_window=window, device=device,
                              precision=precision, mesh=mesh)


def _write_metrics(path: str, header: str, lines: list) -> None:
    """Write a metrics file (rank 0 alone under a launcher)."""
    from audiodenoiser_torch.parallel.distributed import is_primary

    with open(path if is_primary() else os.devnull, "w") as f:
        f.write(header + "\n")
        for line in lines:
            f.write(line + "\n")


@torch.inference_mode()
def evaluate_routed_waveform(mixture: MixtureOfDenoisers, clean_dir: str, noise_dir: str,
                             output_dir: str, noise_types=NOISE_CLASSES,
                             sample_rate: int = 8000, snr_db: float = 8.0,
                             reverb_wet_level: float = 0.35, seed: int = 0,
                             bypass_db: Optional[float] = 40.0) -> dict:
    """Auto-routed waveform-domain evaluation (either family): the test
    wavs corrupted on the device per noise type (draws from one generator
    seeded with ``seed``), routed on the corruption's noisy magnitudes,
    denoised through the routed specialists and scored by SI-SDR (mean,
    clamped at 30 dB, median), STOI and PESQ. Writes
    ``{nt}_routed_metrics.txt``. ``bypass_db`` (None or <= 0 disables)
    applies ``identity_bypass``."""
    from audiodenoiser_torch.data.builders import _corrupt_and_featurize
    from audiodenoiser_torch.data.pipeline import NoiseBank
    from audiodenoiser_torch.data.wav_io import load_wav_list, read_wav
    from audiodenoiser_torch.eval.metrics import pesq, si_sdr, stoi
    from audiodenoiser_torch.eval.runner import batch_metric_mean

    clean_files = load_wav_list(clean_dir)
    if not clean_files:
        print(f"No wavs in {clean_dir}; nothing to do")
        return {}
    dev = mixture.device
    clips = [read_wav(f, sample_rate=sample_rate)[0] for f in clean_files]
    min_len = min(len(c) for c in clips)
    clean = torch.from_numpy(np.stack([c[:min_len] for c in clips])).to(dev)
    noise_files = load_wav_list(noise_dir) if os.path.isdir(noise_dir) else []
    bank = NoiseBank([read_wav(f, sample_rate=sample_rate)[0] for f in noise_files],
                     target_len=min_len, device=dev) if noise_files else None
    if bypass_db is not None and bypass_db <= 0:
        bypass_db = None
    os.makedirs(output_dir, exist_ok=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {}
    for nt in noise_types:
        segs = (bank.sample(gen, clean.shape[0]) if bank is not None and nt == "urban"
                else torch.zeros_like(clean))
        noisy, _, noisy_mag = _corrupt_and_featurize(
            clean, segs, nt, mixture.n_fft, mixture.hop, True, sample_rate, snr_db,
            reverb_wet_level, generator=gen)
        # the corruption's own STFT feeds the router: no second STFT
        pred = mixture.classify(noisy_mag[:, None]).cpu().numpy()
        acc = float(np.mean(pred == NOISE_CLASSES.index(nt)))
        den = mixture.denoise_waveform(noisy, labels=pred, bypass_db=bypass_db)
        sn = si_sdr(noisy, clean).cpu().numpy()
        sd = si_sdr(den, clean).cpu().numpy()
        metrics = {
            "routing_accuracy": acc,
            "si_sdr_noisy": float(sn.mean()), "si_sdr": float(sd.mean()),
            "si_sdr30_noisy": float(np.minimum(sn, 30.0).mean()),
            "si_sdr30": float(np.minimum(sd, 30.0).mean()),
            "si_sdr_median_noisy": float(np.median(sn)),
            "si_sdr_median": float(np.median(sd)),
        }
        clean_np, noisy_np, den_np = (a.cpu().numpy() for a in (clean, noisy, den))
        for name, fn in (("stoi", stoi), ("pesq", pesq)):
            try:  # per-clip degenerate inputs drop out of the mean
                metrics[f"{name}_noisy"] = batch_metric_mean(fn, clean_np, noisy_np,
                                                             sample_rate)
                metrics[name] = batch_metric_mean(fn, clean_np, den_np, sample_rate)
            except ValueError:
                pass
        print(f"\n=== Auto-routed waveform eval on noise type: {nt} ===")
        print(f"Routing accuracy: {acc:.3f}")
        print(f"SI-SDR: {metrics['si_sdr_noisy']:.3f} dB (noisy) -> {metrics['si_sdr']:.3f} dB")
        print(f"SI-SDR (clamped@30): {metrics['si_sdr30_noisy']:.3f} -> "
              f"{metrics['si_sdr30']:.3f} dB | median: {metrics['si_sdr_median_noisy']:.3f} "
              f"-> {metrics['si_sdr_median']:.3f} dB")
        if "stoi" in metrics:
            print(f"STOI: {metrics['stoi_noisy']:.4f} -> {metrics['stoi']:.4f}")
        if "pesq" in metrics:
            print(f"PESQ-approx: {metrics['pesq_noisy']:.3f} -> {metrics['pesq']:.3f}")
        lines = [f"Routing Accuracy: {acc:.6f}",
                 f"SI-SDR noisy: {metrics['si_sdr_noisy']:.3f} dB",
                 f"SI-SDR denoised: {metrics['si_sdr']:.3f} dB",
                 f"SI-SDR clamped@30 noisy: {metrics['si_sdr30_noisy']:.3f} dB",
                 f"SI-SDR clamped@30 denoised: {metrics['si_sdr30']:.3f} dB",
                 f"SI-SDR median noisy: {metrics['si_sdr_median_noisy']:.3f} dB",
                 f"SI-SDR median denoised: {metrics['si_sdr_median']:.3f} dB"]
        if "stoi" in metrics:
            lines += [f"STOI noisy: {metrics['stoi_noisy']:.4f}",
                      f"STOI denoised: {metrics['stoi']:.4f}"]
        if "pesq" in metrics:
            lines += [f"PESQ-approx noisy: {metrics['pesq_noisy']:.3f}",
                      f"PESQ-approx denoised: {metrics['pesq']:.3f}",
                      "# PESQ-approx is a calibrated approximation of ITU-T P.862, valid for",
                      "# internal deltas only — NOT comparable to published P.862 scores."]
        _write_metrics(os.path.join(output_dir, f"{nt}_routed_metrics.txt"),
                       f"Auto-routed waveform metrics ({mixture.family}) for noise type: {nt}",
                       lines)
        results[nt] = metrics
    return results


@torch.inference_mode()
def evaluate_routed(mixture: MixtureOfDenoisers, test_data_dir: str, output_dir: str,
                    noise_types=NOISE_CLASSES, ep_mesh=None) -> dict:
    """Auto-routed evaluation over the test set's ``noisy_{nt}.npy`` /
    ``clean_{nt}.npy`` magnitudes: the router predicts each clip's
    corruption (the noise type is the true label, so the routing accuracy
    comes for free), the predicted specialists denoise, and the combined
    perceptual loss goes to ``{nt}_routed_metrics.txt``. ``ep_mesh``
    chooses the dispatch: a ``('data', 'expert')`` mesh the dense
    ``denoise_ep``, an ``('expert',)`` mesh ``denoise_ep_a2a``, None the
    host-bucketed ``denoise``."""
    from audiodenoiser_torch.losses.spectral import combined_perceptual_loss

    os.makedirs(output_dir, exist_ok=True)
    results = {}
    for nt in noise_types:
        clean_path = os.path.join(test_data_dir, f"clean_{nt}.npy")
        noisy_path = os.path.join(test_data_dir, f"noisy_{nt}.npy")
        if not (os.path.exists(clean_path) and os.path.exists(noisy_path)):
            print(f"Skipping {nt}, missing {clean_path} or {noisy_path}")
            continue
        specs = torch.from_numpy(np.load(noisy_path)).to(mixture.device)[:, None]
        clean = torch.from_numpy(np.load(clean_path)).to(mixture.device)[:, None]
        # one router pass: the accuracy describes the routing the denoise used
        pred = mixture.classify(specs).cpu().numpy()
        acc = float(np.mean(pred == NOISE_CLASSES.index(nt)))
        if ep_mesh is not None and DATA_AXIS in ep_mesh.mesh_dim_names:
            denoised = mixture.denoise_ep(specs, ep_mesh, labels=pred)
        elif ep_mesh is not None:  # each clip forwarded once, by its expert's rank
            denoised = mixture.denoise_ep_a2a(specs, ep_mesh, labels=pred)
        else:
            denoised = mixture.denoise(specs, labels=pred)
        total, s, m, l1 = combined_perceptual_loss(denoised, clean)
        metrics = {"total": float(total), "stft": float(s), "mel": float(m),
                   "l1": float(l1), "routing_accuracy": acc}
        print(f"\n=== Auto-routed eval on noise type: {nt} ===")
        print(f"Routing accuracy: {acc:.3f} (predicted: {[NOISE_CLASSES[i] for i in pred]})")
        print(f"Total Loss: {metrics['total']:.6f}")
        _write_metrics(os.path.join(output_dir, f"{nt}_routed_metrics.txt"),
                       f"Auto-routed metrics for noise type: {nt}",
                       [f"Routing Accuracy: {acc:.6f}",
                        f"Total Loss: {metrics['total']:.6f}",
                        f"STFT Loss: {metrics['stft']:.6f}",
                        f"Mel Loss: {metrics['mel']:.6f}",
                        f"L1 Loss: {metrics['l1']:.6f}"])
        results[nt] = metrics
    return results
