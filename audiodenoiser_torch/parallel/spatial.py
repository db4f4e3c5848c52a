"""Sequence parallelism for long clips: the spectrogram's time axis
sharded over the ranks with a halo exchange (port of
``parallel/spatial.py``).

The clip's ``(freq, T)`` magnitudes are cut into contiguous time shards,
one a rank of a 1-D ``('seq',)`` ``DeviceMesh`` (``make_seq_mesh``). Each
rank

1. sends its first and last ``halo`` frames to its left and right
   neighbours and receives theirs (point-to-point, the counterpart of
   JAX's ``lax.ppermute``); the ranks at the clip's edges receive zeros,
   which is the zero padding the clip's edge sees;
2. forwards its ``shard + 2 * halo`` window through the whole model;
3. crops the valid centre, and the ranks all-gather the shards.

With ``halo >= RECEPTIVE_RADIUS`` (the 4-level U-Net's one-sided time
receptive field, 92 frames) and 16-frame alignment (so the four max-pool
grids fall alike on every shard) the result equals the unsharded forward
of the clip zero-padded by the halo, cropped (``reference_padded_forward``).
Each rank holds ``T / n`` frames of activations.

The layout is the port's NCHW: a batch is ``(B, C, F, T)`` where JAX's is
``(B, F, T, C)``, and a single clip ``(F, T)`` in both. Every rank passes
the whole input and gets the whole output. ``denoise_waveform_sharded``
runs the STFT and the noisy-phase iSTFT unsharded on every rank (K1 and
K2 on the card, ``precision="kernel"``); only the U-Net is sharded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from audiodenoiser_torch.device import DeviceLike
from audiodenoiser_torch.dsp import stft as stft_lib
from audiodenoiser_torch.parallel import distributed

SEQ_AXIS = "seq"

# One-sided time receptive field of the 4-level U-Net, in input frames:
# encoder DoubleConvs contribute 2@1 + 2@2 + 2@4 + 2@8 = 30, the bottleneck
# 2@16 = 32, decoder DoubleConvs 2@8 + 2@4 + 2@2 + 2@1 = 30; total 92.
RECEPTIVE_RADIUS = 92

# Four stride-2 max-pools: shard and halo sizes must be multiples of 16 so
# every rank's pooling grid coincides with the global one.
ALIGN = 16

_MESHES: dict = {}


def make_seq_mesh(n_devices: Optional[int] = None, device: DeviceLike = None):
    """A 1-D ``('seq',)`` ``DeviceMesh`` over the first ``n_devices`` ranks
    of the process group (default all; a world-size-1 group of this
    process without a launcher). ``device`` picks the backend (None: the
    card). Every rank calls it; a rank past ``n_devices`` is not on the
    mesh (``mesh.get_coordinate()`` is None)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    kind = distributed.ensure_process_group(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError(f"asked for a mesh of {n} devices; the process group has {world}")
    key = (kind, n)
    if key not in _MESHES:
        _MESHES[key] = (init_device_mesh(kind, (n,), mesh_dim_names=(SEQ_AXIS,)) if n == world
                        else DeviceMesh(kind, torch.arange(n), mesh_dim_names=(SEQ_AXIS,)))
    return _MESHES[key]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _as_batch(spec: torch.Tensor):
    squeeze = spec.dim() == 2
    if squeeze:
        spec = spec[None, None]
    if spec.dim() != 4:
        raise ValueError(f"expected (F,T) or (B,C,F,T), got {tuple(spec.shape)}")
    return spec, squeeze


def _halos(x: torch.Tensor, halo: int, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's left and right halos: the neighbours' edge frames, zeros
    past the clip's ends."""
    group = mesh.get_group()
    ranks = mesh.mesh.flatten().tolist()
    r, n = mesh.get_local_rank(), len(ranks)
    left = x.new_zeros((*x.shape[:-1], halo))
    right = x.new_zeros((*x.shape[:-1], halo))
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.isend, x[..., :halo].contiguous(), ranks[r - 1], group),
                dist.P2POp(dist.irecv, left, ranks[r - 1], group)]
    if r < n - 1:
        ops += [dist.P2POp(dist.isend, x[..., -halo:].contiguous(), ranks[r + 1], group),
                dist.P2POp(dist.irecv, right, ranks[r + 1], group)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return left, right


@torch.inference_mode()
def denoise_spec_sharded(model: nn.Module, spec: torch.Tensor, mesh,
                         halo: int = 96) -> torch.Tensor:
    """Denoise magnitudes with the time axis sharded over ``mesh``'s
    ``seq`` ranks.

    Args:
      model: a ``UNet``-like module (eval mode), on this rank's device.
      spec: ``(B, C, F, T)`` or ``(F, T)`` magnitudes, the same on every rank.
      mesh: a 1-D ``('seq',)`` mesh from ``make_seq_mesh``.
      halo: frames exchanged a side, rounded up to 16; at least
        ``RECEPTIVE_RADIUS`` gives the exact overlap-tile result.

    Returns the denoised array with the input's shape and dtype, on every
    rank of the mesh.
    """
    model.eval()
    spec, squeeze = _as_batch(spec)
    n_seq = mesh.size()
    halo = _round_up(max(halo, 1), ALIGN)
    t = spec.shape[-1]
    # equal 16-aligned shards of at least ``halo`` frames, so the exchange
    # is one hop to the adjacent rank; a short clip gets more zero padding
    shard = max(_round_up(-(-t // n_seq), ALIGN), halo)
    r = mesh.get_local_rank()
    x = F.pad(spec, (0, shard * n_seq - t))[..., r * shard:(r + 1) * shard].contiguous()
    left, right = _halos(x, halo, mesh)
    out = model(torch.cat([left, x, right], dim=-1))[..., halo:halo + shard].contiguous()
    parts = [torch.empty_like(out) for _ in range(n_seq)]
    dist.all_gather(parts, out, group=mesh.get_group())
    out = torch.cat(parts, dim=-1)[..., :t]
    return out[0, 0] if squeeze else out


@torch.inference_mode()
def denoise_waveform_sharded(model: nn.Module, wav: torch.Tensor, mesh, n_fft: int = 512,
                             hop_length: int = 128, halo: int = 96,
                             precision: str = "kernel") -> torch.Tensor:
    """Waveform-in/waveform-out denoising of one long ``(samples,)`` clip,
    the U-Net time-sharded over the mesh (noisy-phase reconstruction). The
    STFT and iSTFT run unsharded on every rank: at hop 128 they are about
    1e-4 of the U-Net's operations, so only the forward pays the exchange
    (``2 * halo`` frames a neighbour pair)."""
    if wav.dim() != 1:
        raise ValueError(f"expected a single (samples,) clip, got {tuple(wav.shape)}")
    spec = stft_lib.stft(wav, n_fft, hop_length, center=True, precision=precision)
    mag, phase = stft_lib.magphase(spec)
    denoised = denoise_spec_sharded(model, mag, mesh, halo=halo)
    rec = denoised.float().clamp_min(0.0) * phase
    return stft_lib.istft(rec, hop_length, n_fft=n_fft, center=True, length=wav.shape[-1],
                          precision=precision)


@torch.inference_mode()
def reference_padded_forward(model: nn.Module, spec: torch.Tensor,
                             halo: int = 96) -> torch.Tensor:
    """The unsharded oracle of ``denoise_spec_sharded``: the clip
    zero-padded by ``halo`` frames a side (and up to a multiple of 16)
    through the model, cropped. The sharded result is this computation,
    partitioned."""
    model.eval()
    spec, squeeze = _as_batch(spec)
    halo = _round_up(max(halo, 1), ALIGN)
    t = spec.shape[-1]
    x = F.pad(spec, (halo, _round_up(t, ALIGN) - t + halo))
    out = model(x)[..., halo:halo + t]
    return out[0, 0] if squeeze else out
