"""The process group (port of ``parallel/distributed.py``).

JAX joins every host's chips into one device set through its coordination
service; the port's counterpart is a ``torch.distributed`` process group
with one rank per card. ``maybe_initialize`` joins the group that a
launcher describes in the environment (``torchrun``'s ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and is a
no-op without one, so every entry point calls it first.

The backend follows the device the caller asked for: NCCL for the card,
with rank r on ``cuda:LOCAL_RANK``; gloo for the CPU. Nothing moves to the
CPU when no card is found (``device.resolve_device`` raises instead).

``ensure_process_group`` gives a mesh its group: the launcher's, or, with
no launcher (``--mesh on`` in one process), a world-size-1 group over a
localhost port, so that the mesh's collectives run there too.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from audiodenoiser_torch.device import DeviceLike, resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_device_type: Optional[str] = None  # the device type the group was made for


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init(device: torch.device, backend: Optional[str],
          timeout: Optional[datetime.timedelta], **kwargs) -> None:
    global _device_type
    if device.type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device if device.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    if timeout is not None:
        kwargs["timeout"] = timeout
    dist.init_process_group(backend or BACKENDS[device.type], **kwargs)
    _device_type = device.type


def maybe_initialize(device: DeviceLike = None, backend: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> bool:
    """Join the launcher's process group when its environment is set.

    Returns True when a group exists (made now or earlier), False for the
    single-process no-op. ``device`` picks the backend (None: the card);
    ``backend`` overrides it (gloo carries CUDA tensors too, where two
    ranks share one card); ``timeout`` bounds each collective (a serving
    follower waits for the next request as long as it takes)."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in LAUNCHER_ENV):
        return False
    _init(resolve_device(device), backend, timeout, init_method="env://")
    return True


def ensure_process_group(device: DeviceLike = None) -> str:
    """The group a mesh runs over: the existing one, the launcher's, or a
    world-size-1 group of this process alone. Returns its device type,
    which must be ``device``'s."""
    dev = resolve_device(device)
    if not maybe_initialize(dev):
        _init(dev, None, None, init_method=f"tcp://127.0.0.1:{_free_port()}",
              world_size=1, rank=0)
    kind = device_type()
    if kind != dev.type:
        raise ValueError(f"the process group runs on {kind}; a mesh on {dev.type} "
                         "needs a group of its own backend")
    return kind


def device_type() -> str:
    """The device type of this process's group (``cuda`` for NCCL)."""
    if _device_type is not None:
        return _device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for a card under a launcher."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return dev


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and sidecars."""
    return rank() == 0
