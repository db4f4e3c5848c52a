"""Keeping the ranks of a meshed service in step.

A meshed runner's call is a collective: every rank of the mesh must make
it, in the same order. Under a launcher, ``cli.serve``'s rank 0 runs the
HTTP service and the other ranks follow. ``install()`` turns this on in
every rank before the first meshed runner is built; each
``DenoiserRunner(mesh=...)`` then registers itself, in build order, so a
runner has one number on every rank. A build makes the same calls on
every rank (a pool's memory probe) with nothing broadcast. Once rank 0
has ``start``-ed, ``lead`` broadcasts each call (the runner's number, its
method and its arguments, tensors moved to the CPU) and makes it, one
call at a time across the service's threads; the other ranks sit in
``follow``, which makes the same calls until ``stop``. ``reload`` rebuilds
a serving generation on every rank (``/admin/reload``): a build that
fails on rank 0 fails on every rank, which keeps the runner numbers in
step. Runners of earlier generations stay registered, as open sessions
may still call them.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
import torch.distributed as dist

_ACTIVE: Optional["Calls"] = None


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(o) for o in obj)
    return obj


class Calls:
    """The registry of meshed runners and the leader's broadcast."""

    def __init__(self):
        self.runners: list = []
        self.lock = threading.RLock()
        self.broadcasting = False  # rank 0, once its followers sit in follow()

    def register(self, runner) -> "Calls":
        runner.call_id = len(self.runners)
        self.runners.append(runner)
        return self

    def _send(self, message) -> None:
        dist.broadcast_object_list([message], src=0)

    def start(self) -> None:
        """Rank 0, after its first build: broadcast every call from now on."""
        self.broadcasting = True

    def lead(self, runner, method: str, *args):
        """Make a call, broadcast first once started; returns its result."""
        with self.lock:
            if self.broadcasting:
                self._send((runner.call_id, method, _cpu(args)))
            return getattr(runner, method)(*args)

    def reload(self, build: Callable[[], object]):
        """Rank 0: have every rank run ``build`` (a new generation) now."""
        with self.lock:
            self._send(("reload",))
            self.broadcasting = False
            try:
                return build()
            finally:
                self.broadcasting = True

    def stop(self) -> None:
        """Rank 0: release the followers."""
        with self.lock:
            if self.broadcasting:
                self._send(None)
                self.broadcasting = False

    def follow(self, build: Callable[[], object]) -> None:
        """Every other rank: make rank 0's calls until it stops."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            message = box[0]
            if message is None:
                return
            if message[0] == "reload":
                try:
                    build()
                except Exception as e:  # rank 0 fails the same build and reports it
                    print(f"[follow] reload failed on rank {dist.get_rank()}: {e}", flush=True)
                continue
            call_id, method, args = message
            runner = self.runners[call_id]
            args = tuple(a.to(runner.device) if torch.is_tensor(a) else a for a in args)
            getattr(runner, method)(*args)


def install() -> Calls:
    """Start keeping this process's meshed runners in step (a service of
    more than one rank)."""
    global _ACTIVE
    _ACTIVE = Calls()
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active() -> Optional[Calls]:
    return _ACTIVE


def register(runner) -> Optional[Calls]:
    """Number ``runner`` in the active registry; returns it (None outside
    a meshed service, where a runner's calls need no broadcast)."""
    return None if _ACTIVE is None else _ACTIVE.register(runner)
