"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own
``lib<name>-<hash>.so`` under ``audiodenoiser_torch/_build/`` (listed in
``.gitignore``). The hash covers the source text, every shared header
``csrc/*.cuh`` and the flags, so an edited source or header builds anew.
All missing libraries are compiled at once, one ``nvcc`` per source in
parallel, on first use; nothing is built at import time. The launch helpers
below are what every wrapper needs around its ctypes call.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # source name -> nvcc/ptxas output


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _target(name: str, csrc: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:12]}.so"


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all() -> float:
    """Compile every source whose library is missing; returns seconds."""
    with _lock:
        t0 = time.perf_counter()
        todo = [n for n in sources() if not _target(n).exists()]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name in todo:
                tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC_DIR / f"{name}.cu")]
                procs[name] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                out, _ = proc.communicate()
                build_log[name] = out
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
                else:
                    os.replace(tmp, _target(name))  # atomic publish
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return time.perf_counter() - t0


def on_device(device: torch.device):
    """The CUDA device context a launch on ``device`` needs: none when that
    device is already current (the common case, and the cheap one)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


_sm_counts: dict[int, int] = {}


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current CUDA stream on ``device``, through
    PyTorch's own accessor: about a microsecond, against some ten for
    building a ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def sm_count(device: torch.device) -> int:
    """The device's number of SMs, read once."""
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


_count_lock = threading.Lock()


def count_launch(kernel, variant: str, n: int = 1) -> None:
    """``n`` launches of ``kernel`` through ``variant`` (more than one from
    a replayed CUDA graph): its total and the variant's own counter, under
    a lock, since server threads launch concurrently."""
    with _count_lock:
        kernel.launches += n
        setattr(kernel, f"{variant}_launches", getattr(kernel, f"{variant}_launches") + n)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _libs[name] = lib
    return lib
