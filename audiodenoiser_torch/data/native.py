"""ctypes bindings to the native C++ audio-ingest library (port of
``data/native.py``).

The source is the repository's ``native/audioio.cpp``. It is built with
g++ (the flags of ``native/Makefile``) into the ignored
``audiodenoiser_torch/_build/`` as ``libaudioio-<hash>.so``, the hash
covering the source and the flags, at first use and never at import; the
``native/`` folder is only read. It exposes:

- ``load_wav(path, sample_rate)``: decode, mono downmix and polyphase
  resampling that agrees with ``scipy.signal.resample_poly`` (the scipy
  path of ``data.wav_io``);
- ``load_batch(paths, sample_rate, chunk_samples)``: decode every file in
  parallel straight into a rectangular (n_chunks, chunk_samples) float32
  array, the layout ``data.builders.load_clean_chunks`` returns.

``available()`` is False when there is no compiler, the build fails, or
``ADT_DISABLE_NATIVE=1`` is set; callers then keep to the scipy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "audioio.cpp"
BUILD_DIR = REPO_DIR / "audiodenoiser_torch" / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
build_log = ""  # the compiler's output of this process's build, if it built


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libaudioio-{h.hexdigest()[:12]}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    global build_log
    if not SOURCE.exists():
        return None
    so = _target()
    if not so.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            build_log = str(exc)
            return None
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return None
        os.replace(tmp, so)  # atomic publish: concurrent builds race safely
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.adio_version.restype = ctypes.c_int
    lib.adio_load_wav.restype = ctypes.c_int
    lib.adio_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_int64)]
    lib.adio_free.restype = None
    lib.adio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.adio_load_batch.restype = ctypes.c_int64
    lib.adio_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            if os.environ.get("ADT_DISABLE_NATIVE") != "1":
                _lib = _build_and_load()
        return _lib


def library_path() -> Optional[str]:
    """Where the loaded library lives, or None when it is not available."""
    return str(_target()) if _get() is not None else None


def available() -> bool:
    return _get() is not None


def load_wav(path: str, sample_rate: Optional[int] = None) -> np.ndarray:
    """Decode one wav to mono float32, resampled to ``sample_rate`` when given."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native audioio unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_int64()
    rc = lib.adio_load_wav(str(path).encode(), int(sample_rate or 0), ctypes.byref(out),
                           ctypes.byref(n))
    if rc != 0:
        raise IOError(f"native decode failed for {path} (rc={rc})")
    try:
        return np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.adio_free(out)


def load_batch(paths: Sequence[str], sample_rate: int, chunk_samples: int) -> np.ndarray:
    """Parallel decode + resample + chunk -> (n_chunks, chunk_samples) float32."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native audioio unavailable")
    if not paths:
        return np.zeros((0, chunk_samples), np.float32)
    encoded = [str(p).encode() for p in paths]  # alive while the library reads them
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.adio_load_batch(arr, len(encoded), int(sample_rate), int(chunk_samples),
                            ctypes.byref(out))
    if n < 0:
        raise IOError(f"native batch decode failed (rc={n})")
    try:
        if n == 0:
            return np.zeros((0, chunk_samples), np.float32)
        return np.ctypeslib.as_array(out, shape=(n, chunk_samples)).copy()
    finally:
        lib.adio_free(out)
