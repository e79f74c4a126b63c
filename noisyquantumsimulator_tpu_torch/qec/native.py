"""Host C++ OSD-0 for the BP decoders' non-converged shots (ctypes).

Counterpart of the reference's `qec/native.py` `osd0_batch_native`. The
C++ source is the repository's shared `native/uf_decoder.cpp`; this module
builds it with the host C++ compiler into the port's own build directory,

    g++ -O3 -fPIC -std=c++17 -shared -o _build/libufdecode-<hash>.so
        native/uf_decoder.cpp

cached by a hash of the source and the flags and written through a
temporary file with an atomic rename, so concurrent processes never see a
half-written library. It never runs `make` in `native/` and never writes
there. The build runs at the first OSD call, never at import. A failed
build raises: the numpy `ldpc._osd0` is the twin the tests hold this
library to, not a fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from .._kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "uf_decoder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found ($CXX, g++ or c++ on PATH); "
                           "the native OSD-0 library cannot be built")
    return cxx


def library_path() -> Path:
    if not SOURCE.exists():
        raise RuntimeError(f"native OSD-0 source not found: {SOURCE}")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libufdecode-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the OSD-0 library into the build directory if it is not
    there yet; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / out.name
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    return out


def load():
    """The loaded OSD-0 library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8 = ctypes.POINTER(ctypes.c_uint8)
            lib.osd0_batch.argtypes = [
                u8, ctypes.c_int, ctypes.c_int, u8,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, u8]
            lib.osd0_batch.restype = None
            _lib = lib
        return _lib


def osd0_batch_native(H: np.ndarray, dets: np.ndarray,
                      beliefs: np.ndarray) -> np.ndarray:
    """C++ OSD-0 over GF(2) for a batch of shots, bit-identical to
    `ldpc._osd0`: H (m, n) 0/1, dets (S, m) 0/1, beliefs (S, n) ->
    estimated errors (S, n) uint8."""
    lib = load()
    H = np.ascontiguousarray(H, dtype=np.uint8)
    dets = np.ascontiguousarray(dets, dtype=np.uint8)
    beliefs = np.ascontiguousarray(beliefs, dtype=np.float32)
    m, n = H.shape
    S = dets.shape[0]
    if dets.shape != (S, m) or beliefs.shape != (S, n):
        raise ValueError(f"dets {dets.shape} / beliefs {beliefs.shape} do not "
                         f"match H {H.shape}")
    out = np.zeros((S, n), dtype=np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.osd0_batch(H.ctypes.data_as(u8), m, n, dets.ctypes.data_as(u8),
                   beliefs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), S,
                   out.ctypes.data_as(u8))
    return out


__all__ = ["osd0_batch_native", "build", "library_path", "SOURCE"]
