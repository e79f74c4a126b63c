"""The host C++ decoders (ctypes): OSD-0, exact matching, erasure peeling.

Counterpart of the reference's `qec/native.py`: `osd0_batch_native` (OSD-0
for the BP decoders' non-converged shots), `NativeMatchingDecoder` (exact
cluster-decomposition matching over the same APSP tables as the device
matchers) and `NativeErasurePeeler`. The C++ source is the repository's shared `native/uf_decoder.cpp`; this module
builds it with the host C++ compiler into the port's own build directory,

    g++ -O3 -fPIC -std=c++17 -shared -o _build/libufdecode-<hash>.so
        native/uf_decoder.cpp

cached by a hash of the source and the flags and written through a
temporary file with an atomic rename, so concurrent processes never see a
half-written library. It never runs `make` in `native/` and never writes
there. The build runs at the first call, never at import. A failed build
raises: the numpy `ldpc._osd0` is the twin the tests hold OSD-0 to, not a
fallback, and no caller in the port switches to another decoder when the
build fails (`native_available` only reports it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

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
            vp, i32 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)
            lib.uf_create.restype = vp
            lib.uf_create.argtypes = [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_double), i32]
            lib.uf_destroy.argtypes = [vp]
            lib.uf_decode_batch.argtypes = [vp, u8, ctypes.c_int,
                                            ctypes.c_int, u8]
            lib.uf_decode_batch_ex.argtypes = [
                vp, u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8, i32,
                i32, u8, ctypes.POINTER(ctypes.c_double)]
            lib.er_create.restype = vp
            lib.er_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int64), u8]
            lib.er_destroy.argtypes = [vp]
            lib.er_peel_batch.argtypes = [vp, u8, u8, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int, u8]
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


def native_available() -> bool:
    """Whether the library builds and loads here. A report only: the
    decoders that need the library call `load()` and raise when it fails."""
    try:
        load()
        return True
    except Exception:
        return False


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeMatchingDecoder:
    """C++ exact matching (cluster decomposition, subset DP, blossom for
    oversize components) over the same APSP tables as the device matchers."""

    def __init__(self, n_detectors: int, edges: np.ndarray, probs: np.ndarray,
                 obs: np.ndarray):
        from .decoders import MatchingGraph
        lib = load()
        g = MatchingGraph.from_edges(n_detectors, edges, probs, obs)
        self.n_detectors = n_detectors
        self._dist = np.ascontiguousarray(g.dist, dtype=np.float64)
        # unreachable pairs: a large finite sentinel for the C++ tables
        self._dist[~np.isfinite(self._dist)] = 1e18
        self._par = np.ascontiguousarray(g.parity, dtype=np.int32)
        self._lib = lib
        self._handle = lib.uf_create(n_detectors + 1,
                                     _ptr(self._dist, ctypes.c_double),
                                     _ptr(self._par, ctypes.c_int32))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.uf_destroy(self._handle)
            self._handle = None

    def decode_batch(self, detectors: np.ndarray) -> np.ndarray:
        """detectors (S, n_det) -> predicted observable flips (S,) int64."""
        dets = np.ascontiguousarray(np.asarray(detectors), dtype=np.uint8)
        shots, n_det = dets.shape
        out = np.zeros(shots, dtype=np.uint8)
        t0 = time.perf_counter()
        self._lib.uf_decode_batch(self._handle, _ptr(dets, ctypes.c_uint8),
                                  shots, n_det, _ptr(out, ctypes.c_uint8))
        self.last_decode_seconds = time.perf_counter() - t0
        return out.astype(np.int64)

    def decode_batch_ex(self, detectors: np.ndarray, mode: int = 0,
                        threads: Optional[int] = None):
        """Decode with per-shot diagnostics.

        mode 0: exact cluster decomposition (production); 1: whole-shot
        exact DP up to 22 defects (validation oracle); 2: greedy + 2-opt
        only. Returns a dict with 'pred' (S,) int64, 'n_defects' (S,)
        int32, 'max_cluster' (S,) int32, 'exact' (S,) bool (every
        component within the exact-DP budget), 'cost' (S,) float64 total
        matching weight. Shots are split over `threads` host threads
        (default: up to 16 from 512 shots on); ctypes drops the GIL and
        each call reads only the decoder's constant tables."""
        dets = np.ascontiguousarray(np.asarray(detectors), dtype=np.uint8)
        shots, n_det = dets.shape
        pred = np.zeros(shots, dtype=np.uint8)
        ndef = np.zeros(shots, dtype=np.int32)
        maxc = np.zeros(shots, dtype=np.int32)
        exact = np.zeros(shots, dtype=np.uint8)
        cost = np.zeros(shots, dtype=np.float64)
        t0 = time.perf_counter()

        def run(lo: int, hi: int) -> None:
            self._lib.uf_decode_batch_ex(
                self._handle, _ptr(dets[lo:hi], ctypes.c_uint8), hi - lo,
                n_det, int(mode), _ptr(pred[lo:hi], ctypes.c_uint8),
                _ptr(ndef[lo:hi], ctypes.c_int32),
                _ptr(maxc[lo:hi], ctypes.c_int32),
                _ptr(exact[lo:hi], ctypes.c_uint8),
                _ptr(cost[lo:hi], ctypes.c_double))

        nt = threads if threads is not None else (
            min(os.cpu_count() or 1, 16) if shots >= 512 else 1)
        nt = max(1, min(nt, shots))
        if nt == 1:
            run(0, shots)
        else:
            from concurrent.futures import ThreadPoolExecutor
            step = -(-shots // nt)
            bounds = [(i, min(i + step, shots)) for i in range(0, shots, step)]
            with ThreadPoolExecutor(max_workers=len(bounds)) as ex:
                list(ex.map(lambda b: run(*b), bounds))
        self.last_decode_seconds = time.perf_counter() - t0
        return {"pred": pred.astype(np.int64), "n_defects": ndef,
                "max_cluster": maxc, "exact": exact.astype(bool),
                "cost": cost}


class NativeErasurePeeler:
    """C++ erasure peeling (leaf-inward, boundary, cycle-breaking order of
    the reference's host loop). Residual defects go to the matching pass."""

    def __init__(self, n_detectors: int, edges: np.ndarray, obs0: np.ndarray):
        lib = load()
        self._edges = np.ascontiguousarray(edges, dtype=np.int64)
        self._obs0 = np.ascontiguousarray(obs0, dtype=np.uint8)
        self.n_detectors = n_detectors
        self.n_sites = self._edges.shape[0]
        self._lib = lib
        self._handle = lib.er_create(n_detectors, self.n_sites,
                                     _ptr(self._edges, ctypes.c_int64),
                                     _ptr(self._obs0, ctypes.c_uint8))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.er_destroy(self._handle)
            self._handle = None

    def peel_batch(self, detectors: np.ndarray, heralds: np.ndarray):
        """Returns (residual_detectors (S, n_det) uint8, obs_parity (S,))."""
        dets = np.ascontiguousarray(detectors, dtype=np.uint8).copy()
        hh = np.ascontiguousarray(heralds, dtype=np.uint8)
        S = dets.shape[0]
        out = np.zeros(S, dtype=np.uint8)
        self._lib.er_peel_batch(self._handle, _ptr(dets, ctypes.c_uint8),
                                _ptr(hh, ctypes.c_uint8), S, self.n_detectors,
                                self.n_sites, _ptr(out, ctypes.c_uint8))
        return dets, out.astype(np.int64)


__all__ = ["osd0_batch_native", "build", "library_path", "SOURCE",
           "native_available", "NativeMatchingDecoder", "NativeErasurePeeler"]
