"""Build and load the package's CUDA kernels (nvcc + ctypes).

The sources under `csrc/` are compiled by nvcc into one shared library with
a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/libnqs_kernels-<hash>.so csrc/*.cu

The build runs at first use, i.e. when a CUDA tensor first reaches a kernel
wrapper, never at import. It is cached by a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Only the sources in this package are compiled.

Every C entry point returns a `cudaError_t` (0 on success, checked with
`cudaGetLastError()` right after each launch); `check` raises on anything
else. Pointers and the stream go through ctypes as `c_void_p`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (see the .cu files)
_SIGNATURES = {
    "nqs_phase_scan_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "nqs_phase_scan_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "nqs_masked_squaring_f32": (_P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_f64": (_P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_c64": (_P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_c128": (_P, _P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of noisyquantumsimulator_tpu_torch cannot be built")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libnqs_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the cached library if it is not there yet.
    Returns its path; records the seconds taken in `build_info`."""
    out = library_path()
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{res.stderr[-4000:]}")
    os.replace(tmp, out)       # atomic: a concurrent build sees all or none
    build_info.update(seconds=seconds, cached=False, command=" ".join(cmd))
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.nqs_error_string.argtypes = [ctypes.c_int]
            lib.nqs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.nqs_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on `device`, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


__all__ = ["SRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "check",
           "library_path", "build_info", "stream_handle", "ptr"]
