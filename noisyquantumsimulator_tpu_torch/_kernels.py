"""Build and load the package's CUDA kernels (nvcc + ctypes).

The sources under `csrc/` are compiled by nvcc, one process per source, all
started together, and linked into one shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <tmp>/<name>.o csrc/<name>.cu
                                                                (each source)
    nvcc -shared -o _build/libnqs_kernels-<hash>.so <tmp>/*.o

The build runs at first use, i.e. when a CUDA tensor first reaches a kernel
wrapper, never at import. It is cached by a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Only the sources in this package are compiled, unless a caller names
other sources or adds `-D` defines (a variant is then a library of its own
hash). ptxas reports each kernel's registers, shared memory and spills into
`_build/build-<hash>.log`, beside the library of the same hash
(`ptxas_report`).

Every C entry point returns a `cudaError_t` (0 on success, checked with
`cudaGetLastError()` right after each launch); `check` raises on anything
else. Pointers and the stream go through ctypes as `c_void_p`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import tempfile
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points and their argument types (see the .cu files)
_SIGNATURES = {
    "nqs_bp_c2v_f32": (_P, _P, _P, _I, _I, _I, _F, _P),
    "nqs_bp_c2v_bf16": (_P, _P, _P, _I, _I, _I, _F, _P),
    "nqs_bp_c2v_max_slots": (),
    "nqs_bp_v2c_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    "nqs_bp_v2c_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P),
    "nqs_bp_v2c_max_degree": (),
    "nqs_phase_scan_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "nqs_phase_scan_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "nqs_masked_squaring_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_f64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_c64": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_c128": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "nqs_masked_squaring_is_resident": (_I, _I),
    "nqs_population_scan_f32": (_P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P),
    "nqs_population_scan_f64": (_P, _P, _P, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P),
    "nqs_population_scan_is_resident": (_I, _I, _I),
    "nqs_osd0": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "nqs_osd0_smem_bytes": (_I, _I),
    "nqs_empty_launch": (_P,),
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


def library_path(sources=None, defines=()) -> Path:
    """The cached library of `sources` (default: every csrc source) built
    with the extra nvcc arguments `defines` (such as "-DNAME=1")."""
    srcs = _sources() if sources is None else sorted(Path(p) for p in sources)
    h = hashlib.sha256(" ".join((*NVCC_FLAGS, *defines)).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libnqs_kernels-{h.hexdigest()[:16]}.so"


def log_path(lib: Path) -> Path:
    """The nvcc / ptxas log of the library `lib` (same hash)."""
    return lib.with_name(lib.stem.replace("libnqs_kernels", "build") + ".log")


def build(sources=None, defines=()) -> Path:
    """Compile the .cu files of `sources` (default: csrc/*.cu) with the
    extra nvcc arguments `defines` into their cached library if it is not
    there yet. Returns its path; records the seconds taken in
    `build_info`."""
    out = library_path(sources, defines)
    srcs = _sources() if sources is None else sorted(Path(p) for p in sources)
    if out.exists():
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("cached", True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in (p for p in srcs if p.suffix == ".cu"):
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text[-4000:]}")
        if not failed:
            tmp = Path(tmpdir) / out.name
            cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"link ({res.returncode}):\n{res.stderr[-4000:]}")
            else:
                os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    seconds = time.perf_counter() - t0
    log_path(out).write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    build_info.update(seconds=seconds, cached=False,
                      command=" ".join(jobs[0][0]) + " (one per source)")
    return out


def open_library(path: Path):
    """Load a built library with ctypes and declare the C entry points it
    has (a variant built from some of the sources has only theirs)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.nqs_error_string.argtypes = [ctypes.c_int]
    lib.nqs_error_string.restype = ctypes.c_char_p
    return lib


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
        return _lib


def ptxas_report(lib: Path | None = None) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) for every
    kernel of the library `lib` (default: the package's, as `load` builds
    it), read from its build log."""
    log = log_path(lib if lib is not None else library_path())
    if not log.exists():
        return []
    out, name = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (-1, -1)    # -1: not reported
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spill))
            name = None
    return out


def ptxas_stack_report(lib: Path | None = None) -> dict:
    """{kernel: bytes of stack frame} for every kernel of the library `lib`
    (default: the package's), read from its build log. A kernel whose local
    arrays stayed in registers has 0."""
    log = log_path(lib if lib is not None else library_path())
    if not log.exists():
        return {}
    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name] = int(m.group(1))
    return out


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
           "library_path", "log_path", "open_library", "build_info",
           "ptxas_report", "ptxas_stack_report", "stream_handle", "ptr"]
