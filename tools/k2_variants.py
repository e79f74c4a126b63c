#!/usr/bin/env python3
"""Time variants of kernel K2 (csrc/masked_squaring.cu) at its batched shapes.

    python3 tools/k2_variants.py

Run from the root of the repository on an NVIDIA H100 (sm_90a) with nvcc
under $CUDA_HOME or /usr/local/cuda. Each variant is the kernel source built
by `_kernels.build` with `-D` switches that the source declares (register
tile, threads and launch bounds, the loaders, the route, or an ablation that
removes a part of the product to see what it costs), each into a library of
its own hash, all built in parallel. Each variant's C entry point is timed
with CUDA events on the same inputs as chip_smoke.py's phase 9 (s = 3):
(1024, 81) float32 and (5120, 81) complex64 with 12 trips, (300, 81) and
(300, 256) complex64 with 4. Ablations give wrong results by design; each
variant's error against the plain twin is printed beside its two times, with
the time of one squaring and of the rest of the call (load, store, launch;
from a second timing with s = 1) and ptxas's registers and spills of the
kernel it runs. `torch.linalg.
matrix_power(R, 8)` is timed on the same inputs. Then the rate of FP32 FMAs
alone in K2's two register-tile patterns (tools/ffma_peak.cu), the ceiling of
every route. Last, the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.chip_common import PEAK_FP32, SEED, cuda_ms  # noqa: E402
from noisyquantumsimulator_tpu_torch import _kernels  # noqa: E402
from noisyquantumsimulator_tpu_torch.bench import card  # noqa: E402
from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (  # noqa: E402
    _ENTRY, _masked_squaring_plain)

K2_SOURCES = (_kernels.SRC_DIR / "masked_squaring.cu",
              _kernels.SRC_DIR / "nqs_errors.cu")
PEAK_SOURCES = (ROOT / "tools" / "ffma_peak.cu", _kernels.SRC_DIR / "nqs_errors.cu")

VARIANTS = {
    "as committed": (),
    "R loaded through registers": ("-DNQS_K2_SYNC_LOAD=1",),
    # float32 resident route: register tile, threads and blocks an SM
    "f32 8x4 tiles, 256 threads, 2 blocks/SM": ("-DNQS_K2_TM_F32=8",),
    "f32 8x8 tiles, 128 threads, 3 blocks/SM": (
        "-DNQS_K2_TM_F32=8", "-DNQS_K2_TN_F32=8", "-DNQS_K2_THREADS_F32=128",
        "-DNQS_K2_BLOCKS_F32=3"),
    "f32 14x4 tiles, 128 threads, 3 blocks/SM": (
        "-DNQS_K2_TM_F32=14", "-DNQS_K2_THREADS_F32=128", "-DNQS_K2_BLOCKS_F32=3"),
    "f32 4x4 tiles, 448 threads, 2 blocks/SM": (
        "-DNQS_K2_TM_F32=4", "-DNQS_K2_THREADS_F32=448"),
    # complex64 resident route
    "c64 448 threads, 1 block/SM": ("-DNQS_K2_THREADS_C64=448", "-DNQS_K2_BLOCKS_C64=1"),
    "c64 448 threads, 2 blocks/SM": ("-DNQS_K2_THREADS_C64=448",),
    "c64 224 threads, 2 blocks/SM": ("-DNQS_K2_THREADS_C64=224",),
    # tiled route
    "tiled 2 blocks/SM": ("-DNQS_K2_BLOCKS_TILED=2",),
    "tiled 3 blocks/SM": ("-DNQS_K2_BLOCKS_TILED=3",),
    "tiled, panels copied element by element": ("-DNQS_K2_ELEM_PANELS=1",),
    "everything tiled": ("-DNQS_K2_FORCE_TILED=1",),
    # ablations: what each part of the product costs
    "FMAs alone (operands loaded once)": ("-DNQS_K2_ABLATE=1",),
    "shared loads alone (adds for FMAs)": ("-DNQS_K2_ABLATE=2",),
}

# (B, N, dtype, max_squarings), all with s = 3
SHAPES = ((1024, 81, "float32", 12), (5120, 81, "complex64", 12),
          (300, 81, "complex64", 4), (300, 256, "complex64", 4))


def build():
    """Every variant's library and the FMA peak's, built in parallel."""
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        jobs = {name: pool.submit(_kernels.build, K2_SOURCES, defines)
                for name, defines in VARIANTS.items()}
        peak = pool.submit(_kernels.build, PEAK_SOURCES)
        paths = {name: job.result() for name, job in jobs.items()}
        peak_lib = _kernels.open_library(peak.result())
    peak_lib.nqs_ffma_peak.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    peak_lib.nqs_ffma_peak.restype = ctypes.c_int
    libs = {}
    for name, path in paths.items():
        regs = {}
        stack = _kernels.ptxas_stack_report(path)
        for kernel, r, st, _ in _kernels.ptxas_report(path):
            if "masked_square" not in kernel:
                continue
            route = "resident" if "resident" in kernel else "tiled"
            m = re.search(r"kernelI(f|6float2)(Lb[01])?E", kernel)
            if m and m.group(2) != "Lb0":      # tiled: the 16-byte-word kernel
                elem = {"f": "float32", "6float2": "complex64"}[m.group(1)]
                regs[(route, elem)] = (
                    f"{r} regs" + (f", spills {st} B" if st else "")
                    + (f", stack {stack[kernel]} B" if stack.get(kernel) else ""))
        libs[name] = (_kernels.open_library(path), regs)
    return libs, peak_lib


def ffma_peak_tflops(lib, complex_pattern, sms):
    """FP32 FLOP/s of FMAs alone: 2 blocks of 256 threads an SM, 64 FMAs per
    thread and iteration."""
    import torch
    blocks, threads, iters = 2 * sms, 256, 20000
    out = torch.empty(blocks * threads, device="cuda")
    stream = _kernels.stream_handle(out.device)

    def run(n_iter):
        _kernels.check(lib, lib.nqs_ffma_peak(
            _kernels.ptr(out), int(complex_pattern), blocks, threads, n_iter,
            stream), "FMA peak")
    run(100)
    ms = min(cuda_ms(lambda: run(iters), 1) for _ in range(2))
    return blocks * threads * iters * 64 * 2 / (ms * 1e-3) / 1e12


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    libs, peak_lib = build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    for B, N, dtname, ms in SHAPES:
        dt = getattr(torch, dtname)
        R = torch.randn((B, N, N), dtype=dt, device="cuda", generator=gen)
        R = torch.eye(N, dtype=dt, device="cuda") + R * (0.05 / N ** 0.5)
        s = torch.full((B,), 3, device="cuda", dtype=torch.int32)
        s1 = torch.ones_like(s)
        ref = _masked_squaring_plain(R, s, ms)
        out, s0, sc1 = (torch.empty_like(R) for _ in range(3))
        stream = _kernels.stream_handle(R.device)
        entry, code = _ENTRY[dt]
        reps = 3 if B * N * N > 4e6 else 20
        for i, (name, (lib, regs)) in enumerate(libs.items()):
            def run(counts=s):
                _kernels.check(lib, getattr(lib, entry)(
                    _kernels.ptr(R), _kernels.ptr(out), _kernels.ptr(s0),
                    _kernels.ptr(sc1), _kernels.ptr(counts), ms, B, N, stream),
                    f"K2 variant {name!r}")
            if i == 0:
                cuda_ms(run, 10)                  # clocks up
            run()
            err = float((out - ref).abs().max() / ref.abs().max())
            t = [cuda_ms(run, reps) for _ in range(2)]
            one = min(cuda_ms(lambda: run(s1), reps) for _ in range(2))
            per = (min(t) - one) / 2
            route = "resident" if lib.nqs_masked_squaring_is_resident(code, N) \
                else "tiled"
            print(f"({B}, {N}) {dtname} | {name} | {t[0]:.4f} / {t[1]:.4f} ms | "
                  f"a squaring {per:.4f}, the rest {one - per:.4f} ms | "
                  f"rel err {err:.3e} | {route}, {regs.get((route, dtname), '?')}",
                  flush=True)
        lib_fn = lambda: torch.linalg.matrix_power(R, 8)
        lib_fn()
        t = [cuda_ms(lib_fn, reps) for _ in range(2)]
        print(f"({B}, {N}) {dtname} | torch.linalg.matrix_power(R, 8) | "
              f"{t[0]:.4f} / {t[1]:.4f} ms", flush=True)
        del R, ref, out, s0, sc1
        torch.cuda.empty_cache()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, cplx in (("8 x 8 real tile", False), ("4 x 4 complex tile", True)):
        print(f"FP32 FMAs alone, {label}: "
              f"{ffma_peak_tflops(peak_lib, cplx, sms):.2f} TFLOP/s of "
              f"{PEAK_FP32 / 1e12:.0f} ({sms} SMs)", flush=True)
    print(*card(), sep=", ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
