#!/usr/bin/env python3
"""Time variants of kernel K1 (csrc/phase_scan.cu) at the sweep's shapes.

    python3 tools/k1_variants.py

Run from the root of the repository on an NVIDIA H100 (sm_90a) with nvcc
under $CUDA_HOME or /usr/local/cuda. Each variant is the kernel source built
by `_kernels.build` with `-D` switches that the source declares (the L2
route's tiling, or an ablation that removes a part of the step to see what
it costs), each into a library of its own hash, all built in parallel. Each
variant's `nqs_phase_scan_f32` is timed twice in a row with CUDA events on
the same inputs: dim 3 (B = 32768, n = 81) and dim 4 (B = 8192, n = 256),
S = 5, 300 steps, float32. Ablations remove work, so their results are wrong
by design; each variant's error against the plain twin is printed beside
its time, with ptxas's registers of the two float32 routes. Then the rate of
`mma.sync.m16n8k8` TF32 alone (tools/mma_tf32_peak.cu), and the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tools.chip_common import SEED, cuda_ms, gate_plan, host_scan_inputs  # noqa: E402
from noisyquantumsimulator_tpu_torch import _kernels  # noqa: E402
from noisyquantumsimulator_tpu_torch.bench import card  # noqa: E402

K1_SOURCES = (_kernels.SRC_DIR / "phase_scan.cu", _kernels.SRC_DIR / "nqs_errors.cu")
PEAK_SOURCES = (ROOT / "tools" / "mma_tf32_peak.cu",
                _kernels.SRC_DIR / "nqs_errors.cu")

VARIANTS = {
    "as committed": (),
    # L2 route (dim 4): m tiles a warp, blocks an SM
    "L2 4 m tiles": ("-DNQS_K1_MW_L2=4",),
    "L2 4 m tiles, 2 blocks/SM": ("-DNQS_K1_MW_L2=4", "-DNQS_K1_BLOCKS_L2=2"),
    "L2 6 m tiles": ("-DNQS_K1_MW_L2=6",),
    "L2 8 m tiles": ("-DNQS_K1_MW_L2=8",),
    # ablations: what each part of the step costs
    "no rotation": ("-DNQS_K1_ABLATE=1",),
    "no split of the state": ("-DNQS_K1_ABLATE=2",),
    "hi*hi product only": ("-DNQS_K1_ABLATE=3",),
}


def build():
    """Every variant's library and the mma peak's, built in parallel."""
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        jobs = {name: pool.submit(_kernels.build, K1_SOURCES, defines)
                for name, defines in VARIANTS.items()}
        peak = pool.submit(_kernels.build, PEAK_SOURCES)
        paths = {name: job.result() for name, job in jobs.items()}
        peak_path = peak.result()
    libs = {}
    for name, path in paths.items():
        regs, spills = [], []
        for kernel, r, st, _ in _kernels.ptxas_report(path):
            if "phase_scan_tc_kernel" in kernel:
                route = "L2" if "ILb0E" in kernel else "smem"
                regs.append(f"{route} {r}")
                if st:
                    spills.append(f"{route} {st} B")
        libs[name] = (_kernels.open_library(path), regs, spills)
    peak_lib = _kernels.open_library(peak_path)
    peak_lib.nqs_mma_tf32_peak.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    peak_lib.nqs_mma_tf32_peak.restype = ctypes.c_int
    return libs, peak_lib


def scan_args(U, cq, phases_bn, x0, D, P):
    """The kernel's operands, as `evolve_real_phased_many_cuda` makes them,
    and the plain twin's result."""
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        _evolve_real_phased_many_plain, _prologue)
    cq_r, ph, dphi, v0 = _prologue(U, cq, phases_bn, x0, D, P)
    ops = (U.T.contiguous(), cq_r.contiguous(), dphi.contiguous(),
           v0.contiguous())
    ref = _evolve_real_phased_many_plain(U, cq, phases_bn, x0, D, P)
    return ops, ph, ref


def mma_peak_tflops(lib, sms):
    """Dense TF32 FLOP/s of mma.sync alone: 2 blocks of 256 threads an SM."""
    import torch
    blocks, threads, iters = 2 * sms, 256, 20000
    out = torch.empty(blocks * threads, device="cuda")
    stream = _kernels.stream_handle(out.device)

    def run(n_iter):
        _kernels.check(lib, lib.nqs_mma_tf32_peak(_kernels.ptr(out), blocks, threads,
                                                  n_iter, stream), "mma peak")
    run(100)
    ms = cuda_ms(lambda: run(iters), 1)
    products = blocks * threads // 32 * iters * 8
    return products * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    from noisyquantumsimulator_tpu_torch.solver.real_rep import _rotate
    libs, peak_lib = build()
    rng = np.random.default_rng(SEED)
    for dim, B in ((3, 32768), (4, 8192)):
        U, cq, ph, x0, D, P = host_scan_inputs(gate_plan(dim))
        phases_bn = rng.uniform(0.95, 1.05, B)[:, None] * ph[None]
        args = [torch.as_tensor(a, device="cuda").to(torch.float32)
                for a in (U, cq, phases_bn, x0)]
        (UT, cq_r, dphi, v0), ph_r, ref = scan_args(*args, D, P)
        S, n = x0.shape
        out = torch.empty_like(v0)
        stream = _kernels.stream_handle(out.device)
        for i, (name, (lib, regs, spills)) in enumerate(libs.items()):
            def run():
                _kernels.check(lib, lib.nqs_phase_scan_f32(
                    _kernels.ptr(UT), _kernels.ptr(cq_r), _kernels.ptr(dphi),
                    _kernels.ptr(v0), _kernels.ptr(out), B, S, n, D, P,
                    dphi.shape[1], stream), f"K1 variant {name!r}")
            if i == 0:
                cuda_ms(run, 10)                  # clocks up
            run()
            got = _rotate(out, ph_r[:, -1, None], cq_r, D, P)
            err = float((got - ref).abs().max() / ref.abs().max())
            t = [cuda_ms(run, 3) for _ in range(2)]
            print(f"dim {dim} | {name} | {t[0]:.3f} / {t[1]:.3f} ms | rel err "
                  f"{err:.3e} | registers {', '.join(regs)}"
                  f"{' | spill stores ' + ', '.join(spills) if spills else ''}",
                  flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"mma.sync.m16n8k8 TF32 alone: {mma_peak_tflops(peak_lib, sms):.1f} "
          f"TFLOP/s dense ({sms} SMs)")
    print(*card(), sep=", ", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
