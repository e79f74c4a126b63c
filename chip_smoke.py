#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of the CZ gate engine once on one GPU.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA GPU (built
for sm_90a: H100 / H200), nvcc under $CUDA_HOME or /usr/local/cuda, and
PyTorch built for CUDA. It imports nothing of JAX. Phases, one status line
each; any failure raises and the script exits non-zero:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    nvcc builds csrc/*.cu (noisyquantumsimulator_tpu_torch/_build)
  3. K1       the phase-scan kernel vs its plain twin at the bench layout
              (n = 81, S = 5, 300 steps, B = 1024; n = 256, B = 256), f32/f64
  4. K2       the masked-squaring kernel vs its twin on the main path's
              squaring inputs: (1, 81), (300, 81) and (1, 256), mixed s
  5. gate     simulate_cz_gate(SmoothJPSimulationInputs(), device="cuda") at
              complex64 and complex128 vs a host complex128 scipy reference
  6. sweep    the bench sweep (bench_gate.build_workload) at dim 3, batch
              32768, and dim 4, batch 8192: sims/s and the kernels' launch
              counts in that run, then each kernel's time vs its twin's

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it prints no result and
exits with code 2.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

SEED = 20261016
K1_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/phase_scan.cu"
K1_REPLACES = "noisyquantumsimulator_tpu/solver/scan_pallas.py:71"
K2_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/masked_squaring.cu"
K2_REPLACES = "noisyquantumsimulator_tpu/ops/expm_pallas.py:35"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _plan(dim, n_steps=300):
    from noisyquantumsimulator_tpu_torch.core.configs import (
        SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_cz_gate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return plan_cz_gate(SmoothJPSimulationInputs(), hilbert_space_dim=dim,
                            n_steps_smooth=n_steps)


def _host_scan_inputs(plan):
    """U_real, cq, phases, x0 in float64 numpy, built on the host with
    scipy (independent of both kernels)."""
    from scipy.linalg import expm as sexpm
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_phase_frame
    from noisyquantumsimulator_tpu_torch.solver.real_rep import build_real_rep
    g = plan_phase_frame(plan)
    D = plan.rho0s.shape[-1]
    rep = build_real_rep(g, D)
    W = rep.Wr + 1j * rep.Wi
    Ub = sexpm((plan.L0 + plan.Cp + plan.Cm) * plan.schedule.dts[0])
    U_real = (W @ Ub @ W.conj().T).real
    x0 = (plan.rho0s.reshape(len(plan.rho0s), D * D) @ W.T).real
    return U_real, rep.cq, np.asarray(plan.schedule.phases), x0, D, rep.P


def _cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_vs_plain_ms(kernel, plain, reps):
    """Time both in turns (plain, kernel, kernel, plain) after a warm-up;
    returns (kernel ms, plain ms), each the mean of its two turns."""
    kernel(), plain()
    p1 = _cuda_ms(plain, reps)
    k1 = _cuda_ms(kernel, reps)
    k2 = _cuda_ms(kernel, reps)
    p2 = _cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device():
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi exited {smi.returncode}")
    say("1 device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{count} device(s); device 0: {name}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    return name, count


def phase_build():
    from noisyquantumsimulator_tpu_torch import _kernels
    t0 = time.perf_counter()
    _kernels.load()
    info = _kernels.build_info
    say("2 build", f"ok: {_kernels.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info.get('seconds', 0.0):.2f} s,"
        f" cached={info.get('cached')})")


def phase_k1(rng):
    import torch
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)
    errs = {}
    for dim, B in ((3, 1024), (4, 256)):
        U, cq, ph, x0, D, P = _host_scan_inputs(_plan(dim))
        phases_bn = rng.uniform(0.9, 1.1, B)[:, None] * ph[None]
        for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
            args = [torch.as_tensor(a, device="cuda").to(dt)
                    for a in (U, cq, phases_bn, x0)]
            got = evolve_real_phased_many_cuda(*args, D, P)
            ref = _evolve_real_phased_many_plain(*args, D, P)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            require(bool(torch.isfinite(got).all()), "K1 output finite")
            require(got.shape == (B, len(x0), D + 2 * P), "K1 output shape")
            require(err <= tol * scale,
                    f"K1 dim {dim} {dt}: max|d| {err:.3e} > {tol} * {scale:.3e}")
            errs[(dim, str(dt))] = err
            say("3 K1", f"dim {dim} B={B} S={len(x0)} n={D + 2 * P} 300 steps "
                f"{dt}: max|kernel - twin| = {err:.3e} (max|ref| {scale:.3e}, "
                f"tol {tol} relative)")
    return errs


def _squaring_inputs(plan, B, dtype, device):
    """The main path's squaring inputs: Taylor-16 of the scaled segment
    Liouvillians (B = 1: U_base's; B > 1: per-segment, with the segments
    scaled by 0.05..1 so their squaring counts differ)."""
    import torch
    from noisyquantumsimulator_tpu_torch.gate.simulate import (
        plan_squaring_bound)
    from noisyquantumsimulator_tpu_torch.ops.expm import (
        _THETA16, _scale, _taylor16)
    from noisyquantumsimulator_tpu_torch.solver.propagator import (
        segment_liouvillians)
    L0, Cp, Cm = (torch.as_tensor(a, device=device).to(dtype)
                  for a in (plan.L0, plan.Cp, plan.Cm))
    ms = plan_squaring_bound(plan)
    if B == 1:
        A = ((L0 + Cp + Cm) * float(plan.schedule.dts[0]))[None]
    else:
        A = segment_liouvillians(L0, Cp, Cm, plan.schedule)[:B]
        A = A * torch.linspace(0.05, 1.0, B, dtype=torch.float64,
                               device=device).to(dtype)[:, None, None]
    As, s = _scale(A, _THETA16, ms)
    I = torch.eye(A.shape[-1], dtype=dtype, device=device).expand(A.shape)
    return _taylor16(As, I).contiguous(), s, ms


def phase_k2():
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    errs = {}
    for dim, B in ((3, 1), (3, 300), (4, 1)):
        plan = _plan(dim)
        for dt, tol in ((torch.complex64, 1e-5), (torch.complex128, 1e-12)):
            R, s, ms = _squaring_inputs(plan, B, dt, "cuda")
            got = fused_masked_squaring(R, s, ms)
            ref = _masked_squaring_plain(R, s, ms)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            require(bool(torch.isfinite(torch.view_as_real(got)).all()),
                    "K2 output finite")
            require(err <= tol * scale,
                    f"K2 ({B},{R.shape[-1]}) {dt}: {err:.3e} > {tol} * {scale:.3e}")
            errs[(B, R.shape[-1], str(dt))] = err
            say("4 K2", f"B={B} N={R.shape[-1]} {dt} max_squarings={ms} "
                f"s in [{int(s.min())}, {int(s.max())}]: max|kernel - twin| = "
                f"{err:.3e} (max|ref| {scale:.3e}, tol {tol} relative)")
    return errs


def _host_reference_states(plan):
    """Host complex128 phase-frame result (scipy expm + ordered product),
    the same algorithm as the reference bench's x64 tier."""
    from scipy.linalg import expm as sexpm
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_phase_frame
    g = plan_phase_frame(plan)
    ph = np.asarray(plan.schedule.phases, np.float64)
    Ub = sexpm((plan.L0 + plan.schedule.amps[0] * (plan.Cp + plan.Cm))
               * plan.schedule.dts[0])
    U = np.eye(Ub.shape[0], dtype=np.complex128)
    prev = None
    for k in range(len(ph)):
        W = Ub if prev is None else Ub * np.exp(1j * (prev - ph[k]) * g)[None, :]
        U = W @ U
        prev = ph[k]
    U = np.exp(1j * ph[-1] * g)[:, None] * U * np.exp(-1j * ph[0] * g)[None, :]
    D = plan.rho0s.shape[-1]
    return (plan.rho0s[:4].reshape(4, D * D) @ U.T).reshape(4, D, D)


def _uhlmann(rho, sigma):
    w, v = np.linalg.eigh(0.5 * (rho + rho.conj().T))
    sq = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.conj().T
    m = sq @ sigma @ sq
    wm = np.linalg.eigvalsh(0.5 * (m + m.conj().T))
    return float(np.sum(np.sqrt(np.clip(wm, 0.0, None))) ** 2)


def phase_gate():
    import torch
    from noisyquantumsimulator_tpu_torch.core.configs import (
        SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import simulate_cz_gate
    ref = _host_reference_states(_plan(3))
    out = {}
    for dt, tol in ((torch.complex64, 1e-4), (torch.complex128, 1e-10)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t0 = time.perf_counter()
            r = simulate_cz_gate(SmoothJPSimulationInputs(), device="cuda",
                                 dtype=dt)
            wall = time.perf_counter() - t0
        F, phase = r.avg_fidelity, r.phase_info["controlled_phase_deg"]
        par = max(abs(1.0 - _uhlmann(r.results[k].astype(np.complex128), ref[i]))
                  for i, k in enumerate(("00", "01", "10", "11")))
        require(np.isfinite(F) and 0.97 <= F <= 0.99, f"F = {F} in [0.97, 0.99]")
        require(par <= tol, f"{dt} state parity {par:.3e} > {tol}")
        out[str(dt)] = F
        say("5 gate", f"simulate_cz_gate cuda {dt}: F = {F:.9f}, controlled "
            f"phase = {phase:.6f} deg, max|1 - F_state| vs host c128 = "
            f"{par:.3e} (tol {tol}); first call {wall:.2f} s")
    return out


def phase_sweep(F_c64, errs_k1, errs_k2):
    import torch
    from noisyquantumsimulator_tpu_torch import bench_gate
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)

    sizes = ((3, 32768), (4, 8192))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        work = {dim: bench_gate.build_workload(batch, 300, torch.complex64,
                                               dim=dim, device="cuda")
                for dim, batch in sizes}

    # --- the main path, counted: only the sweep runs between reset and read
    fused_masked_squaring.launches = 0
    evolve_real_phased_many_cuda.launches = 0
    rates, F_one = {}, None
    for dim, batch in sizes:
        step, scales, _ = work[dim]
        fids = step(scales)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fids = step(scales)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        rates[dim] = batch / med
        require(fids.shape == (batch,) and bool(torch.isfinite(fids).all()),
                "sweep fidelities finite, one per sim")
        require(0.5 < float(fids.min()) and float(fids.max()) <= 1.0 + 1e-4,
                "sweep fidelities in (0.5, 1]")
        if dim == 3:
            F_one = float(step(torch.ones(1, dtype=torch.float32, device="cuda")))
        say("6 sweep", f"dim {dim} batch {batch} complex64: median {med * 1e3:.3f}"
            f" ms of 5 -> {rates[dim]:.1f} sims/s (times ms "
            f"{[round(t * 1e3, 3) for t in times]}); F range "
            f"[{float(fids.min()):.6f}, {float(fids.max()):.6f}]")
    launches = {"K1": evolve_real_phased_many_cuda.launches,
                "K2": fused_masked_squaring.launches}
    say("6 sweep", f"launches in the sweep run: K1 {launches['K1']}, "
        f"K2 {launches['K2']}")
    require(launches["K1"] > 0 and launches["K2"] > 0, "both kernels launched")
    require(abs(F_one - F_c64) <= 1e-6,
            f"sweep F at scale 1.0 ({F_one:.9f}) = phase 5 F ({F_c64:.9f})")
    say("6 sweep", f"F at scale 1.0 = {F_one:.9f} (phase 5 complex64: "
        f"{F_c64:.9f})")

    # --- kernel vs twin times at the sweep's own shapes (not counted)
    timing = {}
    for dim, batch in sizes:
        plan = work[dim][2]
        U, cq, ph, x0, D, P = _host_scan_inputs(plan)
        scales = work[dim][1]
        args = [torch.as_tensor(a, device="cuda").to(torch.float32)
                for a in (U, cq, ph, x0)]
        phases_bn = scales[:, None] * args[2][None]
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: evolve_real_phased_many_cuda(args[0], args[1], phases_bn,
                                                 args[3], D, P),
            lambda: _evolve_real_phased_many_plain(args[0], args[1], phases_bn,
                                                   args[3], D, P), reps=3)
        timing[("K1", dim)] = (k_ms, p_ms)
        say("6 sweep", f"K1 dim {dim} (B={batch}, S=5, n={D + 2 * P}, 300 steps,"
            f" f32): kernel {k_ms:.3f} ms, plain twin {p_ms:.3f} ms")
        R, s, ms = _squaring_inputs(plan, 1, torch.complex64, "cuda")
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: fused_masked_squaring(R, s, ms),
            lambda: _masked_squaring_plain(R, s, ms), reps=50)
        timing[("K2", dim)] = (k_ms, p_ms)
        say("6 sweep", f"K2 dim {dim} (B=1, N={R.shape[-1]}, {ms} trips, "
            f"complex64): kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} ms")

    kernels = [
        {"name": "K1 phase_scan", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": launches["K1"],
         "max_abs_err": errs_k1[(3, "torch.float32")],
         "ms": timing[("K1", 3)][0], "plain_ms": timing[("K1", 3)][1],
         "shape": "dim 3: B=32768 S=5 n=81 300 steps f32"},
        {"name": "K2 masked_squaring", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"],
         "max_abs_err": errs_k2[(1, 81, "torch.complex64")],
         "ms": timing[("K2", 3)][0], "plain_ms": timing[("K2", 3)][1],
         "shape": "dim 3: B=1 N=81 complex64"},
    ]
    return kernels


def main() -> int:
    dev = phase_device()
    if dev is None:
        print("[1 device] FAIL: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    name, count = dev
    phase_build()
    rng = np.random.default_rng(SEED)
    errs_k1 = phase_k1(rng)
    errs_k2 = phase_k2()
    F = phase_gate()
    kernels = phase_sweep(F["torch.complex64"], errs_k1, errs_k2)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
