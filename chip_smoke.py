#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one GPU: the CZ gate
engine and the BB-LDPC sample + BP decode path.

    python3 chip_smoke.py

Run from the root of the repository on a machine with an NVIDIA GPU (built
for sm_90a: H100 / H200), nvcc under $CUDA_HOME or /usr/local/cuda, and
PyTorch built for CUDA. It imports nothing of JAX. Phases, one status line
each; any failure raises and the script exits non-zero:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    nvcc builds csrc/*.cu (noisyquantumsimulator_tpu_torch/_build);
              ptxas registers and spills of K1 (no spills allowed)
  3. K1       the phase-scan kernel vs its plain twin at the bench layout
              (n = 81, S = 5, 300 steps, B = 1024; n = 256, B = 256), f32/f64
  4. K2       the masked-squaring kernel vs its twin on the main path's
              squaring inputs: (1, 81), (300, 81) and (1, 256), mixed s
  5. gate     simulate_cz_gate(SmoothJPSimulationInputs(), device="cuda") at
              complex64 and complex128 vs a host complex128 scipy reference
  6. sweep    the bench sweep (bench_gate.build_workload) at dim 3, batch
              32768, and dim 4, batch 8192: sims/s and the kernels' launch
              counts in that run; a torch.profiler window of 3 steps per dim
              (device idle share, K1's share of device time); then K1 vs its
              twin at the sweep's own shapes (f32, 1e-4 relative), each
              kernel's time vs its twin's, K1's TFLOP/s and share of its
              bounds, 300 x torch.mm of the per-step product (context), and
              torch.linalg.matrix_power beside K2
  7. K3       the min-sum c2v kernel vs its twin, bit-exact, at bf16 and f32
              on (26, 288, 65536), (26, 288, 512) and (7, 13, 1000), inputs
              with a padding slab, ties and exact zeros
  8. bb       the BB-LDPC memory path (bench_bb.build_bb_workload): gross
              code [[144,12]], 3 rounds, p = 1e-3, 65,536 shots, one warm-up
              rep and 3 timed reps queued before any sync: shots/s,
              p_logical with its Wilson CI, K3's launch count in that run;
              the card's tiered decode vs the CPU twin path on 4096 shots;
              then K3's time vs its twin's

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
# H100 SXM dense peaks (NVIDIA's data sheet, 700 W): FP32 outside the tensor
# cores, TF32 on them (a 3xTF32 product costs three), device memory.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
TRACE_DIR = "noisyquantumsimulator_tpu_torch/_build/traces"   # git-ignored
K1_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/phase_scan.cu"
K1_REPLACES = "noisyquantumsimulator_tpu/solver/scan_pallas.py:71"
K2_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/masked_squaring.cu"
K2_REPLACES = "noisyquantumsimulator_tpu/ops/expm_pallas.py:35"
K3_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/bp_c2v.cu"
K3_REPLACES = "noisyquantumsimulator_tpu/qec/bp_kernels.py:38"
K3_SHAPES = ((26, 288, 65536), (26, 288, 512), (7, 13, 1000))


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
    k1 = [r for r in _kernels.ptxas_report() if "phase_scan" in r[0]]
    require(len(k1) == 3, f"ptxas report of the 3 K1 kernels, got {len(k1)}")
    for name, regs, st, ld in k1:
        say("2 build", f"ptxas {name}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
        require(st == 0 and ld == 0, f"{name} spills")


def phase_k1(rng):
    import torch
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)
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
            say("3 K1", f"dim {dim} B={B} S={len(x0)} n={D + 2 * P} 300 steps "
                f"{dt}: max|kernel - twin| = {err:.3e} (max|ref| {scale:.3e}, "
                f"tol {tol} relative)")


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


def _profile_steps(step, scales, dim, n_steps=3):
    """torch.profiler over `n_steps` sweep steps: wall ms per step, the
    device's idle share within the kernels' span (1 - union of kernel,
    memcpy and memset intervals / span) and K1's share of device time."""
    import os
    import torch
    from torch.profiler import ProfilerActivity, profile
    step(scales)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(scales)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n_steps
    os.makedirs(TRACE_DIR, exist_ok=True)
    path = os.path.join(TRACE_DIR, f"sweep_dim{dim}_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = json.load(f)
    evs = evs["traceEvents"] if isinstance(evs, dict) else evs
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                  e.get("name", "")) for e in evs
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        return wall, None, None, path
    busy, end = 0.0, dev[0][0]
    for a, b, _ in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = end - dev[0][0]
    k1 = sum(b - a for a, b, name in dev if "phase_scan" in name)
    return wall, 1.0 - busy / span, k1 / busy, path


def _k1_bounds_ms(B, S, n, n_seg):
    """(FP32-pipe bound, 3xTF32 tensor-core bound, bytes bound) of one K1
    call, in ms: 2 R n^2 n_seg FLOPs for R = B S unpadded rows; bytes of
    v0, out, U^T and dphi read or written once."""
    flops = 2.0 * B * S * n * n * n_seg
    nbytes = 4.0 * (2 * B * S * n + n * n + B * n_seg)
    return (flops / PEAK_FP32 * 1e3, 3 * flops / PEAK_TF32 * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def phase_sweep(F_c64, errs_k2):
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
    rates, F_one, k1_launches = {}, None, {}
    for dim, batch in sizes:
        k1_before = evolve_real_phased_many_cuda.launches
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
        k1_launches[dim] = evolve_real_phased_many_cuda.launches - k1_before
        say("6 sweep", f"dim {dim} batch {batch} complex64: median {med * 1e3:.3f}"
            f" ms of 5 -> {rates[dim]:.1f} sims/s (times ms "
            f"{[round(t * 1e3, 3) for t in times]}); F range "
            f"[{float(fids.min()):.6f}, {float(fids.max()):.6f}]")
    launches = {"K1": evolve_real_phased_many_cuda.launches,
                "K2": fused_masked_squaring.launches}
    say("6 sweep", f"launches in the sweep run: K1 {launches['K1']} (dim 3 "
        f"{k1_launches[3]}, dim 4 {k1_launches[4]}), K2 {launches['K2']}")
    require(launches["K1"] == 13, "K1 launched once per sweep step (13)")
    require(launches["K2"] > 0, "K2 launched")
    require(abs(F_one - F_c64) <= 1e-6,
            f"sweep F at scale 1.0 ({F_one:.9f}) = phase 5 F ({F_c64:.9f})")
    say("6 sweep", f"F at scale 1.0 = {F_one:.9f} (phase 5 complex64: "
        f"{F_c64:.9f})")

    # --- traced window (not counted)
    for dim, batch in sizes:
        step, scales, _ = work[dim]
        wall, idle, k1_share, path = _profile_steps(step, scales, dim)
        if idle is None:
            say("6 sweep", f"dim {dim} profiler window: no device events in "
                f"{path}; idle share not measured")
        else:
            say("6 sweep", f"dim {dim} profiler window, 3 steps: wall "
                f"{wall * 1e3:.3f} ms/step, device idle share {idle:.4f}, K1 "
                f"{k1_share * 100:.2f}% of device time (trace {path})")

    # --- kernel vs twin at the sweep's own shapes: parity, then times (not
    # counted)
    timing, bounds, library, errs_k1 = {}, {}, {}, {}
    for dim, batch in sizes:
        plan = work[dim][2]
        U, cq, ph, x0, D, P = _host_scan_inputs(plan)
        S, n = x0.shape
        scales = work[dim][1]
        args = [torch.as_tensor(a, device="cuda").to(torch.float32)
                for a in (U, cq, ph, x0)]
        phases_bn = scales[:, None] * args[2][None]

        def kernel():
            return evolve_real_phased_many_cuda(args[0], args[1], phases_bn,
                                                args[3], D, P)

        def plain():
            return _evolve_real_phased_many_plain(args[0], args[1], phases_bn,
                                                  args[3], D, P)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        require(got.shape == (batch, S, n) and bool(torch.isfinite(got).all()),
                f"K1 dim {dim} output finite, shape ({batch}, {S}, {n})")
        require(err <= 1e-4 * scale,
                f"K1 dim {dim} B={batch} f32: max|d| {err:.3e} > 1e-4 * {scale:.3e}")
        errs_k1[dim] = err
        say("6 sweep", f"K1 dim {dim} at the sweep's shape (B={batch}, S={S}, "
            f"n={n}, 300 steps, f32): max|kernel - twin| = {err:.3e} (max|ref| "
            f"{scale:.3e}, tol 1e-4 relative)")
        del got, ref
        k_ms, p_ms = _kernel_vs_plain_ms(kernel, plain, reps=3)
        timing[("K1", dim)] = (k_ms, p_ms)
        fp32_ms, tc_ms, byte_ms = _k1_bounds_ms(batch, S, n, ph.shape[0])
        bounds[("K1", dim)] = (max(tc_ms, byte_ms),
                               "operations" if tc_ms >= byte_ms else "bytes")
        tflops = 2.0 * batch * S * n * n * ph.shape[0] / (k_ms * 1e-3) / 1e12
        say("6 sweep", f"K1 dim {dim} (B={batch}, S={S}, n={n}, 300 steps, f32):"
            f" kernel {k_ms:.3f} ms, plain twin {p_ms:.3f} ms; {tflops:.2f} "
            f"TFLOP/s = {fp32_ms / k_ms * 100:.1f}% of the FP32-pipe bound "
            f"{fp32_ms:.3f} ms, {tc_ms / k_ms * 100:.1f}% of the 3xTF32 bound "
            f"{tc_ms:.3f} ms (bytes bound {byte_ms:.4f} ms)")
        X = torch.randn(batch * S, n, device="cuda")
        UT = args[0].T.contiguous()
        mm_ms = _cuda_ms(lambda: [torch.mm(X, UT) for _ in range(300)], 1)
        mm_ms = min(mm_ms, _cuda_ms(lambda: [torch.mm(X, UT) for _ in range(300)], 1))
        say("6 sweep", f"context: 300 x torch.mm ({batch * S}, {n}) x ({n}, {n}) "
            f"f32 (TF32 off): {mm_ms:.3f} ms")
        del X

        R, s, ms = _squaring_inputs(plan, 1, torch.complex64, "cuda")
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: fused_masked_squaring(R, s, ms),
            lambda: _masked_squaring_plain(R, s, ms), reps=50)
        timing[("K2", dim)] = (k_ms, p_ms)
        s_data = int(s.clamp(max=ms).sum())          # squarings this data needs
        N = R.shape[-1]
        k2_ops = s_data * 8.0 * N ** 3
        k2_bytes = 2.0 * R.numel() * R.element_size()
        bounds[("K2", dim)] = (max(k2_ops / PEAK_FP32, k2_bytes / PEAK_BYTES) * 1e3,
                               "operations" if k2_ops / PEAK_FP32 >= k2_bytes / PEAK_BYTES
                               else "bytes")
        power = 2 ** int(s[0].clamp(max=ms))
        lib_fn = lambda: torch.linalg.matrix_power(R, power)
        lib_fn()
        lib_ms = min(_cuda_ms(lib_fn, 50), _cuda_ms(lib_fn, 50))
        lib_err = float((lib_fn() - fused_masked_squaring(R, s, ms)).abs().max())
        library[("K2", dim)] = lib_ms
        say("6 sweep", f"K2 dim {dim} (B=1, N={N}, {ms} trips, {s_data} "
            f"squarings, complex64): kernel {k_ms:.4f} ms, plain twin "
            f"{p_ms:.4f} ms, torch.linalg.matrix_power(R, {power}) {lib_ms:.4f} "
            f"ms (max|diff| {lib_err:.3e}); bound {bounds[('K2', dim)][0]:.6f} ms "
            f"({bounds[('K2', dim)][1]})")

    k1_note = ("no single PyTorch call computes the rotated 300-step scan; "
               "300 x torch.mm of the per-step product is printed as context")
    kernels = [
        {"name": f"K1 phase_scan dim {dim}", "route": "cuda", "source": K1_SOURCE,
         "replaces": K1_REPLACES, "launches": k1_launches[dim],
         "max_abs_err": errs_k1[dim],
         "ms": timing[("K1", dim)][0], "plain_ms": timing[("K1", dim)][1],
         "bound_ms": bounds[("K1", dim)][0], "bound_by": bounds[("K1", dim)][1],
         "library_ms": None, "library_note": k1_note,
         "shape": f"dim {dim}: B={batch} S=5 n={81 if dim == 3 else 256} "
                  "300 steps f32 (3xTF32 tensor cores)"}
        for dim, batch in sizes]
    kernels.append(
        {"name": "K2 masked_squaring", "route": "cuda", "source": K2_SOURCE,
         "replaces": K2_REPLACES, "launches": launches["K2"],
         "max_abs_err": errs_k2[(1, 81, "torch.complex64")],
         "ms": timing[("K2", 3)][0], "plain_ms": timing[("K2", 3)][1],
         "bound_ms": bounds[("K2", 3)][0], "bound_by": bounds[("K2", 3)][1],
         "library_ms": library[("K2", 3)],
         "library_call": "torch.linalg.matrix_power(R, 2**s)",
         "shape": "dim 3: B=1 N=81 complex64"})
    return kernels


def _c2v_inputs(rng, w, n_chk, S):
    """Messages (w, n_chk, S) and syndrome signs (n_chk, S), float32 numpy:
    normal LLR-like values with padding slabs (+1e30 in the trailing slots
    of some checks, as low-degree checks have), forced ties (slot 1 = slot
    0, and equal magnitudes of opposite sign) and exact zeros."""
    m = rng.standard_normal((w, n_chk, S), dtype=np.float32)
    m *= np.float32(4.0)
    m[w - 1, ::2] = 1e30
    if w > 3:
        m[w - 2, ::3] = 1e30
    m[1, :, ::7] = m[0, :, ::7]
    m[2, :, 3::11] = 0.0
    m[min(3, w - 1), 1::2, 5::13] = -m[0, 1::2, 5::13]
    sgn = np.where(rng.random((n_chk, S)) < 0.5, -1.0, 1.0).astype(np.float32)
    return m, sgn


def phase_k3():
    import torch
    from noisyquantumsimulator_tpu_torch import _kernels
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda
    lib = _kernels.load()
    require(lib.nqs_bp_c2v_max_slots() == bp_cuda.MAX_SLOTS,
            "K3 slot limit of the library = bp_cuda.MAX_SLOTS")
    rng = np.random.default_rng(SEED + 3)
    errs = {}
    for shape in K3_SHAPES:
        m, sgn = _c2v_inputs(rng, *shape)
        m32 = torch.as_tensor(m, device="cuda")
        s32 = torch.as_tensor(sgn, device="cuda")
        del m
        for dt in (torch.bfloat16, torch.float32):
            msg, ss = m32.to(dt), s32.to(dt)
            before = bp_cuda.c2v.launches
            got = bp_cuda.c2v(msg, ss, 0.75)
            require(bp_cuda.c2v.launches == before + 1, "K3 launch counted")
            ref = bp_cuda._c2v_plain(msg, ss, 0.75)
            torch.cuda.synchronize()
            require(got.shape == msg.shape and got.dtype == dt, "K3 output shape")
            require(bool(torch.isfinite(got.float()).all()), "K3 output finite")
            err = float((got.float() - ref.float()).abs().max())
            require(err == 0.0, f"K3 {shape} {dt}: max|kernel - twin| = {err:.3e}"
                    " (must be bit-exact)")
            errs[(shape, str(dt))] = err
            say("7 K3", f"{shape} {dt}: max|kernel - twin| = {err} (bit-exact "
                f"required); padding, ties and zeros in the input")
            del msg, ss, got, ref
        del m32, s32
        torch.cuda.empty_cache()
    return errs


def phase_bb(errs_k3):
    import torch
    from noisyquantumsimulator_tpu_torch import bench_bb
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda, native
    from noisyquantumsimulator_tpu_torch.qec.dem_decoder import (
        decoder_from_numpy)
    from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

    shots, reps = 65536, 3
    t0 = time.perf_counter()
    w = bench_bb.build_bb_workload(rounds=3, p=1e-3, shots=shots,
                                   fast_iters=6, device="cuda")
    dec = w.decoder
    say("8 bb", f"gross code [[{w.n},{w.k}]], 3 rounds, p = 1e-3: "
        f"{w.circuit.n_detectors} detectors, {dec.n_mech} mechanisms, "
        f"w_max {int(dec.H.sum(axis=1).max())}; host build "
        f"{time.perf_counter() - t0:.2f} s; {w.decoder_label}")
    t0 = time.perf_counter()
    native.build()
    say("8 bb", f"native OSD-0 library {native.library_path()} "
        f"({time.perf_counter() - t0:.2f} s, g++ {' '.join(native.CXX_FLAGS)})")

    def gen(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return g

    # warm-up rep (allocator, cuBLAS handles, the library load)
    f, b, dets_r, bel_r, obs_r = w.e2e(gen(SEED))
    w.osd_host(int(b), dets_r, bel_r, obs_r)
    torch.cuda.synchronize()

    # --- the main path, counted: only the timed reps run between reset and read
    bp_cuda.c2v.launches = 0
    t0 = time.perf_counter()
    fails = bad = 0
    # queue every rep before syncing any, so host OSD of rep r overlaps
    # the device work of rep r + 1
    outs = [w.e2e(gen(SEED + 100 + r)) for r in range(reps)]
    for f, b, dets_r, bel_r, obs_r in outs:
        nb = int(b)
        fails += int(f) + w.osd_host(nb, dets_r, bel_r, obs_r)
        bad += nb
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bp_cuda.c2v.launches
    n_tot = shots * reps
    rate = n_tot / wall
    p_l = fails / n_tot
    lo, hi = wilson_ci(fails, n_tot)
    say("8 bb", f"{reps} reps x {shots} shots in {wall:.4f} s -> {rate:.1f} "
        f"shots/s; e2e_n_errors = {fails}, p_logical = {p_l:.3e} (95% Wilson "
        f"CI [{lo:.3e}, {hi:.3e}]); non-converged fraction {bad / n_tot:.4e} "
        f"({bad} OSD residue rows, cap {w.cap} per rep); K3 launches in the "
        f"timed reps: {launches}")
    require(launches > 0, "K3 launched on the BB path")
    require(p_l <= 1e-4, f"p_logical_shot {p_l:.3e} <= 1e-4")

    # --- the card's tiered decode vs the CPU twin path on one detector batch
    o = w.sampler(gen(SEED + 7))
    batch = o["detectors"][:4096].to(torch.float32)
    kw = dict(n_iters=60, kernel="slots", fast_iters=w.fast_iters,
              fast_dtype=torch.bfloat16, retry_damping=0.5, retry_iters=90,
              retry_cap_divisor=128)
    cpu_dec = decoder_from_numpy(dec.H, dec.obs_mask, dec.probs, "cpu", **kw)
    cuda_dec = decoder_from_numpy(dec.H, dec.obs_mask, dec.probs, "cuda", **kw)
    pg, bg, _ = cuda_dec._full(batch)
    t0 = time.perf_counter()
    pc, bc, _ = cpu_dec._full(batch.cpu())
    cpu_s = time.perf_counter() - t0
    pg, bg = pg.cpu(), bg.cpu()
    agree = float((pg == pc).float().mean())
    say("8 bb", f"4096 shots, card vs CPU twin path: non-converged {int(bg.sum())}"
        f" vs {int(bc.sum())}, bad flags equal {bool(torch.equal(bg, bc))}, "
        f"predictions agree on {agree:.6f} (CPU {cpu_s:.2f} s)")
    require(torch.equal(bg, bc), "bad flags of the card and the CPU twin agree")
    require(agree >= 0.999, f"predictions agree on {agree:.6f} >= 0.999")

    # --- K3 vs twin times at the path's shapes (not counted)
    rng = np.random.default_rng(SEED + 8)
    timing = {}
    for shape, dt, reps_t in (((26, 288, 65536), torch.bfloat16, 20),
                              ((26, 288, 512), torch.float32, 200)):
        m, sgn = _c2v_inputs(rng, *shape)
        msg = torch.as_tensor(m, device="cuda").to(dt)
        ss = torch.as_tensor(sgn, device="cuda").to(dt)
        del m
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: bp_cuda.c2v(msg, ss, 0.75),
            lambda: bp_cuda._c2v_plain(msg, ss, 0.75), reps=reps_t)
        nbytes = 2 * msg.numel() * msg.element_size() + ss.numel() * ss.element_size()
        timing[shape] = (k_ms, p_ms, nbytes / PEAK_BYTES * 1e3)
        say("8 bb", f"K3 {shape} {dt}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f}"
            f" GB/s of {nbytes / 1e6:.1f} MB moved), plain twin {p_ms:.4f} ms")
        del msg, ss
        torch.cuda.empty_cache()
    shape = (26, 288, 65536)
    return {"name": "K3 bp_c2v", "route": "cuda", "source": K3_SOURCE,
            "replaces": K3_REPLACES, "launches": launches,
            "max_abs_err": errs_k3[(shape, "torch.bfloat16")],
            "ms": timing[shape][0], "plain_ms": timing[shape][1],
            "bound_ms": timing[shape][2], "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no single PyTorch call computes normalized "
                            "min-sum check-to-variable messages",
            "shape": "w_max=26 n_chk=288 S=65536 bf16"}


def main() -> int:
    dev = phase_device()
    if dev is None:
        print("[1 device] FAIL: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    name, count = dev
    phase_build()
    phase_k1(np.random.default_rng(SEED))
    errs_k2 = phase_k2()
    F = phase_gate()
    kernels = phase_sweep(F["torch.complex64"], errs_k2)
    errs_k3 = phase_k3()
    kernels.append(phase_bb(errs_k3))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
