"""The reference's benchmark records on the port: gate sims/s against the
zvode baseline with four parity tiers, the BB-LDPC record, the surface-code
record and the suite that runs them.

Counterpart of the repository's root `bench.py`, function for function.

* `main` (`--one-gate`, `--dim4`, `--batch`, `--steps`, `--curve`,
  `--engine`, `--prec`): sims/s of the batched smooth-JP CZ sweep
  (`bench_gate.build_workload`; kernels K2 and K1), the same gate integrated
  by the host zvode oracle at the reference tolerances (the baseline), and
  the worst 1 - F over the 4 basis states against that oracle at four
  tiers: complex64 and real float32 on the device, host complex128, and
  complex128 on the device.
* `main_bb` (`--bb`): the gross code's sample + tiered BP (kernel K3) +
  host OSD-0 record (`bench_bb.build_bb_workload`).
* `--qec`: the surface-code record, `bench_qec.main_qec`.
* no record flag: the suite (`main_all`; `--full` for the deep budgets),
  each record in its own child process, merged into BENCH_H100.json at the
  repository root (or `--out PATH`); its last line is `compact_summary_line`,
  and it exits 1 when a record failed.

Every entry point runs on the card unless `--device cpu` (or device="cpu")
is given; without a CUDA device it raises.

    python -m noisyquantumsimulator_tpu_torch.bench --one-gate
    python -m noisyquantumsimulator_tpu_torch.bench --one-gate --dim4
    python -m noisyquantumsimulator_tpu_torch.bench --bb --shots 65536
    python -m noisyquantumsimulator_tpu_torch.bench
    python -m noisyquantumsimulator_tpu_torch.bench --one-gate --batch 8 \\
        --steps 20 --device cpu

A record prints as one JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .bench_bb import build_bb_workload
from .bench_gate import build_workload
from .bench_qec import _generator, _sync, main_qec, record_line
from .gate.simulate import plan_phase_frame, plan_squaring_bound
from .ops.hamiltonians import drive_operator
from .ops.hilbert import HS3, HS4
from .ops.lindblad import build_all_noise_operators, static_hamiltonian
from .solver.propagator import evolve_rhos_phased, uniform_base_propagator
from .solver.real_rep import (build_real_rep, evolve_real_phased,
                              from_real_coords, real_propagator_device,
                              to_real_coords)
from .solver.reference import mesolve_zvode
from .utils.math import wilson_ci

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "BENCH_H100.json"


def _device(device: Union[str, torch.device]) -> torch.device:
    """The device a record runs on; a CUDA device that is not there raises
    (nothing carries on on the CPU unless the caller asked for it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark runs on the card; "
                           "pass --device cpu (device='cpu') to run it on "
                           "the CPU")
    return dev


def card() -> Tuple[Optional[str], Optional[str]]:
    """(name, power limit) of the first card as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them; (None, None) where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None, None
    if not out:
        return None, None
    name, _, limit = out[0].rpartition(", ")
    return name or None, limit or None


def run_baseline_zvode(plan, n_states: int = 4):
    """(seconds, final rhos (n_states, D, D)) for the gate integrated by the
    host zvode oracle at the reference tolerances (atol 1e-10, rtol 1e-8).

    The per-segment Hamiltonians and collapse operators are rebuilt from the
    plan's scalar metadata (rates, detunings, polarization), not taken from
    its L0 / C+ / C-, so the parity numbers also check the planner's
    Liouvillian assembly. Works at dim 3 and at the mJ-resolved dim 4."""
    hs = HS3 if plan.hilbert_space_dim == 3 else HS4
    pol = plan.pulse_info.get("polarization", "sigma+")
    zs = plan.pulse_info.get("zeeman_splitting_r", 0.0)
    S = drive_operator(hs, polarization=pol)
    amps = np.asarray(plan.schedule.amps)
    phases = np.asarray(plan.schedule.phases)
    dts = np.asarray(plan.schedule.dts)
    H_static = static_hamiltonian(hs, plan.Delta, plan.V, plan.delta_zeeman,
                                  plan.delta_stark, plan.trap_laser_on,
                                  zeeman_splitting=zs)
    Hsegs = [H_static + 0.5 * plan.Omega * a
             * (np.exp(1j * p) * S + np.exp(-1j * p) * S.conj().T)
             for a, p in zip(amps, phases)]
    nb = plan.noise_breakdown
    c_ops, _ = build_all_noise_operators(
        hs=hs, gamma_r=nb.get("gamma_r", 0.0),
        gamma_bbr=nb.get("gamma_bbr", 0.0),
        gamma_phi_laser=nb.get("gamma_phi_laser", 0.0),
        gamma_phi_thermal=nb.get("gamma_phi_thermal", 0.0),
        gamma_phi_zeeman=nb.get("gamma_phi_zeeman", 0.0),
        gamma_loss_antitrap=nb.get("gamma_loss_antitrap", 0.0),
        gamma_loss_background=nb.get("gamma_loss_background", 0.0),
        gamma_scatter_intermediate=nb.get("gamma_scatter_intermediate", 0.0),
        gamma_leakage=nb.get("gamma_leakage", 0.0),
        branching_1=nb.get("branching_1", 0.5),
        mJ_leakage_rate=nb.get("mJ_leakage_rate", 0.0))

    rhos = []
    t0 = time.perf_counter()
    for i in range(n_states):
        rhos.append(mesolve_zvode(Hsegs, dts, plan.rho0s[i], c_ops,
                                  atol=1e-10, rtol=1e-8))
    return time.perf_counter() - t0, np.stack(rhos)


def _state_fidelity(rho, sigma):
    """Uhlmann fidelity (tr sqrt(sqrt(rho) sigma sqrt(rho)))^2 via eigh
    (robust for the near-pure states here, unlike scipy.sqrtm)."""
    rho = np.asarray(rho, np.complex128)
    sigma = np.asarray(sigma, np.complex128)
    w, v = np.linalg.eigh(0.5 * (rho + rho.conj().T))
    s = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.conj().T
    m = s @ sigma @ s
    wm = np.linalg.eigvalsh(0.5 * (m + m.conj().T))
    return float(np.sum(np.sqrt(np.clip(wm, 0.0, None))) ** 2)


def _phase_frame_numpy_x64(plan):
    """Host complex128 implementation of the same phase-frame algorithm
    (scipy expm + ordered product): the x64 verification tier."""
    from scipy.linalg import expm as sexpm
    g = plan_phase_frame(plan)
    amps = np.asarray(plan.schedule.amps)
    dts = np.asarray(plan.schedule.dts)
    ph = np.asarray(plan.schedule.phases, np.float64)
    Ub = sexpm((plan.L0 + amps[0] * (plan.Cp + plan.Cm)) * dts[0])
    U = np.eye(Ub.shape[0], dtype=np.complex128)
    prev = None
    for k in range(len(ph)):
        W = Ub if prev is None else \
            Ub * np.exp(1j * (prev - ph[k]) * g)[None, :]
        U = W @ U
        prev = ph[k]
    U = (np.exp(1j * ph[-1] * g)[:, None] * U
         * np.exp(-1j * ph[0] * g)[None, :])
    D = plan.rho0s.shape[-1]
    vec = plan.rho0s[:4].reshape(4, D * D)
    return (vec @ U.T).reshape(4, D, D)


def _put(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on dev in dtype (cast from 128/64-bit numpy)."""
    src = np.complex128 if dtype.is_complex else np.float64
    return torch.as_tensor(np.asarray(a, src), device=dev).to(dtype)


def measure_parity_f64_device(plan, device: Union[str, torch.device] = "cuda"):
    """The 64-bit device tier. The reference ran the phase-frame algorithm
    on two float64 planes (its TPU has no complex128); on the card this tier
    is a plain complex128 run: U_base by the batched expm (K2 squares) with
    plan_squaring_bound + 1 squarings at most, then the complex phase-frame
    scan. Returns the final (4, D, D) states and the seconds of one scan
    (after a warm-up call; the host copy included, as the reference's)."""
    dev = _device(device)
    cdt = torch.complex128
    g = plan_phase_frame(plan)
    amp0 = float(np.asarray(plan.schedule.amps)[0])
    dt0 = float(np.asarray(plan.schedule.dts)[0])
    L0, Cp, Cm = (_put(a, cdt, dev) for a in (plan.L0, plan.Cp, plan.Cm))
    rho0s = _put(plan.rho0s[:4], cdt, dev)
    gd = _put(g, torch.float64, dev)
    phd = _put(plan.schedule.phases, torch.float64, dev)
    Ub = uniform_base_propagator(L0, Cp, Cm, amp0, dt0,
                                 max_squarings=plan_squaring_bound(plan) + 1)
    evolve_rhos_phased(Ub, gd, phd, rho0s)             # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    rh = evolve_rhos_phased(Ub, gd, phd, rho0s).cpu().numpy()
    return rh, time.perf_counter() - t0


def measure_parity(plan, rhos_zvode, prec: str = "highest",
                   device: Union[str, torch.device] = "cuda"):
    """Worst-case 1 - F(device state, zvode-oracle state) over the 4
    computational basis states, at four tiers. Returns (complex64 scan,
    host x64, complex128 on the device, seconds of the complex128 scan,
    float32 real-basis scan)."""
    if prec != "highest":
        raise ValueError(f"prec={prec!r}: the port pins full FP32 products; "
                         "only 'highest' is ported")
    dev = _device(device)
    cdt, rdt = torch.complex64, torch.float32
    g = plan_phase_frame(plan)
    L0, Cp, Cm = (_put(a, cdt, dev) for a in (plan.L0, plan.Cp, plan.Cm))
    rho0s = _put(plan.rho0s[:4], cdt, dev)
    phases = _put(plan.schedule.phases, rdt, dev)
    Ub = uniform_base_propagator(
        L0, Cp, Cm, float(np.asarray(plan.schedule.amps)[0]),
        float(np.asarray(plan.schedule.dts)[0]),
        max_squarings=plan_squaring_bound(plan))
    rhos_host = evolve_rhos_phased(Ub, _put(g, rdt, dev), phases,
                                   rho0s).cpu().numpy()
    errs = [1.0 - _state_fidelity(rhos_host[i], rhos_zvode[i])
            for i in range(4)]
    # the real Hermitian-basis throughput engine's own tier (kernel K1)
    D = plan.rho0s.shape[-1]
    rep = build_real_rep(g, D)
    Wr, Wi, cq = (_put(a, rdt, dev) for a in (rep.Wr, rep.Wi, rep.cq))
    xf = evolve_real_phased(real_propagator_device(Ub, Wr, Wi), cq, phases,
                            to_real_coords(rho0s, Wr, Wi), D, rep.P)
    rhos_real = from_real_coords(xf, Wr, Wi).cpu().numpy()
    errs_real = [1.0 - _state_fidelity(rhos_real[i], rhos_zvode[i])
                 for i in range(4)]
    rhos_x64 = _phase_frame_numpy_x64(plan)
    errs64 = [1.0 - _state_fidelity(rhos_x64[i], rhos_zvode[i])
              for i in range(4)]
    rhos_f64dev, t_f64 = measure_parity_f64_device(plan, dev)
    errs_f64 = [1.0 - _state_fidelity(rhos_f64dev[i], rhos_zvode[i])
                for i in range(4)]
    return (float(np.max(np.abs(errs))), float(np.max(np.abs(errs64))),
            float(np.max(np.abs(errs_f64))), t_f64,
            float(np.max(np.abs(errs_real))))


def _sims_per_sec(step, scales, batch, reps=10):
    """The reference's definition: one warm-up call, then `reps` steps
    queued back to back and one fence (the mean fidelity read on the host)
    at the end; sims/s = batch * reps / wall seconds."""
    out = step(scales)
    float(out.sum())                       # warm-up fence
    t0 = time.perf_counter()
    for _ in range(reps):
        out = step(scales)
    mean_f = float(out.mean())             # fences the whole in-order queue
    dt = time.perf_counter() - t0
    return batch * reps / dt, mean_f


_CURVE = (128, 512, 2048, 4096, 8192, 16384, 32768, 65536)


def main(batch: int = 128, n_steps: int = 300, curve: bool = False,
         dim: int = 3, prec: str = "highest", engine: str = "real",
         device: Union[str, torch.device] = "cuda") -> dict:
    """The gate record: prints it as one JSON line and returns it."""
    dev = _device(device)
    step, scales, plan = build_workload(batch, n_steps, dim=dim, prec=prec,
                                        engine=engine, device=dev)
    sims_per_sec, mean_f = _sims_per_sec(step, scales, batch)

    batch_curve = []
    if curve:
        for b in _CURVE:
            if b == batch:
                batch_curve.append({"batch": b,
                                    "sims_per_sec": round(sims_per_sec, 2)})
                continue
            s2, sc2, _ = build_workload(b, n_steps, dim=dim, prec=prec,
                                        engine=engine, device=dev)
            v, _ = _sims_per_sec(s2, sc2, b)
            batch_curve.append({"batch": b, "sims_per_sec": round(v, 2)})

    t_ref, rhos_zvode = run_baseline_zvode(plan)
    baseline_sims_per_sec = 1.0 / t_ref
    (parity_err, parity_err_x64, parity_err_f64dev,
     t_f64dev, parity_err_real) = measure_parity(plan, rhos_zvode, prec=prec,
                                                 device=dev)

    # useful-math FLOP accounting per sim (unpadded superoperator algebra; a
    # complex matmul is 8 M K N real FLOPs, the real engine's 2 M K N): one
    # (n_states, D^2) x (D^2, D^2) shared-weight product plus elementwise
    # phase rotations per segment; the shared U_base expm is amortized
    D2 = plan.L0.shape[0]
    n_states = plan.rho0s.shape[0]
    mm = 2 if engine == "real" else 8
    flops_per_sim = n_steps * (mm * n_states * D2 ** 2 + 20 * n_states * D2)
    achieved_gflops = sims_per_sec * flops_per_sim / 1e9

    out = {
        "metric": "cz_lindblad_sims_per_sec",
        "value": round(sims_per_sec, 2),
        "unit": "sims/s",
        "vs_baseline": round(sims_per_sec / baseline_sims_per_sec, 2),
        "baseline_sims_per_sec": round(baseline_sims_per_sec, 4),
        "baseline": "zvode CPU, 4 basis states x 300 segments, atol 1e-10 rtol 1e-8",
        "batch": batch,
        "n_segments": n_steps,
        "hilbert_dim": dim,
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "power_limit": card()[1] if dev.type == "cuda" else None,
        "dtype": "float32 (real Hermitian basis)" if engine == "real"
                 else "complex64",
        "matmul_precision": prec,
        "mean_fidelity": round(mean_f, 6),
        "parity_err_throughput_path_vs_zvode": (
            parity_err_real if engine == "real" else parity_err),
        "parity_err_c64_vs_zvode": parity_err,
        "parity_err_real_f32_vs_zvode": parity_err_real,
        "parity_err_x64_vs_zvode": parity_err_x64,
        # on the card this tier is complex128 (the reference: float64 planes)
        "parity_err_f64_device_vs_zvode": parity_err_f64dev,
        "f64_device_sims_per_sec": round(1.0 / t_f64dev, 2),
        "achieved_useful_gflops": round(achieved_gflops, 1),
        "engine": ("phase-frame, real Hermitian basis: one expm + "
                   "shared-weight REAL matvec scan (solver/real_rep.py)"
                   if engine == "real" else
                   "phase-frame: one expm + shared-weight matvec scan"),
    }
    if batch_curve:
        out["batch_curve"] = batch_curve
    print(json.dumps(out), flush=True)
    return out


def main_bb(rounds: int = 3, p: float = 1e-3, shots: int = 8192,
            fast_iters: int = 6, seed: int = 0, reps: int = 3,
            device: Union[str, torch.device] = "cuda") -> dict:
    """The gross-code [[144, 12, 12]] circuit-level memory record: sample +
    tiered DEM-BP on the device, native OSD-0 of the non-converged residue on
    the host inside the timed loop (`bench_bb.build_bb_workload`). Every rep
    is queued before the first is read, so the host OSD of rep r overlaps
    the device work of rep r + 1. A residue above its cap raises
    (RuntimeError): a silent undercount is not a result. Prints the record
    as one JSON line and returns it."""
    dev = _device(device)
    w = build_bb_workload(rounds, p, shots, fast_iters, dev)
    w.step(_generator(dev, 0))                                 # warm-up
    _sync(dev)

    t0 = time.perf_counter()
    fails = bad = 0
    outs = [w.e2e(_generator(dev, 1000 * seed + 100 + r)) for r in range(reps)]
    for f, b, dets_r, bel_r, obs_r in outs:
        nb = int(b)
        fails += int(f) + w.osd_host(nb, dets_r, bel_r, obs_r)
        bad += nb
    dt = time.perf_counter() - t0
    n_tot = shots * reps

    rec = {
        "metric": "gross_code_e2e_sample_bp_decode_shots_per_sec",
        "value": round(n_tot / dt, 0),
        "unit": "shots/s",
        "vs_baseline": None,
        "code": f"[[{w.n},{w.k}]]", "rounds": rounds, "p": p,
        "n_detectors": w.circuit.n_detectors,
        "n_mechanisms": w.decoder.n_mech,
        "backend": dev.type,
        "decoder": w.decoder_label,
        "e2e_p_logical_shot": fails / n_tot,
        "e2e_n_errors": fails,
        "e2e_n_decoded": n_tot,
        "e2e_p_logical_ci95": [float(x) for x in wilson_ci(fails, n_tot)],
        "bp_nonconverged_frac": bad / n_tot,
        "seed": seed,
    }
    print(json.dumps(rec), flush=True)
    return rec


def _flag(argv, name, default, cast=int):
    if name in argv:
        return cast(argv[argv.index(name) + 1])
    return default


def _git_commit() -> str:
    """Short commit hash for the records' provenance; "unknown" outside a
    git checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10, cwd=ROOT).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# The reference's record suites: names, arguments and time budgets (s).
_SUITE = [
    ("gate_dim3", ["--one-gate"], 300),
    ("gate_dim4", ["--one-gate", "--dim4"], 300),
    ("qec_d7", ["--qec", "--d", "7", "--rounds", "7",
                "--shots", str(1 << 20), "--reps-decode", "6"], 420),
    ("qec_d9", ["--qec", "--d", "9", "--rounds", "9",
                "--shots", str(1 << 18), "--decode-shots", str(1 << 17),
                "--reps-decode", "27"], 600),
    ("qec_d11", ["--qec", "--d", "11", "--rounds", "11",
                 "--shots", str(1 << 18), "--decode-shots", str(1 << 17),
                 "--reps-decode", "16"], 900),
    ("bb_ldpc", ["--bb", "--shots", str(1 << 16)], 420),
]

# --full: the deep-statistics budgets
_SUITE_FULL = [
    ("gate_dim3", ["--one-gate"], 1500),
    ("gate_dim4", ["--one-gate", "--dim4"], 1800),
    ("qec_d7", ["--qec", "--d", "7", "--rounds", "7",
                "--reps-decode", "8"], 1500),
    ("qec_d9", ["--qec", "--d", "9", "--rounds", "9",
                "--shots", str(1 << 19), "--decode-shots", str(1 << 19),
                "--reps-decode", "6"], 2400),
    ("qec_d11", ["--qec", "--d", "11", "--rounds", "11",
                 "--shots", str(1 << 19), "--decode-shots", str(1 << 19)],
     3000),
    ("bb_ldpc", ["--bb", "--shots", str(1 << 17)], 2400),
]


def _merge(path: Path, records: dict) -> dict:
    """Merge this run's records into the file at `path` by an atomic
    replace; returns what it wrote. Records of other workloads already there
    are kept; a record of this run replaces its name's older entry, a failed
    one with its error, so no stale result stands in for it. A suite cut
    short keeps every record it finished."""
    try:
        prev = json.loads(path.read_text())
    except (OSError, ValueError):
        prev = {}
    merged = dict(prev.get("records", {}))
    merged.update(records)
    head = merged.get("gate_dim3", {})
    out = dict(head) if "value" in head else {
        "metric": "cz_lindblad_sims_per_sec", "value": None,
        "unit": "sims/s", "vs_baseline": None}
    out["records"] = merged
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(json.dumps(out, indent=1))
    os.replace(tmp, path)
    return out


def main_all(full: bool = False, out: Union[str, Path, None] = None,
             suite: Optional[Sequence[Tuple[str, List[str], int]]] = None,
             device: str = "cuda") -> dict:
    """Run the suite: each record in its own child process
    (`python -m noisyquantumsimulator_tpu_torch.bench ARGS --device DEV`)
    with its time budget. Each finished record prints as one JSON line,
    stamped with the commit, the card's name and power limit and the
    child's wall seconds, and is merged into `out` (BENCH_H100.json at the
    repository root by default) at once; a record that failed or ran out of
    time prints and is merged as {"error": ...}. The last line printed is
    `compact_summary_line`. `suite` replaces the record list (tests pass a
    small one)."""
    _device(device)
    path = Path(out) if out is not None else DEFAULT_OUT
    suite = suite if suite is not None else (_SUITE_FULL if full else _SUITE)
    commit = _git_commit()
    name_, limit = card() if torch.device(device).type == "cuda" else (None, None)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    records = {}
    for name, args, tmo in suite:
        cmd = [sys.executable, "-m", "noisyquantumsimulator_tpu_torch.bench",
               *args, "--device", device]
        t0 = time.perf_counter()
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=tmo, cwd=ROOT, env=env)
            lines = [ln for ln in r.stdout.strip().splitlines()
                     if ln.startswith("{")]
            if r.returncode == 0 and lines:
                records[name] = json.loads(lines[-1])
            else:
                records[name] = {"error": (r.stderr or "no output")[-500:]}
        except subprocess.TimeoutExpired:
            records[name] = {"error": f"timeout after {tmo}s"}
        except (OSError, ValueError) as e:  # keep the suite alive
            records[name] = {"error": f"{type(e).__name__}: {e}"}
        wall = time.perf_counter() - t0
        if "value" in records[name]:
            records[name].update(generated_at_commit=commit, card=name_,
                                 wall_s=round(wall, 2))
            records[name].setdefault("power_limit", limit)
        rec = dict(records[name], record=name)
        print(json.dumps(rec), flush=True)
        print(f"# {name}: "
              + (f"{records[name].get('value')} "
                 f"{records[name].get('unit', '')} ({wall:.1f} s)"
                 if "value" in records[name]
                 else records[name]["error"][:120]),
              file=sys.stderr, flush=True)
        _merge(path, records)

    summary = _merge(path, records)
    print(compact_summary_line(summary), flush=True)
    return summary


def compact_summary_line(out: dict) -> str:
    """The suite's last line: the headline value plus a digest per record,
    at most 1500 characters (past that the digest is dropped). The full
    records are the lines printed before it and the file."""
    digest = {}
    for n, r in out.get("records", {}).items():
        if "value" not in r:
            digest[n] = {"error": str(r.get("error", ""))[:60]}
            continue
        d = {"value": r["value"], "unit": r.get("unit")}
        for k_src, k_dst in (("e2e_sample_decode_shots_per_sec", "e2e"),
                             ("e2e_p_logical_shot", "p_L"),
                             ("e2e_n_errors", "n_err")):
            if k_src in r:
                d[k_dst] = r[k_src]
        digest[n] = d
    head = {"metric": out.get("metric"), "value": out.get("value"),
            "unit": out.get("unit"), "vs_baseline": out.get("vs_baseline")}
    line = json.dumps({**head, "summary": digest})
    if len(line) > 1500:
        line = json.dumps(head)
    return line


def cli(argv: Sequence[str]) -> int:
    """The reference's dispatch on `argv` (sys.argv[1:]), plus `--device`
    and `--out`. Returns 1 when a record of the suite failed, else 0."""
    argv = list(argv)
    device = _flag(argv, "--device", "cuda", str)
    if "--qec" in argv:
        print(record_line(main_qec(
            d=_flag(argv, "--d", 7), rounds=_flag(argv, "--rounds", 7),
            shots=_flag(argv, "--shots", 1 << 20),
            decode_shots=_flag(argv, "--decode-shots", 1 << 17),
            reps_decode=_flag(argv, "--reps-decode", 3),
            seed=_flag(argv, "--seed", 0), device=_device(device))),
            flush=True)
    elif "--bb" in argv:
        main_bb(rounds=_flag(argv, "--rounds", 3),
                shots=_flag(argv, "--shots", 8192),
                seed=_flag(argv, "--seed", 0),
                reps=_flag(argv, "--reps", 3), device=device)
    elif any(f in argv for f in ("--one-gate", "--dim4", "--batch", "--steps",
                                 "--curve", "--prec")):
        dim4 = "--dim4" in argv
        main(batch=_flag(argv, "--batch", 8192 if dim4 else 32768),
             n_steps=_flag(argv, "--steps", 300),
             curve="--curve" in argv,
             dim=4 if dim4 else 3,
             prec=_flag(argv, "--prec", "highest", str),
             engine=_flag(argv, "--engine", "real", str),
             device=device)
    else:
        summary = main_all(full="--full" in argv,
                           out=_flag(argv, "--out", None, str), device=device)
        if any("value" not in r for r in summary["records"].values()):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
