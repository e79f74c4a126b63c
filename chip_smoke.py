#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one GPU: the CZ gate
engine, the BB-LDPC sample + BP decode path, the optimizer's forward and
gradient paths, the channel / calibration bridge, the Layer-1 primitive
backends (neutral atoms, trapped ions, cavity QED), the surface-code memory
path, the architecture loop (topology -> compiler -> scheduler ->
executor, and the exact circuit simulators), the multi-device layer on a
one-rank NCCL group, lattice surgery, the NN decoder, the reference's
bench.py records through the port's bench module, and every study of the
port's studies package (the gate, QEC and platform studies).

    python3 chip_smoke.py
    python3 chip_smoke.py --only k2          (phases 1, 2 and 9)
    python3 chip_smoke.py --only bb          (phases 1, 2, 7 and 8)
    python3 chip_smoke.py --only optimizer   (phases 1, 2, 9 and 10)
    python3 chip_smoke.py --only gradients   (phases 1, 2 and 11)
    python3 chip_smoke.py --only channel     (phases 1, 2 and 12)
    python3 chip_smoke.py --only primitives  (phases 1, 2 and 13)
    python3 chip_smoke.py --only surface     (phases 1, 2 and 14)
    python3 chip_smoke.py --only architecture  (phases 1, 2, 15 and 16)
    python3 chip_smoke.py --only parallel    (phases 1, 2 and 17)
    python3 chip_smoke.py --only surgery     (phases 1, 2 and 18)
    python3 chip_smoke.py --only bench       (phases 1, 2 and 19)
    python3 chip_smoke.py --only studies     (phases 1, 2 and 20)
    python3 chip_smoke.py --only platforms   (phases 1, 2 and 21)

Run from the root of the repository on a machine with an NVIDIA GPU (built
for sm_90a: H100 / H200), nvcc under $CUDA_HOME or /usr/local/cuda, and
PyTorch built for CUDA. It imports nothing of JAX. It holds each kernel's
wrapper against its twin at the main path's shapes, holds what no card test
of tests/test_torch_cuda.py holds, and times each kernel alone. The
benchmark's cells (nqs_bench/) time the entries end to end; phase 19's
records time the same entries once more through the bench.py CLI, as a
check of that CLI, and phases 1-10 time none. Phases, one status line each
(3 and 4, K1 and K2 against their twins at other shapes, are the card
tests'); any failure raises and the script exits non-zero:

  1. device   the card's name and its nvidia-smi name and power limit
  2. build    nvcc builds csrc/*.cu (noisyquantumsimulator_tpu_torch/_build);
              ptxas registers and spills of K1, K2, the population scan,
              the min-sum v2c kernel, OSD-0 and the sampler's fault walk (no
              spills allowed);
              the time of one empty kernel launch
  5. gate     simulate_cz_gate(SmoothJPSimulationInputs(), device="cuda") at
              complex64 and complex128 vs a host complex128 scipy reference
  6. sweep    the bench sweep (bench_gate.build_workload) at dim 3, batch
              32768, and dim 4, batch 8192: one step each, the fidelities'
              holds and the kernels' launch counts in that run; then K1 and
              K2 vs their twins at the sweep's own shapes (K1 f32, 1e-4
              relative; K2's U_base squaring, complex64, 1e-5 relative), each
              kernel's time vs its twin's, K1's TFLOP/s and share of its
              bounds, 300 x torch.mm of the per-step product (context), and
              torch.linalg.matrix_power beside K2
  7. K3       the library's slot and degree limits equal bp_cuda's
  8. bb       the BB-LDPC memory path (bench_bb.build_bb_workload): gross
              code [[144,12]], 3 rounds, p = 1e-3, 65,536 shots, one warm-up
              rep and 3 reps queued before any sync: p_logical with its
              Wilson CI, the launch counts of K3 and of the v2c kernel in
              that run (98 a rep each: 7 fast, 91 retry) and of the sampler
              kernel (one a rep); the card's tiered
              decode vs the CPU twin path on 4096 shots; then K3 and the
              v2c kernel vs their twins at the two tiers' shapes ((26, 288,
              65536) bf16 and (26, 288, 512) f32 for K3), both bit-exact,
              and their times; the step (OSD-0 on the card) launching the
              OSD-0 kernel once a rep with residue rows, then the kernel vs
              its twin, the host C++ OSD-0, bit for bit on 37 residue rows
              of the gross DEM, and both times; last the sampler kernel vs
              its twin, the op route, bit for bit on the op route's draws at
              the reps' shape (65536 shots x 2088 draws), its time with the
              layout it picks, with one thread a shot and the op route's,
              and its bound (Philox's integer operations, the rows' bytes)
  9. K2 batched  K2 vs its twin and torch.linalg.matrix_power at the shapes
              where it does real work (K2_BATCHED: optimizer populations,
              bang-bang segments, the per-segment engine at dim 3 and 4, the
              64-bit tier), uniform and mixed squaring counts; per shape the
              bound (the largest of operations, bytes and one empty launch)
              and which binds; mixed s must cost less than uniform s = max
 10. optimizer  the population objectives of optimize/engine.py at P = 1024:
              smooth JP (300 segments, float32 real core) and bang-bang (5
              segments, complex64): evaluations/s, K2 launches per call
              (exactly one; no autograd graph recorded), a profiler window
              of 3 bang-bang calls, 8 members against the complex128
              per-segment path; the population-scan kernel at the smooth-JP
              call's own operands ((1024, 81), S = 5, 300 steps, f32; one
              launch a call) against its twin, the batched-product loop:
              times, bounds, spills; the per-segment engine of one gate at dim 4
              against the phase-frame route; then optimize_cz_gate("smooth_jp",
              maxiter=10, popsize=15, grad_polish=False, seed=42): history
              does not increase, final fidelity no lower than at x0
 11. gradients  K2's autograd Function (forward K2, trips recomputed with
              K2, reverse loop in torch.matmul) against autograd through its
              twin at (1, 81) f32, (5, 81) c64 with s = 9..11, (2, 256) c64
              (tiled) and (4, 81) c128 mixed s; make_value_and_grad of smooth
              JP at x0, 300 segments: the float64 real core against the
              complex128 per-segment path, float32 against float64; the
              median ms of 5 value-and-grad calls (smooth JP float32, bang-bang
              complex64) and of 5 GRAPE Adam steps at 300 phases, each with
              its device idle share and K2 launches per call; then
              optimize_cz_gate("smooth_jp", maxiter=10, popsize=15, seed=42)
              with its default polish against grad_polish=False, and
              optimize_cz_gate("grape", grape_steps=50)
 12. channel    extract_cz_channel() at complex64 and complex128 against
              phase 5's host complex128 propagator (scipy expm, ordered
              product), projected alike: superop within 1e-4 / 1e-10, F_avg, mean leakage,
              CP/TP; calibrate_cz into a temporary CalibrationStore and read
              back; seconds per extraction and K2 launches; K2 at the
              channel's (300, 81) complex64 squaring inputs vs its twin
 13. primitives  simulate_fluorescence_readout() and simulate_sideband_cooling()
              at their defaults (540 x 540 and 81 x 81 float64 expms on the
              card) against a host scipy expm of the same generators (1e-10)
              and the shipped records; NeutralAtomBackend built from the
              default store (loads, writes nothing) and from an empty
              temporary store (CZ, Raman, cooling and readout generated on the
              card): construction and cz() times, summaries equal (CZ to 1e-4,
              the rest to 1e-10); simulate_ms_gate(n_fock=10) at the two
              regimes of the shipped trapped-ion records (19 expms of (1600,
              1600) complex128 a call) against those records (superop and F
              to 1e-10): seconds per call, K2 launches, peak device memory;
              IonBackend; K2 against its twin (1e-12 relative) and
              torch.linalg.matrix_power at the generators' squaring inputs,
              (1, 540) and (1, 539) float64 s = 6 (tiled: 16-byte and element
              copies), (1, 81) float64 s = 12 (resident), (7, 1600) complex128
              s = 4 (tiled), with their bounds
 14. surface    the surface-code memory path (bench_qec, the reference's
              `bench.py --qec` records qec_d7 and qec_d9): the fast sampler's
              detector rates at d = 7 over one 2^20-shot block against the
              DEM's analytic rates (5 sigma); the sampler kernel vs the op
              route at the decode's shape (131072 x 2576), as in phase 8;
              at each distance, 4096 shots
              decoded on the card against the native whole-shot exact DP
              (mode 1) on every shot the card certifies, and bit-identical
              to the port's CPU path (predictions and flags); then the
              records: sample shots/s (median of timed calls), end-to-end
              sample + exact decode + host escalation shots/s, p_L with its
              Wilson CI (must overlap BENCH_CANON.json's), escalated fraction,
              peak device memory, the idle share of one rep and its top
              device ops, and the sampler kernel's launches (one a sample).
              The sampler is the one kernel of the port that runs here: the
              decode is torch ops, as the reference's is XLA
 15. cavity     simulate_cavity_gate(n_fock=6) at the two regimes of the
              shipped cavity records (7 noise cases, one (1, 576, 576)
              complex128 expm each, K2 tiled) against those records and the
              host scipy engine (superop, F and budget to 1e-10): ms per call,
              K2 launches, peak device memory; every case's max_squarings
              against what the card needs; CavityBackend from the default
              store and from an empty temporary store (its in-process record,
              n_fock = 4, against the same on the CPU to 1e-12); K2 against
              its twin (1e-12 relative) and matrix_power at (1, 576) and
              (1, 256) complex128, with their bounds
 16. architecture  the d = 5 rotated-code extraction circuit (49 qubits, 520
              gates, 5 rounds) compiled onto a 9 x 9 grid for neutral atoms,
              trapped ions and cavity QED (native ops, SWAPs and makespan
              equal to the reference's); execute() at 2^20 shots with
              NeutralAtomBackend, IonBackend and CavityBackend (both regimes):
              seconds, device events and idle share of a call, every qubit's
              flip and phase rate within 5 sigma of its exact marginal; the
              cavity rows of the study's d = 3 memory experiment (p_L CI
              overlaps the study's); DensityMatrixSimulator on an 11-qubit
              and TrajectorySimulator (T = 16384) on a 13-qubit repetition
              code against the exact 2p(1 - p). Only K2 runs here among the
              port's kernels (phase 15); the rest is torch ops and host code
 17. parallel   a one-rank NCCL group (the card is one device; make_mesh(2) and
              dryrun_multichip(4) raise): entry() (K2, one launch) against its
              CPU run; dryrun_multichip(1) (sweep step, sharded QEC Monte
              Carlo, sharded DE; five K2 launches); complex128 evolve_rhos of
              the 32-segment problem against the host zvode oracle (1 - F
              within 1e-8), evolve_rhos_trajectory's last state against it
              (1e-12), total_propagator_phased against total_propagator at 300
              segments (1e-10); make_population_objective_sharded at P = 1024
              (phase 10's problem): costs equal to the unsharded objective's,
              one K2 launch a call, evaluations/s, 8 members against the
              complex128 per-segment path (1e-4), 2 DE generations;
              run_bb_memory_sharded on the gross code at p = 1e-2, 65536 shots,
              50 iterations: shots/s, p_L with its Wilson CI, convergence; its
              rank body on the card against the CPU on 4096 fixed error rows;
              K2 at entry()'s (32, 81) complex64 inputs against its twin
 18. surgery    run_zz_surgery(5) at 131072 shots: p = 0 silent, and at p =
              1e-3 every decoded rate (native exact matcher) below its raw
              rate; train_nn_decoder(d=3, p=3e-3, steps=300) on the card beats
              0.6 of the trivial decoder's p_L, its logits equal the CPU
              module's on 4096 rows (1e-5); d = 5 training timed. No kernel of
              the port runs here (torch ops and host C++)
 19. bench      the reference's bench.py records through the port's
              noisyquantumsimulator_tpu_torch.bench, in this process: main at
              dim 3 (batch 32768) and dim 4 (batch 8192) with the zvode
              baseline and the four parity tiers, main_bb (65536 shots, 3
              reps); each record printed, its keys equal to the reference's
              (written out below), K1, K2 and K3 launched during the records;
              the 32-bit tiers <= 1e-4 at dim 3 and <= 2e-4 at dim 4, the
              64-bit tiers <= 1e-8, mean F in 0.97-0.99, p_L <= 1e-4;
              validate_bangbang.run and diagnose_bb.sweep on the card (all
              checks pass, best area within 0.5 of 22.08; equal to the CPU's);
              compact_summary_line of the three records <= 1500 characters;
              K2 against its twin and matrix_power at the complex128 tier's
              squaring inputs, (1, 81) and (1, 256), with their bounds
 20. studies    the port's studies (noisyquantumsimulator_tpu_torch/studies/),
              each between a reset and a read of the three kernels' launch
              counts, held to the outputs the reference shipped under
              examples/: research_parameter_sweeps --quick (F to 1e-8 at
              complex128, the protocol sweeps to 1e-4); GRAPE, 400 Adam steps
              over 300 phases at complex64 (baseline F to 1e-4 relative and
              cost to 3e-3 relative of the shipped 32-bit run, final F at
              least 0.005 above the baseline and within 2e-4 of the shipped;
              the complex128 baseline equal to the JAX package's x64 value);
              qec_study --quick and qec_scale_study --small (p_L Wilson CIs
              overlap the shipped); decoder_accuracy_study at d = 7, 2^19
              shots (oracle, window and escalated CIs overlap, every shot
              certified); gross_code_study in full (0 errors, non-converged
              fraction within 2x of the shipped); then K2 at the sweeps' and
              GRAPE's most frequent squaring inputs, K1 at the gate's float64
              scan and K3 at the gross code's shape against their twins
 21. platforms  the platform studies, each between a reset and a read of the
              three kernels' launch counts, held to the outputs the reference
              shipped under examples/: the MS and cavity engine studies at
              full size (the engine fields to 1e-10 of ms_gate_engine.json /
              cavity_gate_engine.json, the analytic column to 1e-12, CPTP;
              each record written, into a temporary store, equal to the
              shipped record to 1e-10 but for the run's nbar and the names of
              the producing package and engine); ion_memory --quick (2^16
              shots a cell, all ten cells; every CI overlaps the shipped, the
              pricing equal to a fresh backend's and within 1e-12 of the
              shipped; decode seconds a cell); nn_decoder_study --small (NN
              p_L < 0.6 x trivial, the MWPM errors equal to the host decoder
              re-run on the same rows); multichip_scaling at the world sizes
              the cards allow (one NCCL rank a card; detector fraction within
              15% of the shipped CPU run's, the reduced counts the sum over
              ranks); generate_figures --quick data (each gate series' first
              point equal to the CPU's complex128 call to 1e-10, every F in
              (0, 1], smooth JP equal to phase 5's complex128 gate where
              phase 5 ran); the demo notebook's 8 code cells (F in 0.97-0.99;
              the optimized F and cost at least as good as the objective's
              at the literature parameters; memory p_L < 0.5; section 3
              equal to the figures' protocol comparison)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it prints no result and
exits with code 2.
"""
from __future__ import annotations

import json
import re
import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np

from tools.chip_common import (
    PEAK_BYTES, PEAK_FP32, PEAK_FP64, PEAK_INT32, PEAK_TF32, SEED, cuda_ms,
    gate_plan, host_scan_inputs, population_near)

K1_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/phase_scan.cu"
K1_REPLACES = "noisyquantumsimulator_tpu/solver/scan_pallas.py:71"
K2_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/masked_squaring.cu"
K2_REPLACES = "noisyquantumsimulator_tpu/ops/expm_pallas.py:35"
PSCAN_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/population_scan.cu"
K3_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/bp_c2v.cu"
K3_REPLACES = "noisyquantumsimulator_tpu/qec/bp_kernels.py:38"
V2C_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/bp_v2c.cu"
OSD0_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/osd0.cu"
SAMPLER_SOURCE = "noisyquantumsimulator_tpu_torch/csrc/fast_sampler.cu"
PHILOX_OPS = 70    # integer operations of one Philox4x32-10 call (10 rounds)
# the keys of the reference's bench.py records (main, main_bb), in its order;
# the port's gate record adds power_limit after device
GATE_KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_sims_per_sec",
             "baseline", "batch", "n_segments", "hilbert_dim", "backend",
             "device", "power_limit", "dtype", "matmul_precision",
             "mean_fidelity", "parity_err_throughput_path_vs_zvode",
             "parity_err_c64_vs_zvode", "parity_err_real_f32_vs_zvode",
             "parity_err_x64_vs_zvode", "parity_err_f64_device_vs_zvode",
             "f64_device_sims_per_sec", "achieved_useful_gflops", "engine")
BB_KEYS = ("metric", "value", "unit", "vs_baseline", "code", "rounds", "p",
           "n_detectors", "n_mechanisms", "backend", "decoder",
           "e2e_p_logical_shot", "e2e_n_errors", "e2e_n_decoded",
           "e2e_p_logical_ci95", "bp_nonconverged_frac", "seed")
# K2 at the shapes where it does real work: (B, N, dtype, max_squarings,
# squaring counts, who launches it). "mixed" draws s uniformly from 0..6.
K2_BATCHED = (
    (15, 81, "float32", 12, "3", "a default DE generation (popsize 15), real core"),
    (1024, 81, "float32", 12, "3", "a card-sized population, real core"),
    (1024, 81, "float32", 12, "mixed", "the same, members of different norms"),
    (1024, 81, "float32", 12, "6", "the same, every member at the mixed maximum"),
    (75, 81, "complex64", 12, "3", "bang-bang, 5 segments, P = 15"),
    (5120, 81, "complex64", 12, "3", "bang-bang, 5 segments, P = 1024"),
    (300, 81, "complex64", 4, "3", "per-segment engine of one gate, dim 3"),
    (300, 256, "complex64", 4, "3", "per-segment engine of one gate, dim 4"),
    (300, 256, "complex64", 12, "3", "the same under the default 12 trips"),
    (64, 81, "complex128", 12, "mixed", "the 64-bit parity tier"),
    (64, 81, "float64", 12, "mixed", "the 64-bit parity tier, real core"),
)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _kernel_vs_plain_ms(kernel, plain, reps):
    """Time both in turns (plain, kernel, kernel, plain) after a warm-up;
    returns (kernel ms, plain ms), each the mean of its two turns."""
    kernel(), plain()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_device():
    import torch
    if not torch.cuda.is_available():
        return None
    from noisyquantumsimulator_tpu_torch.bench import card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi_name, limit = card()
    require(smi_name is not None, "nvidia-smi reads the card's name and power limit")
    say("1 device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{count} device(s); device 0: {name}")
    print(f"{smi_name}, {limit}", flush=True)
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
    k2 = [r for r in _kernels.ptxas_report() if "masked_square" in r[0]]
    require(len(k2) == 12, f"ptxas report of the 12 K2 kernels, got {len(k2)}")
    stack = _kernels.ptxas_stack_report()
    for name, regs, st, ld in k2:
        route = "resident" if "resident" in name else "tiled"
        m = re.search(r"kernelI(.+?)EE?v", name)
        elem = m.group(1) if m else name
        say("2 build", f"ptxas K2 {route} <{elem}>: {regs} registers, spill "
            f"stores {st} B, spill loads {ld} B, stack frame {stack.get(name)} B")
    for name, _, st, ld in k2:
        require(st == 0 and ld == 0 and stack.get(name) == 0,
                f"{name} spills or keeps its register tiles on the stack")
    ps = [r for r in _kernels.ptxas_report() if "population_scan" in r[0]]
    require(len(ps) == 14, f"ptxas report of the 14 population-scan kernels, "
            f"got {len(ps)}")
    for name, regs, st, ld in ps:
        m = re.search(r"kernelI(.+?)Li(\d+)EE", name)
        what = f"<{m.group(1)}, {m.group(2)}>" if m else name
        say("2 build", f"ptxas population scan {what}: {regs} registers, spill "
            f"stores {st} B, spill loads {ld} B, stack frame {stack.get(name)} B")
        require(st == 0 and ld == 0, f"{name} spills")
    osd = [r for r in _kernels.ptxas_report() if "osd0_kernel" in r[0]]
    require(len(osd) == 1, f"ptxas report of the OSD-0 kernel, got {len(osd)}")
    for name, regs, st, ld in osd:
        say("2 build", f"ptxas OSD-0: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")
        require(st == 0 and ld == 0, f"{name} spills")
    v2c = [r for r in _kernels.ptxas_report() if "v2c_kernel" in r[0]]
    require(len(v2c) == 4, f"ptxas report of the 4 v2c kernels, got {len(v2c)}")
    for name, regs, st, ld in v2c:
        m = re.search(r"kernelI(.+?)Li(\d+)EE", name)
        what = f"<{m.group(1)}, {m.group(2)}>" if m else name
        say("2 build", f"ptxas v2c {what}: {regs} registers, spill stores {st} B, "
            f"spill loads {ld} B, stack frame {stack.get(name)} B")
        require(st == 0 and ld == 0, f"{name} spills")
    walk = [r for r in _kernels.ptxas_report() if "fault_walk_kernel" in r[0]]
    require(len(walk) == 2, f"ptxas report of the 2 sampler kernels, got {len(walk)}")
    for name, regs, st, ld in walk:
        what = "given draws" if "ILb1E" in name else "Philox"
        say("2 build", f"ptxas sampler fault walk ({what}): {regs} registers, spill "
            f"stores {st} B, spill loads {ld} B, stack frame {stack.get(name)} B")
        require(st == 0 and ld == 0, f"{name} spills")


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


def _empty_launch_ms():
    """The time of one empty kernel launch (csrc/empty_launch.cu), from
    2000 launches back to back between two CUDA events; best of 3."""
    import torch
    from noisyquantumsimulator_tpu_torch import _kernels
    lib = _kernels.load()
    stream = _kernels.stream_handle(torch.device("cuda", 0))

    def run():
        _kernels.check(lib, lib.nqs_empty_launch(stream), "empty launch")
    run()
    return min(cuda_ms(run, 2000) for _ in range(3))


def _k2_bound_ms(R, s, max_squarings, launch_ms):
    """K2's bound for these inputs, the largest of three times: operations
    (8 N^3 real FLOP per complex squaring, 2 N^3 per real one, for the
    min(s[b], max_squarings) squarings each matrix needs, at the FP32
    pipes' peak or the FP64 tensor cores'), bytes (R read once and written
    once) and one empty kernel launch. Returns (ms, which, the three terms)."""
    import torch
    N = R.shape[-1]
    per = 8.0 if R.dtype.is_complex else 2.0
    peak = PEAK_FP32 if R.dtype in (torch.float32, torch.complex64) else PEAK_FP64
    squarings = int(s.clamp(max=max_squarings).sum())
    terms = {"operations": squarings * per * N ** 3 / peak * 1e3,
             "bytes": 2.0 * R.numel() * R.element_size() / PEAK_BYTES * 1e3,
             "launch": launch_ms}
    which = max(terms, key=terms.get)
    return terms[which], which, terms


def phase_k2_batched(launch_ms):
    """Phase 9: K2 against its plain twin and torch.linalg.matrix_power at
    the batched shapes of K2_BATCHED, each with its bound: the largest of
    operations, bytes and one empty launch (`launch_ms`). Returns the rows
    by (B, N, dtype, max_squarings, s)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    rows = {}
    for B, N, dtname, ms, skind, who in K2_BATCHED:
        dt = getattr(torch, dtname)
        R = torch.randn((B, N, N), dtype=dt, device="cuda", generator=gen)
        R = torch.eye(N, dtype=dt, device="cuda") + R * (0.05 / N ** 0.5)
        if skind == "mixed":
            s = torch.randint(0, 7, (B,), device="cuda", generator=gen,
                              dtype=torch.int32)
        else:
            s = torch.full((B,), int(skind), device="cuda", dtype=torch.int32)
        tol = 1e-5 if dtname in ("float32", "complex64") else 1e-12
        before = fused_masked_squaring.launches
        got = fused_masked_squaring(R, s, ms)
        per_chain = fused_masked_squaring.launches - before
        ref = _masked_squaring_plain(R, s, ms)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        require(got.shape == R.shape and got.dtype == dt, "K2 output shape")
        require(bool(torch.isfinite(torch.view_as_real(got) if dt.is_complex
                                    else got).all()), "K2 output finite")
        require(err <= tol * scale, f"K2 ({B}, {N}) {dtname} s={skind}: "
                f"{err:.3e} > {tol} * {scale:.3e}")
        del got, ref
        reps = 3 if B * N * N > 4e6 else 20
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: fused_masked_squaring(R, s, ms),
            lambda: _masked_squaring_plain(R, s, ms), reps)
        lib_ms = None
        if skind != "mixed":
            power = 2 ** min(int(skind), ms)
            lib_fn = lambda: torch.linalg.matrix_power(R, power)
            lib_fn()
            lib_ms = min(cuda_ms(lib_fn, reps), cuda_ms(lib_fn, reps))
        bound, which, terms = _k2_bound_ms(R, s, ms, launch_ms)
        rows[(B, N, dtname, ms, skind)] = dict(
            ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, err=err, terms=terms,
            binds=which)
        lib_txt = "none (s differs per matrix)" if lib_ms is None else \
            f"{lib_ms:.4f} ms ({lib_ms / k_ms:.2f}x K2's time)"
        say("9 K2 batched", f"({B}, {N}) {dtname} max_squarings={ms} s={skind} "
            f"[{who}]: max|kernel - twin| = {err:.3e} (max|ref| {scale:.3e}, tol "
            f"{tol} relative); K2 {k_ms:.4f} ms in {per_chain} launch(es), plain "
            f"twin {p_ms:.4f} ms, matrix_power {lib_txt}; bound {bound:.5f} ms "
            f"({which}; operations {terms['operations']:.5f}, bytes "
            f"{terms['bytes']:.5f}, launch {terms['launch']:.5f}) -> "
            f"{bound / k_ms * 100:.1f}% of the bound")
        del R, s
        torch.cuda.empty_cache()
    mixed = rows[(1024, 81, "float32", 12, "mixed")]["ms"]
    full = rows[(1024, 81, "float32", 12, "6")]["ms"]
    say("9 K2 batched", f"(1024, 81) float32: mixed s in 0..6 {mixed:.4f} ms "
        f"against uniform s = 6 {full:.4f} ms")
    require(mixed < full, "masked trips cost less than squarings")
    t12 = rows[(300, 256, "complex64", 12, "3")]["ms"]
    t4 = rows[(300, 256, "complex64", 4, "3")]["ms"]
    say("9 K2 batched", f"(300, 256) complex64, s = 3: 12 trips {t12:.4f} ms "
        f"against 4 trips {t4:.4f} ms (the tiled route's masked trips return "
        "before any load)")
    require(t12 < 1.15 * t4, "masked trips of the tiled route move no matrix")
    return rows


def _host_reference_propagator(plan):
    """Host complex128 phase-frame propagator (scipy expm + ordered product),
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
    return np.exp(1j * ph[-1] * g)[:, None] * U * np.exp(-1j * ph[0] * g)[None, :]


def _host_reference_states(plan):
    """The four computational states evolved by _host_reference_propagator."""
    U = _host_reference_propagator(plan)
    D = plan.rho0s.shape[-1]
    return (plan.rho0s[:4].reshape(4, D * D) @ U.T).reshape(4, D, D)


def _uhlmann(rho, sigma):
    w, v = np.linalg.eigh(0.5 * (rho + rho.conj().T))
    sq = (v * np.sqrt(np.clip(w, 0.0, None))) @ v.conj().T
    m = sq @ sigma @ sq
    wm = np.linalg.eigvalsh(0.5 * (m + m.conj().T))
    return float(np.sum(np.sqrt(np.clip(wm, 0.0, None))) ** 2)


def phase_gate():
    """Phase 5: the default gate at complex64 and complex128 against the
    host complex128 reference; returns each dtype's F."""
    import torch
    from noisyquantumsimulator_tpu_torch.core.configs import (
        SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import simulate_cz_gate
    ref = _host_reference_states(gate_plan(3))
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


def _share(by_name, *needles):
    """Share of the device time of `by_name` spent in kernels whose name
    holds one of `needles` (lower case)."""
    total = sum(by_name.values())
    return sum(t for name, t in by_name.items()
               if any(n in name.lower() for n in needles)) / total


def _k1_bounds_ms(B, S, n, n_seg):
    """(FP32-pipe bound, 3xTF32 tensor-core bound, bytes bound) of one K1
    call, in ms: 2 R n^2 n_seg FLOPs for R = B S unpadded rows; bytes of
    v0, out, U^T and dphi read or written once."""
    flops = 2.0 * B * S * n * n * n_seg
    nbytes = 4.0 * (2 * B * S * n + n * n + B * n_seg)
    return (flops / PEAK_FP32 * 1e3, 3 * flops / PEAK_TF32 * 1e3,
            nbytes / PEAK_BYTES * 1e3)


def phase_sweep(F_c64, launch_ms):
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
    F_one, k1_launches = None, {}
    for dim, batch in sizes:
        k1_before = evolve_real_phased_many_cuda.launches
        step, scales, _ = work[dim]
        fids = step(scales)
        torch.cuda.synchronize()
        require(fids.shape == (batch,) and bool(torch.isfinite(fids).all()),
                "sweep fidelities finite, one per sim")
        require(0.5 < float(fids.min()) and float(fids.max()) <= 1.0 + 1e-4,
                "sweep fidelities in (0.5, 1]")
        if dim == 3:
            F_one = float(step(torch.ones(1, dtype=torch.float32, device="cuda")))
        k1_launches[dim] = evolve_real_phased_many_cuda.launches - k1_before
        say("6 sweep", f"dim {dim} batch {batch} complex64: F range "
            f"[{float(fids.min()):.6f}, {float(fids.max()):.6f}]")
    launches = {"K1": evolve_real_phased_many_cuda.launches,
                "K2": fused_masked_squaring.launches}
    say("6 sweep", f"launches in the sweep run: K1 {launches['K1']} (dim 3 "
        f"{k1_launches[3]}, dim 4 {k1_launches[4]}), K2 {launches['K2']}")
    require(launches["K1"] == 3, "K1 launched once per sweep step (3)")
    require(launches["K2"] > 0, "K2 launched")
    require(abs(F_one - F_c64) <= 1e-6,
            f"sweep F at scale 1.0 ({F_one:.9f}) = phase 5 F ({F_c64:.9f})")
    say("6 sweep", f"F at scale 1.0 = {F_one:.9f} (phase 5 complex64: "
        f"{F_c64:.9f})")

    # --- kernel vs twin at the sweep's own shapes: parity, then times (not
    # counted)
    timing, bounds, library, errs_k1, errs_k2 = {}, {}, {}, {}, {}
    for dim, batch in sizes:
        plan = work[dim][2]
        U, cq, ph, x0, D, P = host_scan_inputs(plan)
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
        mm_ms = cuda_ms(lambda: [torch.mm(X, UT) for _ in range(300)], 1)
        mm_ms = min(mm_ms, cuda_ms(lambda: [torch.mm(X, UT) for _ in range(300)], 1))
        say("6 sweep", f"context: 300 x torch.mm ({batch * S}, {n}) x ({n}, {n}) "
            f"f32 (TF32 off): {mm_ms:.3f} ms")
        del X

        R, s, ms = _squaring_inputs(plan, 1, torch.complex64, "cuda")
        got = fused_masked_squaring(R, s, ms)
        ref = _masked_squaring_plain(R, s, ms)
        torch.cuda.synchronize()
        errs_k2[dim] = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        require(bool(torch.isfinite(torch.view_as_real(got)).all()),
                f"K2 dim {dim} output finite")
        require(errs_k2[dim] <= 1e-5 * scale,
                f"K2 dim {dim} (1, {R.shape[-1]}) complex64: max|d| "
                f"{errs_k2[dim]:.3e} > 1e-5 * {scale:.3e}")
        del ref
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: fused_masked_squaring(R, s, ms),
            lambda: _masked_squaring_plain(R, s, ms), reps=50)
        timing[("K2", dim)] = (k_ms, p_ms)
        s_data = int(s.clamp(max=ms).sum())          # squarings this data needs
        N = R.shape[-1]
        _, binds, terms = _k2_bound_ms(R, s, ms, launch_ms)
        by = "operations" if terms["operations"] >= terms["bytes"] else "bytes"
        bounds[("K2", dim)] = (terms[by], by, binds)
        power = 2 ** int(s[0].clamp(max=ms))
        lib_fn = lambda: torch.linalg.matrix_power(R, power)
        lib_fn()
        lib_ms = min(cuda_ms(lib_fn, 50), cuda_ms(lib_fn, 50))
        lib_err = float((lib_fn() - got).abs().max())
        library[("K2", dim)] = lib_ms
        say("6 sweep", f"K2 dim {dim} (B=1, N={N}, {ms} trips, {s_data} "
            f"squarings, complex64): max|kernel - twin| = {errs_k2[dim]:.3e}; "
            f"kernel {k_ms:.4f} ms, plain twin "
            f"{p_ms:.4f} ms, torch.linalg.matrix_power(R, {power}) {lib_ms:.4f} "
            f"ms (max|diff| {lib_err:.3e}); bound {bounds[('K2', dim)][0]:.6f} ms "
            f"({bounds[('K2', dim)][1]}); one empty launch takes "
            f"{launch_ms:.6f} ms, so of operations, bytes and launch the "
            f"{binds} binds")

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
         "max_abs_err": errs_k2[3],
         "ms": timing[("K2", 3)][0], "plain_ms": timing[("K2", 3)][1],
         "bound_ms": bounds[("K2", 3)][0], "bound_by": bounds[("K2", 3)][1],
         "library_ms": library[("K2", 3)],
         "library_call": "torch.linalg.matrix_power(R, 2**s)",
         "empty_launch_ms": launch_ms, "binds": bounds[("K2", 3)][2],
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
    """Phase 7: the library's slot and degree limits equal the wrappers'
    (K3 against its twin is test_c2v_kernel_bit_exact_vs_twin's)."""
    from noisyquantumsimulator_tpu_torch import _kernels
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda
    lib = _kernels.load()
    require(lib.nqs_bp_c2v_max_slots() == bp_cuda.MAX_SLOTS,
            "K3 slot limit of the library = bp_cuda.MAX_SLOTS")
    require(lib.nqs_bp_v2c_max_degree() == bp_cuda.MAX_DEGREE,
            "v2c degree limit of the library = bp_cuda.MAX_DEGREE")
    say("7 K3", f"library limits: K3 {bp_cuda.MAX_SLOTS} slots, v2c degree "
        f"{bp_cuda.MAX_DEGREE}, as bp_cuda's")


def _fault_walk_row(sample, shots, gen, launch_ms, launches, phase):
    """The sampler kernel against its twin, the op route, at one main-path
    shape (none of these launches is in `launches`): bit for bit on the op
    route's draws; then a sample from a generator (the key's draw included)
    timed with the layout the wrapper picks against one thread a shot, and
    against the op route. Returns the kernel's `kernels` row."""
    from unittest import mock
    from noisyquantumsimulator_tpu_torch.qec import sampler_cuda
    tab = sample.device_table
    n_draws = tab["n_draws"]
    n_out = tab["n_det"] + tab["n_obs"] + tab["n_erase"]
    u, ebits = sample.draws(gen)
    got = sampler_cuda.walk(tab, shots, draws=(u, ebits))
    want = sample.op_route(u, ebits)
    differ = [int((g != want[k]).sum())
              for g, k in zip(got, ("detectors", "observables", "heralds"))]
    require(differ == [0, 0, 0], f"sampler kernel vs the op route on its draws at "
            f"{shots} x {n_draws} (detectors, observables, heralds differ at {differ})")
    del u, ebits, got, want

    def kernel():
        return sample(gen)

    def one_thread():
        with mock.patch.object(sampler_cuda, "SPLIT_THREADS", 0):
            return sample(gen)

    with mock.patch.object(sampler_cuda, "SPLIT_THREADS", 0):
        require(sampler_cuda.layout(n_out, n_draws, shots)[1] == 1,
                "the layout without a split walks one thread a shot")
    k_ms, one_ms = _kernel_vs_plain_ms(kernel, one_thread, reps=20)
    k2_ms, p_ms = _kernel_vs_plain_ms(kernel, lambda: sample.op_route(*sample.draws(gen)),
                                      reps=5)
    # one Philox call a shot and four draws; the uint8 rows out
    calls = shots * -(-n_draws // 4)
    ops_ms = calls * PHILOX_OPS / PEAK_INT32 * 1e3
    bytes_ms = shots * n_out / PEAK_BYTES * 1e3
    bound, bound_by = max((ops_ms, "operations"), (bytes_ms, "bytes"), (launch_ms, "launch"))
    block_shots, split, _ = sampler_cuda.layout(n_out, n_draws, shots)
    say(phase, f"sampler fault walk ({shots} shots, {n_draws} draws, {len(sample.order)} "
        f"fault bits, {n_out} outputs): vs the op route bit for bit on its draws; "
        f"kernel {k_ms:.4f} / {k2_ms:.4f} ms ({block_shots} shots a block, {split} threads "
        f"a shot), one thread a shot {one_ms:.4f} ms, the op route {p_ms:.4f} ms; bound "
        f"{bound:.4f} ms ({bound_by}: {calls} Philox calls {ops_ms:.4f} ms, bytes "
        f"{bytes_ms:.4f} ms), {bound / k_ms:.1%} of it")
    return {"name": "fault_walk", "route": "cuda", "source": SAMPLER_SOURCE,
            "replaces": None, "launches": launches, "max_abs_err": 0.0,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by,
            "one_thread_a_shot_ms": one_ms, "library_ms": None,
            "library_note": "no single PyTorch call draws a circuit's faults and "
                            "XORs their signatures",
            "shape": f"shots={shots} draws={n_draws} outputs={n_out} split={split}"}


def phase_bb(launch_ms):
    import torch
    from noisyquantumsimulator_tpu_torch import bench_bb
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda, native, osd_cuda, sampler_cuda
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
    w.step(gen(SEED))
    torch.cuda.synchronize()

    # --- the main path, counted: only the reps run between reset and read
    bp_cuda.c2v.launches = bp_cuda.v2c.launches = sampler_cuda.walk.launches = 0
    fails = bad = 0
    # queue every rep before syncing any, so host OSD of rep r overlaps
    # the device work of rep r + 1
    outs = [w.e2e(gen(SEED + 100 + r)) for r in range(reps)]
    for f, b, dets_r, bel_r, obs_r in outs:
        nb = int(b)
        fails += int(f) + w.osd_host(nb, dets_r, bel_r, obs_r)
        bad += nb
    torch.cuda.synchronize()
    launches, v2c_launches = bp_cuda.c2v.launches, bp_cuda.v2c.launches
    walk_launches = sampler_cuda.walk.launches
    n_tot = shots * reps
    p_l = fails / n_tot
    lo, hi = wilson_ci(fails, n_tot)
    say("8 bb", f"{reps} reps x {shots} shots: e2e_n_errors = {fails}, "
        f"p_logical = {p_l:.3e} (95% Wilson CI [{lo:.3e}, {hi:.3e}]); "
        f"non-converged fraction {bad / n_tot:.4e} ({bad} OSD residue rows, cap "
        f"{w.cap} per rep); launches in the reps: K3 {launches}, v2c {v2c_launches}, "
        f"sampler {walk_launches}")
    per_rep = (w.fast_iters + 1) + (dec.retry_iters + 1)
    require(launches == v2c_launches == per_rep * reps,
            f"K3 and v2c launch {per_rep} times a rep (7 fast + 91 retry)")
    require(walk_launches == reps, "the sampler kernel launches once a rep")
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

    # --- K3 vs twin at the path's shapes, bit-exact, then times (not counted)
    rng = np.random.default_rng(SEED + 8)
    timing = {}
    for shape, dt, reps_t in (((26, 288, 65536), torch.bfloat16, 20),
                              ((26, 288, 512), torch.float32, 200)):
        m, sgn = _c2v_inputs(rng, *shape)
        msg = torch.as_tensor(m, device="cuda").to(dt)
        ss = torch.as_tensor(sgn, device="cuda").to(dt)
        del m
        got = bp_cuda.c2v(msg, ss, 0.75)
        require(got.shape == msg.shape and got.dtype == dt
                and bool(torch.isfinite(got.float()).all()),
                f"K3 {shape} {dt} output finite, shape and dtype")
        err = float((got.float()
                     - bp_cuda._c2v_plain(msg, ss, 0.75).float()).abs().max())
        require(err == 0.0, f"K3 {shape} {dt}: max|kernel - twin| = {err:.3e}"
                " (must be bit-exact)")
        del got
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: bp_cuda.c2v(msg, ss, 0.75),
            lambda: bp_cuda._c2v_plain(msg, ss, 0.75), reps=reps_t)
        nbytes = 2 * msg.numel() * msg.element_size() + ss.numel() * ss.element_size()
        timing[shape] = (k_ms, p_ms, nbytes / PEAK_BYTES * 1e3, err)
        say("8 bb", f"K3 {shape} {dt}: max|kernel - twin| = {err} (bit-exact "
            f"required); kernel "
            f"{k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} "
            f"MB moved), plain twin {p_ms:.4f} ms")
        del msg, ss
        torch.cuda.empty_cache()
    shape = (26, 288, 65536)
    k3_row = {"name": "K3 bp_c2v", "route": "cuda", "source": K3_SOURCE,
              "replaces": K3_REPLACES, "launches": launches,
              "max_abs_err": timing[shape][3],
              "ms": timing[shape][0], "plain_ms": timing[shape][1],
              "bound_ms": timing[shape][2], "bound_by": "bytes",
              "library_ms": None,
              "library_note": "no single PyTorch call computes normalized "
                              "min-sum check-to-variable messages",
              "shape": "w_max=26 n_chk=288 S=65536 bf16"}

    # --- the v2c kernel vs its twin at the tiers' shapes (not counted): the
    # fast tier's message pass (bf16, undamped) and the retry's (f32, damped)
    tables = dec._bp_fast.keywords["tables"]
    n_edges = int(dec.H.sum())
    rows = {}
    for S_t, dt, damping, reps_t in ((65536, torch.bfloat16, 0.0, 20),
                                     (512, torch.float32, 0.5, 200)):
        g = gen(SEED + 9)
        msg_cv = (4 * torch.randn((tables["Ec"], S_t), generator=g,
                                  device="cuda")).to(dt)
        msg_vc = (4 * torch.randn((tables["Ec"], S_t), generator=g,
                                  device="cuda")).to(dt)
        msg_vc[tables["pad_c"]] = bp_cuda.BIG
        llr = torch.as_tensor(np.log((1 - dec.probs) / dec.probs), device="cuda").to(dt)
        got = bp_cuda.v2c(msg_cv, llr, tables, msg_vc.clone(), damping)
        ref = bp_cuda._v2c_plain(msg_cv, llr, tables, msg_vc.clone(), damping)
        bel = bp_cuda.v2c(msg_cv, llr, tables)
        bel_ref = bp_cuda._v2c_plain(msg_cv, llr, tables)
        torch.cuda.synchronize()
        n_msg, n_bel = int((got != ref).sum()), int((bel != bel_ref).sum())
        err = max(float((got.float() - ref.float()).abs().max()),
                  float((bel.float() - bel_ref.float()).abs().max()))
        # the gross DEM's variables have <= 3 edges, which the twin's sum
        # adds in slot order as the kernel does: both modes equal it bit for
        # bit (the damped retry shape checks the blend)
        require(n_msg == 0 and n_bel == 0,
                f"v2c {dt} damping {damping}: messages and beliefs equal the "
                f"twin's ({n_msg} and {n_bel} differ)")
        out_k, out_p = msg_vc.clone(), msg_vc.clone()
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: bp_cuda.v2c(msg_cv, llr, tables, out_k, damping),
            lambda: bp_cuda._v2c_plain(msg_cv, llr, tables, out_p, damping),
            reps=reps_t)
        # each edge's message in and its new message out (the old one in too
        # when damped); the priors and the index table
        item = msg_cv.element_size()
        nbytes = (item * S_t * n_edges * (3 if damping else 2)
                  + item * len(llr) + tables["cpos_of_vslot"].numel() * 8)
        bound = nbytes / PEAK_BYTES * 1e3
        say("8 bb", f"v2c ({tables['Ec']} slots, {n_edges} edges, {S_t}) {dt} damping "
            f"{damping}: kernel {k_ms:.4f} ms ({nbytes / k_ms / 1e6:.1f} GB/s of "
            f"{nbytes / 1e6:.1f} MB moved; bound {bound:.4f} ms at 3.35 TB/s), plain "
            f"twin {p_ms:.4f} ms; vs the twin: messages differ at {n_msg}, beliefs "
            f"at {n_bel}, max|d| {err:.3e}")
        rows[S_t] = (k_ms, p_ms, bound, err)
        del msg_cv, msg_vc, got, ref, bel, bel_ref, out_k, out_p
        torch.cuda.empty_cache()
    k_ms, p_ms, bound, err = rows[65536]
    v2c_row = {"name": "v2c bp_v2c", "route": "cuda", "source": V2C_SOURCE,
               "replaces": None, "launches": v2c_launches, "max_abs_err": err,
               "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": "bytes",
               "library_ms": None,
               "library_note": "no single PyTorch call computes min-sum "
                               "variable-to-check messages",
               "shape": f"Ec={tables['Ec']} edges={n_edges} S=65536 bf16"}

    # --- the step (OSD-0 on the card): one OSD-0 launch a rep with residue
    # rows (the tier-2 shots), then the kernel vs its twin, the host C++
    # OSD-0, bit for bit on a rep's residue rows at 37, and times
    osd_cuda.osd0.launches = 0
    outs = [w.step(gen(SEED + 200 + r)) for r in range(reps)]
    torch.cuda.synchronize()
    with_rows = sum(int((o[:-1, 1] == 2).any()) for o in outs)
    osd_launches = osd_cuda.osd0.launches
    require(osd_launches == with_rows,
            f"the step launches OSD-0 once a rep with residue rows: "
            f"{osd_launches} launches, {with_rows} such reps")
    tab = osd_cuda.tables(dec.H, dec.obs_mask, w.k, "cuda")
    tab_h = osd_cuda.tables(dec.H, dec.obs_mask, w.k, "cpu")
    _, b, dets_r, bel_r, obs_r = w.e2e(gen(SEED + 10))
    n_rows = 37
    args = [t[:n_rows].contiguous() for t in (dets_r, bel_r, obs_r)]
    args_h = [t.cpu() for t in args]
    got = [t.cpu() for t in osd_cuda.osd0(tab, *args)]
    want = osd_cuda.osd0(tab_h, *args_h)
    differ = [int((g != x).sum()) for g, x in zip(got, want)]
    require(differ == [0, 0, 0], f"OSD-0 on the card vs its twin at {n_rows} rows "
            f"(est, flips, failures differ at {differ})")
    k_ms = cuda_ms(lambda: osd_cuda.osd0(tab, *args), reps=50)
    t0 = time.perf_counter()
    for _ in range(5):
        osd_cuda.osd0(tab_h, *args_h)
    twin_ms = (time.perf_counter() - t0) / 5 * 1e3
    # H packed and the columns' masks in once, each row's detectors, beliefs
    # and observables in, its estimate, flips and flag out
    nbytes = (8 * (tab["Hp"].numel() + tab["obs_mask"].numel())
              + n_rows * (tab["m"] + 4 * tab["n"] + 4 * w.k + tab["n"] + 9))
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bound, bound_by = max((bytes_ms, "bytes"), (launch_ms, "launch"))
    say("8 bb", f"OSD-0 ({tab['m']} x {tab['n']}, rank {tab['rank']}) on {n_rows} "
        f"residue rows of a rep with {int(b)}: the step launched it {osd_launches} "
        f"times in {reps} reps; vs the twin bit for bit; kernel {k_ms:.4f} ms "
        f"(bound {bound:.4f} ms, {bound_by}; bytes {bytes_ms:.5f} ms), the twin "
        f"(host C++, copies included) {twin_ms:.4f} ms")
    osd_row = {"name": "osd0", "route": "cuda", "source": OSD0_SOURCE,
               "replaces": None, "launches": osd_launches, "max_abs_err": 0.0,
               "ms": k_ms, "plain_ms": twin_ms, "bound_ms": bound, "bound_by": bound_by,
               "library_ms": None,
               "library_note": "no single PyTorch call computes OSD-0 over GF(2)",
               "shape": f"m={tab['m']} n={tab['n']} rows={n_rows}"}
    walk_row = _fault_walk_row(w.sampler, shots, gen(SEED + 11), launch_ms,
                               walk_launches, "8 bb")
    return [k3_row, v2c_row, osd_row, walk_row]


# substrings of the names of cuBLAS / CUTLASS product kernels in a trace
_GEMM_NAMES = ("gemm", "cutlass", "xmma", "cublas")


def _drive_population(obj, pop, what):
    """Warm-up, then 5 timed calls of a population objective with K2's
    count set to 0 just before and read just after. Returns (costs,
    metrics, K2 launches of the 5 calls, evaluations/s)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    P = len(pop)
    pop_dev = torch.as_tensor(pop, device="cuda")
    obj(pop_dev)
    torch.cuda.synchronize()
    fused_masked_squaring.launches = 0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        cost, metrics = obj(pop_dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = fused_masked_squaring.launches
    med = statistics.median(times)
    require(launches == 5, f"K2 launched once a call by the {what} objective")
    require(cost.grad_fn is None and not cost.requires_grad,
            f"{what}: the population objective records no autograd graph")
    require(cost.shape == (P,) and bool(torch.isfinite(cost).all()),
            f"{what}: one finite cost per member")
    say("10 optimizer", f"{what}, P = {P}: median {med * 1e3:.3f} ms of 5 calls "
        f"-> {P / med:.1f} evaluations/s (times ms "
        f"{[round(t * 1e3, 3) for t in times]}); K2 launches per call "
        f"{launches / 5:g}; best cost {float(cost.min()):.4f}, members below the "
        f"1e6 floor {int((cost < 1e6).sum())}")
    return cost, metrics, launches, P / med


def _hold_to_c128(what, problem, key, kw, pop8, cost, metrics, obj64, tol_f,
                  phase="10 optimizer"):
    """The first members' costs and fidelities against the complex128
    per-segment path (one expm per member and segment, evolve_rhos): the
    fidelities within `tol_f` absolute and the cost within 5e-3 relative at
    32 bits (the cost multiplies an error of a fidelity by up to
    2e5 (1 - F)), and the same objective at 64 bits within 1e-6 relative.
    Also prints the squaring counts of the per-segment Liouvillians under
    Taylor-16 and complex64's Pade-13: each squaring doubles the relative
    error of the chain. Returns max|dF|."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm import (
        _THETA13_SINGLE, _THETA16, _needed_squarings)
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.solver.propagator import (
        segment_liouvillians)
    c128 = torch.complex128
    put = lambda a: torch.as_tensor(np.asarray(a), device="cuda").to(c128)
    sched = engine.SCHEDULE_BUILDERS[key](
        torch.as_tensor(pop8, device="cuda"), problem, **kw)
    with torch.no_grad():
        ref_c, ref_m = engine._evaluate_arrays(
            sched, put(problem.L0_bare), put(problem.Cd), put(problem.Cp),
            put(problem.Cm), put(problem.rho0s),
            {k: put(v) for k, v in problem.kets.items()})
        A = segment_liouvillians(put(problem.L0_bare), put(problem.Cp),
                                 put(problem.Cm), sched, put(problem.Cd))
        s_t, s_p = (_needed_squarings(A, th) for th in (_THETA16, _THETA13_SINGLE))
    c64, m64 = obj64(pop8)
    n = len(pop8)
    rel32 = float(((cost[:n].double() - ref_c).abs() / ref_c).max())
    rel64 = float(((c64 - ref_c).abs() / ref_c).max())
    dF = max(float((metrics[k][:n].double() - ref_m[k]).abs().max())
             for k in ("avg_fidelity", "f00", "f01", "f10", "f11",
                       "cz_phase_fidelity"))
    say(phase, f"{what}: {n} members against the complex128 per-segment "
        f"path (squarings of its segments: Taylor-16 {int(s_t.min())}.."
        f"{int(s_t.max())}, complex64 Pade-13 {int(s_p.min())}..{int(s_p.max())}): "
        f"max|dF| "
        f"over the six fidelities {dF:.3e} (tol "
        f"{tol_f:g}), cost "
        f"relative {rel32:.3e} (tol 5e-3); the same objective at 64 bits: cost "
        f"relative {rel64:.3e} (tol 1e-6); reference costs "
        f"{[round(float(c), 3) for c in ref_c]}")
    require(dF <= tol_f, f"{what}: fidelities within {tol_f:g} of complex128")
    require(rel32 <= 5e-3, f"{what}: 32-bit cost within 5e-3 relative")
    require(rel64 <= 1e-6, f"{what}: 64-bit cost within 1e-6 relative")
    return dF


def _population_scan_entry(obj, pop, launch_ms):
    """The population-scan kernel at the main path's own operands (one call
    of the smooth-JP population objective, recorded as it reaches the scan):
    against its twin, the batched-product loop (float32, 1e-4 relative),
    times of both in turns, and its bounds. Returns its kernels-line entry."""
    import torch
    from noisyquantumsimulator_tpu_torch import _kernels
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.solver.population_scan_cuda import (
        _evolve_real_phased_population_plain, evolve_real_phased_population_cuda)
    seen, scan = [], engine.evolve_real_phased

    def spy(*args):
        seen.append(args)
        return scan(*args)
    engine.evolve_real_phased = spy
    try:
        launches = evolve_real_phased_population_cuda.launches
        loops = evolve_real_phased_population_cuda.loop_calls
        obj(torch.as_tensor(pop, device="cuda"))
        launches = evolve_real_phased_population_cuda.launches - launches
        loops = evolve_real_phased_population_cuda.loop_calls - loops
    finally:
        engine.evolve_real_phased = scan
    require(len(seen) == 1 and launches == 1 and loops == 0,
            f"one population-scan launch a call ({launches}; loop {loops})")
    U, cq, ph, x0, D, P = seen[0]
    (M, n, _), n_seg, S = U.shape, ph.shape[1], x0.shape[-2]
    kernel = lambda: evolve_real_phased_population_cuda(U, cq, ph, x0, D, P)
    plain = lambda: _evolve_real_phased_population_plain(U, cq, ph, x0, D, P)
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    require(got.shape == (M, S, n) and bool(torch.isfinite(got).all()),
            "population scan output finite")
    require(err <= 1e-4 * scale,
            f"population scan f32: max|d| {err:.3e} > 1e-4 * {scale:.3e}")
    k_ms, p_ms = _kernel_vs_plain_ms(kernel, plain, reps=5)
    flops = 2.0 * M * S * n * n * n_seg
    nbytes = 4.0 * (M * n * n + P + M * n_seg + 2 * M * S * n)
    fp32_ms, tf32_ms = flops / PEAK_FP32 * 1e3, flops / PEAK_TF32 * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    spills = [(name, st, ld) for name, _, st, ld in _kernels.ptxas_report()
              if "population_scan" in name]
    say("10 optimizer", f"population scan ({M}, {n}) S={S} {n_seg} steps f32 at "
        f"the smooth-JP call's operands: kernel {k_ms:.4f} ms ({flops / k_ms * 1e-9:.2f}"
        f" TFLOP/s), twin (300 x product + torch.bmm) {p_ms:.4f} ms; max|kernel - "
        f"twin| {err:.3e} (max|ref| {scale:.3e}, tol 1e-4 relative); bounds: FP32 "
        f"pipes {fp32_ms:.4f} ms ({fp32_ms / k_ms * 100:.1f}%), the benchmark's "
        f"495 TFLOP/s {tf32_ms:.4f} ms ({tf32_ms / k_ms * 100:.1f}%), bytes "
        f"{byte_ms:.4f} ms; spills in {sum(st + ld > 0 for _, st, ld in spills)} "
        f"of {len(spills)} kernels")
    return {"name": "population scan", "route": "cuda", "source": PSCAN_SOURCE,
            "replaces": None, "launches": launches, "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": fp32_ms,
            "bound_by": "operations (FP32 pipes)", "bound_495_ms": tf32_ms,
            "bytes_ms": byte_ms, "empty_launch_ms": launch_ms,
            "spills": sum(st + ld for _, st, ld in spills),
            "library_ms": p_ms,
            "library_note": "no single call computes the rotated scan; the twin "
                            "(300 x one product and one torch.bmm) is the library "
                            "yardstick",
            "shape": f"M={M} S={S} n={n} {n_seg} steps f32 (FP32 FMAs)"}


def phase_optimizer(launch_ms=None):
    """Phase 10: the optimizer's forward path. Returns K2's launches on it,
    by the shape it was launched at, the objectives' rates and the
    population-scan kernel's kernels-line entry."""
    import torch
    from noisyquantumsimulator_tpu_torch.gate.simulate import (
        plan_squaring_bound, run_plan)
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    from noisyquantumsimulator_tpu_torch.solver.propagator import evolve_rhos
    from noisyquantumsimulator_tpu_torch.utils.profiling import profile_window

    P = 1024
    rng = np.random.default_rng(SEED + 10)
    app = ApparatusConstraints()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = engine.build_fixed_problem(app, app.make_full_noise())
    say("10 optimizer", f"default apparatus, full noise, 3-level atoms: host plan "
        f"{time.perf_counter() - t0:.2f} s; V/Omega = {problem.V_over_Omega:.1f}, "
        f"phase-frame generator {'found' if problem.g is not None else 'absent'}")
    require(problem.g is not None, "the default apparatus is phase-frame eligible")
    launches = {}

    # --- smooth JP, 300 segments, the float32 real core: one expm a member
    bounds, x0 = forward.get_smooth_jp_bounds_and_x0()
    pop = population_near(x0, bounds, P, 0.1, rng)
    obj = engine.make_population_objective(problem, "smooth_jp")
    obj64 = engine.make_population_objective(problem, "smooth_jp",
                                             dtype=torch.complex128)
    cost, metrics, launches["smooth_jp"], rate_sj = _drive_population(
        obj, pop, "smooth_jp (300 segments, float32 real core)")
    require(launches["smooth_jp"] == 5, "smooth_jp: one K2 launch per call")
    _hold_to_c128("smooth_jp", problem, "smooth_jp", {}, pop[:8], cost, metrics, obj64,
                  1e-4)
    pscan = _population_scan_entry(obj, pop, launch_ms)

    # --- bang-bang, 5 segments, complex64: one expm a member and segment
    bounds, x0 = forward.get_jp_bangbang_bounds_and_x0(5)
    pop = population_near(x0, bounds, P, 0.02, rng)
    kw = dict(n_segments=5)
    obj = engine.make_population_objective(problem, "jp_bangbang", **kw)
    obj64 = engine.make_population_objective(problem, "jp_bangbang",
                                             dtype=torch.complex128, **kw)
    what = "jp_bangbang (5 segments, complex64)"
    cost, metrics, launches["jp_bangbang"], rate_bb = _drive_population(obj, pop, what)
    require(launches["jp_bangbang"] == 5, "jp_bangbang: one K2 launch per call")
    pop_dev = torch.as_tensor(pop, device="cuda")
    wall, idle, by_name, path, _ = profile_window(lambda: obj(pop_dev),
                                                  "optimizer_bangbang")
    if idle is None:
        say("10 optimizer", f"{what} profiler window: no device events in "
            f"{path}; idle share not measured")
    else:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        say("10 optimizer", f"{what} profiler window, 3 calls: wall "
            f"{wall * 1e3:.3f} ms/call, device idle share {idle:.4f}; of device "
            f"time K2 {_share(by_name, 'masked_square') * 100:.2f}%, cuBLAS "
            f"products (the ordered product, Pade-13) "
            f"{_share(by_name, *_GEMM_NAMES) * 100:.2f}%; {len(by_name)} kernels, "
            f"longest: " + "; ".join(f"{n[:60]} {t / sum(by_name.values()) * 100:.1f}%"
                                     for n, t in top) + f" (trace {path})")
    # a bang-bang segment is a fifth of the gate: its expm is Pade-13 at its
    # single-precision theta, which takes 2-3 fewer squarings than Taylor-16 and
    # so holds the 1e-4 tier; the margin over 6 populations of 8
    dFs = [_hold_to_c128("jp_bangbang", problem, "jandura_pupillo", kw, pop[:8],
                         cost, metrics, obj64, 1e-4)]
    for k in range(1, 6):
        pop8 = population_near(x0, bounds, 8, 0.02,
                                np.random.default_rng(SEED + 10 + k))
        c8, m8 = obj(pop8)
        dFs.append(_hold_to_c128(f"jp_bangbang (population {k + 1} of 6)", problem,
                                 "jandura_pupillo", kw, pop8, c8, m8, obj64, 1e-4))
    say("10 optimizer", f"jp_bangbang max|dF| against complex128 over 6 populations "
        f"of 8: {[f'{d:.3e}' for d in dFs]}, largest {max(dFs):.3e} (tier 1e-4)")
    del obj, obj64, cost, metrics
    torch.cuda.empty_cache()

    # --- the per-segment engine of one gate at dim 4 (300 x 256 x 256
    # complex64) against the phase-frame route of the same plan
    plan = gate_plan(4)
    plan.device, plan.dtype = "cuda", torch.complex64
    put = lambda a: torch.as_tensor(np.asarray(a), device="cuda").to(torch.complex64)
    ms = plan_squaring_bound(plan)
    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    rhos = evolve_rhos(put(plan.L0), put(plan.Cp), put(plan.Cm), plan.schedule,
                       put(plan.rho0s), max_squarings=ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["per_segment_dim4"] = fused_masked_squaring.launches
    ref = run_plan(plan)[3]
    err = float((rhos - ref).abs().max())
    say("10 optimizer", f"per-segment engine, dim 4, 300 segments, complex64: "
        f"{wall * 1e3:.1f} ms (first call), K2 launches "
        f"{launches['per_segment_dim4']} (max_squarings {ms}); max|rho - rho of "
        f"the phase-frame route| = {err:.3e} (tol 1e-4)")
    require(launches["per_segment_dim4"] == ms, "per-segment dim 4: one K2 launch a trip")
    require(err <= 1e-4, "per-segment and phase-frame routes agree at dim 4")
    del rhos, ref
    torch.cuda.empty_cache()

    # --- the entry point: a short differential evolution
    x0_sj = forward.get_smooth_jp_bounds_and_x0()[1]
    F0 = float(engine.make_objective(problem, "smooth_jp")(x0_sj)[1]["avg_fidelity"])
    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = forward.optimize_cz_gate("smooth_jp", maxiter=10, popsize=15,
                                       grad_polish=False, seed=42)
    wall = time.perf_counter() - t0
    launches["optimize_cz_gate"] = fused_masked_squaring.launches
    hist = np.asarray(res.history)
    F1 = res.best_metrics["avg_fidelity"]
    say("10 optimizer", f"optimize_cz_gate('smooth_jp', maxiter=10, popsize=15, "
        f"grad_polish=False, seed=42): {wall:.2f} s, {res.n_evaluations} "
        f"evaluations, K2 launches {launches['optimize_cz_gate']}; best cost per "
        f"generation {[round(float(h), 4) for h in hist]}; F = {F1:.6f} (at x0 "
        f"{F0:.6f})")
    require(len(hist) == 10 and bool(np.all(np.diff(hist) <= 0.0)),
            "DE history does not increase")
    require(launches["optimize_cz_gate"] == 12,
            "one K2 launch per generation, the start and the final metrics")
    require(np.isfinite(F1) and F1 >= F0 - 1e-6,
            f"final fidelity {F1} no lower than at x0 {F0}")
    return launches, {"smooth_jp": rate_sj, "jp_bangbang": rate_bb}, pscan


# K2's gradient against autograd through its twin: (B, N, dtype, squaring
# counts, who runs it). Inputs: Taylor-16 of skew-Hermitian K / 2^s, so every
# chain stays near a unitary however many squarings it takes.
K2_GRAD = (
    (1, 81, "float32", [3], "the real core's expm (value_and_grad, smooth JP)"),
    (5, 81, "complex64", [9, 10, 11, 10, 9], "bang-bang's segments"),
    (2, 256, "complex64", [3, 3], "the tiled route"),
    (4, 81, "complex128", [0, 2, 5, 1], "the 64-bit tier, mixed s"),
)


def _chain_inputs(B, N, dtype, s, seed):
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm import _taylor16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    X = torch.randn((B, N, N), dtype=dtype, device="cuda", generator=gen)
    K = X - X.mH
    As = K * (1.8 / K.abs().sum(-2).amax(-1))[:, None, None]
    I = torch.eye(N, dtype=dtype, device="cuda").expand(As.shape)
    G = torch.randn((B, N, N), dtype=dtype, device="cuda", generator=gen)
    return (_taylor16(As, I).contiguous(),
            torch.tensor(s, dtype=torch.int32, device="cuda"), G)


def _k2_grad_checks():
    """K2's Function gradient against autograd through the plain twin at
    K2_GRAD; forward + backward times of both (not counted)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    for i, (B, N, dtname, s_list, who) in enumerate(K2_GRAD):
        dt = getattr(torch, dtname)
        ms = 12 if N <= 81 else 4
        R, s, G = _chain_inputs(B, N, dt, s_list, SEED + 110 + i)

        def grad_of(square):
            Rg = R.clone().requires_grad_(True)
            return torch.autograd.grad((square(Rg, s, ms) * G).real.sum(), Rg)[0]
        before = fused_masked_squaring.launches
        got = grad_of(fused_masked_squaring)
        n_launch = fused_masked_squaring.launches - before
        ref = grad_of(_masked_squaring_plain)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))
        tol = 1e-5 if dtname in ("float32", "complex64") else 1e-12
        require(bool(torch.isfinite(torch.view_as_real(got) if dt.is_complex
                                    else got).all()), "K2 gradient finite")
        require(rel <= tol, f"K2 gradient ({B}, {N}) {dtname}: {rel:.3e} > {tol}")
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: grad_of(fused_masked_squaring),
            lambda: grad_of(_masked_squaring_plain), 10)
        say("11 gradients", f"K2 Function ({B}, {N}) {dtname} s={s_list} [{who}]: "
            f"|grad - autograd through the twin| / |grad| = {rel:.3e} (tol {tol}); "
            f"K2 launches forward + backward {n_launch}; forward + backward "
            f"{k_ms:.4f} ms (autograd through the twin {p_ms:.4f} ms)")


def _time_calls(fn, what, tag, n=5):
    """Warm-up, then n timed calls with K2's count set to 0 just before and
    read just after; a profiler window of 3 calls (not counted). Returns
    (median ms, K2 launches of the n calls, idle share or None)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.utils.profiling import profile_window
    fn()
    torch.cuda.synchronize()
    fused_masked_squaring.launches = 0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = fused_masked_squaring.launches
    require(launches > 0, f"K2 launched by {what}")
    med = statistics.median(times) * 1e3
    _, idle, by_name, path, _ = profile_window(fn, tag)
    idle_txt = "not measured (no device events)" if idle is None else f"{idle:.4f}"
    k2_txt = "" if by_name is None else (
        f", K2 {_share(by_name, 'masked_square') * 100:.2f}% of device time")
    say("11 gradients", f"{what}: median {med:.3f} ms of {n} (times ms "
        f"{[round(t * 1e3, 3) for t in times]}); K2 launches per call "
        f"{launches / n:g}; device idle share {idle_txt}{k2_txt} (trace {path})")
    return med, launches, idle


def phase_gradients(launch_ms):
    """Phase 11: the gradient paths. Returns K2's record for the kernels
    line, at the value-and-grad expm's squaring inputs."""
    import dataclasses
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm import _THETA16, _scale, _taylor16
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    _k2_grad_checks()

    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = engine.build_fixed_problem(app, app.make_full_noise())
    x0 = forward.get_smooth_jp_bounds_and_x0()[1]
    c64, g64 = engine.make_value_and_grad(problem, "smooth_jp",
                                          dtype=torch.complex128)(x0)
    cs, gs = engine.make_value_and_grad(dataclasses.replace(problem, g=None),
                                        "smooth_jp", dtype=torch.complex128)(x0)
    c32, g32 = engine.make_value_and_grad(problem, "smooth_jp")(x0)
    rel_c = abs(float(c64) - float(cs)) / abs(float(cs))
    rel_g = float(torch.linalg.norm(g64 - gs) / torch.linalg.norm(gs))
    g32d = g32.double()
    cos = float(g32d @ g64 / (torch.linalg.norm(g32d) * torch.linalg.norm(g64)))
    rel32 = float(torch.linalg.norm(g32d - g64) / torch.linalg.norm(g64))
    say("11 gradients", f"make_value_and_grad smooth_jp at x0, 300 segments: cost "
        f"{float(c64):.6f} (float64 real core) vs {float(cs):.6f} (complex128 "
        f"per-segment): relative {rel_c:.3e}, gradient relative {rel_g:.3e} (tol "
        f"1e-7); float32 cost {float(c32):.6f}, gradient cosine to float64 "
        f"{cos:.7f} (tol 0.999), relative error {rel32:.3e}; |grad| "
        f"{float(torch.linalg.norm(g64)):.4e}")
    require(rel_c <= 1e-7 and rel_g <= 1e-7, "real core gradient = per-segment")
    require(cos >= 0.999, f"float32 gradient cosine {cos} >= 0.999")

    vg = engine.make_value_and_grad(problem, "smooth_jp")
    x0_dev = torch.as_tensor(x0, device="cuda")
    ms_sj, l_sj, idle_sj = _time_calls(
        lambda: float(vg(x0_dev)[0]), "value_and_grad smooth_jp (300 segments, "
        "float32 real core, population of one)", "grad_smooth_jp")
    xb = torch.as_tensor(forward.get_jp_bangbang_bounds_and_x0(5)[1], device="cuda")
    vgb = engine.make_value_and_grad(problem, "jp_bangbang", n_segments=5)
    ms_bb, l_bb, idle_bb = _time_calls(
        lambda: float(vgb(xb)[0]), "value_and_grad jp_bangbang (5 segments, "
        "complex64)", "grad_bangbang")
    ph0 = engine.smooth_jp_uniform_from_params(
        torch.as_tensor(x0), problem, n_steps=300)[0]
    kw = dict(omega_tau=float(x0[0]), delta_over_omega=float(x0[4]))
    vgg = engine.make_value_and_grad(problem, "grape", **kw)
    ph = ph0.to(device="cuda", dtype=torch.float32).clone().requires_grad_(True)
    adam = forward.grape_adam(ph, 2e-3)

    def grape_step():
        cost, grad = vgg(ph.detach())
        ph.grad = grad
        adam.step()
        return cost
    ms_gr, l_gr, idle_gr = _time_calls(
        grape_step, "GRAPE Adam step (300 phases, float32)", "grad_grape")

    # --- the entry point with its default polish, against DE alone
    runs = {}
    for polish in (False, True):
        fused_masked_squaring.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            res = (forward.optimize_cz_gate("smooth_jp", maxiter=10, popsize=15,
                                            seed=42) if polish else
                   forward.optimize_cz_gate("smooth_jp", maxiter=10, popsize=15,
                                            seed=42, grad_polish=False))
        runs[polish] = (res, time.perf_counter() - t0,
                        fused_masked_squaring.launches)
    (de, de_s, de_l), (pol, pol_s, pol_l) = runs[False], runs[True]
    say("11 gradients", f"optimize_cz_gate('smooth_jp', maxiter=10, popsize=15, "
        f"seed=42): DE alone cost {de.best_cost:.6f} F {de.best_metrics['avg_fidelity']:.6f} "
        f"in {de_s:.2f} s ({de_l} K2 launches); with the default polish cost "
        f"{pol.best_cost:.6f} F {pol.best_metrics['avg_fidelity']:.6f} in "
        f"{pol_s:.2f} s ({pol_l} K2 launches, {pol.n_evaluations - de.n_evaluations}"
        f" gradient steps): gain {de.best_cost - pol.best_cost:.6f} in cost, "
        f"polish wall {pol_s - de_s:.2f} s")
    require(pol.best_cost <= de.best_cost, "the polish ends no worse than DE")
    require(pol_l > de_l, "K2 launched by the polish")

    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        gr = forward.optimize_cz_gate("grape", grape_steps=50)
    gr_s = time.perf_counter() - t0
    gr_l = fused_masked_squaring.launches
    F_gr = gr.best_metrics["avg_fidelity"]
    say("11 gradients", f"optimize_cz_gate('grape', grape_steps=50): history "
        f"{[round(h, 4) for h in gr.history]}, F = {F_gr:.6f}, {gr_s:.2f} s, "
        f"K2 launches {gr_l}")
    require(gr.history[-1] <= gr.history[0], "GRAPE history does not rise")
    require(F_gr > 0.95 and gr_l > 0, f"GRAPE F {F_gr} > 0.95, K2 launched")

    # --- K2 at the value-and-grad expm's squaring inputs (not counted)
    with torch.no_grad():
        _, dt, det = engine.smooth_jp_uniform_from_params(
            x0_dev.float()[None], problem)
        put = lambda a: torch.as_tensor(a, device="cuda")
        A = ((put(problem.R_L0) + det[:, None, None] * put(problem.R_Cd)
              + put(problem.R_drive)) * dt[:, None, None])
        As, s = _scale(A, _THETA16, 12)
        R = _taylor16(As, torch.eye(A.shape[-1], device="cuda").expand(A.shape))
        got, ref = fused_masked_squaring(R, s, 12), _masked_squaring_plain(R, s, 12)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    require(err <= 1e-5 * float(ref.abs().max()), "K2 at value_and_grad's inputs")
    k_ms, p_ms = _kernel_vs_plain_ms(lambda: fused_masked_squaring(R, s, 12),
                                     lambda: _masked_squaring_plain(R, s, 12), 50)
    lib_fn = lambda: torch.linalg.matrix_power(R, 2 ** int(s[0]))
    lib_fn()
    lib_ms = min(cuda_ms(lib_fn, 50), cuda_ms(lib_fn, 50))
    _, binds, terms = _k2_bound_ms(R, s, 12, launch_ms)
    by = "operations" if terms["operations"] >= terms["bytes"] else "bytes"
    say("11 gradients", f"K2 (1, 81) float32 at the value-and-grad expm, s = "
        f"{int(s[0])}: max|kernel - twin| {err:.3e}; kernel {k_ms:.4f} ms, plain "
        f"twin {p_ms:.4f} ms, matrix_power {lib_ms:.4f} ms; bound {terms[by]:.6f} "
        f"ms ({by}; of operations, bytes and one empty launch the {binds} "
        f"binds)")
    return {"name": "K2 masked_squaring (1, 81) float32 [value_and_grad]",
            "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
            "launches": l_sj, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": terms[by], "bound_by": by, "library_ms": lib_ms,
            "library_call": "torch.linalg.matrix_power(R, 2**s)",
            "empty_launch_ms": terms["launch"], "binds": binds,
            "launched_by": "5 value_and_grad calls of smooth JP (forward and "
                           "backward recompute)",
            "shape": "B=1 N=81 float32, 12 trips (resident route)"}


def _host_channel_reference(plan):
    """Host complex128 qubit-subspace superop of a plan, from phase 5's
    host propagator (one scipy expm, phase rotations and the ordered
    product), independent of the card's per-segment expm."""
    from noisyquantumsimulator_tpu_torch.channels.tomography import (
        _subspace_superop)
    return _subspace_superop(_host_reference_propagator(plan),
                             plan.hilbert_space_dim)


def phase_channel(launch_ms):
    """Phase 12: the channel / calibration bridge. Returns its K2 launches
    and its kernels-line record."""
    import tempfile
    import torch
    from noisyquantumsimulator_tpu_torch.channels import (
        CalibrationStore, calibrate_cz, extract_cz_channel)
    from noisyquantumsimulator_tpu_torch.core.configs import (
        SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_cz_gate
    from noisyquantumsimulator_tpu_torch.ops.expm import (_THETA13_SINGLE, _pade13,
                                                          _scale)
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    from noisyquantumsimulator_tpu_torch.solver.propagator import (
        segment_liouvillians)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        plan = plan_cz_gate(SmoothJPSimulationInputs())
    t0 = time.perf_counter()
    S_ref = _host_channel_reference(plan)
    say("12 channel", f"host complex128 reference (scipy expm + ordered product "
        f"of {len(plan.schedule.dts)} phase-rotated segments): "
        f"{time.perf_counter() - t0:.2f} s")
    launches = {}
    for dt, tol in ((torch.complex64, 1e-4), (torch.complex128, 1e-10)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            extract_cz_channel(dtype=dt)                       # warm-up
            torch.cuda.synchronize()
            fused_masked_squaring.launches = 0
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                ch = extract_cz_channel(dtype=dt)
                walls.append(time.perf_counter() - t0)
        launches[str(dt)] = fused_masked_squaring.launches
        err = float(np.abs(ch.superop - S_ref).max())
        require(np.all(np.isfinite(ch.superop)) and ch.superop.shape == (16, 16),
                "channel superop finite, (16, 16)")
        require(err <= tol, f"channel {dt}: max|dS| {err:.3e} > {tol}")
        require(launches[str(dt)] > 0, "K2 launched by the channel extraction")
        say("12 channel", f"extract_cz_channel(dtype={dt}) on the card: max|S - "
            f"S_host| = {err:.3e} (tol {tol}); F_avg {ch.avg_gate_fidelity:.9f}, "
            f"process F {ch.process_fidelity:.9f}, mean leakage "
            f"{ch.mean_leakage:.6e}, CP {ch.completely_positive}, TP "
            f"{ch.trace_preserving}; median {statistics.median(walls):.4f} s per "
            f"extraction of 3 (plan included; {walls}); K2 launches per "
            f"extraction {launches[str(dt)] / 3:g}")
    with tempfile.TemporaryDirectory() as tmp:
        store = CalibrationStore(tmp)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            rec = calibrate_cz(store=store)
        back = store.load("neutral_atoms", "rydberg_cz", rec.regime)
        S_back = store.load_superop("neutral_atoms", "rydberg_cz", rec.regime)
        n_files = len(store.list_records())
    require(back.to_json() == json.loads(json.dumps(rec.to_json())),
            "calibration record reads back as written")
    require(S_back.shape == (16, 16) and n_files == 1, "one record, (16, 16)")
    probs = np.asarray(rec.pauli_error_probs)
    require(abs(probs.sum() - 1) < 1e-6 and probs[0] > 0.9,
            "twirled Pauli probabilities normalised, mostly no error")
    say("12 channel", f"calibrate_cz into a temporary store: {rec.regime}, avg "
        f"gate infidelity {rec.error_rates['avg_gate_infidelity']:.6e}, p(II) "
        f"{probs[0]:.6f}; read back equal")

    # --- K2 at the channel's squaring inputs (not counted)
    put = lambda a: torch.as_tensor(np.asarray(a), device="cuda").to(torch.complex64)
    A = segment_liouvillians(put(plan.L0), put(plan.Cp), put(plan.Cm), plan.schedule)
    As, s = _scale(A, _THETA13_SINGLE, 12)     # the channel's complex64 Pade-13
    R = _pade13(As, torch.eye(A.shape[-1], dtype=A.dtype, device="cuda")
                .expand(A.shape)).contiguous()
    got, ref = fused_masked_squaring(R, s, 12), _masked_squaring_plain(R, s, 12)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    require(err <= 1e-5 * float(ref.abs().max()), "K2 at the channel's inputs")
    k_ms, p_ms = _kernel_vs_plain_ms(lambda: fused_masked_squaring(R, s, 12),
                                     lambda: _masked_squaring_plain(R, s, 12), 20)
    uniform = bool((s == s[0]).all())
    lib_ms = None
    if uniform:
        lib_fn = lambda: torch.linalg.matrix_power(R, 2 ** int(s[0]))
        lib_fn()
        lib_ms = min(cuda_ms(lib_fn, 20), cuda_ms(lib_fn, 20))
    _, binds, terms = _k2_bound_ms(R, s, 12, launch_ms)
    by = "operations" if terms["operations"] >= terms["bytes"] else "bytes"
    say("12 channel", f"K2 (300, 81) complex64, s in [{int(s.min())}, "
        f"{int(s.max())}]: max|kernel - twin| {err:.3e}; kernel {k_ms:.4f} ms, "
        f"plain twin {p_ms:.4f} ms, matrix_power "
        f"{'none (s differs)' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
        f"{terms[by]:.5f} ms ({by}; of operations, bytes and one empty launch "
        f"the {binds} binds)")
    return launches, {
        "name": "K2 masked_squaring (300, 81) complex64 [channel]",
        "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": launches["torch.complex64"],
        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": terms[by], "bound_by": by, "library_ms": lib_ms,
        "library_call": "torch.linalg.matrix_power(R, 2**s)",
        "empty_launch_ms": terms["launch"], "binds": binds,
        "launched_by": "extract_cz_channel complex64, 3 extractions",
        "shape": "B=300 N=81 complex64, 12 trips (resident route)"}


def _k2_entries(rows, launches):
    """K2's records at its batched shapes for the kernels line: phase 9's
    measurements beside the launches of phase 10's runs."""
    out = []
    for key, run, shape in (
            ((1024, 81, "float32", 12, "3"), "smooth_jp",
             "B=1024 N=81 float32, 12 trips, s=3 (resident route)"),
            ((5120, 81, "complex64", 12, "3"), "jp_bangbang",
             "B=5120 N=81 complex64, 12 trips, s=3 (resident route)"),
            ((300, 256, "complex64", 4, "3"), "per_segment_dim4",
             "B=300 N=256 complex64, 4 trips, s=3 (tiled route)")):
        r = rows[key]
        by = ("operations" if r["terms"]["operations"] >= r["terms"]["bytes"]
              else "bytes")
        out.append({"name": f"K2 masked_squaring {key[:3]}", "route": "cuda",
                    "source": K2_SOURCE, "replaces": K2_REPLACES,
                    "launches": launches[run], "max_abs_err": r["err"],
                    "ms": r["ms"], "plain_ms": r["plain_ms"],
                    "bound_ms": r["terms"][by], "bound_by": by,
                    "library_ms": r["library_ms"],
                    "library_call": "torch.linalg.matrix_power(R, 2**s)",
                    "empty_launch_ms": r["terms"]["launch"], "binds": r["binds"],
                    "launched_by": run, "shape": shape})
    return out


def _engine_as(fn):
    """Within the block, gate/readout's and gate/cooling's `_expm_engine`
    is `fn`."""
    import contextlib
    from unittest import mock
    from noisyquantumsimulator_tpu_torch.gate import cooling, readout
    stack = contextlib.ExitStack()
    for m in (readout, cooling):
        stack.enter_context(mock.patch.object(m, "_expm_engine", fn))
    return stack


def _timed(fn, n=3):
    """Warm-up, then n calls with K2's count set to 0 just before and read
    just after. Returns (last result, median s, times, K2 launches)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    fn()
    torch.cuda.synchronize()
    fused_masked_squaring.launches = 0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times), times, fused_masked_squaring.launches


def _k2_hold(R, s, ms, what, tol):
    """K2 against its twin at squaring inputs R, s (`tol` relative: 1e-12
    at 64 bits); not counted. Returns (max|kernel - twin|, max|twin|)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    got, ref = fused_masked_squaring(R, s, ms), _masked_squaring_plain(R, s, ms)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    require(got.shape == R.shape and bool(torch.isfinite(
        torch.view_as_real(got) if got.is_complex() else got).all()),
        f"K2 {what}: finite, shaped as R")
    require(err <= tol * scale, f"K2 {what}: {err:.3e} > {tol:g} * {scale:.3e}")
    return err, scale


def _k2_at(R, s, ms, what, launch_ms, reps, phase="13 primitives", tol=1e-12):
    """K2 against its twin (`tol` relative: 1e-12 at 64 bits) and
    matrix_power at squaring inputs R, s; times (not counted) and the
    bound."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
        _masked_squaring_plain, fused_masked_squaring)
    err, scale = _k2_hold(R, s, ms, what, tol)
    k_ms, p_ms = _kernel_vs_plain_ms(lambda: fused_masked_squaring(R, s, ms),
                                     lambda: _masked_squaring_plain(R, s, ms), reps)
    lib_ms = None
    if bool((s == s[0]).all()):
        lib_fn = lambda: torch.linalg.matrix_power(R, 2 ** min(int(s[0]), ms))
        lib_fn()
        lib_ms = min(cuda_ms(lib_fn, reps), cuda_ms(lib_fn, reps))
    bound, binds, terms = _k2_bound_ms(R, s, ms, launch_ms)
    by = "operations" if terms["operations"] >= terms["bytes"] else "bytes"
    say(phase, f"K2 {what}, max_squarings {ms}, s in [{int(s.min())}, "
        f"{int(s.max())}]: max|kernel - twin| = {err:.3e} (max|ref| {scale:.3e}, "
        f"tol {tol:g} relative); K2 {k_ms:.4f} ms, plain twin {p_ms:.4f} ms, "
        f"matrix_power {'none (s differs)' if lib_ms is None else f'{lib_ms:.4f} ms'}"
        f"; bound {bound:.5f} ms ({binds}; operations {terms['operations']:.5f} at "
        f"{PEAK_FP64 / 1e12:g} TFLOP/s, bytes {terms['bytes']:.5f}, launch "
        f"{terms['launch']:.5f}) -> {bound / k_ms * 100:.1f}% of the bound")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=terms[by],
                bound_by=by, library_ms=lib_ms, empty_launch_ms=terms["launch"],
                binds=binds)


def _pade_inputs(A, ms):
    """Pade-13 of A / 2^s on the card, as expm computes it before K2."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm import _THETA13, _pade13, _scale
    As, s = _scale(A, _THETA13, ms)
    I = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return _pade13(As, I).contiguous(), s


def _engine_record(which, regime, res, host, make_record, launches, med, times,
                   ms_needed):
    """Readout or cooling: the card's result against scipy and the shipped
    record."""
    from noisyquantumsimulator_tpu_torch.channels import CalibrationStore
    shipped = CalibrationStore().load("neutral_atoms", which, regime)
    rec = make_record(res, regime)
    d_rates = max(abs(rec.error_rates[k] - shipped.error_rates[k])
                  for k in shipped.error_rates)
    if which == "readout":
        d_host = float(np.abs(res.confusion_matrix - host.confusion_matrix).max())
        d_ship = float(np.abs(res.confusion_matrix - np.asarray(
            shipped.metadata["confusion_matrix"])).max())
        txt = (f"confusion matrix {res.confusion_matrix.tolist()}, threshold "
               f"{res.threshold}, F {res.fidelity:.12f}")
    else:
        d_host = float(np.abs(res.populations - host.populations).max())
        d_ship = abs(res.final_nbar - shipped.error_rates["final_nbar"])
        txt = (f"final nbar {res.final_nbar:.12f}, P(n=0) "
               f"{res.ground_state_fraction:.12f}")
    say("13 primitives", f"{which} on the card: {txt}; max|card - host scipy "
        f"expm| = {d_host:.3e} (tol 1e-10); vs the shipped {regime}: "
        f"{d_ship:.3e}, error rates {d_rates:.3e} (tol 1e-10); median "
        f"{med * 1e3:.3f} ms a call of 3 ({[round(t * 1e3, 3) for t in times]}); "
        f"max_squarings {ms_needed} (s = {ms_needed}), K2 launches per call "
        f"{launches / 3:g}")
    require(d_host <= 1e-10 and d_ship <= 1e-10 and d_rates <= 1e-10,
            f"{which}: card = scipy = shipped record within 1e-10")
    require(launches > 0, f"K2 launched by {which}")


def phase_primitives(launch_ms):
    """Phase 13: the Layer-1 primitives and their gate engines. Returns K2's
    records for the kernels line at the engines' squaring inputs."""
    import os
    import tempfile
    from unittest import mock
    import torch
    from scipy.linalg import expm as sexpm
    from noisyquantumsimulator_tpu_torch.channels import CalibrationStore
    from noisyquantumsimulator_tpu_torch.channels.calibration import (
        _complex_matrix_from_json)
    from noisyquantumsimulator_tpu_torch.gate import (cooling, ms_gate,
                                                      open_system, readout)
    from noisyquantumsimulator_tpu_torch.ops import expm as texpm
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.primitives import (IonBackend,
                                                            NeutralAtomBackend)
    from noisyquantumsimulator_tpu_torch.studies import ms_gate_engine_study
    scipy_engine = lambda A, device=None: sexpm(A)
    gens = []
    real_engine = readout._expm_engine

    def spy_engine(A, device="cuda"):
        gens.append(np.asarray(A, np.float64))
        return real_engine(A, device)

    # --- readout (540 x 540) and cooling (81 x 81), float64 on the card
    entries = []
    for which, sim, make, regime in (
            ("readout", readout.simulate_fluorescence_readout,
             readout.readout_calibration_record, "rb87_highna_2ms"),
            ("cooling", cooling.simulate_sideband_cooling,
             cooling.cooling_calibration_record, "rb87_rsc_100khz")):
        with _engine_as(spy_engine):
            sim()
        G = gens[-1]
        need = texpm.squarings_for(np.abs(G).sum(axis=0).max(), "pade13")
        res, med, times, launches = _timed(sim)
        with _engine_as(scipy_engine):
            host = sim()
        _engine_record(which, regime, res, host, make, launches, med, times, need)
        A = torch.as_tensor(G, device="cuda")[None]
        R, s = _pade_inputs(A, need)
        N = G.shape[0]
        route = "tiled, 16-byte copies" if N > 81 else "resident"
        row = _k2_at(R, s, need, f"({1}, {N}) float64 [{which}, {route}]",
                     launch_ms, 20)
        if which == "readout":
            R9, s9 = _pade_inputs(A[:, :539, :539].contiguous(), need)
            check = _k2_at(R9, s9, need, "(1, 539) float64 [the readout generator "
                           "cut to 539: tiled, element copies]", launch_ms, 20)
            row["element_route_check"] = dict(
                check, shape="B=1 N=539 float64, max_squarings 6 (tiled route, "
                             "element-by-element copies); not on the main path")
        entries.append(dict(
            {"name": f"K2 masked_squaring (1, {N}) float64 [{which}]",
             "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
             "launches": launches}, **row,
            library_call="torch.linalg.matrix_power(R, 2**s)",
            launched_by=f"3 simulate_{'fluorescence_readout' if which == 'readout' else 'sideband_cooling'}"
                        f"() calls",
            shape=f"B=1 N={N} float64, {need} trips ({route.split(',')[0]} route)"))

    # --- NeutralAtomBackend: shipped records, then everything generated
    default = CalibrationStore()
    before = {p: os.stat(p).st_mtime_ns for p in default.list_records()}
    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        b1 = NeutralAtomBackend(device="cuda")
    t_b1 = time.perf_counter() - t0
    l_b1 = fused_masked_squaring.launches
    after = {p: os.stat(p).st_mtime_ns for p in default.list_records()}
    require(before == after, "the default store is read, not written")
    t0 = time.perf_counter()
    b1.cz()
    t_cz = time.perf_counter() - t0
    sum1 = b1.summary()
    with tempfile.TemporaryDirectory() as tmp:
        store = CalibrationStore(tmp)
        fused_masked_squaring.launches = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            b2 = NeutralAtomBackend(device="cuda", calibration_store=store)
        t_b2 = time.perf_counter() - t0
        l_b2 = fused_masked_squaring.launches
        saved = sorted(os.path.relpath(p, tmp) for p in store.list_records())
    sum2 = b2.summary()
    say("13 primitives", f"NeutralAtomBackend(device='cuda'), default store: "
        f"{t_b1:.3f} s (Raman on the host, {l_b1} K2 launches), cz() "
        f"{t_cz * 1e6:.1f} us; summary {sum1}")
    say("13 primitives", f"NeutralAtomBackend(device='cuda'), empty temporary "
        f"store: {t_b2:.3f} s, {l_b2} K2 launches, saved {saved}; summary {sum2}")
    require(l_b2 > 0 and len(saved) == 4, "CZ, Raman, cooling and readout "
            "generated on the card and saved")
    for k in sum1:
        tol = 1e-4 if k.startswith("cz_") else 1e-10
        ok = sum1[k] == sum2[k] or abs(sum1[k] - sum2[k]) <= tol
        require(ok, f"backend summaries agree on {k}: {sum1[k]} vs {sum2[k]}")

    # --- the MS gate at the shipped records' regimes: 19 expms of (1600, 1600)
    # complex128 a call, K2 tiled
    stacks = []
    real_expm = texpm.expm

    def spy_expm(A, **kw):
        if not stacks and A.shape[0] == 7:
            stacks.append(A.clone())
        return real_expm(A, **kw)
    ms_launches = None
    # the shipped records' regimes, n_fock = 10, the default 7 Gauss-Hermite
    # nodes (the study that made them owns them)
    for regime, kw in ms_gate_engine_study.REGIMES.items():
        rec = CalibrationStore().load("trapped_ions", "ms_gate", regime)
        S_rec = _complex_matrix_from_json(rec.superop)
        F_rec = 1.0 - rec.error_rates["avg_gate_infidelity"]
        with mock.patch.object(open_system, "expm", spy_expm):
            ms_gate.simulate_ms_gate(n_fock=10, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, med, times, launches = _timed(
            lambda: ms_gate.simulate_ms_gate(n_fock=10, **kw))
        peak = torch.cuda.max_memory_allocated()
        ms_launches = launches if ms_launches is None else ms_launches
        dS = float(np.abs(res.superop - S_rec).max())
        dF = abs(res.fidelity - F_rec)
        say("13 primitives", f"simulate_ms_gate(n_fock=10) [{regime}] on the card, "
            f"complex128: F {res.fidelity:.12f} (record {F_rec:.12f}, |dF| "
            f"{dF:.3e}), max|S - S_record| = {dS:.3e} (tol 1e-10); median "
            f"{med:.3f} s a call of 3 ({[round(t, 3) for t in times]}); K2 "
            f"launches per call {launches / 3:g}; peak device memory "
            f"{peak / 2 ** 30:.3f} GiB; nbar recorded {res.parameters['nbar']}")
        require(dS <= 1e-10 and dF <= 1e-10, f"MS {regime}: the shipped record")
        require(launches > 0, "K2 launched by the MS engine")

    # --- IonBackend: the shipped record, its fidelities
    ion = IonBackend(device="cuda")
    rec = ion.ms_calibration
    F_ms, F_cz = ion.ms().fidelity, ion.cz().fidelity
    say("13 primitives", f"IonBackend(device='cuda'): summary {ion.summary()}")
    require(abs(F_ms - (1.0 - rec.error_rates["avg_gate_infidelity"])) <= 1e-12
            and 0.99 < F_cz <= F_ms, "IonBackend ms() / cz() from the record")

    # --- K2 at the MS engine's squaring inputs: the "full" case's 7 nodes
    need = int(texpm._needed_squarings(stacks[0], texpm._THETA13).max())
    R, s = _pade_inputs(stacks[0], need)
    del stacks
    row = _k2_at(R, s, need, "(7, 1600) complex128 [MS gate, tiled]", launch_ms, 3)
    del R, s
    torch.cuda.empty_cache()
    entries.append(dict(
        {"name": "K2 masked_squaring (7, 1600) complex128 [MS gate]",
         "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
         "launches": ms_launches}, **row,
        library_call="torch.linalg.matrix_power(R, 2**s)",
        launched_by="3 simulate_ms_gate(n_fock=10) calls [yb171_default]",
        shape=f"B=7 N=1600 complex128, {need} trips (tiled route)"))
    return entries


# phase 14: the reference's qec records and the reps the phase runs of each
# (its suite runs 6 and 27; at least 3 and 8 here)
QEC_RECORDS = (("qec_d7", 7, 1 << 20, 6), ("qec_d9", 9, 1 << 18, 27))
QEC_DECODE_SHOTS = 1 << 17
QEC_CHECK_SHOTS = 4096


def _dem_detector_rates(circuit):
    """Each detector's analytic flip rate (1 - prod(1 - 2 p_i)) / 2 over the
    merged DEM mechanisms that flip it (independent mechanisms)."""
    from noisyquantumsimulator_tpu_torch.qec.dem import build_dem
    dem = build_dem(circuit).merged()
    q = np.ones(circuit.n_detectors)
    for m in dem.mechanisms:
        for det in m.detectors:
            q[det] *= 1.0 - 2.0 * m.probability
    return (1.0 - q) / 2.0, len(dem.mechanisms)


def _qec_checks(tag, d, rounds, gen):
    """Phase 14's decoder checks at one distance, on QEC_CHECK_SHOTS shots:
    the card's decode against the native whole-shot exact DP on every shot
    the card certifies, and against the port's CPU path bit for bit (the
    record's decoder, built for each device)."""
    import torch
    from noisyquantumsimulator_tpu_torch import bench_qec

    wg, wc = (bench_qec.build_qec_workload(d, rounds, 1e-3, QEC_DECODE_SHOTS,
                                           device) for device in ("cuda", "cpu"))
    dets = wg.sampler(gen)["detectors"][:QEC_CHECK_SHOTS]
    pg, fg = bench_qec.device_decode(wg.decoder, dets, wg.chunk)
    t0 = time.perf_counter()
    pc, fc = bench_qec.device_decode(wc.decoder, dets.cpu(), wc.chunk)
    cpu_s = time.perf_counter() - t0
    pg, fg = pg.cpu(), fg.cpu()
    same_p, same_f = bool(torch.equal(pg, pc)), bool(torch.equal(fg, fc))
    say("14 surface", f"{tag}: {QEC_CHECK_SHOTS} shots, card vs the port's CPU "
        f"path (CPU {cpu_s:.2f} s): predictions identical {same_p} "
        f"({int((pg != pc).sum())} differ), flags identical {same_f} "
        f"({int(fg.sum())} flagged on the card, {int(fc.sum())} on the CPU)")
    require(same_p and same_f, f"{tag}: the card's decode equals the CPU path's")

    # certified: the tiered DP decoded every defect; the cluster decoder
    # raised no flag
    cert = (wg.decoder.exact_rows(dets).cpu() if d <= 7 else ~fg).numpy()
    t0 = time.perf_counter()
    o = wg.native.decode_batch_ex(dets.cpu().numpy(), mode=1)
    nat_s = time.perf_counter() - t0
    both = cert & o["exact"]
    diff = int(((pg.numpy() & 1) != (o["pred"] & 1))[both].sum())
    say("14 surface", f"{tag}: card vs the native whole-shot exact DP (mode 1, "
        f"{nat_s:.2f} s): {int(both.sum())} shots certified by both, "
        f"{diff} differ; {int((~cert).sum())} shots not certified by the card, "
        f"{int((~o['exact']).sum())} past the oracle's 22 defects; mean "
        f"defects {float(o['n_defects'].mean()):.3f}, max {int(o['n_defects'].max())}")
    require(diff == 0, f"{tag}: the card's decode equals the exact DP on "
            "every certified shot")


def phase_surface(launch_ms):
    """Phase 14: the surface-code memory path at the reference's qec_d7 and
    qec_d9 sizes (bench_qec). Returns the sampler kernel's entry at the
    decode's d = 7 shape."""
    import torch
    from noisyquantumsimulator_tpu_torch import bench_qec
    from noisyquantumsimulator_tpu_torch.qec import native, sampler_cuda
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import (
        build_fast_sampler)
    from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.build()
    say("14 surface", f"native library {native.library_path().name} "
        f"({time.perf_counter() - t0:.2f} s)")
    with open("BENCH_CANON.json") as f:
        canon = json.load(f)["records"]

    def gen(seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        return g

    # --- the sampler against the DEM's analytic detector rates, d = 7
    circuit = memory_z_circuit(7, 7, p=1e-3)
    rate, n_mech = _dem_detector_rates(circuit)
    N = 1 << 20
    sampler = build_fast_sampler(circuit, N, "cuda")
    counts = sampler(gen(SEED + 14))["detectors"].sum(dim=0, dtype=torch.int64)
    emp = counts.cpu().numpy() / N
    z = (emp - rate) / np.sqrt(rate * (1 - rate) / N)
    say("14 surface", f"qec_d7 sampler: {circuit.n_detectors} detectors, "
        f"{len(sampler.faults)} fault bits, {n_mech} DEM mechanisms; "
        f"{N} shots: detector rates {emp.min():.5f}..{emp.max():.5f}, "
        f"max |z| vs the DEM's analytic rates {np.abs(z).max():.2f} (tol 5)")
    require(np.abs(z).max() < 5.0, "sampler rates within 5 sigma of the DEM")
    del sampler, counts
    torch.cuda.empty_cache()
    sampler = build_fast_sampler(circuit, QEC_DECODE_SHOTS, "cuda")
    walk_row = _fault_walk_row(sampler, QEC_DECODE_SHOTS, gen(SEED + 15), launch_ms,
                               None, "14 surface")
    del sampler
    torch.cuda.empty_cache()

    # --- decoder checks at both distances
    for tag, d, _, _ in QEC_RECORDS:
        _qec_checks(tag, d, d, gen(SEED + 140 + d))
        torch.cuda.empty_cache()

    # --- the records; the sampler kernel's launches counted in each: the
    # throughput's warm-up and calls, the decode's warm-up and reps, the
    # profiled rep and its warm-up
    for tag, d, shots, reps in QEC_RECORDS:
        sampler_cuda.walk.launches = 0
        rec = bench_qec.main_qec(d=d, rounds=d, p=1e-3, shots=shots,
                                 decode_shots=QEC_DECODE_SHOTS,
                                 reps_decode=reps, seed=0, device="cuda")
        torch.cuda.empty_cache()
        launches = sampler_cuda.walk.launches
        require(launches == rec["sample_calls"] + reps + 4,
                f"{tag}: the sampler kernel launches once a sample ({launches} "
                f"launches, {rec['sample_calls']} throughput calls, {reps} reps)")
        if tag == "qec_d7":
            walk_row["launches"] = launches
        print(json.dumps(rec, separators=(",", ":")), flush=True)
        lo, hi = rec["e2e_p_logical_ci95"]
        rlo, rhi = canon[tag]["e2e_p_logical_ci95"]
        say("14 surface", f"{tag}: sample {rec['value']:.1f} shots/s "
            f"({rec['shots_per_call']} a call, median of {rec['sample_calls']});"
            f" e2e {rec['e2e_sample_decode_shots_per_sec']:.1f} shots/s over "
            f"{reps} reps of {QEC_DECODE_SHOTS}; p_L {rec['e2e_p_logical_shot']:.4e}"
            f" ({rec['e2e_n_errors']} errors in {rec['e2e_n_decoded']}), 95% CI "
            f"[{lo:.4e}, {hi:.4e}] vs the reference's [{rlo:.4e}, {rhi:.4e}]; "
            f"escalated {rec['e2e_escalated_fraction']:.6f} (cap "
            f"{rec['e2e_fetch_cap']} rows a rep); peak device memory "
            f"{rec['peak_device_gib']} GiB; idle share of one rep "
            f"{rec['idle_share_one_rep']}; top device ops {rec['top_device_ops_us']}")
        require(lo <= rhi and rlo <= hi, f"{tag}: p_L CI overlaps the reference's")
        require(rec["e2e_escalated_fraction"] * QEC_DECODE_SHOTS
                <= rec["e2e_fetch_cap"], f"{tag}: escalation under the fetch cap")
    say("14 surface", f"phase wall time {time.perf_counter() - t_phase:.1f} s "
        f"(reps: {', '.join(f'{t} {r}' for t, _, _, r in QEC_RECORDS)})")
    return walk_row


def _spy_expm(stacks):
    """A stand-in for gate/open_system's expm that keeps each operand and its
    max_squarings, and checks that count against what the operand needs on
    the card (a count too small gives NaN there, not an error)."""
    from noisyquantumsimulator_tpu_torch.ops import expm as texpm
    real = texpm.expm

    def spy(A, **kw):
        need = int(texpm._needed_squarings(A, texpm._THETA13).max())
        ms = kw.get("max_squarings")
        require(ms is not None and need <= ms,
                f"expm of {tuple(A.shape)}: max_squarings {ms} covers the "
                f"{need} squarings the card needs")
        stacks.append((A.clone(), ms))
        return real(A, **kw)
    return spy


def _k2_entry(row, shape_name, launches, launched_by, shape):
    return dict({"name": f"K2 masked_squaring {shape_name}", "route": "cuda",
                 "source": K2_SOURCE, "replaces": K2_REPLACES,
                 "launches": launches}, **row,
                library_call="torch.linalg.matrix_power(R, 2**s)",
                launched_by=launched_by, shape=shape)


def phase_cavity(launch_ms):
    """Phase 15: the cavity exchange gate at n_fock = 6 for both shipped
    regimes (7 noise cases, one (1, 576, 576) complex128 expm each) against
    the shipped records and the host scipy engine; CavityBackend from the
    default store and from an empty temporary store (the in-process record
    at n_fock = 4); K2 at both shapes. Returns K2's two kernel entries."""
    import os
    import tempfile
    from unittest import mock
    import torch
    from noisyquantumsimulator_tpu_torch.channels import CalibrationStore
    from noisyquantumsimulator_tpu_torch.channels.calibration import (
        _complex_matrix_from_json)
    from noisyquantumsimulator_tpu_torch.gate import cavity_gate, open_system
    from noisyquantumsimulator_tpu_torch.ops import expm as texpm
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.primitives.cavity_backend import (
        CavityBackend)
    from noisyquantumsimulator_tpu_torch.studies import cavity_gate_engine_study
    t_phase = time.perf_counter()
    stacks = []
    launches_576 = None
    # the shipped records store the last noise case's nbar_cavity (0.0), not
    # the run's, so the regimes come from the study that made them
    for regime, kw in cavity_gate_engine_study.REGIMES.items():
        rec = CalibrationStore().load("cavity_qed", "exchange_gate", regime)
        S_rec = _complex_matrix_from_json(rec.superop)
        F_rec = 1.0 - rec.error_rates["avg_gate_infidelity"]
        n0 = len(stacks)
        with mock.patch.object(open_system, "expm", _spy_expm(stacks)):
            cavity_gate.simulate_cavity_gate(n_fock=6, device="cuda", **kw)
        sq = [ms for _, ms in stacks[n0:]]
        norms = [float(A.abs().sum(dim=-2).amax()) for A, _ in stacks[n0:]]
        require(len(sq) == 7 and all(
            ms == texpm.squarings_for(n, "pade13") for ms, n in zip(sq, norms)),
            f"{regime}: 7 cases, each with max_squarings from its 1-norm")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, med, times, launches = _timed(lambda: cavity_gate.simulate_cavity_gate(
            n_fock=6, device="cuda", **kw))
        peak = torch.cuda.max_memory_allocated()
        launches_576 = launches if launches_576 is None else launches_576
        t0 = time.perf_counter()
        host = cavity_gate.simulate_cavity_gate(n_fock=6, engine="host", **kw)
        t_host = time.perf_counter() - t0
        # the host half of a call: the same call with the device channel
        # replaced by a constant
        with mock.patch.object(cavity_gate, "qubit_channel_device",
                               lambda *a, **k: np.eye(16, dtype=complex)):
            t0 = time.perf_counter()
            cavity_gate.simulate_cavity_gate(n_fock=6, device="cuda", **kw)
            t_half = time.perf_counter() - t0
        dS, dF = float(np.abs(res.superop - S_rec).max()), abs(res.fidelity - F_rec)
        dSh, dFh = (float(np.abs(res.superop - host.superop).max()),
                    abs(res.fidelity - host.fidelity))
        dB = max(abs(res.error_budget[k] - host.error_budget[k])
                 for k in host.error_budget)
        say("15 cavity", f"simulate_cavity_gate(n_fock=6) [{regime}] on the card, "
            f"complex128, 7 cases of (1, 576, 576): F {res.fidelity:.12f} (record "
            f"{F_rec:.12f}, |dF| {dF:.3e}), max|S - S_record| = {dS:.3e}; vs the "
            f"host scipy engine ({t_host:.3f} s): superop {dSh:.3e}, F {dFh:.3e}, "
            f"budget {dB:.3e} (tol 1e-10); median {med * 1e3:.3f} ms a call of 3 "
            f"({[round(t * 1e3, 3) for t in times]}), its host half (Liouvillian "
            f"stacks, fidelities; the device channel stubbed) {t_half * 1e3:.3f} ms;"
            f" K2 launches per call {launches / 3:g}; max_squarings per case {sq} (1-norms "
            f"{min(norms):.1f}..{max(norms):.1f}); peak device memory "
            f"{peak / 2 ** 20:.1f} MiB; nbar_cavity recorded "
            f"{res.parameters['nbar_cavity']} (the record says "
            f"{rec.parameters['nbar_cavity']})")
        require(max(dS, dF, dSh, dFh, dB) <= 1e-10,
                f"cavity {regime}: the shipped record and the host engine")
        require(launches > 0, "K2 launched by the cavity engine")
        require(res.parameters["nbar_cavity"] == kw["nbar_cavity"],
                "the record's parameters are the run's")

    # --- CavityBackend: the shipped record, then the in-process fallback
    default = CalibrationStore()
    before = {p: os.stat(p).st_mtime_ns for p in default.list_records()}
    t0 = time.perf_counter()
    b1 = CavityBackend(device="cuda")
    t_b1 = time.perf_counter() - t0
    say("15 cavity", f"CavityBackend(device='cuda'), default store: {t_b1:.4f} s;"
        f" summary {b1.summary()}")
    require(b1.exchange_calibration.regime == "circuit_qed_exchange",
            "the default store's record")
    n0 = len(stacks)
    with tempfile.TemporaryDirectory() as tmp:
        fused_masked_squaring.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(open_system, "expm", _spy_expm(stacks)):
            b2 = CavityBackend(device="cuda", calibration_store=CalibrationStore(tmp))
        t_b2 = time.perf_counter() - t0
        launches_256 = fused_masked_squaring.launches
        c2 = CavityBackend(device="cpu", calibration_store=CalibrationStore(tmp))
    d_sum = max(abs(v - c2.summary()[k]) for k, v in b2.summary().items()
                if isinstance(v, float))
    say("15 cavity", f"CavityBackend(device='cuda'), empty temporary store: "
        f"{t_b2:.3f} s (simulate_cavity_gate(n_fock=4) on the card, 7 cases of "
        f"(1, 256, 256), {launches_256} K2 launches); vs the same on the CPU: "
        f"summary {d_sum:.3e} (tol 1e-12); summary {b2.summary()}")
    require(launches_256 > 0 and d_sum <= 1e-12,
            "the in-process record on the card equals the CPU's")
    after = {p: os.stat(p).st_mtime_ns for p in default.list_records()}
    require(before == after, "the default store is read, not written")

    # --- K2 at both shapes: the case that needs the most squarings
    entries = []
    for (A, need), shape_name, launches, by in (
            (max(stacks[:n0], key=lambda a: a[1]), "(1, 576) complex128 [cavity gate]",
             launches_576, "3 simulate_cavity_gate(n_fock=6) calls [rb_fiber_cavity]"),
            (max(stacks[n0:], key=lambda a: a[1]), "(1, 256) complex128 [cavity fallback]",
             launches_256, "1 CavityBackend() from an empty store "
                           "(simulate_cavity_gate(n_fock=4))")):
        R, s = _pade_inputs(A, need)
        N = A.shape[-1]
        row = _k2_at(R, s, need, shape_name.replace("]", ", tiled]"), launch_ms,
                     20, phase="15 cavity")
        entries.append(_k2_entry(row, shape_name, launches, by,
                                 f"B=1 N={N} complex128, {need} trips (tiled route)"))
    del stacks
    torch.cuda.empty_cache()
    say("15 cavity", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return entries


# phase 16: the d = 5 extraction circuit compiled onto a 9 x 9 grid; the
# reference's compiler gives these counts and makespans on the host (they are
# deterministic host results: native ops, SWAPs, makespan in s)
ARCH_COMPILE = {"neutral_atoms": (24227, 1047, 0.0008140499999999772),
                "trapped_ions": (25027, 1047, 0.036503500000000605),
                "cavity_qed": (24227, 1047, 0.0008140499999999772)}
ARCH_SHOTS = 1 << 20
# the four CX layers of a round of extraction, as (dx, dy) from each ancilla
# to its data qubit; X ancillas (controls) before Z ancillas in every layer
EXTRACTION_LAYERS = ((-1, -1), (1, -1), (-1, 1), (1, 1))


def _extraction_gates(d, rounds):
    """The rotated surface code's CX-based syndrome extraction as compiler
    Gates: per round H on the X ancillas, the four CX layers, H again."""
    from noisyquantumsimulator_tpu_torch.qec.compiler import Gate
    from noisyquantumsimulator_tpu_torch.qec.surface_code import build_layout
    lay = build_layout(d)
    xanc, zanc = sorted(lay.x_anc), sorted(lay.z_anc)
    hs = [Gate("h", (lay.x_anc[a],)) for a in xanc]
    out = []
    for _ in range(rounds):
        out += hs
        for dx, dy in EXTRACTION_LAYERS:
            out += [Gate("cx", (lay.x_anc[a], lay.data[(a[0] + dx, a[1] + dy)]))
                    for a in xanc if (a[0] + dx, a[1] + dy) in lay.data]
            out += [Gate("cx", (lay.data[(a[0] + dx, a[1] + dy)], lay.z_anc[a]))
                    for a in zanc if (a[0] + dx, a[1] + dy) in lay.data]
        out += hs
    return out, lay.n_qubits


def _exact_frame_rates(circuit):
    """Each qubit's exact X- and Z-frame rates at the end of an errors-only
    circuit without measurements: (1 - prod(1 - 2 q_i)) / 2 over the
    channels that touch it, q_i the channel's marginal probability of X or Y
    (X frame), Z or Y (Z frame) on the qubit."""
    n = circuit.n_qubits
    keep = {"x": np.ones(n), "z": np.ones(n)}
    pa, pb = np.divmod(np.arange(16), 4)

    def hit(q, px, pz):
        keep["x"][q] *= 1.0 - 2.0 * px
        keep["z"][q] *= 1.0 - 2.0 * pz

    for ins in circuit.instructions:
        p = ins.arg or 0.0
        require(ins.name in ("X_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2",
                             "PAULI_CHANNEL_2"), f"no {ins.name} in the circuit")
        for t in np.asarray(ins.targets):
            if ins.name == "X_ERROR":
                hit(t, p, 0.0)
            elif ins.name == "Z_ERROR":
                hit(t, 0.0, p)
            elif ins.name == "DEPOLARIZE1":
                hit(t, 2 * p / 3, 2 * p / 3)
            elif ins.name == "DEPOLARIZE2":
                hit(t[0], 8 * p / 15, 8 * p / 15)
                hit(t[1], 8 * p / 15, 8 * p / 15)
            else:
                pr = np.asarray(ins.probs, np.float64)
                for q, k in ((t[0], pa), (t[1], pb)):
                    hit(q, pr[(k == 1) | (k == 2)].sum(), pr[(k == 2) | (k == 3)].sum())
    return (1.0 - keep["x"]) / 2.0, (1.0 - keep["z"]) / 2.0


def _rep_code(n_data, p):
    """The bit-flip repetition code of the reference's four-engine check
    (tests/test_solver.py:200-210) with n_data data qubits (even indices)
    and n_data - 1 ancillas: X_ERROR(p) on the data, two CX into each
    ancilla, MR on the ancillas. Exact detector rate 2p(1 - p)."""
    from noisyquantumsimulator_tpu_torch.qec.circuits import Circuit
    c = Circuit(n_qubits=2 * n_data - 1)
    c.append("X_ERROR", list(range(0, 2 * n_data - 1, 2)), arg=p)
    anc = list(range(1, 2 * n_data - 1, 2))
    for a in anc:
        c.append("CX", np.array([[a - 1, a]]))
        c.append("CX", np.array([[a + 1, a]]))
    c.append("MR", anc)
    return c


def phase_architecture():
    """Phase 16: the architecture loop at full width: the d = 5 extraction
    circuit compiled for each platform, executed at 2^20 shots on every
    backend against the exact marginals; the cavity rows of the study's
    memory experiment; the exact circuit simulators at their users' limits."""
    import torch
    from noisyquantumsimulator_tpu_torch.primitives import (IonBackend,
                                                            NeutralAtomBackend)
    from noisyquantumsimulator_tpu_torch.primitives.cavity_backend import (
        CavityBackend)
    from noisyquantumsimulator_tpu_torch.qec.compiler import compile_circuit
    from noisyquantumsimulator_tpu_torch.qec.executor import (
        compiled_to_error_circuit, execute)
    from noisyquantumsimulator_tpu_torch.qec.memory import run_memory
    from noisyquantumsimulator_tpu_torch.qec.topology import grid_topology
    from noisyquantumsimulator_tpu_torch.solver.circuit_sim import (
        DensityMatrixSimulator, TrajectorySimulator)
    from noisyquantumsimulator_tpu_torch.studies.ion_memory import (
        PLATFORMS, backend_pricing, priced_circuit)
    from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci
    from noisyquantumsimulator_tpu_torch.utils.profiling import profile_window
    t_phase = time.perf_counter()
    gates, n_log = _extraction_gates(5, 5)
    require((n_log, len(gates)) == (49, 520), "d = 5, 5 rounds: 49 qubits, 520 gates")
    compiled = {}
    for platform, (n_ops, n_swaps, makespan) in ARCH_COMPILE.items():
        t0 = time.perf_counter()
        cc = compile_circuit(gates, grid_topology(9, 9), platform=platform)
        t_c = time.perf_counter() - t0
        say("16 architecture", f"compile_circuit(d = 5 extraction, grid 9 x 9, "
            f"{platform}): {len(cc.ops)} native ops, {cc.n_swaps} SWAPs, "
            f"{cc.n_moves} moves, makespan {cc.schedule.total_time * 1e6:.4f} us, "
            f"{cc.schedule.n_layers} layers; host {t_c:.2f} s (the reference's: "
            f"{n_ops}, {n_swaps}, {makespan * 1e6:.4f} us)")
        require((len(cc.ops), cc.n_swaps, cc.schedule.total_time)
                == (n_ops, n_swaps, makespan), f"{platform}: the reference's compile")
        compiled[platform] = cc

    backends = (("neutral_atoms", "NeutralAtomBackend()",
                 lambda: NeutralAtomBackend(device="cuda")),
                ("trapped_ions", "IonBackend() [yb171_default]",
                 lambda: IonBackend(device="cuda")),
                ("cavity_qed", "CavityBackend() [circuit_qed_exchange]",
                 lambda: CavityBackend(regime="circuit_qed_exchange", device="cuda")),
                ("cavity_qed", "CavityBackend() [rb_fiber_cavity]",
                 lambda: CavityBackend(regime="rb_fiber_cavity", device="cuda")))
    cavity = {}
    for i, (platform, name, make) in enumerate(backends):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            b = make()
        if platform == "cavity_qed":
            cavity[b.regime] = b
        cc = compiled[platform]
        circuit = compiled_to_error_circuit(cc, b)
        fx, fz = _exact_frame_rates(circuit)
        run = lambda: execute(cc, b, shots=ARCH_SHOTS, seed=SEED + 160 + i,
                              device="cuda")
        wall, idle, by_name, _, n_ev = profile_window(
            run, f"execute_{i}", n_calls=1, host_ops=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        t_x = time.perf_counter() - t0
        worst = 0.0
        for got, want in ((res.per_qubit_flip_rate, fx), (res.per_qubit_phase_rate, fz)):
            sd = np.sqrt(want * (1 - want) / ARCH_SHOTS)
            require(np.all(got[sd == 0] == want[sd == 0]), "rates that are 0 are 0")
            worst = max(worst, float((np.abs(got - want)[sd > 0] / sd[sd > 0]).max()))
        top = sorted((by_name or {}).items(), key=lambda kv: -kv[1])[:4]
        say("16 architecture", f"execute({platform}, {name}, {ARCH_SHOTS} shots) "
            f"on the card: {len(circuit.instructions)} channel instructions on "
            f"{circuit.n_qubits} qubits; {t_x:.3f} s a call ({wall:.3f} s under "
            f"the profiler), {n_ev} device events a call, idle share "
            f"{'not measured' if idle is None else f'{idle:.4f}'}; P(any error) "
            f"{res.p_any_error:.6f}; flip rates {res.per_qubit_flip_rate.min():.3e}"
            f"..{res.per_qubit_flip_rate.max():.3e}, phase rates "
            f"{res.per_qubit_phase_rate.min():.3e}..{res.per_qubit_phase_rate.max():.3e}"
            f"; max |z| vs the exact marginals {worst:.2f} (tol 5); top device "
            f"ops {[(k[:40], round(v, 1)) for k, v in top]} us")
        require(worst <= 5.0, f"{name}: every qubit's rates within 5 sigma")
        require(n_ev > 0, f"{name}: the executor ran on the card")

    # --- the cavity rows of the study's memory experiment at d = 3
    with open("examples/ion_memory.json") as f:
        shipped = json.load(f)["platforms"]
    for name in ("cavity_circuit_qed", "cavity_rb_fiber"):
        regime = PLATFORMS[name][1]["regime"]
        ref = shipped[name]["memory"]["d3"]
        k_ref, n_ref = ref["n_errors"], ref["shots"]
        pr = backend_pricing(cavity[regime])
        t0 = time.perf_counter()
        res = run_memory(d=3, rounds=3, p=0.0, shots=ARCH_SHOTS,
                         circuit=priced_circuit(3, pr), seed=0, device="cuda")
        t_m = time.perf_counter() - t0
        lo, hi = wilson_ci(res.n_logical_errors, ARCH_SHOTS)
        rlo, rhi = wilson_ci(k_ref, n_ref)
        say("16 architecture", f"memory d = 3 [{regime}] priced by CavityBackend "
            f"(p_meas {pr['p_meas']:.6e}, p_idle {pr['p_idle']:.6e}): p_L "
            f"{res.p_logical_shot:.6f} ({res.n_logical_errors} / {ARCH_SHOTS}), "
            f"95% CI [{lo:.6f}, {hi:.6f}] vs the study's {k_ref} / {n_ref} "
            f"[{rlo:.6f}, {rhi:.6f}]; decoder {res.decoder}; {t_m:.2f} s")
        require(lo <= rhi and rlo <= hi, f"{regime}: p_L CI overlaps the study's")

    # --- the exact simulators at their users' limits
    p = 0.05
    exact = 2 * p * (1 - p)
    rep = _rep_code(6, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dm = DensityMatrixSimulator(rep, device="cuda").run()["measurement_probs"].cpu()
    t_dm = time.perf_counter() - t0
    err = float((dm - exact).abs().max())
    say("16 architecture", f"DensityMatrixSimulator, {rep.n_qubits}-qubit "
        f"repetition code (6 data), rho (2048, 2048) complex64: {t_dm:.3f} s; "
        f"max|p - 2p(1-p)| = {err:.3e} over {dm.numel()} detectors (tol 1e-6)")
    require(dm.numel() == 5 and err <= 1e-6, "density matrix: exact detector rates")
    rep = _rep_code(7, p)
    T = 16384
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meas = TrajectorySimulator(rep, T, device="cuda").sample(gen)["measurements"]
    rates = meas.float().mean(0).cpu().numpy()
    t_tr = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    zt = float(np.abs(rates - exact).max() / np.sqrt(exact * (1 - exact) / T))
    say("16 architecture", f"TrajectorySimulator, {rep.n_qubits}-qubit repetition "
        f"code (7 data), T = {T}, psi ({T}, 8192) complex64: {t_tr:.3f} s, peak "
        f"device memory {peak / 2 ** 30:.3f} GiB; detector rates "
        f"{rates.min():.5f}..{rates.max():.5f}, max |z| vs 2p(1-p) {zt:.2f} (tol 6)")
    require(rates.shape == (6,) and zt <= 6.0, "trajectories: detector rates")
    say("16 architecture", f"phase wall time {time.perf_counter() - t_phase:.1f} s")



def _k2_count(fn):
    """fn() with K2's count set to 0 just before and read just after (after a
    sync): (result, K2 launches, wall s)."""
    import torch
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    torch.cuda.synchronize()
    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, fused_masked_squaring.launches, time.perf_counter() - t0


def _oracle_checks(launches):
    """Phase 17's solver checks, complex128 on the card: evolve_rhos of the
    entry point's 32-segment problem against the host zvode oracle (1 - F
    within 1e-8 for each of the 5 states), the last state of
    evolve_rhos_trajectory against evolve_rhos (1e-12), and
    total_propagator_phased against total_propagator at 300 segments
    (1e-10)."""
    import torch
    from noisyquantumsimulator_tpu_torch.graft_entry import build_small_problem
    from noisyquantumsimulator_tpu_torch.ops.expm import expm
    from noisyquantumsimulator_tpu_torch.ops.hilbert import HS3
    from noisyquantumsimulator_tpu_torch.ops.phase_frame import phase_frame_generator
    from noisyquantumsimulator_tpu_torch.solver.propagator import (
        Schedule, evolve_rhos, evolve_rhos_trajectory, segment_liouvillians,
        total_propagator, total_propagator_phased)
    from noisyquantumsimulator_tpu_torch.solver.reference import (
        mesolve_zvode_liouvillian)
    c128 = torch.complex128
    L0, Cp, Cm, phases, dts, rho0s, _ = build_small_problem(32, dtype=c128)
    put = lambda a: torch.as_tensor(a, device="cuda")
    ops = [put(a) for a in (L0, Cp, Cm)]
    sched = Schedule(np.ones(32), phases, dts)
    rhos, launches["evolve_rhos c128"], wall = _k2_count(
        lambda: evolve_rhos(*ops, sched, put(rho0s)))
    Ls = (segment_liouvillians(*[torch.as_tensor(a) for a in (L0, Cp, Cm)], sched)
          / torch.as_tensor(dts)[:, None, None]).numpy()
    t0 = time.perf_counter()
    ref = [mesolve_zvode_liouvillian(Ls, dts, r) for r in rho0s]
    t_zvode = time.perf_counter() - t0
    got = rhos.cpu().numpy()
    err = max(abs(1.0 - _uhlmann(got[i], ref[i])) for i in range(len(ref)))
    drho = max(float(np.abs(got[i] - ref[i]).max()) for i in range(len(ref)))
    say("17 parallel", f"evolve_rhos, 32 segments, complex128 on the card "
        f"({wall * 1e3:.1f} ms, K2 launches {launches['evolve_rhos c128']}) against "
        f"the host zvode oracle ({t_zvode:.2f} s, atol 1e-10, rtol 1e-8): max|1 - F| "
        f"over the 5 states {err:.3e} (tol 1e-8), max|d rho| {drho:.3e}")
    require(err <= 1e-8, "evolve_rhos within 1e-8 of the zvode oracle")

    traj, launches["evolve_rhos_trajectory c128"], wall = _k2_count(
        lambda: evolve_rhos_trajectory(*ops, sched, put(rho0s)))
    e_last = float((traj[-1] - rhos).abs().max())
    say("17 parallel", f"evolve_rhos_trajectory, 32 segments, complex128: "
        f"{tuple(traj.shape)} in {wall * 1e3:.1f} ms, K2 launches "
        f"{launches['evolve_rhos_trajectory c128']}; max|last state - evolve_rhos| "
        f"{e_last:.3e} (tol 1e-12)")
    require(traj.shape == (33,) + rho0s.shape and e_last <= 1e-12,
            "the trajectory ends at evolve_rhos's state")

    n = 300
    ph = 0.311 * np.pi * np.cos(1.242 * np.linspace(0.0, 10.09, n) - 4.696)
    dt = np.full(n, dts[0] * 32 / n)
    g = phase_frame_generator(L0, Cp, Cm, HS3)
    U_tot, launches["total_propagator c128, 300 segments"], w1 = _k2_count(
        lambda: total_propagator(*ops, Schedule(np.ones(n), ph, dt)))
    U_ph, launches["total_propagator_phased c128"], w2 = _k2_count(
        lambda: total_propagator_phased(expm((ops[0] + ops[1] + ops[2]) * dt[0]),
                                        g, ph))
    e_ph = float((U_ph - U_tot).abs().max())
    say("17 parallel", f"total_propagator_phased (one expm, the telescoped tree, "
        f"{w2 * 1e3:.1f} ms) against total_propagator (300 expms, {w1 * 1e3:.1f} "
        f"ms), 300 segments, complex128: max|dU| {e_ph:.3e} (tol 1e-10)")
    require(e_ph <= 1e-10, "total_propagator_phased equals total_propagator")


def _bb_body_card_vs_cpu(Hx, Hz, p, n_iters, rows):
    """The BB rank body on the card and on the CPU, fed the same error rows:
    equal fail and converged counts, or every differing shot listed with
    |belief| < 1e-4 (a hard decision BP left at a tie)."""
    import torch
    from noisyquantumsimulator_tpu_torch.parallel import bb_mc
    gen = torch.Generator()
    gen.manual_seed(SEED + 17)
    errors = torch.rand((rows, Hz.shape[1]), generator=gen) < p
    outs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        o = bb_mc.rank_body(errors.to(dev), bb_mc.bb_tables(Hx, Hz, p, n_iters, dev))
        outs[dev] = {k: v.cpu() for k, v in o.items()}
        outs[dev]["s"] = time.perf_counter() - t0
    g, c = outs["cuda"], outs["cpu"]
    diff = torch.nonzero((g["fail"] != c["fail"]) | (g["converged"] != c["converged"]))
    diff = diff[:, 0].tolist()
    weak = [int(i) for i in diff
            if min(float(g["belief"][i].abs().min()), float(c["belief"][i].abs().min())) < 1e-4]
    say("17 parallel", f"BB rank body, {rows} fixed error rows, card ({g['s']:.2f} s) "
        f"vs CPU ({c['s']:.2f} s): fail {int(g['fail'].sum())} / "
        f"{int(c['fail'].sum())}, converged {int(g['converged'].sum())} / "
        f"{int(c['converged'].sum())}; shots that differ {diff} "
        f"(with |belief| < 1e-4: {weak})")
    require(len(weak) == len(diff),
            "the card's rank body equals the CPU's shot by shot, but for tied "
            "beliefs")


def phase_parallel(launch_ms):
    """Phase 17: the multi-device layer on a one-rank NCCL group (the card
    is one device): entry(), dryrun_multichip(1), the solver's oracle
    checks, the sharded population objective at P = 1024 and the sharded
    BB-LDPC Monte Carlo at 65536 shots. Returns K2's record for the
    kernels line (the entry point's (32, 81) complex64 chain)."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from noisyquantumsimulator_tpu_torch.graft_entry import (
        build_small_problem, dryrun_multichip, entry)
    from noisyquantumsimulator_tpu_torch.ops.expm import _THETA16, _scale, _taylor16
    from noisyquantumsimulator_tpu_torch.optimize import engine, forward
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
        ApparatusConstraints)
    from noisyquantumsimulator_tpu_torch.optimize.de import differential_evolution
    from noisyquantumsimulator_tpu_torch.parallel import (
        init_rank, make_mesh, make_population_objective_sharded,
        run_bb_memory_sharded)
    from noisyquantumsimulator_tpu_torch.qec.ldpc import gross_code
    from noisyquantumsimulator_tpu_torch.solver.propagator import (
        Schedule, segment_liouvillians)
    from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, os.path.join(tmp, "store"), "cuda")
        try:
            say("17 parallel", f"one-rank {dist.get_backend()} group on "
                f"cuda:{torch.cuda.current_device()}")
            for n, what in ((2, "make_mesh(2)"), (4, "dryrun_multichip(4)")):
                try:
                    make_mesh(n) if n == 2 else dryrun_multichip(n)
                except ValueError as e:
                    say("17 parallel", f"{what} on one rank raises: {e}")
                else:
                    require(False, f"{what} raises on a one-rank group")

            # --- entry(): the 32-segment forward step, K2 on the card
            fn, args = entry()
            F, launches["entry"], wall = _k2_count(lambda: fn(*args))
            fc, ac = entry("cpu")
            F_cpu = float(fc(*ac))
            say("17 parallel", f"entry() forward on the card: F = {float(F):.7f} "
                f"({wall * 1e3:.1f} ms, K2 launches {launches['entry']}); the CPU "
                f"twin path {F_cpu:.7f} (tol 1e-5)")
            require(launches["entry"] == 1, "entry(): one K2 launch")
            require(abs(float(F) - F_cpu) <= 1e-5, "entry(): the card equals the CPU")

            # --- the dry run over a one-rank mesh
            r, launches["dryrun_multichip(1)"], wall = _k2_count(
                lambda: dryrun_multichip(1))
            say("17 parallel", f"dryrun_multichip(1): {wall:.2f} s, mean F "
                f"{r['mean_F']:.6f}, detector fraction "
                f"{r['qec']['detector_fraction']:.4f}, BB p_L "
                f"{r['qec']['bb']['p_logical_shot']:.5f}, DE F {r['de']['F']:.6f}; "
                f"K2 launches {launches['dryrun_multichip(1)']} (the sweep step's "
                f"expm, 3 DE populations, the best member)")
            require(launches["dryrun_multichip(1)"] == 5,
                    "dryrun_multichip(1): five K2 launches")

            _oracle_checks(launches)

            # --- the sharded population objective, P = 1024 (phase 10's)
            P = 1024
            app = ApparatusConstraints()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                problem = engine.build_fixed_problem(app, app.make_full_noise())
            bounds, x0 = forward.get_smooth_jp_bounds_and_x0()
            pop = population_near(x0, bounds, P, 0.1, np.random.default_rng(SEED + 10))
            mesh = make_mesh(axis_names=("pop",))
            obj = make_population_objective_sharded(problem, "smooth_jp", mesh=mesh)
            obj1 = engine.make_population_objective(problem, "smooth_jp")
            obj64 = engine.make_population_objective(problem, "smooth_jp",
                                                     dtype=torch.complex128)
            pop_dev = torch.as_tensor(pop, device="cuda")
            c1, _ = obj1(pop_dev)
            obj(pop_dev)
            (cost, metrics), n_k2, _ = _k2_count(lambda: obj(pop_dev))
            require(n_k2 == 1, "the sharded objective: one K2 launch a call")
            launches["sharded objective, 6 calls"] = n_k2
            same = bool(torch.equal(cost, c1))
            times = []
            for _ in range(5):
                _, n_k2, t = _k2_count(lambda: obj(pop_dev))
                require(n_k2 == 1, "the sharded objective: one K2 launch a call")
                launches["sharded objective, 6 calls"] += n_k2
                times.append(t)
            med = statistics.median(times)
            say("17 parallel", f"make_population_objective_sharded, smooth_jp, P = "
                f"{P} on a one-rank 'pop' mesh: median {med * 1e3:.3f} ms of 5 calls "
                f"-> {P / med:.1f} evaluations/s (times ms "
                f"{[round(t * 1e3, 3) for t in times]}); one K2 launch a call; costs "
                f"equal to the unsharded objective's on the card: {same}")
            require(same, "the sharded costs equal the unsharded objective's")
            _hold_to_c128("smooth_jp (sharded)", problem, "smooth_jp", {}, pop[:8],
                          cost, metrics, obj64, 1e-4, phase="17 parallel")
            res, launches["DE, 2 generations"], wall = _k2_count(
                lambda: differential_evolution(obj, bounds, x0=x0, popsize=P,
                                               maxiter=2))
            say("17 parallel", f"differential_evolution over the sharded objective, "
                f"P = {P}, 2 generations: {wall:.2f} s, K2 launches "
                f"{launches['DE, 2 generations']}, best cost per generation "
                f"{[round(float(h), 4) for h in res.history]}")
            require(launches["DE, 2 generations"] == 3 and len(res.history) == 2
                    and bool(np.all(np.diff(res.history) <= 0.0)),
                    "DE: one K2 launch a generation, history does not increase")
            del obj, obj1, obj64, cost, metrics, pop_dev
            torch.cuda.empty_cache()

            # --- the sharded BB-LDPC Monte Carlo: gross code, 65536 shots a rank
            Hx, Hz = gross_code()
            kw = dict(p=1e-2, shots_per_device=65536, n_iters=50, mesh=make_mesh())
            run_bb_memory_sharded(Hx, Hz, seed=SEED, **kw)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            bb = run_bb_memory_sharded(Hx, Hz, seed=SEED + 1, **kw)
            wall = time.perf_counter() - t0
            lo, hi = wilson_ci(bb["n_fail"], bb["shots"])
            say("17 parallel", f"run_bb_memory_sharded {bb['code']}, p = 1e-2, "
                f"{bb['shots']} shots on {bb['n_devices']} rank, 50 iterations: "
                f"{wall:.3f} s -> {bb['shots'] / wall:.1f} shots/s; p_L "
                f"{bb['p_logical_shot']:.4e} ({bb['n_fail']} errors), 95% CI "
                f"[{lo:.4e}, {hi:.4e}]; converged {bb['bp_converged_frac']:.6f}; "
                f"syndrome weight {bb['syndrome_weight_mean']:.5f} a check; peak "
                f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            require(bb["shots"] == 65536 and 0.0 <= bb["p_logical_shot"] < 0.5,
                    "BB sharded Monte Carlo: a physical p_L")
            torch.cuda.empty_cache()
            _bb_body_card_vs_cpu(Hx, Hz, 1e-2, 50, 4096)
        finally:
            dist.destroy_process_group()

    # --- K2 at the entry point's (32, 81) complex64 squaring inputs
    L0, Cp, Cm, phases, dts, _, _ = build_small_problem()
    A = segment_liouvillians(*[torch.as_tensor(a, device="cuda") for a in (L0, Cp, Cm)],
                             Schedule(np.ones(32), phases, dts))
    As, s = _scale(A, _THETA16)
    R = _taylor16(As, torch.eye(81, dtype=A.dtype, device="cuda").expand(A.shape))
    row = _k2_at(R.contiguous(), s, 12, "(32, 81) complex64 [entry(), the sweep step]",
                 launch_ms, 50, phase="17 parallel", tol=1e-5)
    total = sum(launches.values())
    say("17 parallel", f"K2 launches in this phase's counted runs: {launches} "
        f"(total {total}); phase wall time {time.perf_counter() - t_phase:.1f} s")
    return [_k2_entry(row, "(32, 81, complex64)", total,
                      "phase 17: entry(), dryrun_multichip(1), the oracle checks, "
                      "the sharded objective and its DE",
                      "B=32 N=81 complex64, s from the segments' norms (resident route)")]


def phase_surgery():
    """Phase 18: lattice surgery at d = 5 and the NN decoder, on the card
    (torch ops; the native C++ matcher on the host). No kernel of the port
    runs here."""
    import copy
    import torch
    from noisyquantumsimulator_tpu_torch.qec import native
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    from noisyquantumsimulator_tpu_torch.qec.lattice_surgery import run_zz_surgery
    from noisyquantumsimulator_tpu_torch.qec.nn_decoder import train_nn_decoder
    from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

    t_phase = time.perf_counter()
    native.build()
    N = 131072
    for p in (0.0, 1e-3):
        t0 = time.perf_counter()
        r = run_zz_surgery(5, p=p, shots=N, seed=SEED)
        wall = time.perf_counter() - t0
        if p == 0.0:
            say("18 surgery", f"run_zz_surgery(5, p=0): {N} shots, "
                f"{r['n_detectors']} detectors: detector fraction "
                f"{r['detector_fraction']}, raw rates {r['zz_error_rate_raw']}, "
                f"{r['patch1_logical_error_raw']}, {r['patch2_logical_error_raw']}")
            require(r["detector_fraction"] == 0.0 and r["zz_error_rate_raw"] == 0.0
                    and r["patch1_logical_error_raw"] == 0.0
                    and r["patch2_logical_error_raw"] == 0.0,
                    "surgery at p = 0: every detector and observable is zero")
            continue
        parts = []
        for name in ("zz_error_rate", "patch1_logical_error", "patch2_logical_error"):
            raw, dec = (round(r[name + k] * N) for k in ("_raw", "_decoded"))
            lo, hi = wilson_ci(dec, N)
            parts.append(f"{name} raw {raw / N:.5f} ({raw}), decoded {dec / N:.5f} "
                         f"({dec}, 95% CI [{lo:.5f}, {hi:.5f}])")
            require(dec < raw, f"surgery d = 5: {name} decoded below raw")
        say("18 surgery", f"run_zz_surgery(5, p=1e-3): {N} shots, {r['n_detectors']} "
            f"detectors, {r['n_zz_records']} ZZ records, detector fraction "
            f"{r['detector_fraction']:.5f}: {wall:.2f} s (native decode "
            f"{r['decode_seconds']:.2f} s); " + "; ".join(parts))

    # d = 3 runs twice: the process's first training call and a repeat
    for d, turn in ((3, "first call"), (3, "repeat"), (5, "first call")):
        t0 = time.perf_counter()
        dec, ev = train_nn_decoder(d=d, p=3e-3, steps=300, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lo, hi = wilson_ci(round(ev["p_logical_nn"] * ev["shots"]), ev["shots"])
        say("18 surgery", f"train_nn_decoder(d={d}, p=3e-3, steps=300) on the card, "
            f"{turn} (batch 4096, {dec.layers[0].in_features} features): {wall:.2f} s; "
            f"p_L nn {ev['p_logical_nn']:.5f} (95% CI [{lo:.5f}, {hi:.5f}]), trivial "
            f"{ev['p_logical_trivial']:.5f}, ratio "
            f"{ev['p_logical_nn'] / max(ev['p_logical_trivial'], 1e-12):.3f}; loss "
            f"{[round(h, 4) for h in dec.history]}")
        if d == 3 and turn == "first call":
            require(ev["p_logical_nn"] < 0.6 * ev["p_logical_trivial"],
                    "NN decoder d = 3: p_L below 0.6 of the trivial decoder's")
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED + 18)
            dets = build_fast_sampler(dec.circuit, 4096, "cuda")(gen)["detectors"]
            cpu = copy.deepcopy(dec).to("cpu")
            with torch.no_grad():
                lg, lc = dec(dets).cpu(), cpu(dets.cpu())
            err = float((lg - lc).abs().max())
            say("18 surgery", f"NN logits on 4096 rows, the card vs the same weights "
                f"on the CPU: max|d logit| {err:.3e} (tol 1e-5; max|logit| "
                f"{float(lc.abs().max()):.3f})")
            require(err <= 1e-5, "NN logits: the card equals the CPU")
    say("18 surgery", f"phase wall time {time.perf_counter() - t_phase:.1f} s")


def phase_bench(launch_ms):
    """Phase 19: the reference's bench.py records (gate_dim3, gate_dim4,
    bb_ldpc) through the port's bench module, and the two bang-bang check
    scripts, on the card. The records time themselves (bench._sims_per_sec,
    main_bb's loop); this phase checks them and counts the kernels."""
    import torch
    from noisyquantumsimulator_tpu_torch import bench, diagnose_bb, validate_bangbang
    from noisyquantumsimulator_tpu_torch.gate.simulate import plan_squaring_bound
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        evolve_real_phased_many_cuda)

    t_phase = time.perf_counter()
    records, c128_launches = {}, {}
    f64_tier = bench.measure_parity_f64_device

    def counted_f64_tier(plan, device="cuda"):
        before = fused_masked_squaring.launches
        try:
            return f64_tier(plan, device)
        finally:
            c128_launches[plan.hilbert_space_dim] = (
                fused_masked_squaring.launches - before)

    # --- the main path, counted: each record runs between reset and read
    bench.measure_parity_f64_device = counted_f64_tier
    try:
        for name, dim, batch, tol32 in (("gate_dim3", 3, 32768, 1e-4),
                                        ("gate_dim4", 4, 8192, 2e-4)):
            fused_masked_squaring.launches = 0
            evolve_real_phased_many_cuda.launches = 0
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                r = bench.main(batch=batch, dim=dim)
            wall = time.perf_counter() - t0
            k1, k2 = (evolve_real_phased_many_cuda.launches,
                      fused_masked_squaring.launches)
            records[name] = r
            say("19 bench", f"{name}: {r['value']} sims/s (batch {batch}, mean of "
                f"10 queued steps), zvode baseline {r['baseline_sims_per_sec']} "
                f"sims/s, vs_baseline {r['vs_baseline']}; parity vs zvode: c64 "
                f"{r['parity_err_c64_vs_zvode']:.3e}, real f32 "
                f"{r['parity_err_real_f32_vs_zvode']:.3e}, host x64 "
                f"{r['parity_err_x64_vs_zvode']:.3e}, c128 on the card "
                f"{r['parity_err_f64_device_vs_zvode']:.3e} "
                f"({r['f64_device_sims_per_sec']} sims/s); mean F "
                f"{r['mean_fidelity']}; {r['achieved_useful_gflops']} useful "
                f"GFLOP/s; launches K1 {k1}, K2 {k2} (c128 tier {c128_launches[dim]});"
                f" record wall {wall:.1f} s")
            require(tuple(r) == GATE_KEYS, f"{name}: the reference's record keys")
            require(k1 > 0 and k2 > 0 and c128_launches[dim] > 0,
                    f"{name}: K1 and K2 launched during the record")
            require(0.97 <= r["mean_fidelity"] <= 0.99, f"{name}: mean F in 0.97-0.99")
            for k in ("parity_err_c64_vs_zvode", "parity_err_real_f32_vs_zvode"):
                require(r[k] <= tol32, f"{name}: {k} {r[k]:.3e} <= {tol32:g}")
            for k in ("parity_err_x64_vs_zvode", "parity_err_f64_device_vs_zvode"):
                require(r[k] <= 1e-8, f"{name}: {k} {r[k]:.3e} <= 1e-8")
            require(r["backend"] == "cuda" and r["value"] > 0, f"{name}: on the card")
    finally:
        bench.measure_parity_f64_device = f64_tier

    bp_cuda.c2v.launches = 0
    t0 = time.perf_counter()
    r = bench.main_bb(shots=65536, reps=3)
    wall = time.perf_counter() - t0
    k3 = bp_cuda.c2v.launches
    records["bb_ldpc"] = r
    lo, hi = r["e2e_p_logical_ci95"]
    say("19 bench", f"bb_ldpc: {r['value']} shots/s; p_L {r['e2e_p_logical_shot']:.3e} "
        f"({r['e2e_n_errors']} errors in {r['e2e_n_decoded']}, 95% Wilson CI "
        f"[{lo:.3e}, {hi:.3e}]); non-converged {r['bp_nonconverged_frac']:.4e}; "
        f"K3 launches {k3} (warm-up rep included); record wall {wall:.1f} s")
    require(tuple(r) == BB_KEYS, "bb_ldpc: the reference's record keys")
    require(k3 > 0, "bb_ldpc: K3 launched during the record")
    require(r["e2e_p_logical_shot"] <= 1e-4, "bb_ldpc: p_L <= 1e-4")

    # --- the two scripts on the card, against the same on the CPU
    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    v = validate_bangbang.run("cuda")
    wall, k2 = time.perf_counter() - t0, fused_masked_squaring.launches
    v_cpu = validate_bangbang.run("cpu")
    dv = max(abs(v[k] - v_cpu[k]) for k in ("F_a", "F_b", "F_smooth"))
    say("19 bench", f"validate_bangbang on the card: F {v['F_a']:.6f} / {v['F_b']:.6f}"
        f" / smooth {v['F_smooth']:.6f}, V/Omega {v['V_over_Omega']:.1f}, "
        f"controlled phase {v['controlled_phase_deg']:.2f} deg, checks {v['pass']}; "
        f"{wall:.2f} s, K2 launches {k2}; max|card - CPU| {dv:.3e} (tol 1e-10)")
    require(all(v["pass"]), "validate_bangbang: ALL PASS")
    require(k2 > 0, "validate_bangbang: K2 launched")
    require(dv <= 1e-10, "validate_bangbang: the card equals the CPU")
    fused_masked_squaring.launches = 0
    t0 = time.perf_counter()
    d = diagnose_bb.sweep("cuda")
    wall, k2 = time.perf_counter() - t0, fused_masked_squaring.launches
    dd = float(np.abs(d["avg_fidelity"] - diagnose_bb.sweep("cpu")["avg_fidelity"]).max())
    say("19 bench", f"diagnose_bb on the card: V/Omega {d['V_over_Omega']:.1f}; best "
        f"area {d['best_area']:.2f} (F {d['best_fidelity']:.4f}; validated "
        f"{diagnose_bb.VALIDATED_AREA}); F over the 17 areas "
        f"{[round(float(x), 4) for x in d['avg_fidelity']]}; {wall:.2f} s, K2 "
        f"launches {k2}; max|card - CPU| {dd:.3e} (complex128, tol 1e-10)")
    require(abs(d["best_area"] - diagnose_bb.VALIDATED_AREA) <= 0.5,
            "diagnose_bb: best area within one grid step of 22.08")
    require(k2 == 1, "diagnose_bb: one K2 launch for the whole sweep")
    require(dd <= 1e-10, "diagnose_bb: the card equals the CPU")

    line = bench.compact_summary_line(dict(records["gate_dim3"], records=records))
    say("19 bench", f"compact summary line ({len(line)} characters): {line}")
    require(len(line) <= 1500, "compact summary line <= 1500 characters")

    # --- K2 at the complex128 tier's squaring inputs (not counted)
    out = []
    for dim in (3, 4):
        plan = gate_plan(dim)
        ms = plan_squaring_bound(plan) + 1
        A = torch.as_tensor((plan.L0 + plan.schedule.amps[0] * (plan.Cp + plan.Cm))
                            * plan.schedule.dts[0], device="cuda")[None]
        R, s = _pade_inputs(A, ms)
        N = R.shape[-1]
        route = "resident" if N == 81 else "tiled"
        row = _k2_at(R, s, ms, f"(1, {N}) complex128 [the c128 parity tier, dim "
                     f"{dim}, {route}]", launch_ms, 50 if N == 81 else 20,
                     phase="19 bench")
        out.append(_k2_entry(row, f"(1, {N}, complex128)", c128_launches[dim],
                             f"phase 19: the complex128 parity tier of gate_dim{dim}",
                             f"B=1 N={N} complex128, max_squarings {ms} = "
                             f"plan_squaring_bound + 1 ({route} route)"))
    say("19 bench", f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# GRAPE's holds. The shipped grape_result.json is a 32-bit run; it sits
# 2.1e-3 relative in the baseline cost and 7.6e-5 in the final F from the
# complex128 values (the JAX package's x64 run at x0: cost
# 350.18040669132205, F 0.9713353367950325; final F 0.9790815671308957), so
# the 32-bit cost is held to 3e-3 relative, F to 1e-4 relative, the final F
# to 2e-4, and the complex128 baseline on the card to the x64 value.
GRAPE_BASELINE = (349.4451599121094, 0.9714149236679077)
GRAPE_FINAL_F = 0.9791575074195862
GRAPE_X64_BASELINE = (350.18040669132205, 0.9713353367950325)
GRAPE_COST_RTOL, GRAPE_F_RTOL, GRAPE_FINAL_TOL = 3e-3, 1e-4, 2e-4
ACCURACY_SHOTS = 1 << 19


def _shipped(name):
    """An output the reference shipped under examples/."""
    with open(f"examples/{name}") as f:
        return json.load(f)


def _overlap(a, b):
    return a[0] <= b[1] and b[0] <= a[1]


def _first_k2_inputs(calls):
    """A stand-in for ops/expm_cuda's `_squaring`, through which the K2
    wrapper and its backward make every launch: keeps the first operand of
    each (shape, dtype), counts its calls and the launches they made, then
    calls it."""
    from noisyquantumsimulator_tpu_torch.ops import expm_cuda
    real, counter = expm_cuda._squaring, expm_cuda.fused_masked_squaring

    def spy(R, s, max_squarings):
        key = (tuple(R.shape), str(R.dtype).replace("torch.", ""))
        if key not in calls:
            calls[key] = [R.detach().clone(), s.clone(), max_squarings, 0, 0]
        before = counter.launches
        out = real(R, s, max_squarings)
        calls[key][3] += 1
        calls[key][4] += counter.launches - before
        return out
    return spy


def _counted(phase, tag, fn, runs, k2_calls):
    """fn() with every kernel's launch count set to 0 just before it and read
    just after (after a sync), the host clock around both; K2's operands are
    kept per shape in k2_calls[tag]. Records runs[tag] = {wall, K1, K2, K3},
    prints it and returns fn's result."""
    import torch
    from unittest import mock
    from noisyquantumsimulator_tpu_torch.ops import expm_cuda
    from noisyquantumsimulator_tpu_torch.ops.expm_cuda import fused_masked_squaring
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        evolve_real_phased_many_cuda)
    evolve_real_phased_many_cuda.launches = 0
    fused_masked_squaring.launches = 0
    bp_cuda.c2v.launches = 0
    k2_calls[tag] = {}
    t0 = time.perf_counter()
    with mock.patch.object(expm_cuda, "_squaring", _first_k2_inputs(k2_calls[tag])):
        out = fn()
    torch.cuda.synchronize()
    runs[tag] = r = dict(wall=time.perf_counter() - t0,
                         K1=evolve_real_phased_many_cuda.launches,
                         K2=fused_masked_squaring.launches, K3=bp_cuda.c2v.launches)
    shapes = {f"{k[0]} {k[1]}": tuple(v[3:]) for k, v in k2_calls[tag].items()}
    say(phase, f"{tag}: wall {r['wall']:.1f} s; launches K1 {r['K1']}, K2 "
        f"{r['K2']} ((calls, launches) by shape {shapes}), K3 {r['K3']}")
    require(sum(v[4] for v in k2_calls[tag].values()) == r["K2"],
            f"{tag}: every K2 launch seen at its shape")
    return out


def _hold_sweeps(got, ref):
    """The sweep study against examples/sweep_results.json: F to 1e-8 at
    complex128 (the protocol sweeps' complex64 population objective to
    1e-4), gate times and the noise breakdown to 1e-9 relative. Returns the
    largest |dF| per part."""
    worst = {}

    def hold(part, f_got, f_ref, tol):
        d = float(np.max(np.abs(np.asarray(f_got) - np.asarray(f_ref))))
        worst[part] = max(worst.get(part, 0.0), d)
        require(d <= tol, f"sweeps {part}: max|dF| {d:.3e} <= {tol:g}")

    def close(part, a, b):
        require(np.allclose(a, b, rtol=1e-9, atol=0), f"sweeps {part}: equal to "
                "the shipped values to 1e-9 relative")

    for name, v in got.items():
        if isinstance(v, dict) and "phase_error_deg" in v:
            close(name + " values", v["values"], ref[name]["values"])
            hold("hardware sweeps", v["fidelity"], ref[name]["fidelity"], 1e-8)
            close(name + " gate time", v["gate_time_us"], ref[name]["gate_time_us"])
            require(np.allclose(v["phase_error_deg"], ref[name]["phase_error_deg"],
                                rtol=0, atol=1e-6), f"sweeps {name}: phase error "
                    "within 1e-6 deg of the shipped")
    for name in ("lp_delta_over_omega", "smooth_jp_amplitude"):
        close(name + " values", got[name]["values"], ref[name]["values"])
        hold("protocol sweeps", got[name]["fidelity"], ref[name]["fidelity"], 1e-4)
    for sp in ("Rb87", "Cs133"):
        for proto in ("lp", "smooth_jp"):
            hold("species", got["species_comparison"][sp][proto]["fidelity"],
                 ref["species_comparison"][sp][proto]["fidelity"], 1e-8)
    for part in ("pulse_shape_comparison", "protocol_summary"):
        for name, row in ref[part].items():
            rows = row.values() if part == "protocol_summary" else [row]
            grows = (got[part][name].values() if part == "protocol_summary"
                     else [got[part][name]])
            for g, r in zip(grows, rows):
                hold(part, g["fidelity"], r["fidelity"], 1e-8)
                close(f"{part} {name}", [g[k] for k in r if k != "fidelity"],
                      [r[k] for k in r if k != "fidelity"])
    for name, row in ref["noise_breakdown"].items():
        require(set(got["noise_breakdown"][name]) == set(row),
                f"noise breakdown {name}: the shipped keys")
        close(f"noise breakdown {name}", [float(got["noise_breakdown"][name][k])
                                          for k in row], [float(row[k]) for k in row])
    return worst


def phase_studies(launch_ms):
    """Phase 20: the gate and QEC studies (noisyquantumsimulator_tpu_torch/
    studies/) on the card at their own widths, each held to the output the
    reference shipped under examples/. Every study runs between a reset and
    a read of the three kernels' launch counts."""
    import torch
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
    from noisyquantumsimulator_tpu_torch.optimize.engine import (
        build_fixed_problem, make_objective)
    from noisyquantumsimulator_tpu_torch.optimize.forward import (
        get_smooth_jp_bounds_and_x0)
    from noisyquantumsimulator_tpu_torch.qec import bp_cuda
    from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
        _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)
    from noisyquantumsimulator_tpu_torch.studies import (
        decoder_accuracy_study, grape_optimal_control, gross_code_study,
        qec_scale_study, qec_study, research_parameter_sweeps)
    from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

    t_phase = time.perf_counter()
    runs, k2_calls = {}, {}

    def counted(tag, fn):
        return _counted("20 studies", tag, fn, runs, k2_calls)

    # --- 1. research_parameter_sweeps --quick against sweep_results.json
    got = counted("research_parameter_sweeps", lambda: research_parameter_sweeps.run(
        quick=True, device="cuda"))
    worst = _hold_sweeps(got, _shipped("sweep_results.json"))
    sec = got["seconds"]
    say("20 studies", f"sweeps --quick: max|dF| against the shipped file "
        f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }; 27 hardware points in "
        f"{sec['hardware_sweeps']:.2f} s ({27 / sec['hardware_sweeps']:.2f} points/s); "
        f"parts {({k: round(v, 2) for k, v in sec.items()})}")
    require(runs["research_parameter_sweeps"]["K2"] > 0, "sweeps: K2 launched")

    # --- 2. GRAPE, 400 Adam steps over 300 phases at complex64
    g = counted("grape_optimal_control",
                lambda: grape_optimal_control.run(device="cuda"))
    b, fin = g["baseline_smooth_jp"], g["grape"]
    say("20 studies", f"GRAPE: baseline cost {b['cost']:.4f} (shipped "
        f"{GRAPE_BASELINE[0]:.4f}), F {b['avg_fidelity']:.7f} (shipped "
        f"{GRAPE_BASELINE[1]:.7f}); final F {fin['avg_fidelity']:.7f} (shipped "
        f"{GRAPE_FINAL_F:.7f}), cost {fin['cost']:.4f}, controlled phase "
        f"{fin['controlled_phase_deg']:.3f} deg; {g['seconds']:.2f} s for 400 steps "
        f"({g['seconds'] / 400 * 1e3:.1f} ms a step); history "
        f"{[round(h['cost'], 3) for h in g['history']]}")
    require(abs(b["cost"] / GRAPE_BASELINE[0] - 1) <= GRAPE_COST_RTOL,
            f"GRAPE baseline cost within {GRAPE_COST_RTOL:g} relative")
    require(abs(b["avg_fidelity"] / GRAPE_BASELINE[1] - 1) <= GRAPE_F_RTOL,
            f"GRAPE baseline F within {GRAPE_F_RTOL:g} relative")
    require(fin["avg_fidelity"] >= b["avg_fidelity"] + 0.005,
            "GRAPE: final F at least 0.005 above the baseline")
    require(abs(fin["avg_fidelity"] - GRAPE_FINAL_F) <= GRAPE_FINAL_TOL,
            f"GRAPE: final F within {GRAPE_FINAL_TOL:g} of the shipped run's")
    require(runs["grape_optimal_control"]["K2"] > 0, "GRAPE: K2 launched")
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prob = build_fixed_problem(app, app.make_full_noise(),
                                   dtype=torch.complex128, device="cuda")
    c, m = make_objective(prob, "smooth_jp", n_steps=300)(get_smooth_jp_bounds_and_x0()[1])
    dc = abs(float(c) / GRAPE_X64_BASELINE[0] - 1)
    df = abs(float(m["avg_fidelity"]) - GRAPE_X64_BASELINE[1])
    say("20 studies", f"GRAPE baseline at complex128 on the card: cost {float(c):.10f}"
        f" (the JAX package's x64 {GRAPE_X64_BASELINE[0]:.10f}; {dc:.2e} relative), "
        f"F {float(m['avg_fidelity']):.12f} (|dF| {df:.2e})")
    require(dc <= 1e-9 and df <= 1e-10, "GRAPE baseline at complex128 equals the "
            "JAX package's x64 value")

    # --- 3. qec_study --quick: per-shot Wilson CIs against the shipped table
    q = counted("qec_study", lambda: qec_study.run(quick=True, device="cuda"))
    ref = _shipped("qec_study.json")
    for key, n_err in q["errors"].items():
        d, _ = qec_study.parse_key(key)
        n = q["shots"][key]
        ci = wilson_ci(n_err, n)
        n_ref = ref["shots"][key]
        k_ref = round(qec_study.shot_rate(ref["table"][key], d) * n_ref)
        ci_ref = wilson_ci(k_ref, n_ref)
        say("20 studies", f"qec_study {key}: {n_err} / {n} (CI [{ci[0]:.3e}, "
            f"{ci[1]:.3e}]); shipped ~{k_ref} / {n_ref} (CI [{ci_ref[0]:.3e}, "
            f"{ci_ref[1]:.3e}])")
        require(_overlap(ci, ci_ref), f"qec_study {key}: CI overlaps the shipped")
    say("20 studies", f"qec_study --quick: Lambda {q['lambda']} (shipped "
        f"{ref['lambda']}), teraquop d {q['teraquop_d']}")

    # --- 4. qec_scale_study --small: p_L CIs against qec_scale.json
    s = counted("qec_scale_study", lambda: qec_scale_study.run(small=True,
                                                               device="cuda"))
    ref = {r["d"]: r for r in _shipped("qec_scale.json")["points"]}
    for r in s["points"]:
        lo, hi = r["p_L_ci95"]
        say("20 studies", f"qec_scale d={r['d']}: sample {r['sample_shots_per_sec']:.1f}"
            f" shots/s, e2e {r['e2e_sample_decode_shots_per_sec']:.1f}; p_L "
            f"{r['e2e_p_logical_shot']:.3e} ({r['n_errors']} / {r['decode_shots']}, "
            f"CI [{lo:.3e}, {hi:.3e}]; shipped {ref[r['d']]['p_L_ci95']}); "
            f"escalated {r['e2e_escalated_fraction']:.3e}")
        require(_overlap(r["p_L_ci95"], ref[r["d"]]["p_L_ci95"]),
                f"qec_scale d={r['d']}: p_L CI overlaps the shipped")

    # --- 5. decoder_accuracy_study at d = 7
    a = counted("decoder_accuracy_study", lambda: decoder_accuracy_study.run(
        ds=(7,), shots=ACCURACY_SHOTS, device="cuda"))
    (row,) = a["points"]
    ref = {r["d"]: r for r in _shipped("decoder_accuracy.json")["points"]}[7]
    n_ref, w, wr = ref["shots"], row["windows"]["W5C2"], ref["windows"]["W5C2"]
    for what, k, k_ref in (
            ("oracle", row["n_errors_oracle"], ref["p_L_oracle"] * n_ref),
            ("window W5C2", w["n_errors_window"], wr["p_L_window"] * n_ref),
            ("escalated W5C2", w["n_errors_escalated"], wr["p_L_escalated"] * n_ref)):
        ci, ci_ref = wilson_ci(k, row["shots"]), wilson_ci(round(k_ref), n_ref)
        say("20 studies", f"decoder accuracy d=7 {what}: {k} / {row['shots']} "
            f"(CI [{ci[0]:.3e}, {ci[1]:.3e}]); shipped {round(k_ref)} / {n_ref} "
            f"(CI [{ci_ref[0]:.3e}, {ci_ref[1]:.3e}])")
        require(_overlap(ci, ci_ref), f"decoder accuracy d=7 {what}: CI overlaps")
    say("20 studies", f"decoder accuracy d=7: certified {row['oracle_certified_fraction']}"
        f", flagged {w['flagged_fraction']:.3e}, oracle {row['oracle_shots_per_sec_host']:.0f}"
        f" shots/s (host), window {w['window_shots_per_sec']:.0f} shots/s; tiered "
        f"split {row['tiered_overflow_split']}")
    require(row["oracle_certified_fraction"] == 1.0, "oracle certifies every shot")

    # --- 6. gross_code_study in full
    gc = counted("gross_code_study", lambda: gross_code_study.run(device="cuda"))
    ref = _shipped("gross_code_study.json")
    for key in ("p=0.001", "p=0.002"):
        r, rr = gc[key], ref[key]
        say("20 studies", f"gross code {key}: {r['value']} shots/s, {r['e2e_n_errors']}"
            f" errors in {r['e2e_n_decoded']}; non-converged "
            f"{r['bp_nonconverged_frac']:.4e} (shipped {rr['bp_nonconverged_frac']:.4e})"
            f"; {r['decoder']}")
        require(r["e2e_n_errors"] == 0, f"gross code {key}: 0 errors")
        ratio = r["bp_nonconverged_frac"] / rr["bp_nonconverged_frac"]
        require(0.5 <= ratio <= 2.0, f"gross code {key}: non-converged fraction "
                "within a factor of 2 of the shipped")
    require(runs["gross_code_study"]["K3"] > 0, "gross code: K3 launched")

    # --- the kernels at the studies' shapes (not counted)
    out = []
    for tag in ("research_parameter_sweeps", "grape_optimal_control"):
        (shape, dt), (R, s_, ms, n, _) = max(k2_calls[tag].items(),
                                             key=lambda kv: kv[1][3])
        # no limit given (expm's default): the chain runs max(s) trips
        ms = int(s_.max()) if ms is None else ms
        row = _k2_at(R, s_, ms, f"{shape} {dt} [{tag}]", launch_ms, 50,
                     phase="20 studies",
                     tol=1e-12 if dt in ("complex128", "float64") else 1e-6)
        out.append(_k2_entry(row, f"{shape} {dt} [{tag}]", runs[tag]["K2"],
                             f"phase 20: {tag} ({n} of its K2 calls at this shape)",
                             f"B={shape[0]} N={shape[1]} {dt}, max_squarings {ms}"))
    if runs["research_parameter_sweeps"]["K1"]:
        U, cq, ph, x0, D, P = host_scan_inputs(gate_plan(3))
        args = [torch.as_tensor(v, device="cuda").to(torch.float64)
                for v in (U, cq, ph[None], x0)]
        got = evolve_real_phased_many_cuda(*args, D, P)
        ref = _evolve_real_phased_many_plain(*args, D, P)
        err = float((got - ref).abs().max())
        require(err <= 1e-12 * float(ref.abs().max()), "K1 float64: equal to its twin")
        k_ms, p_ms = _kernel_vs_plain_ms(
            lambda: evolve_real_phased_many_cuda(*args, D, P),
            lambda: _evolve_real_phased_many_plain(*args, D, P), 20)
        S, n = x0.shape
        flops = 2.0 * S * n * n * len(ph)
        nbytes = 8.0 * (2 * S * n + n * n + len(ph))
        terms = {"operations": flops / PEAK_FP64 * 1e3, "bytes": nbytes / PEAK_BYTES * 1e3}
        by = max(terms, key=terms.get)
        say("20 studies", f"K1 float64 B=1 S={S} n={n} {len(ph)} steps [the sweep's "
            f"gate simulations]: max|kernel - twin| {err:.3e}; K1 {k_ms:.4f} ms, twin "
            f"{p_ms:.4f} ms; bound {terms[by]:.5f} ms ({by})")
        out.append({"name": "K1 phase_scan float64 [research_parameter_sweeps]",
                    "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
                    "launches": runs["research_parameter_sweeps"]["K1"],
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": terms[by], "bound_by": by, "library_ms": None,
                    "library_note": "no single PyTorch call computes the rotated scan",
                    "shape": f"B=1 S={S} n={n} n_seg={len(ph)} float64"})
    rng = np.random.default_rng(SEED + 20)
    m, sgn = _c2v_inputs(rng, 26, 288, 65536)
    msg = torch.as_tensor(m, device="cuda").to(torch.bfloat16)
    ss = torch.as_tensor(sgn, device="cuda").to(torch.bfloat16)
    err = float((bp_cuda.c2v(msg, ss, 0.75).float()
                 - bp_cuda._c2v_plain(msg, ss, 0.75).float()).abs().max())
    require(err == 0.0, "K3 at the gross code's shape: bit-exact to its twin")
    k_ms, p_ms = _kernel_vs_plain_ms(lambda: bp_cuda.c2v(msg, ss, 0.75),
                                     lambda: bp_cuda._c2v_plain(msg, ss, 0.75), 20)
    nbytes = 2 * msg.numel() * msg.element_size() + ss.numel() * ss.element_size()
    say("20 studies", f"K3 (26, 288, 65536) bf16 [gross code study]: kernel {k_ms:.4f}"
        f" ms, twin {p_ms:.4f} ms, bytes bound {nbytes / PEAK_BYTES * 1e3:.4f} ms")
    out.append({"name": "K3 bp_c2v [gross_code_study]", "route": "cuda",
                "source": K3_SOURCE, "replaces": K3_REPLACES,
                "launches": runs["gross_code_study"]["K3"], "max_abs_err": err,
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": nbytes / PEAK_BYTES * 1e3,
                "bound_by": "bytes", "library_ms": None,
                "library_note": "no single PyTorch call computes normalized "
                                "min-sum check-to-variable messages",
                "shape": "w_max=26 n_chk=288 S=65536 bf16"})
    del msg, ss
    torch.cuda.empty_cache()
    say("20 studies", f"study wall times {({k: round(v['wall'], 1) for k, v in runs.items()})}"
        f"; phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def _json_diff(got, want, skip=(), path=""):
    """(largest |got - want| over the numbers of two JSON trees, [paths
    where keys, lengths, strings or booleans differ]); dict keys in `skip`
    are left out."""
    if isinstance(want, dict):
        keys = set(want) - set(skip)
        if not isinstance(got, dict) or set(got) - set(skip) != keys:
            return 0.0, [path]
        pairs = [(got[k], want[k], f"{path}/{k}") for k in sorted(keys)]
    elif isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return 0.0, [path]
        pairs = [(g, w, f"{path}[{i}]") for i, (g, w) in enumerate(zip(got, want))]
    elif isinstance(want, (str, bool)) or want is None:
        return 0.0, ([] if got == want else [path])
    else:
        return abs(float(got) - float(want)), []
    worst, bad = 0.0, []
    for g, w, p in pairs:
        d, b = _json_diff(g, w, skip, p)
        worst, bad = max(worst, d), bad + b
    return worst, bad


# phase 21: the engine studies' fields held to the shipped outputs (the
# dominant Pauli errors apart: their labels tie to rounding)
ENGINE_FIELDS = ("engine_infidelity", "engine_process_infidelity", "duration_s",
                 "leakage", "budget_top3")
# K2's (shape, dtype) pairs that earlier phases time (12, 13, 15, 19, 20):
# phase 21 holds them against the twin on the studies' operands, and times
# and lists the others
K2_TIMED_ELSEWHERE = {((7, 1600, 1600), "complex128"), ((1, 576, 576), "complex128"),
                      ((1, 81, 81), "complex128"), ((1, 81, 81), "float32"),
                      ((300, 81, 81), "complex64"), ((1, 81, 81), "float64"),
                      ((1, 540, 540), "float64")}
# the notebook's section 4 against the objective at the literature smooth-JP
# parameters: the optimizer must cut the cost to half and raise F by 0.003
# (the card's run: cost 129.68 against 349.37, F 0.977753 against 0.971393)
NOTEBOOK_COST_RATIO, NOTEBOOK_F_GAIN = 0.5, 0.003


def _hold_engine_study(got, ref, store, platform, op, nbar_key):
    """The MS or cavity study on the card against its shipped JSON (the
    engine fields to 1e-10, the analytic column to 1e-12, CPTP; the dominant
    Pauli errors by value, as their labels tie to rounding: each label's
    probability that of the shipped record, the three values the shipped
    ones) and each record it wrote against the shipped record in
    calibration_data/ (1e-10; the run's nbar, and the strings that name the
    producing package and engine, left out and printed)."""
    for regime, row in got["regimes"].items():
        r = ref["regimes"][regime]
        d, bad = _json_diff({k: row[k] for k in ENGINE_FIELDS},
                            {k: r[k] for k in ENGINE_FIELDS})
        da = abs(row["analytic_infidelity_crosscheck"]
                 - r["analytic_infidelity_crosscheck"])
        require(Path(row["calibration_record"]).resolve()
                == (Path(store) / platform / op / f"{regime}.json").resolve(),
                f"{op} {regime}: the record went into the study's store")
        with open(row["calibration_record"]) as f:
            rec = json.load(f)
        with open(f"calibration_data/{platform}/{op}/{regime}.json") as f:
            rec_ref = json.load(f)
        dr, bad_r = _json_diff(rec, rec_ref, skip=(nbar_key, "engine", "generator"))
        probs = dict(zip(rec_ref["pauli_labels"], rec_ref["pauli_error_probs"]))
        top, top_ref = row["dominant_pauli_errors"], r["dominant_pauli_errors"]
        dp = max(max(abs(p - probs[lab]), abs(p - q))
                 for (lab, p), (_, q) in zip(top, top_ref))
        say("21 platforms", f"{op} [{regime}]: 1 - F {row['engine_infidelity']:.12e} "
            f"(shipped {r['engine_infidelity']:.12e}); max|d| over the engine fields "
            f"{d:.3e} (tol 1e-10), analytic {da:.3e} (tol 1e-12), cptp {row['cptp']}; "
            f"dominant Pauli errors {top} (shipped {top_ref}; {dp:.3e} by value); "
            f"the record written against calibration_data/: max|d| {dr:.3e} (tol "
            f"1e-10), {nbar_key} {rec['parameters'][nbar_key]} (shipped "
            f"{rec_ref['parameters'][nbar_key]}), engine "
            f"{rec['parameters'].get('engine')} ({rec_ref['parameters'].get('engine')})"
            f"; {row['sim_wall_s']} s a call")
        require(not bad and d <= 1e-10, f"{op} {regime}: engine fields {bad}")
        require(len(top) == 3 and dp <= 1e-10, f"{op} {regime}: dominant Pauli errors")
        require(da <= 1e-12 and row["cptp"], f"{op} {regime}: analytic, CPTP")
        require(not bad_r and dr <= 1e-10, f"{op} {regime}: record {bad_r}")


def _first_points_on_cpu(fd):
    """The first point of each gate series of figure_data, computed again on
    the CPU at complex128: {series: F}; and the default smooth-JP gate's
    noise breakdown there."""
    import torch
    from noisyquantumsimulator_tpu_torch.core.configs import (
        LPSimulationInputs, SmoothJPSimulationInputs)
    from noisyquantumsimulator_tpu_torch.gate.simulate import simulate_cz_gate
    from noisyquantumsimulator_tpu_torch.optimize.sweeps import hardware_sweep
    c128 = torch.complex128
    spacing = fd["blockade_importance"]["spacing_factor"][:1]
    n0 = fd["species_comparison"]["n_rydberg"][0]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        F = {
            "blockade noiseless": hardware_sweep(
                "spacing_factor", spacing, include_noise=False,
                sim_kwargs={"trap_laser_on": False}, device="cpu").fidelity[0],
            "blockade full noise": hardware_sweep(
                "spacing_factor", spacing, device="cpu").fidelity[0],
            "protocol LP": simulate_cz_gate(LPSimulationInputs(), device="cpu",
                                            dtype=c128).avg_fidelity,
            "temperature": hardware_sweep(
                "temperature", fd["temperature_sensitivity"]["temperature_K"][:1],
                device="cpu").fidelity[0]}
        for sp in ("Rb87", "Cs133"):
            F[f"species {sp}"] = simulate_cz_gate(
                SmoothJPSimulationInputs(), device="cpu", dtype=c128, species=sp,
                n_rydberg=n0).avg_fidelity
        nb = simulate_cz_gate(SmoothJPSimulationInputs(), device="cpu",
                              dtype=c128).noise_breakdown
    return {k: float(v) for k, v in F.items()}, nb


def phase_platforms(launch_ms, F_c128=None):
    """Phase 21: the platform studies (the MS and cavity engine studies,
    ion_memory, the NN decoder study, multichip_scaling, generate_figures'
    data, the demo notebook) on the card, each once between a reset and a
    read of the three kernels' launch counts, and held to the outputs the
    reference shipped under examples/; K2 held against its twin at every
    shape the studies gave it. `F_c128` is phase 5's complex128 F of the
    default smooth-JP gate, where phase 5 ran. Returns the kernel entries of
    the K2 shapes that no earlier phase times."""
    import tempfile
    import torch
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
    from noisyquantumsimulator_tpu_torch.optimize.engine import (
        build_fixed_problem, make_objective)
    from noisyquantumsimulator_tpu_torch.optimize.forward import (
        get_smooth_jp_bounds_and_x0)
    from noisyquantumsimulator_tpu_torch.qec.dem import build_dem, dem_to_edges
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    from noisyquantumsimulator_tpu_torch.qec.native import NativeMatchingDecoder
    from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit
    from noisyquantumsimulator_tpu_torch.studies import (
        cavity_gate_engine_study, demo_notebook, generate_figures, ion_memory,
        ms_gate_engine_study, multichip_scaling, nn_decoder_study)
    t_phase = time.perf_counter()
    runs, k2_calls = {}, {}

    def counted(tag, fn):
        return _counted("21 platforms", tag, fn, runs, k2_calls)

    # --- 1-2. the MS and cavity engine studies at full size, records into a
    # temporary store
    with tempfile.TemporaryDirectory() as store:
        for mod, ref, platform, op, nbar_key in (
                (ms_gate_engine_study, "ms_gate_engine.json", "trapped_ions",
                 "ms_gate", "nbar"),
                (cavity_gate_engine_study, "cavity_gate_engine.json", "cavity_qed",
                 "exchange_gate", "nbar_cavity")):
            got = counted(mod.NAME, lambda: mod.run(device="cuda", store_root=store))
            _hold_engine_study(got, _shipped(ref), store, platform, op, nbar_key)
            require(runs[mod.NAME]["K2"] > 0, f"{mod.NAME}: K2 launched")

    # --- 3. ion_memory --quick: all ten cells against the shipped CIs
    im = counted("ion_memory", lambda: ion_memory.run(quick=True, device="cuda"))
    ref = _shipped("ion_memory.json")["platforms"]
    for name, pl in im["platforms"].items():
        again = ion_memory.backend_pricing(ion_memory.make_backend(name, "cuda"))
        again = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                 for k, v in again.items()}
        dp, bad = _json_diff(pl["pricing"], ref[name]["pricing"])
        require(pl["pricing"] == again, f"ion_memory {name}: the pricing of a "
                "fresh backend (phase 16's derivation)")
        require(not bad and dp <= 1e-12, f"ion_memory {name}: pricing within "
                f"1e-12 of the shipped ({dp:.3e})")
        for dk, row in pl["memory"].items():
            rr = ref[name]["memory"][dk]
            say("21 platforms", f"ion_memory {name} {dk}: p_L {row['p_logical_shot']:.4e}"
                f" ({row['n_errors']} / {row['shots']}, CI [{row['ci95'][0]:.4e}, "
                f"{row['ci95'][1]:.4e}]; shipped {rr['n_errors']} / {rr['shots']}, "
                f"[{rr['ci95'][0]:.4e}, {rr['ci95'][1]:.4e}]); {row['decoder']}; "
                f"sample {row['sample_seconds']:.3f} s, decode "
                f"{row['decode_seconds']:.3f} s, {row['shots_per_second']:.1f} shots/s")
            require(_overlap(row["ci95"], rr["ci95"]),
                    f"ion_memory {name} {dk}: CI overlaps the shipped")
        say("21 platforms", f"ion_memory {name}: pricing within {dp:.3e} of the "
            f"shipped, equal to a fresh backend's; Lambda d3/d5 "
            f"{pl['lambda_d3_over_d5']} (shipped {ref[name]['lambda_d3_over_d5']})")

    # --- 4. nn_decoder_study --small
    nn = counted("nn_decoder_study", lambda: nn_decoder_study.run(small=True,
                                                                   device="cuda"))
    circuit = memory_z_circuit(nn["d"], nn["rounds"], p=nn["p"])
    edges, probs, obs_m = dem_to_edges(build_dem(circuit))
    nat = NativeMatchingDecoder(circuit.n_detectors, edges, probs, obs_m)
    sampler = build_fast_sampler(circuit, min(nn["eval_shots"], nn_decoder_study.BLOCK),
                                 "cuda")
    err = 0
    for b in range(nn["eval_blocks"]):
        dets, obs = nn_decoder_study.eval_block(sampler, b, "cuda")
        err += int(np.sum((nat.decode_batch_ex(dets.cpu().numpy(), mode=0)["pred"]
                           & 1) != obs))
    ship = _shipped("nn_decoder_d5.json")
    say("21 platforms", f"nn_decoder --small: NN p_L {nn['p_logical_nn']:.5f} "
        f"({nn['n_errors_nn']} / {nn['eval_shots']}), exact MWPM "
        f"{nn['p_logical_exact_mwpm']:.5f} ({nn['n_errors_mwpm']}; the host decoder "
        f"re-run on the same rows: {err}), trivial {nn['p_logical_trivial']:.5f}; "
        f"NN / exact {nn['nn_over_exact_ratio']:.3f} (shipped full run "
        f"{ship['nn_over_exact_ratio']:.3f}); {nn['train_steps']} steps in "
        f"{nn['train_seconds']:.2f} s, scoring {nn['eval_seconds']:.2f} s")
    require(nn["p_logical_nn"] < 0.6 * nn["p_logical_trivial"],
            "NN p_L below 0.6 x the trivial decoder's")
    require(err == nn["n_errors_mwpm"], "MWPM errors equal the host decoder's on "
            "the same rows")

    # --- 5. multichip_scaling: the world sizes the card count allows
    mc = counted("multichip_scaling", lambda: multichip_scaling.run(device="cuda"))
    ref = _shipped("multichip_scaling.json")["surface_mc"][0]
    s, bb = mc["surface_mc"][0], mc["bb_ldpc_mc"][0]
    say("21 platforms", f"multichip_scaling: {mc['note']}; surface {s['shots_per_sec']:.1f}"
        f" shots/s, detector fraction {s['detector_fraction']:.5f} (shipped CPU run "
        f"{ref['detector_fraction']:.5f}), obs rate {s['obs_rate']:.5f}, rank counts "
        f"{s['rank_counts']}; BB {bb['code']} {bb['shots']} shots p_L "
        f"{bb['p_logical_shot']:.5f}, converged {bb['bp_converged_frac']:.4f}, "
        f"{bb['seconds']:.3f} s")
    require([r["n_devices"] for r in mc["surface_mc"]] == list(
        multichip_scaling.default_sizes(torch.device("cuda"))),
        "the world sizes the cards allow (one card: 1 only)")
    require(abs(s["detector_fraction"] / ref["detector_fraction"] - 1) < 0.15,
            "detector fraction within 15% of the shipped")
    require([sum(c) for c in zip(*s["rank_counts"])] == [s["n_detectors_fired"],
                                                           s["n_obs_flips"]],
            "the reduced counts are the sum over ranks")

    # --- 6. generate_figures --quick data
    fd = counted("generate_figures", lambda: generate_figures.figure_data(
        quick=True, device="cuda"))
    first, nb_cpu = _first_points_on_cpu(fd)
    got = {"blockade noiseless": fd["blockade_importance"]["noiseless"]["fidelity"][0],
           "blockade full noise": fd["blockade_importance"]["full noise"]["fidelity"][0],
           "protocol LP": fd["protocol_comparison"]["fidelity"][0],
           "temperature": fd["temperature_sensitivity"]["fidelity"][0],
           **{f"species {sp}": fd["species_comparison"][sp][0]
              for sp in ("Rb87", "Cs133")}}
    worst = max(abs(got[k] - first[k]) for k in first)
    dnb = max(abs(fd["noise_breakdown"][k] - float(nb_cpu[k]))
              / max(abs(float(nb_cpu[k])), 1e-300) for k in fd["noise_breakdown"])
    every = [f for v in (fd["blockade_importance"]["noiseless"]["fidelity"],
                         fd["blockade_importance"]["full noise"]["fidelity"],
                         fd["protocol_comparison"]["fidelity"],
                         fd["species_comparison"]["Rb87"],
                         fd["species_comparison"]["Cs133"],
                         fd["temperature_sensitivity"]["fidelity"],
                         fd["pareto"]["fidelity"]) for f in v]
    say("21 platforms", f"generate_figures --quick: first points card vs CPU "
        f"complex128 {({k: float(f'{abs(got[k] - first[k]):.3e}') for k in first})} "
        f"(tol 1e-10); noise breakdown {dnb:.3e} relative; protocols "
        f"{dict(zip(['LP', 'smooth JP', 'bang-bang'], fd['protocol_comparison']['fidelity']))}"
        f"; {len(fd['pareto']['fidelity'])} exploration points, front "
        f"{len(fd['pareto']['front_fidelity'])}; F in [{min(every):.6f}, "
        f"{max(every):.6f}]; parts {({k: round(v, 2) for k, v in fd['seconds'].items()})}")
    require(worst <= 1e-10, "figures: first points equal the CPU's to 1e-10")
    require(dnb <= 1e-12, "figures: the noise breakdown equals the CPU's")
    require(all(0.0 < f <= 1.0 for f in every), "figures: every F in (0, 1]")
    if F_c128 is not None:
        require(abs(fd["protocol_comparison"]["fidelity"][1] - F_c128) <= 1e-12,
                "figures: smooth JP equals phase 5's complex128 gate")
    require(runs["generate_figures"]["K1"] > 0 and runs["generate_figures"]["K2"] > 0,
            "figures: K1 and K2 launched")

    # --- 7. the notebook, all 8 code cells on the card
    nb = counted("demo_notebook", lambda: demo_notebook.run(device="cuda"))
    say("21 platforms", f"demo notebook: F {nb['default_fidelity']:.9f}, protocols "
        f"{nb['protocol_fidelity']}, optimized {nb['optimized_fidelity']:.6f}, CZ "
        f"record {nb['cz_record_fidelity']:.6f}, memory p_L "
        f"{nb['memory_p_logical_shot']:.3e} ({nb['memory_n_errors']} of 50000); "
        f"cell seconds {({k: round(v, 2) for k, v in nb['seconds'].items()})}")
    # section 4 optimizes under the default apparatus (ApparatusConstraints,
    # full noise), not section 1's plan defaults: its baseline is the
    # objective at the literature smooth-JP parameters, at its complex64
    app = ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        prob = build_fixed_problem(app, app.make_full_noise(), device="cuda")
    c0, m0 = make_objective(prob, "smooth_jp", n_steps=300)(
        get_smooth_jp_bounds_and_x0()[1])
    F0 = float(m0["avg_fidelity"])
    say("21 platforms", f"demo notebook section 4: optimized F "
        f"{nb['optimized_fidelity']:.6f}, cost {nb['optimized_cost']:.4f}; the "
        f"objective at the literature parameters F {F0:.6f}, cost {float(c0):.4f} "
        f"(section 1's plan defaults: F {nb['default_fidelity']:.6f})")
    require(0.97 <= nb["default_fidelity"] <= 0.99, "notebook: F in 0.97-0.99")
    require(nb["optimized_fidelity"] >= F0 + NOTEBOOK_F_GAIN
            and nb["optimized_cost"] <= NOTEBOOK_COST_RATIO * float(c0),
            f"notebook: the optimizer raised F by at least {NOTEBOOK_F_GAIN:g} and "
            f"cut the cost to {NOTEBOOK_COST_RATIO:g} x its value at the literature "
            "parameters")
    require(nb["memory_p_logical_shot"] < 0.5, "notebook: p_L under 0.5")
    pc = dict(zip(("LP", "smooth JP", "bang-bang"), fd["protocol_comparison"]["fidelity"]))
    dpc = max(abs(pc[k] - nb["protocol_fidelity"][k]) for k in pc)
    require(dpc <= 1e-12, f"figures' protocol comparison equals the notebook's "
            f"section 3 ({dpc:.3e})")
    require(runs["demo_notebook"]["K1"] > 0 and runs["demo_notebook"]["K2"] > 0,
            "notebook: K1 and K2 launched")

    # --- K2 on the first operand the studies gave it at each shape (not
    # counted): every shape against its twin; the shapes no earlier phase
    # times are timed and listed
    shapes = {}
    for tag, calls in k2_calls.items():
        for key, (R, s_, ms, n, k) in calls.items():
            first = shapes.setdefault(key, dict(R=R, s=s_, ms=ms, tag=tag, by={}))
            first["by"][tag] = (n, k)
    out = []
    for (shape, dt), c in shapes.items():
        # no limit given (expm's default): the chain runs max(s) trips
        ms = int(c["s"].max()) if c["ms"] is None else c["ms"]
        what = f"{shape} {dt} [{c['tag']}]"
        tol = 1e-12 if dt in ("complex128", "float64") else 1e-6
        if (shape, dt) in K2_TIMED_ELSEWHERE:
            err, scale = _k2_hold(c["R"], c["s"], ms, what, tol)
            say("21 platforms", f"K2 {what}, max_squarings {ms}: max|kernel - twin| "
                f"{err:.3e} (max|ref| {scale:.3e}, tol {tol:g} relative); timed in "
                "an earlier phase")
            continue
        row = _k2_at(c["R"], c["s"], ms, what, launch_ms, 20, phase="21 platforms",
                     tol=tol)
        by = ", ".join(f"{t} ({n} calls, {k} launches)" for t, (n, k) in c["by"].items())
        out.append(_k2_entry(row, what, sum(k for _, k in c["by"].values()),
                             f"phase 21: {by}",
                             f"B={shape[0]} N={shape[1]} {dt}, max_squarings {ms}"))
    say("21 platforms", f"study wall times {({k: round(v['wall'], 1) for k, v in runs.items()})}"
        f"; launches {({k: (v['K1'], v['K2'], v['K3']) for k, v in runs.items()})}; "
        f"phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("k2", "bb", "optimizer", "gradients", "channel",
                                       "primitives", "surface", "architecture",
                                       "parallel", "surgery", "bench", "studies",
                                       "platforms"),
                    help="run phases 1, 2 and 9 (k2), 1, 2, 7 and 8 (bb), "
                         "1, 2, 9 and 10 "
                         "(optimizer), 1, 2 and 11 (gradients), 1, 2 and 12 "
                         "(channel), 1, 2 and 13 (primitives), 1, 2 and 14 "
                         "(surface), 1, 2, 15 and 16 (architecture), 1, 2 and 17 "
                         "(parallel), 1, 2 and 18 (surgery), 1, 2 and 19 "
                         "(bench), 1, 2 and 20 (studies) or 1, 2 and 21 "
                         "(platforms) only, and print no result line")
    args = ap.parse_args(argv)
    dev = phase_device()
    if dev is None:
        print("[1 device] FAIL: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    name, count = dev
    phase_build()
    launch_ms = _empty_launch_ms()
    say("2 build", f"one empty kernel launch: {launch_ms * 1e3:.3f} us (2000 "
        "back to back, best of 3): no kernel's bound is below it")
    if args.only == "bb":
        phase_k3()
        phase_bb(launch_ms)
        return 0
    if args.only == "gradients":
        phase_gradients(launch_ms)
        return 0
    if args.only == "channel":
        phase_channel(launch_ms)
        return 0
    if args.only == "primitives":
        phase_primitives(launch_ms)
        return 0
    if args.only == "surface":
        phase_surface(launch_ms)
        return 0
    if args.only == "architecture":
        phase_cavity(launch_ms)
        phase_architecture()
        return 0
    if args.only == "parallel":
        phase_parallel(launch_ms)
        return 0
    if args.only == "surgery":
        phase_surgery()
        return 0
    if args.only == "bench":
        phase_bench(launch_ms)
        return 0
    if args.only == "studies":
        phase_studies(launch_ms)
        return 0
    if args.only == "platforms":
        phase_platforms(launch_ms)
        return 0
    if args.only:
        phase_k2_batched(launch_ms)
        if args.only == "optimizer":
            phase_optimizer(launch_ms)
        return 0
    F = phase_gate()
    kernels = phase_sweep(F["torch.complex64"], launch_ms)
    phase_k3()
    kernels.extend(phase_bb(launch_ms))
    rows = phase_k2_batched(launch_ms)
    launches, _, pscan = phase_optimizer(launch_ms)
    kernels.extend(_k2_entries(rows, launches))
    kernels.append(pscan)
    kernels.append(phase_gradients(launch_ms))
    kernels.append(phase_channel(launch_ms)[1])
    kernels.extend(phase_primitives(launch_ms))
    kernels.append(phase_surface(launch_ms))
    kernels.extend(phase_cavity(launch_ms))
    phase_architecture()
    kernels.extend(phase_parallel(launch_ms))
    phase_surgery()
    kernels.extend(phase_bench(launch_ms))
    kernels.extend(phase_studies(launch_ms))
    kernels.extend(phase_platforms(launch_ms, F["torch.complex128"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
