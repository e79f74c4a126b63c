"""The port's benchmark records (`noisyquantumsimulator_tpu_torch.bench`) and
its two bang-bang check scripts against the reference's root `bench.py`,
`validate_bangbang.py` and `diagnose_bb.py`, on the CPU at small sizes.

The reference's `bench.py` is loaded from its file, unchanged. Tolerances:

* the zvode oracle and the host x64 tier are the same host numpy / scipy
  code on the same plan: 1e-12;
* the 32-bit parity tiers (1 - F of near-pure states, which amplifies
  rounding) are set by the complex64 U_base the scan starts from: the
  reference forms its complex64 products from three real products on float
  planes, the port uses plain complex products, and their U_base differ by
  ~3e-5 at 20 segments (the tiers by ~2e-5). So each tier is held within
  5e-6 of the reference's with both packages on one U_base, once on the
  reference's and once on the port's;
* the 64-bit tiers against zvode: 1e-9 (the reference gives ~2e-11);
* fidelities: 1e-6 at complex128, 1e-4 at complex64 (the objective's
  32-bit tier, as the card's phase 10 holds it); the complex engine's sweep
  1e-5.
"""
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from noisyquantumsimulator_tpu.core import configs as jcfg
from noisyquantumsimulator_tpu.gate import simulate as jsim
from noisyquantumsimulator_tpu.optimize import apparatus as japp
from noisyquantumsimulator_tpu.optimize import engine as jeng
from noisyquantumsimulator_tpu.optimize import forward as jfwd
from noisyquantumsimulator_tpu.solver import propagator as jprop
from noisyquantumsimulator_tpu_torch import bench as tbench
from noisyquantumsimulator_tpu_torch import bench_gate
from noisyquantumsimulator_tpu_torch import diagnose_bb as tdiag
from noisyquantumsimulator_tpu_torch import validate_bangbang as tval
from noisyquantumsimulator_tpu_torch.core import configs as tcfg
from noisyquantumsimulator_tpu_torch.gate import simulate as tsim
from noisyquantumsimulator_tpu_torch.optimize import apparatus as tapp_mod
from noisyquantumsimulator_tpu_torch.optimize import engine as teng
from noisyquantumsimulator_tpu_torch.solver import propagator as tprop

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
N_SEG = 20


def _load_reference_bench():
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rbench = _load_reference_bench()


def _quiet(fn, *a, **k):
    """fn's result and the JSON record it printed last."""
    buf = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(buf):
        warnings.simplefilter("ignore", UserWarning)
        res = fn(*a, **k)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return res, json.loads(lines[-1])


@pytest.fixture(scope="module", autouse=True)
def one_blas_thread():
    """The zvode oracle makes many small BLAS products; beside the other
    test workers, OpenBLAS's default thread pools oversubscribe the cores and
    slow it by orders of magnitude (seconds become many minutes)."""
    with threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def plans():
    """One dim-3, 20-segment smooth-JP plan from each package."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jplan = jsim.plan_cz_gate(jcfg.SmoothJPSimulationInputs(),
                                  n_steps_smooth=N_SEG, hilbert_space_dim=3)
        tplan = tsim.plan_cz_gate(tcfg.SmoothJPSimulationInputs(),
                                  n_steps_smooth=N_SEG, hilbert_space_dim=3,
                                  device="cpu")
    return jplan, tplan


@pytest.fixture(scope="module")
def zvode(plans):
    jplan, tplan = plans
    return rbench.run_baseline_zvode(jplan)[1], tbench.run_baseline_zvode(tplan)[1]


def test_run_baseline_zvode_matches_reference(zvode):
    ref, got = zvode
    assert got.shape == ref.shape == (4, 9, 9)
    assert np.abs(got - ref).max() <= 1e-12


def test_phase_frame_numpy_x64_matches_reference(plans):
    jplan, tplan = plans
    ref = rbench._phase_frame_numpy_x64(jplan)
    got = tbench._phase_frame_numpy_x64(tplan)
    assert np.abs(got - ref).max() <= 1e-12


def test_state_fidelity_matches_reference(zvode):
    ref, got = zvode
    for i in range(4):
        assert abs(tbench._state_fidelity(got[i], ref[(i + 1) % 4])
                   - rbench._state_fidelity(got[i], ref[(i + 1) % 4])) <= 1e-15


_port_u_base = tprop.uniform_base_propagator
_jax_u_base_orig = jprop.uniform_base_propagator


@pytest.mark.parametrize("u_base", ["reference", "port"])
def test_measure_parity_matches_reference(plans, zvode, monkeypatch, u_base):
    """The four tiers of both packages with one complex64 U_base (the
    reference's or the port's, see the module docstring); the 64-bit tiers
    each use their own package's expm."""
    jplan, tplan = plans
    rz = zvode[0]
    if u_base == "reference":
        def port_ub(L0, Cp, Cm, amp, dt, max_squarings=None):
            if L0.dtype != torch.complex64:
                return _port_u_base(L0, Cp, Cm, amp, dt,
                                    max_squarings=max_squarings)
            return torch.from_numpy(np.array(_jax_u_base_orig(
                *(jnp.asarray(a.numpy()) for a in (L0, Cp, Cm)), amp, dt,
                max_squarings=max_squarings)))
        monkeypatch.setattr(tbench, "uniform_base_propagator", port_ub)
    else:
        def jax_ub(L0, Cp, Cm, amp, dt, max_squarings=12, expm_method="auto"):
            ub = _port_u_base(*(torch.from_numpy(np.asarray(a))
                                for a in (L0, Cp, Cm)), amp, dt,
                              max_squarings=max_squarings)
            return jnp.asarray(ub.numpy())
        monkeypatch.setattr(jprop, "uniform_base_propagator", jax_ub)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        r_c64, r_x64, r_f64, _, r_real = rbench.measure_parity(jplan, rz)
    c64, x64, c128, t, real = tbench.measure_parity(tplan, rz, device="cpu")
    assert abs(c64 - r_c64) <= 5e-6 and abs(real - r_real) <= 5e-6
    assert 0 < c64 < 2e-4 and 0 < real < 2e-4
    assert x64 <= 1e-9 and c128 <= 1e-9 and t > 0


def test_measure_parity_rejects_reduced_precision(plans, zvode):
    with pytest.raises(ValueError):
        tbench.measure_parity(plans[1], zvode[1], prec="high", device="cpu")


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_complex_engine_matches_reference(dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rstep, rscales, _ = rbench.build_workload(4, N_SEG, dtype=dtype,
                                                  engine="complex")
        tstep, tscales, _ = bench_gate.build_workload(
            4, N_SEG, dtype=getattr(torch, dtype), device="cpu",
            engine="complex")
    ref = np.asarray(rstep(rscales))
    got = tstep(tscales).numpy()
    assert got.shape == (4,)
    assert np.abs(got - ref).max() <= (1e-5 if dtype == "complex64" else 1e-10)


@pytest.mark.parametrize("kw", [{"prec": "high"}, {"prec": "default"},
                                {"engine": "planes"}])
def test_build_workload_rejects_unported_options(kw):
    with pytest.raises(ValueError):
        bench_gate.build_workload(4, N_SEG, device="cpu", **kw)


def test_main_record_keys_match_reference():
    _, ref = _quiet(rbench.main, batch=4, n_steps=N_SEG)
    rec, printed = _quiet(tbench.main, batch=4, n_steps=N_SEG, device="cpu")
    assert rec == printed
    keys = list(ref)
    keys.insert(keys.index("device") + 1, "power_limit")
    assert list(rec) == keys
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"
    assert rec["power_limit"] is None
    assert 0.97 <= rec["mean_fidelity"] <= 0.99
    assert abs(rec["mean_fidelity"] - ref["mean_fidelity"]) <= 1e-5
    assert rec["parity_err_x64_vs_zvode"] <= 1e-9
    assert rec["parity_err_f64_device_vs_zvode"] <= 1e-9
    assert rec["parity_err_throughput_path_vs_zvode"] == \
        rec["parity_err_real_f32_vs_zvode"]
    for k in ("value", "vs_baseline", "baseline_sims_per_sec",
              "f64_device_sims_per_sec", "achieved_useful_gflops"):
        assert rec[k] > 0, k


def test_main_bb_record_matches_reference_keys():
    _, ref = _quiet(rbench.main_bb, rounds=1, shots=512, reps=1)
    rec, printed = _quiet(tbench.main_bb, rounds=1, shots=512, reps=1,
                          device="cpu")
    assert rec == printed
    assert list(rec) == list(ref)
    assert rec["code"] == "[[144,12]]" and rec["backend"] == "cpu"
    assert rec["n_detectors"] == ref["n_detectors"]
    assert rec["n_mechanisms"] == ref["n_mechanisms"]
    n_err, n_dec = rec["e2e_n_errors"], rec["e2e_n_decoded"]
    assert n_dec == 512 and 0 <= n_err <= n_dec
    assert rec["e2e_p_logical_shot"] == n_err / n_dec
    lo, hi = rec["e2e_p_logical_ci95"]
    assert lo <= rec["e2e_p_logical_shot"] <= hi
    assert 0 <= rec["bp_nonconverged_frac"] <= 1 and rec["value"] > 0


def _bloated():
    return {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": None,
            "records": {f"w{i}": {"value": 1.0, "unit": "x" * 200}
                        for i in range(40)}}


@pytest.mark.parametrize("case", ["canon", "bloated"])
def test_compact_summary_line_matches_reference(case):
    out = (json.loads((ROOT / "BENCH_CANON.json").read_text())
           if case == "canon" else _bloated())
    line = tbench.compact_summary_line(out)
    assert line == rbench.compact_summary_line(out)
    assert len(line) <= 1500


def test_suites_match_reference():
    assert tbench._SUITE == rbench._SUITE
    assert tbench._SUITE_FULL == rbench._SUITE_FULL


def test_main_all_tiny_suite(tmp_path, monkeypatch, capsys):
    """Two small records, each in its own child process on the CPU: one JSON
    line each, then the summary line; both merged into the output file;
    BENCH_CANON.json untouched."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    canon = (ROOT / "BENCH_CANON.json").read_bytes()
    out = tmp_path / "bench.json"
    suite = [("gate_dim3", ["--one-gate", "--batch", "4", "--steps", "20"], 240),
             ("bb_ldpc", ["--bb", "--rounds", "1", "--shots", "512",
                          "--reps", "1"], 240)]
    summary = tbench.main_all(out=out, suite=suite, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    recs = [json.loads(ln) for ln in lines[:2]]
    assert [r["record"] for r in recs] == ["gate_dim3", "bb_ldpc"]
    for r in recs:
        assert "value" in r and r["wall_s"] > 0
        assert "generated_at_commit" in r and "card" in r and "power_limit" in r
    assert recs[0]["metric"] == "cz_lindblad_sims_per_sec"
    assert recs[1]["metric"] == "gross_code_e2e_sample_bp_decode_shots_per_sec"
    assert len(lines[2]) <= 1500
    last = json.loads(lines[2])
    assert last["value"] == recs[0]["value"]
    assert set(last["summary"]) == {"gate_dim3", "bb_ldpc"}
    assert lines[2] == tbench.compact_summary_line(summary)
    saved = json.loads(out.read_text())
    assert set(saved["records"]) == {"gate_dim3", "bb_ldpc"}
    assert saved["value"] == recs[0]["value"]
    assert (ROOT / "BENCH_CANON.json").read_bytes() == canon


def test_suite_marks_a_failed_record_and_exits_nonzero(tmp_path, monkeypatch,
                                                      capsys):
    """A record whose child fails replaces its older entry in the file with
    its error (no stale value stands in for it), the file's other records
    stay, the summary line shows the error and the command exits 1."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.setenv(var, "1")
    out = tmp_path / "bench.json"
    out.write_text(json.dumps({"records": {
        "gate_dim3": {"metric": "cz_lindblad_sims_per_sec", "value": 5.0},
        "other": {"metric": "m", "value": 1.0}}}))
    monkeypatch.setattr(tbench, "_SUITE", [
        ("gate_dim3", ["--one-gate", "--batch", "4", "--steps", "20",
                       "--prec", "high"], 240)])
    assert tbench.cli(["--out", str(out), "--device", "cpu"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    assert "prec='high'" in json.loads(lines[0])["error"]
    assert "error" in json.loads(lines[1])["summary"]["gate_dim3"]
    saved = json.loads(out.read_text())
    assert "value" not in saved["records"]["gate_dim3"]
    assert "error" in saved["records"]["gate_dim3"]
    assert saved["records"]["other"] == {"metric": "m", "value": 1.0}
    assert saved["value"] is None


def test_cli_without_a_card_raises():
    """With no CUDA device and no --device cpu the record does not run on
    the CPU: the command fails and prints no record."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-m",
                        "noisyquantumsimulator_tpu_torch.bench", "--one-gate"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT,
                       env=env)
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert "no CUDA device" in r.stderr


def test_validate_bangbang_matches_reference():
    kw = dict(include_noise=False, trap_laser_on=False, spacing_factor=2.945)
    noiseless = jcfg.NoiseSourceConfig.noiseless()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = {
            "F_a": jsim.simulate_cz_gate(
                jcfg.JPSimulationInputs(noise=noiseless), **kw).avg_fidelity,
            "F_b": jsim.simulate_cz_gate(
                jcfg.JPSimulationInputs(noise=noiseless,
                                        switching_times=tval.SWITCHING_B),
                **kw).avg_fidelity,
            "F_smooth": jsim.simulate_cz_gate(
                jcfg.SmoothJPSimulationInputs(noise=noiseless),
                **kw).avg_fidelity}
        got = tval.run("cpu")
    for k, v in ref.items():
        assert abs(got[k] - float(v)) <= 1e-6, k
    assert got["pass"] == [True, True, True]
    assert abs(got["controlled_phase_deg"]) > 170


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_diagnose_bb_matches_reference(dtype):
    """complex128: `diagnose_bb.sweep` (the root script's precision, x64 on)
    against the reference's sweep. complex64: the same population through
    the port's objective at the 32-bit tier, against the reference's."""
    app = japp.ApparatusConstraints(spacing_factor=2.945)
    problem = jeng.build_fixed_problem(app, app.make_noiseless(),
                                       include_noise=False,
                                       dtype=getattr(jnp, dtype))
    _, x0 = jfwd.get_jp_bangbang_bounds_and_x0(5)
    pop = np.tile(x0, (len(tdiag.AREAS), 1))
    pop[:, 0] = tdiag.AREAS
    _, m = jeng.make_population_objective(problem, "jandura_pupillo",
                                          n_segments=5)(jnp.asarray(pop))
    if dtype == "complex128":
        got = tdiag.sweep("cpu")
        tol = 1e-6
        assert abs(got["best_area"] - tdiag.VALIDATED_AREA) <= 0.5
    else:
        tapp = tapp_mod.ApparatusConstraints(spacing_factor=2.945)
        tproblem = teng.build_fixed_problem(tapp, tapp.make_noiseless(),
                                            include_noise=False, device="cpu",
                                            dtype=torch.complex64)
        _, got = teng.make_population_objective(
            tproblem, "jandura_pupillo", n_segments=5)(torch.as_tensor(pop))
        got = {k: v.numpy().astype(np.float64) for k, v in got.items()
               if k in ("avg_fidelity", "f11")}
        got["V_over_Omega"] = tproblem.V_over_Omega
        tol = 1e-4
    assert np.abs(got["avg_fidelity"] - np.asarray(m["avg_fidelity"])).max() <= tol
    assert np.abs(got["f11"] - np.asarray(m["f11"])).max() <= tol
    assert got["V_over_Omega"] == pytest.approx(float(problem.V_over_Omega))


def test_scripts_print_their_reports(capsys):
    """The two scripts' main() on the CPU: the reference's report lines."""
    assert tval.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ALL PASS" in out and out.count("(PASS)") == 3
    assert tdiag.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("apparatus: V/Omega = ")
    assert len([ln for ln in out if ln.strip().endswith("d")]) == 17
    assert out[-1].startswith("best area: ")


def test_cli_qec_dispatches_to_bench_qec(capsys):
    """`--qec` with the reference's flags runs bench_qec.main_qec and prints
    its record as one line."""
    assert tbench.cli(["--qec", "--d", "3", "--rounds", "2", "--shots", "4096",
                       "--decode-shots", "1024", "--reps-decode", "1",
                       "--seed", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["metric"] == "surface_code_d3_sample_shots_per_sec"
    assert (rec["d"], rec["rounds"], rec["shots_per_call"], rec["seed"],
            rec["e2e_n_decoded"]) == (3, 2, 4096, 2, 1024)
    assert len(lines[-1]) <= 1500
