"""The port's studies (`noisyquantumsimulator_tpu_torch/studies/`) against the
scripts under `examples/` and the JAX package, on the CPU at small sizes.

  * qec_study: `summarize` fed the shipped `examples/qec_study.json` table
    gives its Lambda, per-step Lambda and teraquop footprint exactly;
    `shot_budget` equals the script's (loaded by path) on every cell.
  * research_parameter_sweeps: one hardware-sweep point (smooth JP) and the
    protocol summary's "ideal" row (LP and smooth JP) at 60 segments
    against the JAX functions at complex128: F within 1e-8, gate time and
    phase error within 1e-9 relative.
  * grape_optimal_control: 5 Adam steps over 20 free phases at complex128
    against the reference's value-and-grad with optax.adam on the same
    phases: every step's cost within 1e-9 relative; the complex128
    baseline at 300 segments that chip_smoke.py holds the card to is the
    JAX package's. (At 32 bits the baselines differ by float32 rounding, up
    to ~2e-3 relative in the cost; chip_smoke.py holds the 32-bit run
    accordingly.)
  * each QEC study's `run(..., device="cpu")` at a tiny size carries the
    reference's JSON keys; the CLI writes its `--out` file and refuses
    `--ds` with `--quick`; every study defaults to the card.
  * no study touches `examples/`, `figures/` or `calibration_data/`: their
    files hash the same after this module's tests as before them.
"""
import hashlib
import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp
from noisyquantumsimulator_tpu.core import configs as jconfigs
from noisyquantumsimulator_tpu.gate import simulate as jsim
from noisyquantumsimulator_tpu.optimize import apparatus as japp
from noisyquantumsimulator_tpu.optimize import engine as jeng
from noisyquantumsimulator_tpu.optimize import sweeps as jsweeps
from noisyquantumsimulator_tpu_torch.optimize.apparatus import (
    ApparatusConstraints)
from noisyquantumsimulator_tpu_torch.optimize.forward import (
    get_smooth_jp_bounds_and_x0)
from noisyquantumsimulator_tpu_torch.studies import (
    decoder_accuracy_study, grape_optimal_control, gross_code_study,
    qec_scale_study, qec_study, research_parameter_sweeps)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SIM_KW = {"n_steps_smooth": 60}
STUDIES = (research_parameter_sweeps, grape_optimal_control, qec_study,
           qec_scale_study, decoder_accuracy_study, gross_code_study)


def _tree_hashes():
    files = sorted(EXAMPLES.glob("*.json"))
    for sub in ("figures", "calibration_data"):
        files += sorted(p for p in (ROOT / sub).rglob("*") if p.is_file())
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


HASHES_BEFORE = _tree_hashes()


def _shipped(name):
    with open(EXAMPLES / name) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- qec_study

def test_qec_summary_reproduces_shipped_table():
    ref = _shipped("qec_study.json")
    table = {qec_study.parse_key(k): v for k, v in ref["table"].items()}
    shots = {qec_study.parse_key(k): v for k, v in ref["shots"].items()}
    out = qec_study.summarize(table, shots)
    for key in ("table", "shots", "lambda", "lambda_per_step", "teraquop_d",
                "teraquop_anchored_at_d", "decoder"):
        assert out[key] == ref[key], key


def test_qec_shot_budget_matches_script():
    script = _load_example("qec_study")
    for quick in (True, False):
        for d in (3, 5, 7, 9, 11, 13):
            for p in (5e-4, 1e-3, 2e-3, 4e-3, 8e-3):
                assert qec_study.shot_budget(d, p, quick) == \
                    script.shot_budget(d, p, quick), (d, p, quick)


def test_qec_shot_rate_inverts_logical_error_rate():
    from noisyquantumsimulator_tpu_torch.qec.surface_code import (
        logical_error_rate)
    r = logical_error_rate(37, 200000, 7)
    assert qec_study.shot_rate(r["p_logical_round"], 7) == pytest.approx(
        r["p_logical_shot"], rel=1e-12)


# --------------------------------------------------- research_parameter_sweeps

@pytest.mark.parametrize("name", ["temperature", "n_rydberg"])
def test_hardware_sweep_point_matches_reference(name):
    """The sweep's first point (n_rydberg arrives as a numpy int)."""
    values = dict(research_parameter_sweeps.hardware_studies(1))[name]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = research_parameter_sweeps.hardware_sweeps(
            ApparatusConstraints(), 1, "cpu", SIM_KW, names=(name,))[name]
        ref = jsweeps.hardware_sweep(name, values, protocol="smooth_jp",
                                     apparatus=japp.ApparatusConstraints(),
                                     sim_kwargs=SIM_KW)
    assert got["values"] == np.asarray(values, float).tolist()
    assert abs(got["fidelity"][0] - float(ref.fidelity[0])) <= 1e-8
    assert got["gate_time_us"][0] == pytest.approx(float(ref.gate_time_us[0]),
                                                   rel=1e-9)
    assert got["phase_error_deg"][0] == pytest.approx(
        float(ref.phase_error_deg[0]), rel=1e-9, abs=1e-9)


def test_protocol_summary_ideal_row_matches_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = research_parameter_sweeps.protocol_summary(
            ApparatusConstraints(), "cpu", SIM_KW,
            conditions=research_parameter_sweeps.CONDITIONS[:1])["ideal"]
        app = japp.ApparatusConstraints()
        for proto, cls in (("lp", jconfigs.LPSimulationInputs),
                           ("smooth_jp", jconfigs.SmoothJPSimulationInputs)):
            r = jsim.simulate_cz_gate(
                cls(excitation=app.make_excitation_config(),
                    noise=app.make_full_noise()),
                **{**app.sim_kwargs(), **SIM_KW})
            assert abs(got[proto]["fidelity"] - r.avg_fidelity) <= 1e-8, proto
            assert got[proto]["gate_time_us"] == pytest.approx(
                r.gate_time_us, rel=1e-9)


# ----------------------------------------------------- grape_optimal_control

def test_grape_steps_match_optax():
    n_steps, iters, lr = 20, 5, 2e-3
    got = grape_optimal_control.run(n_steps=n_steps, iters=iters, lr=lr,
                                    device="cpu", dtype=torch.complex128,
                                    log_every=1)
    app = japp.ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = jeng.build_fixed_problem(app, app.make_full_noise())
    _, x0 = get_smooth_jp_bounds_and_x0()
    cost0, m0 = jeng.make_objective(problem, "smooth_jp", n_steps=n_steps)(
        np.asarray(x0))
    phases, _, _ = jeng.smooth_jp_uniform_from_params(jnp.asarray(x0), problem,
                                                      n_steps=n_steps)
    kw = dict(omega_tau=float(x0[0]), delta_over_omega=float(x0[4]))
    vg = jeng.make_value_and_grad(problem, "grape", **kw)
    opt = optax.adam(lr)
    state = opt.init(phases)
    costs = []
    for _ in range(iters):
        cost, grad = vg(phases)
        upd, state = opt.update(grad, state)
        phases = optax.apply_updates(phases, upd)
        costs.append(float(cost))
    cost1, m1 = jeng.make_objective(problem, "grape", **kw)(phases)

    base = got["baseline_smooth_jp"]
    assert base["cost"] == pytest.approx(float(cost0), rel=1e-9)
    assert abs(base["avg_fidelity"] - float(m0["avg_fidelity"])) <= 1e-10
    assert [h["iter"] for h in got["history"]] == list(range(iters))
    for h, c in zip(got["history"], costs):
        assert h["cost"] == pytest.approx(c, rel=1e-9), h["iter"]
    assert got["grape"]["cost"] == pytest.approx(float(cost1), rel=1e-9)
    assert abs(got["grape"]["avg_fidelity"] - float(m1["avg_fidelity"])) <= 1e-10
    assert got["grad_dim"] == n_steps and got["backend"] == "cpu"
    assert set(_shipped("grape_result.json")) <= set(got)


def test_grape_x64_baseline_constant_of_the_card_hold():
    """chip_smoke.py holds the card's complex128 GRAPE baseline (300
    segments) to a written-out value: the JAX package's x64 one."""
    spec = importlib.util.spec_from_file_location("_chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    app = japp.ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        problem = jeng.build_fixed_problem(app, app.make_full_noise())
    cost, m = jeng.make_objective(problem, "smooth_jp", n_steps=300)(
        np.asarray(get_smooth_jp_bounds_and_x0()[1]))
    assert float(cost) == pytest.approx(smoke.GRAPE_X64_BASELINE[0], rel=1e-12)
    assert abs(float(m["avg_fidelity"]) - smoke.GRAPE_X64_BASELINE[1]) <= 1e-13


# ---------------------------------------------------------- the QEC studies

def test_qec_study_run_keys():
    out = qec_study.run(ds=(3,), ps=(1e-3,), shots=2000, device="cpu")
    assert set(_shipped("qec_study.json")) <= set(out)
    assert out["shots"] == {"d3_p0.001": 2000}
    n_err = out["errors"]["d3_p0.001"]
    assert 0 < n_err < 100      # p_L/shot ~3.4e-3 at d = 3, p = 1e-3
    assert out["table"]["d3_p0.001"] == pytest.approx(
        (1 - (1 - 2 * n_err / 2000) ** (1 / 3)) / 2, rel=1e-12)


def test_qec_study_cli_writes_out_and_refuses_ds_with_quick(tmp_path):
    path = tmp_path / "qs.json"
    assert qec_study.main(["--quick", "--device", "cpu", "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    assert len(out["table"]) == 6 and set(out["shots"].values()) == {20000}
    with pytest.raises(ValueError, match="--quick"):
        qec_study.main(["--quick", "--ds", "3", "--device", "cpu",
                        "--out", str(path)])


def test_qec_scale_study_run_keys():
    out = qec_scale_study.run(ds=(3,), sample_shots=2048, decode_shots=1024,
                              reps=1, device="cpu")
    ref = _shipped("qec_scale.json")
    assert set(ref) <= set(out)
    (row,) = out["points"]
    assert set(ref["points"][0]) <= set(row)
    assert row["decode_shots"] == 1024 and row["fetch_cap"] == 128
    assert row["n_errors"] == row["n_errors_device"] + row["n_errors_escalated"]


def test_qec_scale_fetch_cap_matches_script():
    src = (EXAMPLES / "qec_scale_study.py").read_text()
    assert ("cap = decode_shots if d >= 15 else \\\n        min(decode_shots, "
            "max(decode_shots // (8 if d < 13 else 2), 64))") in src
    for d in (3, 7, 9, 11, 13, 15):
        for n in (1 << 10, 1 << 14, 1 << 17):
            expect = n if d >= 15 else min(n, max(n // (8 if d < 13 else 2), 64))
            assert qec_scale_study.fetch_cap(d, n) == expect


def test_decoder_accuracy_study_run_keys():
    out = decoder_accuracy_study.run(ds=(3,), shots=2048,
                                     wcs=((5, 2), (6, 3)), device="cpu")
    ref = _shipped("decoder_accuracy.json")
    assert set(ref) <= set(out)
    (row,) = out["points"]
    assert set(ref["points"][0]) <= set(row)
    assert set(row["windows"]) == {"W5C2", "W6C3"}
    assert set(ref["points"][0]["windows"]["W5C2"]) <= set(row["windows"]["W5C2"])
    assert row["oracle_certified_fraction"] == 1.0
    assert "tiered_overflow_split" in row


def test_gross_code_study_run_keys():
    out = gross_code_study.run(shots=256, reps=1, rounds=1, device="cpu")
    ref = _shipped("gross_code_study.json")
    assert set(ref) <= set(out)
    for key in ("p=0.001", "p=0.002"):
        assert set(ref[key]) <= set(out[key]), key
        assert out[key]["e2e_n_decoded"] == 256
    assert out["p=0.002"]["seed"] == 12
    assert "8 iters" in out["p=0.002"]["decoder"]   # the non-lean budgets


@pytest.mark.parametrize("study", STUDIES, ids=lambda m: m.NAME)
def test_study_defaults_to_the_card(study):
    """Without --device cpu a study raises where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.run()


def test_zz_examples_untouched():
    """Runs last in this module: the studies above wrote nothing under
    examples/, figures/ or calibration_data/."""
    assert _tree_hashes() == HASHES_BEFORE
