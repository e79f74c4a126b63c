"""The port's platform studies (`noisyquantumsimulator_tpu_torch/studies/`)
against the scripts under `examples/` and the JAX package, on the CPU at
small sizes.

  * ms_gate_engine_study / cavity_gate_engine_study at n_fock = 4 against
    the JAX engines: the JSON's numeric fields within 1e-10, the budget
    ranking equal, the Pauli ranking equal by value (its labels tie to
    rounding), `_top_paulis` the script's function, the regimes equal to
    the scripts'; each
    record written into the given store equals the JAX package's record
    to 1e-10 but for the run's nbar, which the reference drops (it keeps
    the last noise case's 0.0): both values are pinned.
  * ion_memory: `backend_pricing` of each of the five platforms equal to the
    script's on the JAX backends within 1e-12; `run_platform` at d = 3 with
    a few thousand shots carries the script's keys and counts that agree
    with its p_L and CI.
  * nn_decoder_study at a tiny size: the exact-MWPM errors equal the JAX
    package's NativeMatchingDecoder on the same detector rows.
  * multichip_scaling on gloo at world sizes 1 and 2: the reduced counts
    are the sum over the ranks, a rank's stream does not depend on the
    world size, and the detector fraction is within 15% of the shipped
    CPU run's.
  * generate_figures at 60 segments and 2 points against the JAX
    `hardware_sweep` / `simulate_cz_gate`: F within 1e-8, gate times and
    rates within 1e-9 relative; `plot` writes the six PNGs.
  * the notebook's code cells but section 4's optimizer through
    `run_cells(..., device="cpu")`: sections 1 and 3's F within 1e-8 of the
    JAX package's `simulate_cz_gate` at x64; no cell mentions JAX.
  * every study defaults to the card; nothing touches `examples/`,
    `figures/` or `calibration_data/`.
"""
import hashlib
import importlib.util
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from noisyquantumsimulator_tpu.core import configs as jconfigs
from noisyquantumsimulator_tpu.gate import cavity_gate as jcg
from noisyquantumsimulator_tpu.gate import ms_gate as jms
from noisyquantumsimulator_tpu.gate import simulate as jsim
from noisyquantumsimulator_tpu.optimize import apparatus as japp
from noisyquantumsimulator_tpu.optimize import sweeps as jsweeps
from noisyquantumsimulator_tpu.physics import cavity_qed as jcq
from noisyquantumsimulator_tpu.physics import trapped_ions as jti
from noisyquantumsimulator_tpu.primitives import backend as jbackend
from noisyquantumsimulator_tpu.primitives import cavity_backend as jcb
from noisyquantumsimulator_tpu.primitives import ion_backend as jion
from noisyquantumsimulator_tpu.qec import dem as jdem
from noisyquantumsimulator_tpu.qec import native as jnative
from noisyquantumsimulator_tpu.qec import surface_code as jsc
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit
from noisyquantumsimulator_tpu_torch.studies import (
    cavity_gate_engine_study, demo_notebook, generate_figures, ion_memory,
    ms_gate_engine_study, multichip_scaling, nn_decoder_study)
from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

from _json_close import close as _close

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
SIM_KW = {"n_steps_smooth": 60}


def _tree_hashes():
    files = sorted(EXAMPLES.glob("*"))
    for sub in ("figures", "calibration_data"):
        files += sorted(p for p in (ROOT / sub).rglob("*") if p.is_file())
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file()}


HASHES_BEFORE = _tree_hashes()


def _shipped(name):
    with open(EXAMPLES / name) as f:
        return json.load(f)


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_blas_thread():
    with threadpool_limits(1):
        yield


# --------------------------------------------- the MS and cavity engine studies

N_FOCK = 4
ENGINE = {"ms": (ms_gate_engine_study, "ms_gate_engine_study", jms.simulate_ms_gate,
                 jms.ms_calibration_record, "trapped_ions/ms_gate", "nbar"),
          "cavity": (cavity_gate_engine_study, "cavity_gate_engine_study",
                     jcg.simulate_cavity_gate, jcg.cavity_calibration_record,
                     "cavity_qed/exchange_gate", "nbar_cavity")}


def _reference_row(which, script, regime, kw):
    """The script's JSON row, computed by the JAX package at N_FOCK."""
    r = ENGINE[which][2](n_fock=N_FOCK, **kw)
    if which == "ms":
        a = jti.ms_gate(**kw)
        extra = {}
    else:
        a = jcq.photon_mediated_gate(g=kw["g"], kappa=kw["kappa"],
                                     gamma=kw["gamma_spont"],
                                     technique="raman_virtual")
        extra = {"cooperativity": r.cooperativity, "cphase_angle": r.cphase_angle}
    row = {"engine_infidelity": 1.0 - r.fidelity,
           "engine_process_infidelity": 1.0 - r.process_fidelity,
           "analytic_infidelity_crosscheck": 1.0 - a.fidelity,
           "duration_s": r.duration, "leakage": r.leakage,
           "cptp": bool(r.completely_positive and r.trace_preserving),
           "budget_top3": sorted(((k, float(v)) for k, v in r.error_budget.items()),
                                 key=lambda kv: -kv[1])[:3],
           "dominant_pauli_errors": script._top_paulis(r.error_map_pauli),
           **extra}
    return row, ENGINE[which][3](r, regime).to_json()


@pytest.fixture(scope="module", params=list(ENGINE))
def engine_study(request, tmp_path_factory):
    which = request.param
    mod, script_name = ENGINE[which][:2]
    script = _load_example(script_name)
    store = tmp_path_factory.mktemp(which)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = mod.run(device="cpu", n_fock=N_FOCK, store_root=str(store))
        ref = {regime: _reference_row(which, script, regime, kw)
               for regime, kw in script.REGIMES.items()}
    return which, mod, script, store, got, ref


def test_engine_study_regimes_equal_the_scripts(engine_study):
    _, mod, script, _, _, _ = engine_study
    assert mod.REGIMES == script.REGIMES


def test_engine_study_matches_reference(engine_study):
    """Numbers within 1e-10. The dominant Pauli errors tie to rounding (IX /
    XI by symmetry; four-fold at the fiber cavity), so their ranking is
    held by value: each label's probability is the reference's for that
    label, and the three values are the reference's top three."""
    which, mod, script, _, got, ref = engine_study
    assert set(got["regimes"]) == set(script.REGIMES)
    shipped = _shipped(f"{mod.NAME.replace('_study', '')}.json")
    for regime, (row, rec_ref) in ref.items():
        g = got["regimes"][regime]
        assert set(shipped["regimes"][regime]) == set(g)
        top = row["dominant_pauli_errors"]
        numbers = {k: v for k, v in row.items() if k != "dominant_pauli_errors"}
        _close({k: g[k] for k in numbers}, numbers, 1e-10, regime)
        probs = dict(zip(rec_ref["pauli_labels"], rec_ref["pauli_error_probs"]))
        for lab, pr in g["dominant_pauli_errors"]:
            assert abs(pr - probs[lab]) <= 1e-10, (regime, lab)
        _close([pr for _, pr in g["dominant_pauli_errors"]],
               [pr for _, pr in top], 1e-10, regime)


def test_top_paulis_equal_the_scripts():
    """The same function as the script's on the same probabilities, ties
    included."""
    script = _load_example("ms_gate_engine_study")
    rng = np.random.default_rng(5)
    for probs in (rng.random(16), np.r_[0.9, np.full(15, 0.1 / 15)],
                  np.r_[0.9, 0.02, 0.02, rng.random(13) * 1e-3]):
        assert ms_gate_engine_study._top_paulis(probs) == script._top_paulis(probs)


def _record(engine_study, regime):
    which, _, _, store, got, _ = engine_study
    path = Path(store) / ENGINE[which][4] / f"{regime}.json"
    assert (ROOT / got["regimes"][regime]["calibration_record"]).resolve() == \
        path.resolve()
    return json.loads(path.read_text())


def test_engine_study_records_match_reference_but_nbar(engine_study):
    """The records equal the JAX package's to 1e-10 with the run's nbar,
    and the names of the producing package and engine, left out; the
    reference stores the last noise case's nbar (0.0), the port the run's."""
    which, _, script, _, _, ref = engine_study
    key = ENGINE[which][5]
    for regime, (_, rec_ref) in ref.items():
        rec, rec_ref = _record(engine_study, regime), json.loads(json.dumps(rec_ref))
        assert (rec["parameters"][key], rec_ref["parameters"][key]) == (
            script.REGIMES[regime][key], 0.0)
        for d in (rec, rec_ref):
            d["parameters"] = {k: v for k, v in d["parameters"].items()
                               if k not in (key, "engine")}
            d["metadata"].pop("generator")
        _close(rec, rec_ref, 1e-10, regime)


# ------------------------------------------------------------------ ion_memory

def _jax_backend(name):
    cls, kw = {"ion_yb171_default": (jion.IonBackend, dict(
                   species="Yb171", ms_regime="yb171_default")),
               "ion_ca40_high_fidelity": (jion.IonBackend, dict(
                   species="Ca40", ms_regime="ca40_high_fidelity")),
               "neutral_atom_n70": (jbackend.NeutralAtomBackend, {}),
               "cavity_circuit_qed": (jcb.CavityBackend,
                                      dict(regime="circuit_qed_exchange")),
               "cavity_rb_fiber": (jcb.CavityBackend,
                                   dict(regime="rb_fiber_cavity"))}[name]
    return cls(**kw)


@pytest.mark.parametrize("name", list(ion_memory.PLATFORMS))
def test_backend_pricing_matches_script(name):
    script = _load_example("ion_memory")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got = ion_memory.backend_pricing(ion_memory.make_backend(name, "cpu"))
        want = script.backend_pricing(_jax_backend(name))
    assert set(got) == set(want)
    _close({k: np.asarray(v).tolist() for k, v in got.items()},
           {k: np.asarray(v).tolist() for k, v in want.items()}, 1e-12, name)
    _close(np.asarray(got["cx_pauli_probs"]).tolist(),
           _shipped("ion_memory.json")["platforms"][name]["pricing"]["cx_pauli_probs"],
           1e-12, name)


def test_run_platform_keys_and_counts():
    shots = 4096
    out = ion_memory.run(shots=shots, ds=(3,), device="cpu")
    ref = _shipped("ion_memory.json")
    assert set(ref) <= set(out) and out["shots_per_cell"] == shots
    assert list(out["platforms"]) == list(ref["platforms"])
    pl = out["platforms"]["cavity_circuit_qed"]
    ref_pl = ref["platforms"]["cavity_circuit_qed"]
    assert set(ref_pl) <= set(pl) and set(ref_pl["pricing"]) == set(pl["pricing"])
    row = pl["memory"]["d3"]
    assert set(ref_pl["memory"]["d3"]) <= set(row)
    k = row["n_errors"]
    assert row["shots"] == shots and row["decoder"] == "native"
    assert 300 < k < 900          # p_L/shot ~0.146 at d = 3
    assert row["p_logical_shot"] == k / shots
    assert row["ci95"] == list(wilson_ci(k, shots))
    assert row["p_logical_round"] == pytest.approx(
        (1 - (1 - 2 * k / shots) ** (1 / 3)) / 2, rel=1e-12)
    assert pl["lambda_d3_over_d5"] is None


# ------------------------------------------------------------ nn_decoder_study

def test_nn_decoder_mwpm_errors_match_reference_decoder():
    d, p, shots = 3, 3e-3, 3000
    out = nn_decoder_study.run(steps=5, batch=128, eval_shots=shots, d=d, p=p,
                               device="cpu")
    assert set(_shipped("nn_decoder_d5.json")) <= set(out)
    assert (out["eval_shots"], out["eval_blocks"], out["train_backend"]) == (
        shots, 1, "cpu")
    jc = jsc.memory_z_circuit(d, d, p=p)
    nat = jnative.NativeMatchingDecoder(jc.n_detectors,
                                        *jdem.dem_to_edges(jdem.build_dem(jc)))
    sampler = build_fast_sampler(memory_z_circuit(d, d, p=p), shots, "cpu")
    dets, obs = nn_decoder_study.eval_block(sampler, 0, "cpu")
    pred = nat.decode_batch_ex(dets.numpy(), mode=0)["pred"] & 1
    assert out["n_errors_mwpm"] == int(np.sum(pred != obs))
    assert out["p_logical_trivial"] == float(np.sum(obs)) / shots
    assert out["nn_over_exact_ratio"] == out["n_errors_nn"] / max(
        out["n_errors_mwpm"], 1)


# ------------------------------------------------------------ multichip_scaling

def test_multichip_scaling_gloo_reduces_rank_counts():
    out = multichip_scaling.run(sizes=(1, 2), device="cpu", shots_per_dev=1024,
                                bb_shots=64)
    ref = _shipped("multichip_scaling.json")
    assert set(ref) <= set(out) and out["platform"] == "cpu"
    assert [s["n_devices"] for s in out["surface_mc"]] == [1, 2]
    for s, b in zip(out["surface_mc"], out["bb_ldpc_mc"]):
        n = s["n_devices"]
        assert set(ref["surface_mc"][0]) <= set(s)
        assert set(ref["bb_ldpc_mc"][0]) <= set(b)
        assert len(s["rank_counts"]) == n and s["shots_total"] == 1024 * n
        assert [sum(c) for c in zip(*s["rank_counts"])] == [
            s["n_detectors_fired"], s["n_obs_flips"]]
        assert b["shots"] == 64 * n and b["n_devices"] == n
        # the shipped CPU run's detector fraction, as the script asserts
        # across world sizes
        assert abs(s["detector_fraction"]
                   / ref["surface_mc"][0]["detector_fraction"] - 1) < 0.15
    # rank 0 draws SeedSequence(3).spawn(world)[0], the same at every world
    assert out["surface_mc"][0]["rank_counts"][0] == \
        out["surface_mc"][1]["rank_counts"][0]


# ------------------------------------------------------------- generate_figures

@pytest.fixture(scope="module")
def figures():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return generate_figures.figure_data(device="cpu", points=2,
                                            sim_kwargs=SIM_KW, pareto=(0, 2))


def test_figure_data_matches_reference(figures):
    app = japp.ApparatusConstraints()
    b = figures["blockade_importance"]
    sp = generate_figures.blockade_spacings(2)
    assert b["spacing_factor"] == sp.tolist() and len(sp) == 6
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for label, noisy, kw in (("noiseless", False, {**SIM_KW, "trap_laser_on": False}),
                                 ("full noise", True, SIM_KW)):
            r = jsweeps.hardware_sweep("spacing_factor", sp[:1], protocol="smooth_jp",
                                       apparatus=app, include_noise=noisy,
                                       sim_kwargs=kw)
            assert abs(b[label]["fidelity"][0] - float(r.fidelity[0])) <= 1e-8
            assert b[label]["V_over_Omega"][0] == pytest.approx(
                float(r.extras["V_over_Omega"][0]), rel=1e-9)
        pc = figures["protocol_comparison"]
        for i, cls in enumerate((jconfigs.LPSimulationInputs,
                                 jconfigs.SmoothJPSimulationInputs,
                                 jconfigs.JPSimulationInputs)):
            r = jsim.simulate_cz_gate(cls(), **SIM_KW)
            assert abs(pc["fidelity"][i] - r.avg_fidelity) <= 1e-8, i
            assert pc["gate_time_us"][i] == pytest.approx(r.tau_total * 1e6,
                                                          rel=1e-9)
            if i == 1:
                nb = {k: float(v) for k, v in r.noise_breakdown.items()
                      if isinstance(v, (int, float)) and not isinstance(v, bool)}
                assert set(nb) == set(figures["noise_breakdown"])
                for k in nb:
                    assert figures["noise_breakdown"][k] == pytest.approx(
                        nb[k], rel=1e-9, abs=1e-12), k
        sc = figures["species_comparison"]
        assert sc["n_rydberg"] == [55, 85]
        for species in ("Rb87", "Cs133"):
            r = jsim.simulate_cz_gate(jconfigs.SmoothJPSimulationInputs(),
                                      species=species, n_rydberg=55, **SIM_KW)
            assert abs(sc[species][0] - r.avg_fidelity) <= 1e-8, species
        ts = figures["temperature_sensitivity"]
        r = jsweeps.hardware_sweep("temperature", ts["temperature_K"],
                                   protocol="smooth_jp", apparatus=app,
                                   sim_kwargs=SIM_KW)
        assert np.max(np.abs(np.asarray(ts["fidelity"]) - r.fidelity)) <= 1e-8
    pa = figures["pareto"]
    assert (pa["maxiter"], pa["popsize"], len(pa["fidelity"])) == (0, 2, 2)
    assert all(0.0 < f <= 1.0 for f in pa["fidelity"])
    assert set(pa["front_fidelity"]) <= set(pa["fidelity"])


def test_figures_plot_writes_the_six_pngs(figures, tmp_path):
    pytest.importorskip("matplotlib")
    paths = generate_figures.plot(figures, tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(generate_figures.PNGS)
    assert [Path(p).name for p in paths] == list(generate_figures.PNGS)
    reference = {line.split('"')[1] for line in
                 (EXAMPLES / "generate_figures.py").read_text().splitlines()
                 if "os.path.join(FIGDIR" in line}
    assert reference == set(generate_figures.PNGS)


# ---------------------------------------------------------------- the notebook

def test_notebook_cells_are_the_ports():
    with open(demo_notebook.NOTEBOOK) as f:
        nb = json.load(f)
    with open(EXAMPLES / "cz_gate_optimization_demo.ipynb") as f:
        ref = json.load(f)
    assert [c["cell_type"] for c in nb["cells"]] == [c["cell_type"] for c in ref["cells"]]
    assert len(nb["cells"]) == 16 and len(demo_notebook.code_cells()) == 8
    for c in nb["cells"]:
        assert "jax" not in "".join(c["source"]).lower()
    assert "DEVICE = " in demo_notebook.code_cells()[0]


def test_notebook_runs_on_the_cpu_but_the_optimizer(tmp_path):
    path = tmp_path / "demo.json"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        assert demo_notebook.main(["--device", "cpu", "--skip", "4",
                                   "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    assert out["skipped"] == [4] and sorted(out["seconds"]) == [
        "0", "1", "2", "3", "5", "6", "7"]
    assert 0.97 <= out["default_fidelity"] <= 0.99
    assert out["protocol_fidelity"]["smooth JP"] == out["default_fidelity"]
    # sections 1 and 3 are plain gates: the reference notebook's, at x64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for name, cls in (("LP", jconfigs.LPSimulationInputs),
                          ("smooth JP", jconfigs.SmoothJPSimulationInputs),
                          ("bang-bang", jconfigs.JPSimulationInputs)):
            F = jsim.simulate_cz_gate(cls()).avg_fidelity
            assert abs(out["protocol_fidelity"][name] - F) <= 1e-8, name
    assert len(out["temperature_sweep_fidelity"]) == 5
    assert 0.9 < out["cz_record_fidelity"] < 1.0
    assert 0.0 < out["memory_p_logical_shot"] < 0.5
    assert "optimized_fidelity" not in out


# ------------------------------------------------------------------- all of them

DEFAULT_CALLS = {
    "ms_gate_engine_study": lambda: ms_gate_engine_study.run(),
    "cavity_gate_engine_study": lambda: cavity_gate_engine_study.run(),
    "ion_memory": lambda: ion_memory.run(),
    "nn_decoder_study": lambda: nn_decoder_study.run(),
    "multichip_scaling": lambda: multichip_scaling.run(),
    "generate_figures": lambda: generate_figures.figure_data(),
    "demo_notebook": lambda: demo_notebook.run(),
}


@pytest.mark.parametrize("name", list(DEFAULT_CALLS))
def test_platform_study_defaults_to_the_card(name):
    """Without device="cpu" a study raises where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_CALLS[name]()


def test_zz_examples_untouched():
    """Runs last in this module: the studies above wrote nothing under
    examples/, figures/ or calibration_data/."""
    assert _tree_hashes() == HASHES_BEFORE
