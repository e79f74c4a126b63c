"""The port's cavity-QED slice against the JAX package: the analytic
physics (`physics/cavity_qed`), the hardware configs (`models/`) and AOD
transport (`physics/transport`), all copied host code (bit-equal); the
cavity exchange-gate Lindblad engine (`gate/cavity_gate` through
`gate/open_system.qubit_channel_device`) and `CavityBackend`.

The engine runs small here: the reference's own parity configuration
(`tests/test_cavity_gate.py`: n_loops = 5, n_fock = 4) and the backend's
in-process fallback (n_fock = 4, the full budget of 7 noise cases: 256 x 256
complex128 Liouvillians). The port's device path on the CPU must lie within
1e-10 of the reference's JAX engine at x64 and of the scipy oracle. The
shipped records were made at the regimes of
`examples/cavity_gate_engine_study.py`, not at the parameters the records
store: the reference records the parameters of the last noise case of its
loop ("cavity_drift", nbar_cavity 0.0); the port records the "full" case's.
"""
import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.channels.calibration import (
    CalibrationStore as JStore)
from noisyquantumsimulator_tpu.gate import cavity_gate as jcg
from noisyquantumsimulator_tpu.models import hardware_configs as jhw
from noisyquantumsimulator_tpu.physics import cavity_qed as jcq
from noisyquantumsimulator_tpu.physics import transport as jtr
from noisyquantumsimulator_tpu.primitives import cavity_backend as jcb
from noisyquantumsimulator_tpu_torch.channels.calibration import (
    CalibrationStore as TStore)
from noisyquantumsimulator_tpu_torch.core.constants import TWO_PI
from noisyquantumsimulator_tpu_torch.gate import cavity_gate as tcg
from noisyquantumsimulator_tpu_torch.models import hardware_configs as thw
from noisyquantumsimulator_tpu_torch.physics import cavity_qed as tcq
from noisyquantumsimulator_tpu_torch.physics import transport as ttr
from noisyquantumsimulator_tpu_torch.primitives import cavity_backend as tcb

from test_torch_primitives import assert_same

torch.set_num_threads(1)

# examples/cavity_gate_engine_study.py:36-46, the regimes of the shipped
# records (that script imports the JAX package, so it is restated here)
REGIMES = {
    "rb_fiber_cavity": dict(
        g=TWO_PI * 10e6, kappa=TWO_PI * 100e3, gamma_spont=TWO_PI * 30e3,
        dephasing_rate=TWO_PI * 5e3, nbar_cavity=0.0,
        cavity_drift_sigma=0.0, n_loops=21),
    "circuit_qed_exchange": dict(
        g=TWO_PI * 50e6, kappa=TWO_PI * 50e3, gamma_spont=TWO_PI * 10e3,
        dephasing_rate=TWO_PI * 20e3, nbar_cavity=0.02,
        cavity_drift_sigma=0.0, n_loops=21),
}

# tests/test_cavity_gate.py:19-21 and :200-209
_QUIET = dict(g=TWO_PI * 10e6, kappa=0.0, gamma_spont=0.0,
              dephasing_rate=0.0, nbar_cavity=0.0, cavity_drift_sigma=0.0,
              include_budget=False, gh_points=5)
PARITY = dict(_QUIET, n_loops=5, n_fock=4, kappa=TWO_PI * 100e3,
              nbar_cavity=0.1)

CQ_CALLS = {
    "cooperativity": lambda m: m.cooperativity(2e7, 3e5, 2e5),
    "vacuum_rabi": lambda m: m.vacuum_rabi_splitting(1.3e6),
    "purcell_factor": lambda m: m.purcell_factor(2e7, 3e5, 2e5),
    "purcell_rate": lambda m: m.purcell_decay_rate(2e7, 3e5, 2e5),
    "jc_hamiltonian": lambda m: m.jaynes_cummings_hamiltonian(6e6, 1e6, 5),
    "reflection": lambda m: m.photon_mediated_gate(),
    "reflection_weak": lambda m: m.photon_mediated_gate(g=TWO_PI * 5e6),
    "raman_virtual": lambda m: m.photon_mediated_gate(
        technique="raman_virtual"),
    "spectrum": lambda m: m.atom_cavity_spectrum(
        TWO_PI * 3e6, TWO_PI * 1e6, TWO_PI * 0.1e6,
        np.linspace(-3e7, 3e7, 101)),
}


@pytest.mark.parametrize("case", list(CQ_CALLS))
def test_cavity_qed_physics_bit_equal(case):
    assert_same(CQ_CALLS[case](tcq), CQ_CALLS[case](jcq), 0.0)


def test_photon_mediated_gate_rejects_unknown_technique():
    with pytest.raises(ValueError, match="technique"):
        tcq.photon_mediated_gate(technique="teleport")


@pytest.mark.parametrize("family", ["NEUTRAL_ATOM_EXPERIMENTS",
                                    "TRAPPED_ION_EXPERIMENTS",
                                    "CAVITY_QED_EXPERIMENTS"])
def test_hardware_configs_field_for_field(family):
    got, want = getattr(thw, family), getattr(jhw, family)
    assert list(got) == list(want)
    cls = {"NEUTRAL_ATOM_EXPERIMENTS": "NeutralAtomConfig",
           "TRAPPED_ION_EXPERIMENTS": "TrappedIonConfig",
           "CAVITY_QED_EXPERIMENTS": "CavityQEDConfig"}[family]
    for name in got:
        a = getattr(thw, cls).from_experiment(name.upper())
        b = getattr(jhw, cls).from_experiment(name.upper())
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a is not got[name]                  # a copy, as the reference
        if family == "NEUTRAL_ATOM_EXPERIMENTS":
            assert dataclasses.asdict(a.apparatus()) == dataclasses.asdict(
                b.apparatus())
        if family == "CAVITY_QED_EXPERIMENTS":
            assert a.cooperativity == b.cooperativity
        with pytest.raises(ValueError, match="Unknown experiment"):
            getattr(thw, cls).from_experiment("nonexistent_lab")
    assert thw.list_experiments() == jhw.list_experiments()


TRANSPORT_CALLS = {
    "default": lambda m: m.simulate_transport(),
    "fast_hot": lambda m: m.simulate_transport(
        distance=120e-6, duration=40e-6, temperature=40e-6,
        trap_depth_K=2e-4),
    "trapezoid": lambda m: m.simulate_transport(profile="trapezoid",
                                                n_steps=123),
    "overdamped": lambda m: m.simulate_transport(gamma=1e7, duration=1e-4),
    "budget": lambda m: m.transport_fidelity_budget(),
    "budget_short": lambda m: m.transport_fidelity_budget(
        30e-6, durations=np.array([20e-6, 60e-6])),
    "profiles": lambda m: [m.minimum_jerk(np.linspace(0, 2e-4, 9), 1e-4, 5e-6),
                           m.constant_jerk_limited(np.linspace(0, 1e-4, 9),
                                                   1e-4, 5e-6)],
}


@pytest.mark.parametrize("case", list(TRANSPORT_CALLS))
def test_transport_bit_equal(case):
    assert_same(TRANSPORT_CALLS[case](ttr), TRANSPORT_CALLS[case](jtr), 0.0)


def test_cavity_host_helpers_bit_equal():
    for m in (2, 9, 21):
        assert tcg.exchange_closure_params(TWO_PI * 10e6, m) == \
            jcg.exchange_closure_params(TWO_PI * 10e6, m)
    dc, tau = tcg.exchange_closure_params(TWO_PI * 50e6, 21)
    assert tcg._ee_return_amplitude(TWO_PI * 50e6, dc, tau) == \
        jcg._ee_return_amplitude(TWO_PI * 50e6, dc, tau)
    assert np.array_equal(tcg._ideal_exchange_unitary(-2.9),
                          jcg._ideal_exchange_unitary(-2.9))
    with pytest.raises(ValueError, match="n_loops"):
        tcg.exchange_closure_params(TWO_PI * 10e6, 1)
    kw = dict(g=TWO_PI * 20e6, n_loops=7, n_fock=5, kappa=3e5,
              gamma_spont=2e5, dephasing_rate=1e4, nbar_cavity=0.05)
    H, c_ops, tau, meta = tcg.build_jc_system(**kw)
    Hj, cj, tauj, metaj = jcg.build_jc_system(**kw)
    assert np.array_equal(H, Hj) and tau == tauj and meta == metaj
    assert len(c_ops) == len(cj) == 6
    assert all(np.array_equal(a, b) for a, b in zip(c_ops, cj))


@pytest.fixture(scope="module")
def parity_results():
    """The reference's parity configuration through the three engines."""
    return {"port": tcg.simulate_cavity_gate(device="cpu", **PARITY),
            "jax": jcg.simulate_cavity_gate(**dict(PARITY, engine="jax")),
            "host": jcg.simulate_cavity_gate(**dict(PARITY, engine="host"))}


@pytest.mark.parametrize("ref", ["jax", "host"])
def test_cavity_gate_device_engine_matches(parity_results, ref):
    got, want = parity_results["port"], parity_results[ref]
    assert_same(got, want, 1e-10, skip={"parameters"})
    assert np.abs(got.superop - want.superop).max() <= 1e-10
    assert abs(got.fidelity - want.fidelity) <= 1e-10
    assert 0.9 < got.fidelity < 1.0 and got.completely_positive


def test_cavity_gate_port_host_engine_matches():
    got = tcg.simulate_cavity_gate(**dict(PARITY, engine="host"))
    want = jcg.simulate_cavity_gate(**dict(PARITY, engine="host"))
    assert_same(got, want, 1e-12, skip={"parameters"})


@pytest.fixture(scope="module")
def full_budget():
    """The backend's in-process fallback: n_fock = 4, all 7 noise cases, and
    the circuit-QED regime of the shipped records at n_fock = 4."""
    cq = dict(REGIMES["circuit_qed_exchange"], n_fock=4)
    return {"port": tcg.simulate_cavity_gate(n_fock=4, device="cpu"),
            "jax": jcg.simulate_cavity_gate(n_fock=4),
            "port_cq": tcg.simulate_cavity_gate(device="cpu", **cq),
            "jax_cq": jcg.simulate_cavity_gate(engine="jax", **cq)}


@pytest.mark.parametrize("which", ["", "_cq"])
def test_cavity_gate_full_budget_matches(full_budget, which):
    got, want = full_budget["port" + which], full_budget["jax" + which]
    assert_same(got, want, 1e-10, skip={"parameters"})
    assert set(got.error_budget) == {
        "cavity_decay", "spontaneous_emission", "dephasing",
        "thermal_photons", "cavity_drift", "model_floor"}
    for k, v in got.error_budget.items():
        assert abs(v - want.error_budget[k]) <= 1e-10, k


def test_cavity_gate_parameters_record_the_full_case(full_budget):
    """Reference-side fault: the record's parameters come from the last
    noise case ("cavity_drift", nbar 0.0); the port keeps the run's."""
    got, want = full_budget["port_cq"].parameters, \
        full_budget["jax_cq"].parameters
    drop = {"nbar_cavity", "engine"}
    assert_same({k: v for k, v in got.items() if k not in drop},
                {k: v for k, v in want.items() if k not in drop}, 0.0)
    assert (want["nbar_cavity"], got["nbar_cavity"]) == (0.0, 0.02)
    assert (want["engine"], got["engine"]) == ("jax", "device")


def test_cavity_calibration_record_matches(full_budget):
    trec = tcg.cavity_calibration_record(full_budget["port_cq"], "small")
    jrec = jcg.cavity_calibration_record(full_budget["jax_cq"], "small")
    t, j = trec.to_json(), jrec.to_json()
    assert t["metadata"].pop("generator") == \
        "noisyquantumsimulator_tpu_torch.gate.cavity_gate"
    assert j["metadata"].pop("generator") == \
        "noisyquantumsimulator_tpu.gate.cavity_gate"
    for d in (t, j):
        d["parameters"] = {k: v for k, v in d["parameters"].items()
                           if k not in ("nbar_cavity", "engine")}
    assert_same(t, j, 1e-10)


def test_cavity_gate_rejects_unknown_engine():
    with pytest.raises(ValueError, match="engine"):
        tcg.simulate_cavity_gate(engine="jax", device="cpu", **PARITY)


def test_cavity_gate_drift_and_spectator_match():
    kw = dict(_QUIET, n_loops=3, n_fock=3, cavity_drift_sigma=TWO_PI * 20e3,
              neighbor_mode_splitting=TWO_PI * 1e9, gh_points=3)
    got = tcg.simulate_cavity_gate(device="cpu", **kw)
    want = jcg.simulate_cavity_gate(**dict(kw, engine="jax"))
    assert_same(got, want, 1e-10, skip={"parameters"})
    assert got.error_budget["spectator_mode(analytic)"] > 0


def _backend_calls():
    return {
        "summary": lambda b: b.summary(),
        "cz": lambda b: b.cz(0, 1),
        "cx": lambda b: b.two_qubit(0, 1, "cx"),
        "exchange": lambda b: b.exchange(2, 3),
        "rx": lambda b: b.rx(1, np.pi / 2),
        "rz": lambda b: b.rz(0, 0.3),
        "measure": lambda b: b.measure(0),
        "residual_cphase": lambda b: b.two_qubit.residual_cphase,
        "cooperativity": lambda b: b.cooperativity,
    }


@pytest.fixture(scope="module")
def cavity_backends():
    """Both shipped regimes from the default store (read only), and the
    in-process fallback from an empty temporary store."""
    out = {}
    for regime in REGIMES:
        out[regime] = (tcb.CavityBackend(regime=regime, device="cpu"),
                       jcb.CavityBackend(regime=regime))
    with tempfile.TemporaryDirectory() as tmp:
        out["empty_store"] = (
            tcb.CavityBackend(calibration_store=TStore(tmp), device="cpu"),
            jcb.CavityBackend(calibration_store=JStore(tmp)))
    return out


@pytest.mark.parametrize("source", list(REGIMES) + ["empty_store"])
@pytest.mark.parametrize("call", list(_backend_calls()))
def test_cavity_backend_matches(cavity_backends, source, call):
    t, j = cavity_backends[source]
    run = _backend_calls()[call]
    assert_same(run(t), run(j), 1e-12)


def test_cavity_backend_sources(cavity_backends):
    t, _ = cavity_backends["empty_store"]
    assert t.exchange_calibration.regime == "circuit_qed_exchange_inprocess"
    assert t.exchange_calibration.metadata["generator"] == \
        "noisyquantumsimulator_tpu_torch.gate.cavity_gate"
    t, _ = cavity_backends["rb_fiber_cavity"]
    assert t.exchange_calibration.regime == "rb_fiber_cavity"
    assert dataclasses.fields(tcb.CavityBackend)[-1].name == "device"
    with pytest.raises(ValueError, match="Unknown two-qubit gate"):
        t.two_qubit(0, 1, "iswap")
    assert tcb.cavity_readout_error(3e4, 1e-6, TWO_PI * 5e6) == \
        jcb.cavity_readout_error(3e4, 1e-6, TWO_PI * 5e6)
