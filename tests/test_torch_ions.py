"""The port's trapped-ion slice against the JAX package: the analytic
physics (`physics/trapped_ions`, copied: bit-equal), the MS-gate Lindblad
engine (`gate/ms_gate` through `gate/open_system.qubit_channel_device`) and
`IonBackend`.

The MS engine runs small here (n_fock = 4, gh_nodes = 3: 11 expms of (256,
256) complex128 Liouvillians); the port's device path on the CPU must lie
within 1e-10 of the reference's JAX engine at x64 and of the scipy oracle.
The reference records the parameters of the last noise case of its loop, so
its `nbar` is 0.0 whatever the run asked for; the port records the "full"
case's. The record comparison leaves out `nbar` and `engine` and pins both
values.
"""
import dataclasses

import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.gate import ms_gate as jms
from noisyquantumsimulator_tpu.gate import open_system as jos
from noisyquantumsimulator_tpu.physics import trapped_ions as jti
from noisyquantumsimulator_tpu.primitives import ion_backend as jion
from noisyquantumsimulator_tpu_torch.gate import ms_gate as tms
from noisyquantumsimulator_tpu_torch.gate import open_system as tos
from noisyquantumsimulator_tpu_torch.physics import trapped_ions as tti
from noisyquantumsimulator_tpu_torch.primitives import ion_backend as tion

from test_torch_primitives import assert_same

torch.set_num_threads(1)

SMALL = dict(n_fock=4, gh_nodes=3)

TI_CALLS = {
    "lamb_dicke": lambda m: m.lamb_dicke_parameter(m.ION_MASSES["Ca40"],
                                                   2e7, 2.5e7),
    "axial_modes": lambda m: [m.axial_mode_frequencies(1e6, n)
                              for n in range(1, 7)],
    "ms_gate": lambda m: m.ms_gate(),
    "ms_gate_ca40": lambda m: m.ms_gate(species="Ca40", nbar=0.2, n_loops=2),
    "shuttle": lambda m: m.shuttle(),
    "shuttle_junction": lambda m: m.shuttle(distance=400e-6, junction=True),
    "fluorescence": lambda m: m.fluorescence_readout(),
    "fluorescence_thresh": lambda m: m.fluorescence_readout(5e-4, threshold=2),
    "cooling_limit": lambda m: m.sideband_cooling_limit(2e7, 1e5),
    "paul_stability": lambda m: [m.paul_stability(q, a) for q, a in
                                 ((0.3, 0.0), (0.95, 0.0), (0.2, -0.1))],
    "paul_micromotion": lambda m: m.paul_micromotion(excess_field=5.0),
    "penning": lambda m: m.penning_frequencies(),
    "penning_crystal": lambda m: m.penning_crystal(n_ions=50),
}


@pytest.mark.parametrize("case", list(TI_CALLS))
def test_trapped_ions_bit_equal(case):
    assert_same(TI_CALLS[case](tti), TI_CALLS[case](jti), 0.0)
    assert tti.ION_MASSES == jti.ION_MASSES


def test_open_system_helpers_bit_equal():
    for name in ("SX", "SY", "SZ", "I2"):
        assert np.array_equal(getattr(tos, name), getattr(jos, name))
    rho = tos.thermal_state(5, 0.3)
    assert np.array_equal(rho, jos.thermal_state(5, 0.3))
    assert np.array_equal(tos.thermal_state(5, 0.0), jos.thermal_state(5, 0.0))
    for a, b in zip(tos.gh_nodes(7, 0.4), jos.gh_nodes(7, 0.4)):
        assert np.array_equal(a, b)
    assert np.array_equal(tos.probe_basis(rho, 5), jos.probe_basis(rho, 5))
    assert np.array_equal(tos.kron3(tos.SX, tos.SZ, rho),
                          jos.kron3(jos.SX, jos.SZ, rho))


def test_qubit_channel_device_matches_host():
    """The device path (CPU here) against the scipy oracle on random
    Liouvillian-like stacks of 1-norm ~70, the MS generator's."""
    rng = np.random.default_rng(8)
    n_mode, M = 2, 3
    n = (4 * n_mode) ** 2
    Ls = rng.standard_normal((M, n, n)) + 1j * rng.standard_normal((M, n, n))
    Ls *= 70.0 / np.abs(Ls).sum(axis=-2).max()
    w = np.array([0.2, 0.5, 0.3])
    rho = tos.thermal_state(n_mode, 0.4)
    got = tos.qubit_channel_device(Ls, w, 1.0, rho, n_mode, device="cpu")
    ref = jos.qubit_channel_host(jos.propagators_host(Ls, 1.0), w, rho, n_mode)
    assert got.shape == (16, 16) and got.dtype == np.complex128
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.fixture(scope="module")
def ms_results():
    return {"port": tms.simulate_ms_gate(device="cpu", **SMALL),
            "jax": jms.simulate_ms_gate(engine="jax", **SMALL),
            "host": jms.simulate_ms_gate(engine="host", **SMALL)}


@pytest.mark.parametrize("ref", ["jax", "host"])
def test_ms_gate_device_engine_matches(ms_results, ref):
    got, want = ms_results["port"], ms_results[ref]
    skip = {"parameters"}
    assert_same(got, want, 1e-10, skip=skip)
    assert np.abs(got.superop - want.superop).max() <= 1e-10
    assert abs(got.fidelity - want.fidelity) <= 1e-10
    assert 0.9 < got.fidelity < 1.0 and got.completely_positive


def test_ms_gate_parameters_record_the_full_case(ms_results):
    got, want = ms_results["port"].parameters, ms_results["jax"].parameters
    drop = {"nbar", "engine"}
    assert_same({k: v for k, v in got.items() if k not in drop},
                {k: v for k, v in want.items() if k not in drop}, 0.0)
    # the reference keeps the last case's ("scattering") nbar, the port the run's
    assert (want["nbar"], got["nbar"]) == (0.0, 0.05)
    assert (want["engine"], got["engine"]) == ("jax", "device")


def test_ms_calibration_record_matches(ms_results):
    trec = tms.ms_calibration_record(ms_results["port"], "small")
    jrec = jms.ms_calibration_record(ms_results["jax"], "small")
    t, j = trec.to_json(), jrec.to_json()
    for d in (t, j):
        d["parameters"] = {k: v for k, v in d["parameters"].items()
                           if k not in ("nbar", "engine")}
    assert_same(t, j, 1e-10)


@pytest.mark.parametrize("kw", [
    dict(motional_dephasing_model="markovian", include_budget=False),
    dict(exact_lamb_dicke=False, amplitude_error=0.02, n_loops=2,
         include_budget=False)])
def test_ms_gate_options_match(kw):
    got = tms.simulate_ms_gate(device="cpu", **SMALL, **kw)
    want = jms.simulate_ms_gate(engine="jax", **SMALL, **kw)
    assert_same(got, want, 1e-10, skip={"parameters"})


def test_ms_gate_rejects_unknown_engine():
    with pytest.raises(ValueError, match="engine"):
        tms.simulate_ms_gate(engine="jax", device="cpu", **SMALL)


def test_build_ms_system_bit_equal():
    for exact in (True, False):
        H, c_ops, tau, meta = tms.build_ms_system(
            n_fock=5, heating_rate_quanta_per_s=50.0,
            motional_dephasing_rate=3.0, laser_dephasing_rate=1.0,
            scattering_rate=2.0, exact_lamb_dicke=exact)
        Hj, cj, tauj, metaj = jms.build_ms_system(
            n_fock=5, heating_rate_quanta_per_s=50.0,
            motional_dephasing_rate=3.0, laser_dephasing_rate=1.0,
            scattering_rate=2.0, exact_lamb_dicke=exact)
        assert np.array_equal(H, Hj) and tau == tauj and meta == metaj
        assert len(c_ops) == len(cj) == 11
        assert all(np.array_equal(a, b) for a, b in zip(c_ops, cj))


@pytest.fixture(scope="module")
def ion_backends():
    return tion.IonBackend(device="cpu"), jion.IonBackend()


def test_ion_backend_summary_matches(ion_backends):
    t, j = ion_backends
    assert t.ms_calibration.regime == "yb171_default"
    assert_same(t.summary(), j.summary(), 1e-12)


@pytest.mark.parametrize("call", ["ms", "cz", "cx", "rx", "measure", "move",
                                  "move_junction", "cool", "idle"])
def test_ion_backend_primitives_match(ion_backends, call):
    t, j = ion_backends
    run = {"ms": lambda b: b.ms(0, 1),
           "cz": lambda b: b.cz(0, 1),
           "cx": lambda b: b.two_qubit(0, 1, "cx"),
           "rx": lambda b: b.rx(1, np.pi / 2),
           "measure": lambda b: b.measure(0),
           "move": lambda b: b.move(0, end=150e-6),
           "move_junction": lambda b: b.move(0, end=300e-6, junction=True),
           "cool": lambda b: b.cool(0, initial_nbar=5.0, target_nbar=0.05),
           "idle": lambda b: b.idle(0, duration=1e-3)}[call]
    assert_same(run(t), run(j), 1e-12)


def test_ion_backend_from_the_ca40_record(ion_backends):
    t = tion.IonBackend(species="Ca40", ms_regime="ca40_high_fidelity",
                        device="cpu")
    j = jion.IonBackend(species="Ca40", ms_regime="ca40_high_fidelity")
    assert_same(t.summary(), j.summary(), 1e-12)
    assert dataclasses.fields(tion.IonBackend)[-1].name == "device"
