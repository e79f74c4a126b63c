"""The port's exact circuit simulators (`solver/circuit_sim`) against the
JAX package: the density-matrix engine within 1e-5 of the reference's on
shared circuits (complex64 as the reference; at most 5 qubits), every
instruction kind included; the trajectory engine statistically, with the
four-engine check of `tests/test_solver.py:212-231` (density matrix, the
fast sampler, trajectories, and the exact 2p(1 - p)) at 8000 shots, and
against the density matrix's marginals on a circuit of every kind.
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.qec.circuits import Circuit as JCircuit
from noisyquantumsimulator_tpu.solver import circuit_sim as jcs
from noisyquantumsimulator_tpu_torch.qec.circuits import Circuit
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
from noisyquantumsimulator_tpu_torch.qec.pauli_frame import build_sampler
from noisyquantumsimulator_tpu_torch.solver import circuit_sim as tcs

torch.set_num_threads(1)

SHOTS = 8000


def _both(build):
    """The same circuit in the port's IR and the reference's."""
    t, j = Circuit(n_qubits=build.n), JCircuit(n_qubits=build.n)
    for c in (t, j):
        build(c)
    return t, j


def _rep(n_data, p):
    """The bit-flip repetition code of tests/test_solver.py:200-210 with
    n_data data qubits (even indices) and their n_data - 1 ancillas."""
    def build(c):
        data = list(range(0, 2 * n_data - 1, 2))
        c.append("X_ERROR", data, arg=p)
        for a in range(1, 2 * n_data - 1, 2):
            c.append("CX", np.array([[a - 1, a]]))
            c.append("CX", np.array([[a + 1, a]]))
        anc = list(range(1, 2 * n_data - 1, 2))
        c.append("MR", anc)
        for k in range(len(anc)):
            c.detector([-len(anc) + k])
    build.n = 2 * n_data - 1
    return build


def _every_kind():
    def build(c):
        c.append("H", [0, 3])
        c.append("S", [1])
        c.append("X", [2])
        c.append("Y", [4])
        c.append("Z", [3])
        c.append("I", [0])
        c.append("CX", np.array([[0, 1], [3, 2]]))
        c.append("CZ", np.array([[4, 1]]))
        c.append("SWAP", np.array([[2, 0]]))
        c.append("X_ERROR", [0, 1], arg=0.07)
        c.append("Z_ERROR", [2], arg=0.11)
        c.append("DEPOLARIZE1", [3, 4], arg=0.05)
        c.append("DEPOLARIZE2", np.array([[0, 4]]), arg=0.04)
        probs = np.r_[0.82, np.linspace(0.001, 0.02, 15)]
        c.append("PAULI_CHANNEL_2", np.array([[3, 1]]), probs=probs / probs.sum())
        c.append("ERASE", [2], arg=0.2)
        c.append("H", [3])
        c.append("M", [0, 1], arg=0.02)
        c.append("MR", [3], arg=0.01)
        c.append("R", [4])
        c.append("X_ERROR", [4], arg=0.3)
        c.append("M", [2, 3, 4])
    build.n = 5
    return build


CIRCUITS = {"rep3": lambda: _rep(3, 0.05), "rep3_noiseless": lambda: _rep(3, 0.0),
            "every_kind": _every_kind}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_density_matrix_matches_reference(name):
    t, j = _both(CIRCUITS[name]())
    got = tcs.DensityMatrixSimulator(t, device="cpu").run()
    want = jcs.DensityMatrixSimulator(j).run()
    assert got["rho"].dtype == torch.complex64
    for k in ("rho", "measurement_probs"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5, k
    rho = got["rho"].numpy()
    assert abs(np.trace(rho) - 1) <= 1e-5
    assert np.abs(rho - rho.conj().T).max() <= 1e-6


def test_bell_state_exact():
    c = Circuit(n_qubits=2)
    c.append("H", [0])
    c.append("CX", np.array([[0, 1]]))
    rho = tcs.DensityMatrixSimulator(c, device="cpu").run()["rho"].numpy()
    want = np.zeros((4, 4))
    want[0, 0] = want[0, 3] = want[3, 0] = want[3, 3] = 0.5
    assert np.abs(rho - want).max() <= 1e-6


def test_four_engine_agreement():
    """Density matrix exact, the fast sampler, the frame sampler and the
    trajectories at 2p(1 - p) per detector."""
    p = 0.05
    rep, _ = _both(_rep(3, p))
    exact = 2 * p * (1 - p)
    dm = tcs.DensityMatrixSimulator(rep, device="cpu").run()
    assert np.allclose(dm["measurement_probs"].numpy(), exact, atol=1e-6)
    tol = 6 * np.sqrt(exact / SHOTS)
    gens = []
    for seed in (2, 3, 4):
        g = torch.Generator()
        g.manual_seed(seed)
        gens.append(g)
    fast = build_fast_sampler(rep, SHOTS, "cpu")(gens[0])["detectors"]
    frame = build_sampler(rep, SHOTS, "cpu")(gens[1])["detectors"]
    traj = tcs.TrajectorySimulator(rep, trajectories=SHOTS,
                                   device="cpu").sample(gens[2])
    meas = traj["measurements"]
    assert meas.shape == (SHOTS, 2) and meas.dtype == torch.uint8
    for rows in (fast, frame, meas):
        assert np.allclose(rows.float().mean(0).numpy(), exact, atol=tol)


def test_trajectories_match_density_marginals():
    """Every instruction kind: each measurement's mean over 8000
    trajectories within 6 sigma of the density matrix's exact marginal, and
    of the reference's trajectories."""
    import jax
    t, j = _both(_every_kind())
    probs = tcs.DensityMatrixSimulator(t, device="cpu").run()[
        "measurement_probs"].numpy().astype(np.float64)
    g = torch.Generator()
    g.manual_seed(9)
    got = tcs.TrajectorySimulator(t, SHOTS, device="cpu").sample(g)[
        "measurements"].float().mean(0).numpy()
    want = np.asarray(jcs.TrajectorySimulator(j, SHOTS).sample(
        jax.random.PRNGKey(9))["measurements"]).mean(0)
    sd = np.sqrt(probs * (1 - probs) / SHOTS)
    assert np.all(np.abs(got - probs) <= 6 * sd + 1e-12)
    assert np.all(np.abs(want - probs) <= 6 * sd + 1e-12)
    assert np.all(np.abs(got - want) <= 6 * np.sqrt(2) * sd + 1e-12)


def test_default_generator_and_limits():
    t, _ = _both(_rep(2, 0.2))
    a = tcs.TrajectorySimulator(t, 64, device="cpu").sample()["measurements"]
    b = tcs.TrajectorySimulator(t, 64, device="cpu").sample()["measurements"]
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="12 qubits"):
        tcs.DensityMatrixSimulator(Circuit(n_qubits=13), device="cpu")
    with pytest.raises(ValueError, match="14 qubits"):
        tcs.TrajectorySimulator(Circuit(n_qubits=15), device="cpu")
    empty = tcs.DensityMatrixSimulator(Circuit(n_qubits=1), device="cpu").run()
    assert empty["measurement_probs"].shape == (0,)
