"""The port's Layer-1 neutral-atom primitives against the JAX package.

Both packages run on the same inputs. Host code that the port copied
(`primitives/{base,calibration_io,gates,motion}`, `gate/raman_gate`, the
channel helpers of `utils/math`) must agree to 1e-12; what the port computes
another way (readout and cooling: the port's Pade-13 expm at float64 on the
CPU, where the reference's float64 switch fails and it falls back to scipy;
`utils/math` in torch) to 1e-10, the bound the port is held to. Nothing
here writes to `calibration_data/`: the backends read the default store,
which the Raman record is never saved to.
"""
import dataclasses

import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu import primitives as jprim
from noisyquantumsimulator_tpu.channels import calibration as jcal
from noisyquantumsimulator_tpu.gate import cooling as jcool
from noisyquantumsimulator_tpu.gate import raman_gate as jraman
from noisyquantumsimulator_tpu.gate import readout as jread
from noisyquantumsimulator_tpu.primitives import calibration_io as jio
from noisyquantumsimulator_tpu.primitives import gates as jgates
from noisyquantumsimulator_tpu.primitives import motion as jmotion
from noisyquantumsimulator_tpu.utils import math as jmath
from noisyquantumsimulator_tpu_torch import primitives as tprim
from noisyquantumsimulator_tpu_torch.channels import calibration as tcal
from noisyquantumsimulator_tpu_torch.gate import cooling as tcool
from noisyquantumsimulator_tpu_torch.gate import raman_gate as traman
from noisyquantumsimulator_tpu_torch.gate import readout as tread
from noisyquantumsimulator_tpu_torch.ops import expm as texpm
from noisyquantumsimulator_tpu_torch.primitives import base as tbase
from noisyquantumsimulator_tpu_torch.primitives import calibration_io as tio
from noisyquantumsimulator_tpu_torch.primitives import gates as tgates
from noisyquantumsimulator_tpu_torch.primitives import motion as tmotion
from noisyquantumsimulator_tpu_torch.utils import math as tmath

torch.set_num_threads(1)

# keys whose values name the package that made them
_NAMES = {"generator", "engine", "generated"}


def assert_same(a, b, tol, path="", skip=_NAMES):
    """a (port) equals b (reference) through dataclasses, dicts, sequences
    and arrays: numbers within `tol` absolute, everything else equal."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        a, b = vars(a), vars(b)
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            if k not in skip:
                assert_same(a[k], b[k], tol, f"{path}.{k}", skip)
        return
    if torch.is_tensor(a):
        a = a.numpy()
    if isinstance(a, (list, tuple)) and not all(
            isinstance(x, (int, float, complex, np.number)) for x in a):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, tol, f"{path}[{i}]", skip)
        return
    if isinstance(a, (str, bool, type(None))):
        assert a == b, (path, a, b)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype.kind in "biufc":
        assert np.array_equal(a, b) or np.all(np.abs(a - b) <= tol), (
            path, float(np.max(np.abs(a - b))))
    else:
        assert np.array_equal(a, b), path


def _store_pair():
    """The default stores of both packages (the repo's calibration_data/)."""
    return tcal.CalibrationStore(), jcal.CalibrationStore()


# --------------------------------------------------------------------------
# copied host modules: base, gates, motion, calibration_io
# --------------------------------------------------------------------------

def test_base_results_and_primitives_match():
    jbase = jprim.base
    assert tbase.__all__ == jbase.__all__
    for name in tbase.__all__:
        t, j = getattr(tbase, name), getattr(jbase, name)
        if dataclasses.is_dataclass(t):
            assert [(f.name, f.type) for f in dataclasses.fields(t)] == \
                [(f.name, f.type) for f in dataclasses.fields(j)], name
            assert_same(t(duration=1e-6), j(duration=1e-6), 0.0)
        else:
            assert (t.name, t.platform) == (j.name, j.platform), name


SQ_CALLS = [("x", {}), ("h", {}), ("t", {}), ("rx", {"angle": 0.3}),
            ("ry", {"angle": -1.1}), ("rz", {"angle": 0.7}),
            ("u3", {"u3": (0.4, 0.1, -0.2)})]


@pytest.mark.parametrize("gate,kw", SQ_CALLS)
def test_single_qubit_gate_matches(gate, kw):
    assert_same(tgates.SingleQubitGate()(1, gate, **kw),
                jgates.SingleQubitGate()(1, gate, **kw), 1e-12)


@pytest.mark.parametrize("gate_type", ["cz", "cx"])
def test_two_qubit_gate_from_the_shipped_record_matches(gate_type):
    ts, js = _store_pair()
    trec = ts.load("neutral_atoms", "rydberg_cz", "n70_smooth_jp_default")
    jrec = js.load("neutral_atoms", "rydberg_cz", "n70_smooth_jp_default")
    assert_same(tgates.TwoQubitGate(trec)(0, 1, gate_type),
                jgates.TwoQubitGate(jrec)(0, 1, gate_type), 1e-12)


def test_rotation_helpers_match():
    for axis in "xyz":
        assert np.array_equal(tgates.rotation_matrix(axis, 0.37),
                              jgates.rotation_matrix(axis, 0.37))
    assert np.array_equal(tgates.u3_matrix(0.1, 0.2, 0.3),
                          jgates.u3_matrix(0.1, 0.2, 0.3))
    assert np.array_equal(tmotion.minimum_jerk_trajectory(3e-6, 2e-4),
                          jmotion.minimum_jerk_trajectory(3e-6, 2e-4))


MOTION_CALLS = [
    ("move", {}, {"end": 5e-6}),
    ("move", {"trap_depth_K": 2e-4}, {"end": 40e-6, "duration": 2e-5}),
    ("cool", {}, {"method": "doppler"}),
    ("cool", {}, {"method": "molasses", "target_temperature": 1e-3}),
    ("cool", {}, {"method": "sideband"}),
    ("cool", {"species": "Cs133"}, {"method": "sympathetic"}),
    ("idle", {}, {"duration": 3e-3}),
    ("idle", {"T1": 1.0, "T2": 0.2}, {"duration": 1e-2}),
    ("measure", {}, {}),
    ("measure", {"destructive": False}, {"state_probabilities": [0.3, 0.7]}),
]


@pytest.mark.parametrize("kind,init,call", MOTION_CALLS)
def test_motion_primitives_match(kind, init, call):
    cls = {"move": "Move", "cool": "Cool", "idle": "Idle", "measure": "Measure"}
    t = getattr(tmotion, cls[kind])(**init)
    j = getattr(jmotion, cls[kind])(**init)
    if kind == "measure":
        got = t(2, rng=np.random.default_rng(5), **call)
        ref = j(2, rng=np.random.default_rng(5), **call)
    else:
        got, ref = t(2, **call), j(2, **call)
    assert_same(got, ref, 1e-12)


@pytest.mark.parametrize("key", [
    ("neutral_atoms", "rydberg_cz", "n70_smooth_jp_default"),
    ("trapped_ions", "ms_gate", "yb171_default")], ids=lambda k: k[1])
def test_superop_from_record_matches(key):
    ts, js = _store_pair()
    trec, jrec = ts.load(*key), js.load(*key)
    assert np.array_equal(tio.superop_from_record(trec),
                          jio.superop_from_record(jrec))
    # a record without its superop falls back to the twirled channel
    trec.superop = jrec.superop = None
    assert np.abs(tio.superop_from_record(trec)
                  - jio.superop_from_record(jrec)).max() <= 1e-12


SHIPPED = [("neutral_atoms", "rydberg_cz", "n70_smooth_jp_default"),
           ("neutral_atoms", "cooling", "rb87_rsc_100khz"),
           ("neutral_atoms", "readout", "rb87_highna_2ms"),
           ("trapped_ions", "ms_gate", "yb171_default"),
           ("trapped_ions", "ms_gate", "ca40_high_fidelity")]


@pytest.mark.parametrize("key", SHIPPED, ids=lambda k: k[2])
def test_shipped_records_load_alike(key):
    ts, js = _store_pair()
    trec, jrec = ts.load(*key), js.load(*key)
    assert trec.to_json() == jrec.to_json()


# --------------------------------------------------------------------------
# engine-driven records: Raman (host scipy), readout and cooling (the expm)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def raman_pair():
    return traman.simulate_raman_gate(), jraman.simulate_raman_gate()


def test_raman_gate_matches(raman_pair):
    t, j = raman_pair
    assert_same(t, j, 1e-10)
    assert 0.99 < t.fidelity < 1.0 and t.superop.shape == (4, 4)


def test_raman_record_matches(raman_pair):
    t, j = raman_pair
    trec = traman.raman_calibration_record(t, "rb87_pi2_default")
    jrec = jraman.raman_calibration_record(j, "rb87_pi2_default")
    assert_same(trec.to_json(), jrec.to_json(), 1e-10)
    assert trec.metadata["generator"].startswith("noisyquantumsimulator_tpu_torch")


@pytest.mark.parametrize("kw", [{}, {"gamma_phi": 2e3, "delta2_error": 1e4,
                                     "amplitude_error": 0.01, "theta": np.pi}])
def test_raman_gate_options_match(kw):
    assert_same(traman.simulate_raman_gate(**kw), jraman.simulate_raman_gate(**kw),
                1e-10)


@pytest.fixture(scope="module")
def readout_pair():
    return (tread.simulate_fluorescence_readout(device="cpu"),
            jread.simulate_fluorescence_readout())


@pytest.fixture(scope="module")
def cooling_pair():
    return (tcool.simulate_sideband_cooling(device="cpu"),
            jcool.simulate_sideband_cooling())


def test_readout_matches_scipy(readout_pair):
    t, j = readout_pair
    assert_same(t, j, 1e-10)
    assert t.parameters["n_max"] == 179 and t.threshold == j.threshold


def test_cooling_matches_scipy(cooling_pair):
    t, j = cooling_pair
    assert_same(t, j, 1e-10)
    assert len(t.populations) == 81


@pytest.mark.parametrize("which", ["readout", "cooling"])
def test_records_match_reference_and_shipped(readout_pair, cooling_pair, which):
    (t, j), make_t, make_j, regime = {
        "readout": (readout_pair, tread.readout_calibration_record,
                    jread.readout_calibration_record, "rb87_highna_2ms"),
        "cooling": (cooling_pair, tcool.cooling_calibration_record,
                    jcool.cooling_calibration_record, "rb87_rsc_100khz"),
    }[which]
    trec, jrec = make_t(t, regime), make_j(j, regime)
    assert_same(trec.to_json(), jrec.to_json(), 1e-10)
    shipped = tcal.CalibrationStore().load("neutral_atoms", which, regime)
    assert_same(trec.error_rates, shipped.error_rates, 1e-10)
    if which == "readout":
        assert_same(trec.metadata["confusion_matrix"],
                    shipped.metadata["confusion_matrix"], 1e-10)


@pytest.mark.parametrize("which,squarings", [("readout", 6), ("cooling", 12)])
def test_expm_engine_passes_the_host_squaring_count(monkeypatch, which, squarings):
    """The generators' host 1-norms set max_squarings: 6 for the 540 x 540
    readout generator, 12 for cooling's."""
    seen = []
    real = texpm.expm

    def spy(A, max_squarings=None, method="auto"):
        seen.append((tuple(A.shape), A.dtype, max_squarings, method))
        return real(A, max_squarings=max_squarings, method=method)
    monkeypatch.setattr(tread, "expm", spy)
    if which == "readout":
        tread.simulate_fluorescence_readout(device="cpu")
        shape = (540, 540)
    else:
        tcool.simulate_sideband_cooling(device="cpu")
        shape = (81, 81)
    assert seen == [(shape, torch.float64, squarings, "pade13")]


def test_expm_engine_matches_scipy_and_raises_past_its_count():
    from scipy.linalg import expm as sexpm
    rng = np.random.default_rng(3)
    A = rng.standard_normal((60, 60)) * 4.0
    assert np.abs(tread._expm_engine(A, device="cpu") - sexpm(A)).max() <= \
        1e-10 * np.abs(sexpm(A)).max()
    with pytest.raises(texpm.SquaringLimitError):
        texpm.expm(torch.as_tensor(A), max_squarings=2, method="pade13")


# --------------------------------------------------------------------------
# the backend and the pinned Cool behaviour
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def backends():
    return tprim.NeutralAtomBackend(device="cpu"), jprim.NeutralAtomBackend()


def test_neutral_atom_backend_summary_matches(backends):
    t, j = backends
    assert_same(t.summary(), j.summary(), 1e-10)
    assert t.device == "cpu"


@pytest.mark.parametrize("call", ["cz", "cx", "rx", "rz", "measure", "idle",
                                  "move"])
def test_neutral_atom_backend_primitives_match(backends, call):
    t, j = backends
    run = {"cz": lambda b: b.cz(0, 1),
           "cx": lambda b: b.two_qubit(0, 1, "cx"),
           "rx": lambda b: b.rx(0, 0.9),
           "rz": lambda b: b.rz(0, 0.9),
           "measure": lambda b: b.measure(1),
           "idle": lambda b: b.idle(0, duration=5e-4),
           "move": lambda b: b.move(0, end=8e-6)}[call]
    assert_same(run(t), run(j), 1e-10)


def test_cool_sideband_with_a_record_ignores_the_target(backends):
    """Pinned: with a cooling record attached, Cool(method="sideband")
    returns the record's numbers whatever target_temperature asks for, as
    the reference does (its motion.py:147-158)."""
    t, j = backends
    rec = t.cooling_calibration
    for target in (None, 1e-9, 1e-3):
        got = t.cool(0, target_temperature=target, method="sideband")
        assert_same(got, j.cool(0, target_temperature=target, method="sideband"),
                    1e-10)
        assert got.final_nbar == rec.error_rates["final_nbar"]
        assert got.final_temperature == rec.metadata["final_temperature_K"]
        assert got.duration == rec.duration


def test_primitives_exports():
    for name in ("NeutralAtomBackend", "IonBackend", "SingleQubitGate",
                 "TwoQubitGate", "Cool", "Idle", "Measure", "Move"):
        assert getattr(tprim, name).__name__ == getattr(jprim, name).__name__


# --------------------------------------------------------------------------
# utils.math
# --------------------------------------------------------------------------

def _states(seed, d=4):
    rng = np.random.default_rng(seed)
    kets = rng.standard_normal((2, d)) + 1j * rng.standard_normal((2, d))
    kets /= np.linalg.norm(kets, axis=-1, keepdims=True)
    X = rng.standard_normal((2, d, d)) + 1j * rng.standard_normal((2, d, d))
    rhos = X @ X.conj().transpose(0, 2, 1)
    rhos /= np.trace(rhos, axis1=-2, axis2=-1)[:, None, None]
    return kets, rhos


MATH_CASES = {
    "fidelity_kets": lambda m, k, r: m.fidelity(k[0], k[1]),
    "fidelity_ket_dm": lambda m, k, r: m.fidelity(k[0], r[1]),
    "fidelity_dm_ket": lambda m, k, r: m.fidelity(r[0], k[1]),
    "fidelity_dms": lambda m, k, r: m.fidelity(r[0], r[1]),
    "purity": lambda m, k, r: m.purity(r),
    "partial_trace_0": lambda m, k, r: m.partial_trace(r, 0, (2, 2)),
    "partial_trace_1": lambda m, k, r: m.partial_trace(r, 1, (2, 2)),
    "entropy": lambda m, k, r: m.von_neumann_entropy(r),
    "concurrence": lambda m, k, r: m.concurrence_2q(r[0]),
    "concurrence_bell": lambda m, k, r: m.concurrence_2q(
        np.outer([1, 0, 0, 1], [1, 0, 0, 1]) / 2.0 + 0j),
    "trace_distance": lambda m, k, r: m.trace_distance(r[0], r[1]),
}


@pytest.mark.parametrize("case", list(MATH_CASES))
def test_math_state_functions_match(case):
    kets, rhos = _states(11)
    got = MATH_CASES[case](tmath, torch.as_tensor(kets), torch.as_tensor(rhos))
    ref = MATH_CASES[case](jmath, kets, rhos)
    assert torch.is_tensor(got)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-10
    # numpy input is accepted alike
    assert np.abs(MATH_CASES[case](tmath, kets, rhos).numpy()
                  - got.numpy()).max() <= 1e-12


def test_math_channel_helpers_match():
    from noisyquantumsimulator_tpu_torch.channels.conversions import unitary_superop
    rng = np.random.default_rng(4)
    U = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))[0]
    S1, S2 = unitary_superop(U), unitary_superop(np.eye(4))
    assert tmath.diamond_norm_upper_bound(S1, S2) == \
        jmath.diamond_norm_upper_bound(S1, S2)
    p = 0.1
    kraus = [np.sqrt(1 - p) * np.eye(2), np.sqrt(p) * np.array([[0, 1], [1, 0]])]
    R = tmath.kraus_to_ptm(kraus)
    assert np.abs(R - jmath.kraus_to_ptm(kraus)).max() <= 1e-15
    assert tmath.process_fidelity_from_ptm(R, np.eye(4)) == \
        jmath.process_fidelity_from_ptm(R, np.eye(4))
    assert tmath.wilson_ci(3, 1000) == jmath.wilson_ci(3, 1000)


def _slice_device_defaults():
    import inspect
    from noisyquantumsimulator_tpu_torch.gate import ms_gate, open_system
    from noisyquantumsimulator_tpu_torch.primitives import ion_backend
    fns = {"simulate_fluorescence_readout": tread.simulate_fluorescence_readout,
           "simulate_sideband_cooling": tcool.simulate_sideband_cooling,
           "_expm_engine": tread._expm_engine,
           "simulate_ms_gate": ms_gate.simulate_ms_gate,
           "qubit_channel_device": open_system.qubit_channel_device,
           "_default_ms_record": ion_backend._default_ms_record,
           "TwoQubitGate": tgates.TwoQubitGate.__init__}
    out = {k: inspect.signature(f).parameters["device"].default
           for k, f in fns.items()}
    for cls in (tprim.NeutralAtomBackend, tprim.IonBackend):
        field, = (f for f in dataclasses.fields(cls) if f.name == "device")
        out[cls.__name__] = field.default
    return out


@pytest.mark.parametrize("name", [
    "simulate_fluorescence_readout", "simulate_sideband_cooling", "_expm_engine",
    "simulate_ms_gate", "qubit_channel_device", "_default_ms_record",
    "TwoQubitGate", "NeutralAtomBackend", "IonBackend"])
def test_slice_entry_points_default_to_the_card(name):
    """This slice's entry points run on the card unless the caller asks for
    the CPU (checked without a card: only the declared default)."""
    assert _slice_device_defaults()[name] == "cuda"
