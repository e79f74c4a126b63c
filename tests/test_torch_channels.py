"""The port's channel / calibration bridge (channels/) against the JAX
reference, on the CPU.

  * conversions and pauli are host numpy copied from the reference: the same
    inputs give bit-equal results.
  * extract_channel on the same plan arrays (`plan_from_numpy(vars(plan))`)
    at complex128: superop, PTM and fidelities within 1e-10, leakage within
    1e-10, the CP/TP flags equal. The default complex64 extraction within
    1e-4 of the reference's superop.
  * a calibration record against the reference's, every number within
    1e-10 (the timestamp and the generator's name aside), and a JSON
    round-trip through a CalibrationStore in a temporary directory.
"""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.channels import calibration as jcal
from noisyquantumsimulator_tpu.channels import conversions as jcv
from noisyquantumsimulator_tpu.channels import pauli as jpl
from noisyquantumsimulator_tpu.channels import tomography as jtom
from noisyquantumsimulator_tpu.core.configs import SmoothJPSimulationInputs
from noisyquantumsimulator_tpu.gate.simulate import plan_cz_gate as jplan_cz
from noisyquantumsimulator_tpu_torch import channels as tch
from noisyquantumsimulator_tpu_torch.channels import calibration as tcal
from noisyquantumsimulator_tpu_torch.channels import conversions as tcv
from noisyquantumsimulator_tpu_torch.channels import pauli as tpl
from noisyquantumsimulator_tpu_torch.channels import tomography as ttom
from noisyquantumsimulator_tpu_torch.gate.simulate import plan_from_numpy

torch.set_num_threads(1)


def _unitary(rng, d):
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    return np.linalg.qr(A)[0]


def _channel(rng, d=4, n_kraus=3):
    """A random CPTP superop (Stinespring of a random isometry)."""
    V = _unitary(rng, d * n_kraus)[:, :d]
    ks = [V[i * d:(i + 1) * d] for i in range(n_kraus)]
    return jcv.kraus_to_superop(ks)


CONVERSIONS = ["superop_to_choi", "superop_to_ptm", "is_cptp",
               "choi_to_superop", "choi_to_kraus", "choi_to_chi",
               "chi_to_choi", "ptm_to_superop", "kraus_to_superop",
               "kraus_to_choi", "unitary_superop", "average_gate_fidelity",
               "process_fidelity", "pauli_basis"]


def _conv_args(name, rng):
    S = _channel(rng)
    C = jcv.superop_to_choi(S)
    U = _unitary(rng, 4)
    return {"superop_to_choi": (S,), "superop_to_ptm": (S,), "is_cptp": (S,),
            "choi_to_superop": (C,), "choi_to_kraus": (C,),
            "choi_to_chi": (C,), "chi_to_choi": (jcv.choi_to_chi(C),),
            "ptm_to_superop": (jcv.superop_to_ptm(S),),
            "kraus_to_superop": (jcv.choi_to_kraus(C),),
            "kraus_to_choi": (jcv.choi_to_kraus(C),),
            "unitary_superop": (U,),
            "average_gate_fidelity": (S, U), "process_fidelity": (S, U),
            "pauli_basis": (2,)}[name]


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", CONVERSIONS)
def test_conversions_bit_equal(name):
    args = _conv_args(name, np.random.default_rng(CONVERSIONS.index(name)))
    assert _equal(getattr(tcv, name)(*args), getattr(jcv, name)(*args))


PAULI = {
    "depolarizing_probs": (0.07, 2), "dephasing_probs": (0.03,),
    "bitflip_probs": (0.02,), "asymmetric_pauli_probs": (0.01, 0.02, 0.03),
    "two_qubit_pauli_probs": ({"IX": 0.01, "ZZ": 0.02, "YI": 0.005},),
    "pauli_channel_kraus": (np.array([0.9, 0.05, 0.03, 0.02]), 1),
    "fidelity_to_depolarizing_rate": (0.991, 4),
    "depolarizing_rate_to_fidelity": (0.02, 4),
    "t1_t2_to_pauli_rates": (100e-6, 50e-6, 1e-6),
    "rates_to_t1_t2": (0.004, 0.004, 0.01, 1e-6),
    "leakage_extended_kraus": (0.03,), "loss_as_erasure_probs": (1e4, 1e-6),
    "seepage_kraus": (0.2,), "leakage_reduction_unit": (0.02, 0.99),
}


@pytest.mark.parametrize("name", list(PAULI))
def test_pauli_bit_equal(name):
    got = getattr(tpl, name)(*PAULI[name])
    ref = getattr(jpl, name)(*PAULI[name])
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        got, ref = list(got.values()), list(ref.values())
    assert _equal(got, ref)


@pytest.mark.parametrize("name", ["pauli_channel_superop", "pauli_twirl",
                                  "twirled_error_probs"])
def test_pauli_superop_functions_bit_equal(name):
    rng = np.random.default_rng(7)
    S = _channel(rng)
    args = {"pauli_channel_superop": (rng.dirichlet(np.ones(16)), 2),
            "pauli_twirl": (S,),
            "twirled_error_probs": (S, jtom.CZ_MATRIX)}[name]
    assert _equal(getattr(tpl, name)(*args), getattr(jpl, name)(*args))


@pytest.fixture(scope="module")
def jax_plan():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jplan_cz(SmoothJPSimulationInputs())


@pytest.fixture(scope="module")
def jax_channel(jax_plan):
    return jtom.extract_channel(jax_plan)


@pytest.fixture(scope="module")
def torch_channel(jax_plan):
    plan = plan_from_numpy(vars(jax_plan), device="cpu", dtype=torch.complex128)
    return ttom.extract_channel(plan)


def test_extract_channel_matches_reference_c128(jax_channel, torch_channel):
    j, t = jax_channel, torch_channel
    for k in ("superop", "superop_aligned", "ptm", "chi"):
        ref = np.asarray(getattr(j, k))
        assert np.abs(getattr(t, k) - ref).max() <= 1e-10, k
    for k in ("avg_gate_fidelity", "process_fidelity", "mean_leakage",
              "duration"):
        assert abs(getattr(t, k) - getattr(j, k)) <= 1e-10, k
    assert np.abs(t.leakage_per_input - j.leakage_per_input).max() <= 1e-10
    assert (t.completely_positive, t.trace_preserving) == \
        (j.completely_positive, j.trace_preserving)
    assert t.metadata == j.metadata
    assert 0.9 < t.avg_gate_fidelity < 1.0 and t.mean_leakage > 0
    assert np.allclose(tcv.kraus_to_superop(t.kraus()), t.superop, atol=1e-9)


def test_extract_cz_channel_complex64(jax_channel):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        t = tch.extract_cz_channel(device="cpu")
    assert t.superop.dtype == np.complex128 and t.superop.shape == (16, 16)
    assert np.abs(t.superop - jax_channel.superop).max() <= 1e-4
    assert abs(t.avg_gate_fidelity - jax_channel.avg_gate_fidelity) <= 1e-4


def _numbers(d):
    """The record's fields as a flat list of (path, value)."""
    if isinstance(d, dict):
        return [(f"{k}/{p}", v) for k in sorted(d) for p, v in _numbers(d[k])]
    if isinstance(d, list):
        return [(f"{i}/{p}", v) for i, x in enumerate(d) for p, v in _numbers(x)]
    return [("", d)]


def _assert_record_matches(got, ref):
    g = got.to_json()
    r = ref.to_json()
    for rec, name in ((g, "noisyquantumsimulator_tpu_torch"),
                      (r, "noisyquantumsimulator_tpu")):
        assert rec["metadata"].pop("generator") == name
        rec["metadata"].pop("generated")
    gn, rn = _numbers(g), _numbers(r)
    assert [p for p, _ in gn] == [p for p, _ in rn]
    for (p, a), (_, b) in zip(gn, rn):
        if isinstance(b, (float, int)) and not isinstance(b, bool):
            assert abs(a - b) <= 1e-10, p
        else:
            assert a == b, p


def test_record_from_channel_matches_reference(jax_channel, torch_channel):
    got = tcal.record_from_channel(torch_channel, "n70_test")
    ref = jcal.record_from_channel(jax_channel, "n70_test")
    _assert_record_matches(got, ref)
    assert got.schema_version == tcal.SCHEMA_VERSION == jcal.SCHEMA_VERSION


def test_calibrate_cz_roundtrip(jax_channel, tmp_path):
    store = tch.CalibrationStore(str(tmp_path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rec = tch.calibrate_cz(store=store, device="cpu",
                               dtype=torch.complex128)
    _assert_record_matches(rec, jcal.record_from_channel(
        jax_channel, "n70_smooth_jp_default"))
    paths = store.list_records()
    assert paths == [os.path.join(str(tmp_path), "neutral_atoms", "rydberg_cz",
                                  "n70_smooth_jp_default.json")]
    back = store.load("neutral_atoms", "rydberg_cz", "n70_smooth_jp_default")
    assert dataclasses.asdict(back) == json.loads(json.dumps(rec.to_json()))
    S = store.load_superop("neutral_atoms", "rydberg_cz", "n70_smooth_jp_default")
    assert S.shape == (16, 16)
    assert np.array_equal(S, tcal._complex_matrix_from_json(rec.superop))


def test_default_store_root_is_the_repositorys():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert tcal.CalibrationStore().root == os.path.join(root, "calibration_data")
    assert tcal.CalibrationStore().root == jcal.CalibrationStore().root
