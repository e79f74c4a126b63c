"""The port's BB-LDPC path against the JAX reference: host code, DEM,
sampler, tiered decoder, native OSD-0 and the end-to-end memory run.

Tolerances: host numpy code (codes, circuits, DEM, slot tables, signature
matrices) is bit-equal. The samplers draw from different random streams,
so their per-detector and per-observable rates agree within 5 binomial
sigma. The tiered decoder at a float32 fast tier agrees on every bad flag
and on the predictions of every converged shot; at a bfloat16 fast tier
(rounded in other places by XLA's fusion and torch's eager ops) failure
rates and non-converged fractions agree within 5e-3, the reference's own
bf16-vs-f32 bound. Native OSD-0 is bit-identical to `_osd0`.
"""
import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.qec import circuits as jc
from noisyquantumsimulator_tpu.qec import dem as jdem
from noisyquantumsimulator_tpu.qec import ldpc as jl
from noisyquantumsimulator_tpu.qec.dem_decoder import DemBPDecoder as JDec
from noisyquantumsimulator_tpu.qec.fast_sampler import build_fast_sampler as jfs
from noisyquantumsimulator_tpu.utils.math import wilson_ci as j_wilson
from noisyquantumsimulator_tpu_torch import bench_bb
from noisyquantumsimulator_tpu_torch.qec import circuits as tc
from noisyquantumsimulator_tpu_torch.qec import dem as tdem
from noisyquantumsimulator_tpu_torch.qec import ldpc as tl
from noisyquantumsimulator_tpu_torch.qec import native as tnative
from noisyquantumsimulator_tpu_torch.qec.dem_decoder import (
    DemBPDecoder as TDec, decoder_from_numpy)
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import (
    build_fast_sampler as tfs, sample_circuit_fast)
from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

torch.set_num_threads(1)

ROUNDS, P = 2, 3e-3


@pytest.fixture(scope="module")
def circ():
    """The small BB memory circuit in both packages, and 1024 shots of
    reference detectors / observables."""
    Hx, Hz = jl.small_bb_code()
    cj = jl.bb_memory_circuit(Hx, Hz, ROUNDS, P)
    ct = tl.bb_memory_circuit(Hx, Hz, ROUNDS, P)
    out = jfs(cj, 1024)(jax.random.PRNGKey(11))
    return dict(cj=cj, ct=ct, dets=np.asarray(out["detectors"], np.uint8),
                obs=np.asarray(out["observables"], np.uint8))


@pytest.fixture(scope="module")
def dem_pair(circ):
    return jdem.build_dem(circ["cj"]).merged(), tdem.build_dem(circ["ct"]).merged()


def _fails(pred, obs):
    f = np.zeros(len(pred), bool)
    for b in range(obs.shape[1]):
        f |= ((np.asarray(pred) >> b) & 1) != obs[:, b]
    return f


@pytest.mark.parametrize("code", ["gross_code", "small_bb_code"])
def test_bb_codes_bit_equal(code):
    Hx0, Hz0 = getattr(jl, code)()
    Hx1, Hz1 = getattr(tl, code)()
    np.testing.assert_array_equal(Hx0, Hx1)
    np.testing.assert_array_equal(Hz0, Hz1)
    assert tl.css_n_k(Hx1, Hz1) == jl.css_n_k(Hx0, Hz0)
    assert tl.check_css(Hx1, Hz1) and jl.check_css(Hx0, Hz0)
    np.testing.assert_array_equal(tl.logical_operators(Hx1, Hz1),
                                  jl.logical_operators(Hx0, Hz0))


def test_memory_circuit_bit_equal(circ):
    cj, ct = circ["cj"], circ["ct"]
    assert (ct.n_qubits, ct.n_measurements) == (cj.n_qubits, cj.n_measurements)
    assert len(ct.instructions) == len(cj.instructions)
    for a, b in zip(ct.instructions, cj.instructions):
        assert (a.name, a.arg) == (b.name, b.arg)
        np.testing.assert_array_equal(a.targets, b.targets)
    np.testing.assert_array_equal(tc.detector_matrix(ct), jc.detector_matrix(cj))
    np.testing.assert_array_equal(tc.observable_matrix(ct),
                                  jc.observable_matrix(cj))


def test_dem_mechanisms_bit_equal(dem_pair):
    dj, dt = dem_pair
    assert (dt.n_detectors, dt.n_observables) == (dj.n_detectors, dj.n_observables)
    assert [(m.detectors, m.observables, m.probability) for m in dt.mechanisms] \
        == [(m.detectors, m.observables, m.probability) for m in dj.mechanisms]


def test_slot_tables_bit_equal(circ):
    H = TDec(circ["ct"], n_iters=2, device="cpu").H
    chk, var = np.nonzero(H)
    args = (chk.astype(np.int64), var.astype(np.int64)) + H.shape
    t0, t1 = jl.build_slot_tables(*args), tl.build_slot_tables(*args)
    assert t0.keys() == t1.keys()
    for k in t0:
        np.testing.assert_array_equal(t0[k], t1[k])


def test_sampler_signatures_match_reference_propagation(circ):
    """The sampler's site -> detector / observable matrices equal those the
    reference's host functions give for the same fault sites."""
    s = tfs(circ["ct"], 8, device="cpu")
    meas = jdem._propagate_faults(circ["cj"], s.faults)
    for row, rec in s.meas_flip_rows:
        meas[row, rec] ^= 1
    m = meas.astype(np.int64)
    Fd = (m @ jc.detector_matrix(circ["cj"]).T.astype(np.int64)) % 2
    Fo = (m @ jc.observable_matrix(circ["cj"]).T.astype(np.int64)) % 2
    assert s.Fd.shape == (len(s.faults), circ["cj"].n_detectors)
    np.testing.assert_array_equal(s.Fd, Fd.astype(np.int8))
    np.testing.assert_array_equal(s.Fo, Fo.astype(np.int8))


def test_sampler_rates_within_5_sigma(circ):
    shots = 20000
    ref = jfs(circ["cj"], shots)(jax.random.PRNGKey(3))
    got = sample_circuit_fast(circ["ct"], shots, seed=3, device="cpu")
    assert got["detectors"].shape == (shots, circ["cj"].n_detectors)
    assert got["detectors"].dtype == np.uint8
    for key in ("detectors", "observables"):
        r0 = np.asarray(ref[key], np.float64).mean(axis=0)
        r1 = got[key].astype(np.float64).mean(axis=0)
        pbar = np.clip((r0 + r1) / 2, 1.0 / shots, None)
        sigma = np.sqrt(2 * pbar * (1 - pbar) / shots)
        assert np.all(np.abs(r0 - r1) <= 5 * sigma), key
        assert r1.mean() > 0


def test_native_osd0_matches_python_and_leaves_native_dir(circ):
    native_dir = tnative.SOURCE.parent
    before = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in native_dir.iterdir() if p.is_file()}
    dec = TDec(circ["ct"], n_iters=2, device="cpu")
    rng = np.random.default_rng(2)
    dets = circ["dets"][:64]
    beliefs = rng.normal(size=(64, dec.n_mech)).astype(np.float32)
    beliefs[:, :20] = beliefs[:, 20:40]          # tied beliefs
    got = tnative.osd0_batch_native(dec.H, dets, beliefs)
    want = np.stack([jl._osd0(dec.H, dets[i], beliefs[i]) for i in range(64)])
    np.testing.assert_array_equal(got, want)
    # each solution reproduces its syndrome (H has full row rank here)
    np.testing.assert_array_equal((got.astype(np.int64) @ dec.H.T) % 2, dets)
    assert Path(tnative.library_path()).parent == tnative.BUILD_DIR
    after = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
             for p in native_dir.iterdir() if p.is_file()}
    assert after == before


def test_full_f32_fast_tier_matches_reference(circ):
    kw = dict(n_iters=25, fast_iters=6, retry_cap_divisor=4)
    dj = JDec(circ["cj"], fast_impl="xla", **kw)
    dt = TDec(circ["ct"], device="cpu", **kw)
    pj, bj, _ = (np.asarray(a) for a in
                 dj._full(jnp.asarray(circ["dets"], jnp.float32)))
    pt, bt, belt = dt._full(torch.tensor(circ["dets"]).float())
    assert pt.dtype == torch.int32 and bt.dtype == torch.bool
    assert belt.shape == (1024, dt.n_mech)
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(pt.numpy()[~bj], pj[~bj])


def test_fast_tier_tail_fits_retry_cap(circ):
    """The decoder is meant to run with every fast-tier failure inside the
    retry capacity; only then do torch.topk and jax top_k pick the same
    set regardless of tie order."""
    dt = TDec(circ["ct"], n_iters=25, fast_iters=6, retry_cap_divisor=4,
               device="cpu")
    dets = torch.tensor(circ["dets"]).float()
    est, _ = dt._bp_fast(dets)
    _, bad = dt.score(est, dets)
    cap = min(1024, max(1024 // 4, 64))
    assert 0 < int(bad.sum()) <= cap


def test_full_bf16_fast_tier_statistics(circ):
    kw = dict(n_iters=25, fast_iters=6, retry_cap_divisor=4)
    dj = JDec(circ["cj"], fast_impl="xla", fast_dtype=jnp.bfloat16, **kw)
    dt = TDec(circ["ct"], fast_dtype=torch.bfloat16, device="cpu", **kw)
    pj, bj, _ = (np.asarray(a) for a in
                 dj._full(jnp.asarray(circ["dets"], jnp.float32)))
    pt, bt, _ = dt._full(torch.tensor(circ["dets"]).float())
    fj, ft = _fails(pj, circ["obs"]), _fails(pt.numpy(), circ["obs"])
    assert abs(fj.mean() - ft.mean()) < 5e-3
    assert abs(bj.mean() - bt.numpy().mean()) < 5e-3


def test_decoder_from_numpy_equals_circuit_decoder(circ):
    kw = dict(n_iters=25, fast_iters=6, retry_cap_divisor=4)
    dj = JDec(circ["cj"], fast_impl="xla", **kw)
    a = decoder_from_numpy(dj.H, dj.obs_mask, dj.probs, "cpu", **kw)
    b = TDec(circ["ct"], device="cpu", **kw)
    np.testing.assert_array_equal(a.H, b.H)
    np.testing.assert_array_equal(a.obs_mask, b.obs_mask)
    dets = torch.tensor(circ["dets"][:256]).float()
    for x, y in zip(a._full(dets), b._full(dets)):
        assert torch.equal(x, y)


def test_run_bb_circuit_memory_within_reference_ci():
    kw = dict(rounds=2, p=8e-3, shots=1024, seed=0, n_iters=20)
    r0 = jl.run_bb_circuit_memory(**kw)
    r1 = tl.run_bb_circuit_memory(**kw, device="cpu")
    assert r1["code"] == r0["code"] == "[[72,12]]"
    assert r1["n_mechanisms"] == r0["n_mechanisms"]
    lo, hi = wilson_ci(round(r0["p_logical_shot"] * 1024), 1024)
    assert 0 < r1["p_logical_shot"] and lo <= r1["p_logical_shot"] <= hi


@pytest.mark.parametrize("k,n", [(0, 100), (7, 2048), (2048, 2048), (3, 0)])
def test_wilson_ci_matches_reference(k, n):
    assert wilson_ci(k, n) == j_wilson(k, n)


def test_bench_bb_workload_cpu_small():
    """The bench workload on the small code and the CPU: e2e returns the
    residue block of `cap` rows, and osd_host refuses a residue larger
    than the cap instead of undercounting."""
    Hx, Hz = tl.small_bb_code()
    w = bench_bb.build_bb_workload(rounds=2, p=1e-3, shots=1024, device="cpu",
                                   Hx=Hx, Hz=Hz)
    assert (w.n, w.k, w.cap, w.fast_iters) == (72, 12, 32, 6)
    fails, n_bad, dets, bel, obs = w.e2e(torch.Generator().manual_seed(1))
    assert dets.shape == (w.cap, w.circuit.n_detectors)
    assert bel.shape == (w.cap, w.decoder.n_mech) and obs.shape == (w.cap, 12)
    nb = int(n_bad)
    assert 0 <= int(fails) <= 1024 and nb <= w.cap
    assert 0 <= w.osd_host(nb, dets, bel, obs) <= nb
    with pytest.raises(RuntimeError):
        w.osd_host(w.cap + 1, dets, bel, obs)
