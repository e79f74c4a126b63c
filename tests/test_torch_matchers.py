"""The port's surface-code matchers against the JAX reference's, on shared
detector arrays: greedy, exact (decode and matching extraction), hybrid,
tiered, window (plain, light/heavy tiers, greedy tier, escalating) and
cluster (tight and default tiers, escalating) matchers, the native C++
decoders, the DP's level tables and the top-k row selection.

Tolerances: every prediction, matching, flag and overflow fraction is
bit-identical to the reference's; the host tables are bit-equal. The shared
arrays come from the reference's sampler (a d = 5, 5-round memory circuit at
p = 4e-3, whose uniform weights give many equal-cost matchings) plus numpy
rows made from a seed that hold more defects than the DP budgets, so rows
with ties, rows over K and rows past the heavy capacities all occur.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.qec import cluster_matcher as jcm
from noisyquantumsimulator_tpu.qec import decoders as jd
from noisyquantumsimulator_tpu.qec import exact_matcher as jem
from noisyquantumsimulator_tpu.qec import native as jnat
from noisyquantumsimulator_tpu.qec import surface_code as jsc
from noisyquantumsimulator_tpu.qec import window_matcher as jwm
from noisyquantumsimulator_tpu.qec.dem import build_dem, dem_to_edges
from noisyquantumsimulator_tpu.qec.fast_sampler import build_fast_sampler
from noisyquantumsimulator_tpu_torch.qec import cluster_matcher as tcm
from noisyquantumsimulator_tpu_torch.qec import decoders as td
from noisyquantumsimulator_tpu_torch.qec import exact_matcher as tem
from noisyquantumsimulator_tpu_torch.qec import native as tnat
from noisyquantumsimulator_tpu_torch.qec import window_matcher as twm

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(scope="module")
def d5():
    """The d = 5 memory circuit, its DEM edges and 640 shared detector rows:
    512 sampled by the reference, 128 numpy rows with 6-20 defects."""
    c = jsc.memory_z_circuit(5, 5, p=4e-3)
    out = build_fast_sampler(c, 512)(jax.random.PRNGKey(21))
    n = c.n_detectors
    rng = np.random.default_rng(11)
    heavy = np.zeros((128, n), np.uint8)
    for r in range(128):
        heavy[r, rng.choice(n, rng.integers(6, 21), replace=False)] = 1
    dets = np.concatenate([np.asarray(out["detectors"], np.uint8), heavy])
    return dict(circuit=c, edges=dem_to_edges(build_dem(c)), dets=dets,
                rounds=jsc.memory_detector_rounds(5, 5), n=n)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("K", [2, 3, 5, 8, 12])
def test_level_tables_are_the_references_valid_columns(K):
    ref = jem._build_level_indices(K)
    port = tem._build_level_indices(K)
    assert len(ref) == len(port) == K
    for k, (r, t) in enumerate(zip(ref, port), start=1):
        assert r["size"] == t["size"]
        _eq(r["idx_bnd"], t["idx_bnd"])
        _eq(r["sel_bi"], t["sel_bi"])
        assert r["pair_ok"][:, :k - 1].all() and not r["pair_ok"][:, k - 1:].any()
        _eq(r["idx_pair"][:, :k - 1], t["idx_pair"])
        _eq(r["sel_ij"][:, :k - 1], t["sel_ij"])


def test_stable_top_rows_is_lax_top_k():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 5, 3000).astype(np.int32)          # many ties
    for k in (1, 64, 1000, 3000):
        _, ref = jax.lax.top_k(jnp.asarray(x), k)
        _eq(ref, td.stable_top_rows(torch.as_tensor(x), k))


@pytest.mark.parametrize("max_defects", [6, 32])
def test_greedy_bit_identical(d5, max_defects):
    e, p, o = d5["edges"]
    jm = jd.MatchingDecoder(d5["n"], e, p, o, max_defects=max_defects)
    tm = td.MatchingDecoder(d5["n"], e, p, o, max_defects=max_defects,
                            device=CPU)
    _eq(jm.decode_batch(d5["dets"]), tm.decode_batch(d5["dets"]))
    mj = jd._greedy_match_batch(jnp.asarray(d5["dets"]), jm._dist, jm._par,
                                max_defects)
    mt = td._greedy_match_batch(torch.as_tensor(d5["dets"]), tm._dist,
                                tm._par, max_defects)
    _eq(mj[0], mt[0])
    _eq(mj[1], mt[1])


@pytest.mark.parametrize("K", [4, 6, 8])
def test_exact_bit_identical(d5, K):
    e, p, o = d5["edges"]
    jm = jem.ExactMatcherTPU(d5["n"], e, p, o, max_defects=K, chunk=256)
    tm = tem.ExactMatcher(d5["n"], e, p, o, max_defects=K, chunk=256,
                          device=CPU)
    dets = d5["dets"]
    assert (dets.sum(1) > K).any()                     # rows over K
    _eq(jm.decode_batch(dets), tm.decode_batch(dets))
    assert jm.overflow_fraction(dets) == tm.overflow_fraction(dets)
    if K != 6:
        for a, b in zip(jm.match_device(jnp.asarray(dets[:320])),
                        tm.match_device(torch.as_tensor(dets[:320]))):
            _eq(a, b)


def test_exact_k12_small_chunk(d5):
    """The K = 12 DP (decode and matching) at a 64-row chunk."""
    e, p, o = d5["edges"]
    dets = d5["dets"][-64:]
    jm = jem.ExactMatcherTPU(d5["n"], e, p, o, max_defects=12, chunk=64)
    tm = tem.ExactMatcher(d5["n"], e, p, o, max_defects=12, chunk=64,
                          device=CPU)
    _eq(jm.decode_batch(dets), tm.decode_batch(dets))
    for a, b in zip(jm.match_device(jnp.asarray(dets)),
                    tm.match_device(torch.as_tensor(dets))):
        _eq(a, b)


def test_hybrid_bit_identical(d5):
    e, p, o = d5["edges"]
    kw = dict(max_defects=6, greedy_defects=24, chunk=256)
    jm = jem.HybridMatcherTPU(d5["n"], e, p, o, **kw)
    tm = tem.HybridMatcher(d5["n"], e, p, o, device=CPU, **kw)
    _eq(jm.decode_batch(d5["dets"]), tm.decode_batch(d5["dets"]))


@pytest.mark.parametrize("cap", [16, 256])
def test_tiered_bit_identical(d5, cap):
    """cap 16 leaves heavy rows past the capacity (truncated alike)."""
    e, p, o = d5["edges"]
    kw = dict(k_light=3, k_heavy=8, chunk=256, heavy_capacity=cap)
    jm = jem.TieredMatcherTPU(d5["n"], e, p, o, **kw)
    tm = tem.TieredMatcher(d5["n"], e, p, o, device=CPU, **kw)
    dets = d5["dets"]
    _eq(jm.decode_batch(dets), tm.decode_batch(dets))
    # int64 rows: see test_reference_tiered_overflow_negates_unsigned_counts
    assert (jm.overflow_fraction(dets.astype(np.int64))
            == tm.overflow_fraction(dets))
    # a device batch smaller than the capacity
    _eq(jm.decode_device(jnp.asarray(dets[:8])),
        tm.decode_device(torch.as_tensor(dets[:8])))


def test_reference_tiered_overflow_negates_unsigned_counts(d5):
    """Reference-side fault: TieredMatcherTPU.overflow_fraction ranks the
    shots by np.argsort(-counts) with counts summed from uint8 rows, so
    unsigned; -0 stays 0 and every other count wraps, so zero-defect shots
    take the heavy capacity first. When the capacity binds, it misstates
    the truncated fraction that its own decode (top_k of int32 counts)
    makes. The port counts what the decode selects."""
    e, p, o = d5["edges"]
    kw = dict(k_light=3, k_heavy=8, chunk=256, heavy_capacity=16)
    jm = jem.TieredMatcherTPU(d5["n"], e, p, o, **kw)
    tm = tem.TieredMatcher(d5["n"], e, p, o, device=CPU, **kw)
    dets = d5["dets"]
    assert jm.overflow_fraction(dets) != jm.overflow_fraction(
        dets.astype(np.int64))
    assert tm.overflow_fraction(dets) == jm.overflow_fraction(
        dets.astype(np.int64))


def test_tiered_rejects_bad_capacity(d5):
    e, p, o = d5["edges"]
    for cap in (0, 64):
        with pytest.raises(ValueError):
            tem.TieredMatcher(d5["n"], e, p, o, chunk=32, heavy_capacity=cap,
                              device=CPU)


@pytest.mark.parametrize("tiering", ["plain", "light_heavy", "greedy"])
def test_window_bit_identical(d5, tiering):
    e, p, o = d5["edges"]
    kw = {"plain": dict(max_defects=6),
          "light_heavy": dict(max_defects=8, k_light=4, heavy_capacity=48),
          "greedy": dict(max_defects=6, greedy_fallback=16,
                         greedy_capacity=32)}[tiering]
    kw.update(window_rounds=3, commit_rounds=1, chunk=320)
    jm = jwm.WindowMatcherTPU(d5["n"], e, p, o, d5["rounds"], **kw)
    tm = twm.WindowMatcher(d5["n"], e, p, o, d5["rounds"], device=CPU, **kw)
    assert jm.n_windows == tm.n_windows
    for s0 in (0, 320):
        rows = d5["dets"][s0:s0 + 320]
        pj, oj = jm.decode_device_with_overflow(jnp.asarray(rows))
        pt, ot = tm.decode_device_with_overflow(torch.as_tensor(rows))
        _eq(pj, pt)
        _eq(oj, ot)
    assert oj.any()                                # budgets exceeded


def test_escalating_window_bit_identical(d5):
    e, p, o = d5["edges"]
    kw = dict(window_rounds=4, commit_rounds=2, max_defects=8, k_light=4,
              chunk=320)
    jm = jwm.EscalatingWindowMatcher(d5["n"], e, p, o, d5["rounds"], **kw)
    tm = twm.EscalatingWindowMatcher(d5["n"], e, p, o, d5["rounds"],
                                     device=CPU, **kw)
    _eq(jm.decode_batch(d5["dets"]), tm.decode_batch(d5["dets"]))
    assert jm.last_flagged_fraction == tm.last_flagged_fraction > 0


@pytest.mark.parametrize("tiers", ["tight", "default"])
def test_cluster_bit_identical(d5, tiers):
    """tight: 12 slots, small size classes, 3 candidates a shot and
    capacities that starve, so every flag rule fires."""
    e, p, o = d5["edges"]
    kw = (dict(max_slots=12, cand_per_shot=3,
               tiers=((3, 4, 4, 0.05), (5, 6, 6, 0.02), (7, 8, 8, 0.01)))
          if tiers == "tight" else dict(max_slots=24,
                                        tiers=jcm.default_tiers(d5["n"])))
    jm = jcm.ClusterMatcherTPU(d5["n"], e, p, o, chunk=320, **kw)
    tm = tcm.ClusterMatcher(d5["n"], e, p, o, chunk=320, device=CPU, **kw)
    assert jm.tier_capacities == tm.tier_capacities
    for s0 in (0, 320):
        rows = d5["dets"][s0:s0 + 320]
        pj, oj = jm.decode_device_with_overflow(jnp.asarray(rows))
        pt, ot = tm.decode_device_with_overflow(torch.as_tensor(rows))
        _eq(pj, pt)
        _eq(oj, ot)
    assert jm.overflow_fraction(d5["dets"]) == tm.overflow_fraction(d5["dets"])


def test_escalating_cluster_bit_identical(d5):
    jm = jcm.cluster_matcher_for_circuit(d5["circuit"], chunk=320,
                                         escalating=True, max_slots=12)
    tm = tcm.cluster_matcher_for_circuit(d5["circuit"], chunk=320,
                                         escalating=True, max_slots=12,
                                         device=CPU)
    _eq(jm.decode_batch(d5["dets"]), tm.decode_batch(d5["dets"]))
    assert jm.last_flagged_fraction == tm.last_flagged_fraction > 0


def test_cluster_rejects_bad_tiers(d5):
    e, p, o = d5["edges"]
    for kw in (dict(tiers=((2, 4, 4, 0.1),)), dict(tiers=((3, 8, 6, 0.1),)),
               dict(max_slots=8, tiers=((3, 12, 12, 0.1),))):
        with pytest.raises(ValueError):
            tcm.ClusterMatcher(d5["n"], e, p, o, device=CPU, **kw)


def test_native_matching_bit_identical(d5):
    e, p, o = d5["edges"]
    jn = jnat.NativeMatchingDecoder(d5["n"], e, p, o)
    tn = tnat.NativeMatchingDecoder(d5["n"], e, p, o)
    dets = d5["dets"]
    _eq(jn.decode_batch(dets), tn.decode_batch(dets))
    for mode in (0, 1, 2):
        rj = jn.decode_batch_ex(dets, mode=mode, threads=2)
        rt = tn.decode_batch_ex(dets, mode=mode, threads=2)
        assert rj.keys() == rt.keys()
        for k in rj:
            _eq(rj[k], rt[k])


def test_native_erasure_peeler_bit_identical():
    c = jsc.memory_z_circuit(3, 3, p=1e-3, p_erase=0.05)
    s = build_fast_sampler(c, 512)
    out = s(jax.random.PRNGKey(4))
    dec = __import__("noisyquantumsimulator_tpu.qec.erasure",
                     fromlist=["ErasureDecoder"]).ErasureDecoder(
        c.n_detectors, s.erasure_meta["x_det"], s.erasure_meta["x_obs"], None)
    args = (c.n_detectors, dec._edges, dec._obs0.astype(np.uint8))
    dets = np.asarray(out["detectors"], np.uint8)
    heralds = np.asarray(out["heralds"], np.uint8)
    assert heralds.any()
    rj = jnat.NativeErasurePeeler(*args).peel_batch(dets, heralds)
    rt = tnat.NativeErasurePeeler(*args).peel_batch(dets, heralds)
    _eq(rj[0], rt[0])
    _eq(rj[1], rt[1])
    assert tnat.native_available()
