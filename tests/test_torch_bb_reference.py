"""The BB memory step (`bench_bb.build_bb_workload`'s `step`) held to the
benchmark's plain reference (`nqs_bench/reference/qec`: a frozen copy of the
circuit and DEM build, a DEM sampler, float32 min-sum with a damped retry and
OSD-0) on the CPU, at the benchmark's CPU cut: the [[72,12,6]] code, 2
rounds, p = 3e-3, under the decoder budgets the program takes there.

  (a) the program's circuit sampler and the reference's DEM sampler against
      the DEM's exact marginals and pairwise detector firing;
  (b) the program's decoder and the reference's on the same syndromes;
  (c) the step's failure count and its OSD-0 rows;
  (d) the step's spans."""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch import bench_bb
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
from noisyquantumsimulator_tpu_torch.qec.ldpc import bb_code, bb_memory_circuit
from noisyquantumsimulator_tpu_torch.qec.native import osd0_batch_native
from noisyquantumsimulator_tpu_torch.utils import observability as tobs
from nqs_bench.reference.qec import bb_model, decoder

torch.set_num_threads(1)

CONFIG = {"code": {"l": 6, "m": 6, "a_powers": [3, 1, 2], "b_powers": [3, 1, 2]},
          "rounds": 2, "p": 3e-3, "noise": bb_model.NOISE,
          "decoder": {"scale": 0.75, "fast_iters": 8, "retry_iters": 90,
                      "retry_damping": 0.5}}
# |z| bound of a binomial count against its exact mean: over the ~10^3
# quantities a test holds, a sound sampler passes it but with odds of ~1e-4
Z_BOUND = 5.5


@pytest.fixture(scope="module")
def model():
    return bb_model.build(CONFIG)


def _code():
    return bb_code(6, 6, (3, 1, 2), (3, 1, 2))


def _workload(shots, p=CONFIG["p"]):
    return bench_bb.build_bb_workload(CONFIG["rounds"], p, shots, 8, "cpu", *_code())


@pytest.fixture(scope="module")
def small():
    return _workload(2048)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _packed(bits):
    return (np.asarray(bits, np.int64) << np.arange(bits.shape[1])).sum(axis=1)


def _z(count, n, q):
    return (count - n * q) / np.sqrt(n * q * (1.0 - q))


def test_the_frozen_dem_is_the_program_s(model, small):
    dec = small.decoder
    assert np.array_equal(model.H, dec.H)
    assert np.array_equal(model.obs_mask, dec.obs_mask)
    assert np.array_equal(model.probs, dec.probs)
    assert (model.k, bb_model.sizes(model)["n_detectors"]) == (12, 108)
    with pytest.raises(ValueError):
        bb_model.build(dict(CONFIG, noise=dict(bb_model.NOISE, measure_flip=2.0)))


@pytest.mark.parametrize("sampler", ["program", "reference"])
def test_a_marginals_and_pairs_are_the_dem_s(model, sampler):
    """(a) Each detector's and observable's firing count, and each pair of
    detectors that share a mechanism firing together, within Z_BOUND
    binomial standard deviations of the DEM's exact values. The program's
    sampler is circuit-exact; the DEM treats a channel's outcomes as
    independent, which moves these probabilities by O(p^2), ~1e-5 here,
    a twentieth of a standard deviation at this count."""
    n = 1 << 15
    if sampler == "program":
        circuit = bb_memory_circuit(*_code(), CONFIG["rounds"], CONFIG["p"])
        o = build_fast_sampler(circuit, n, "cpu")(_gen(11))
        dets, obs = o["detectors"], o["observables"]
    else:
        dets, obs = bb_model.sample(model, n, _gen(12))
    d = dets.numpy().astype(np.float64)
    fired = np.concatenate([d.sum(0), obs.numpy().sum(0)])
    assert np.max(np.abs(_z(fired, n, model.marginals()))) < Z_BOUND
    H = model.H.astype(np.int64)
    a, b = np.nonzero(np.triu(H @ H.T, 1))
    assert len(a) > 300
    both = (d[:, a] * d[:, b]).sum(0)
    assert np.max(np.abs(_z(both, n, model.joint(a, b)))) < Z_BOUND


def _program_corrections(dec, dets):
    """The program decoder's corrections: its hard decision where BP
    converged, native OSD-0 of its beliefs elsewhere, and its predictions."""
    pred, bad, beliefs = dec._full(dets.to(torch.float32))
    hard = (beliefs < 0).numpy().astype(np.uint8)
    rows = np.nonzero(bad.numpy())[0]
    hard[rows] = osd0_batch_native(dec.H, dets.numpy()[rows], beliefs.numpy()[rows])
    return hard, pred.numpy().astype(np.int64), rows


def test_b_both_decoders_satisfy_every_syndrome_and_agree(model, small):
    """(b) On 4096 sampled shots, every correction of both decoders
    reproduces its syndrome, and the two predict the same observable flips
    on all but at most 0.1% of the shots (none differ on these seeds, nor
    on two more pairs tried). They may differ: the program's first tier
    runs in bfloat16, its retry decides after its last iteration where the
    reference's stops at the first match, and two corrections that both
    satisfy a syndrome can differ by a logical."""
    o = small.sampler(_gen(21))
    dets = torch.cat([o["detectors"], small.sampler(_gen(22))["detectors"]])
    hard, pred, rows = _program_corrections(small.decoder, dets)
    ref_hard, tier, _ = decoder.corrections(model, dets, "cpu")
    ref_hard = ref_hard.numpy()
    syn = dets.numpy().astype(np.int64)
    for h in (hard, ref_hard):
        assert np.array_equal((h.astype(np.int64) @ model.H.T.astype(np.int64)) % 2, syn)
    assert bool((tier >= 1).any()) and len(rows) > 0
    flips = _packed((hard.astype(np.int64) @ model.obs.T.astype(np.int64)) % 2)
    conv = np.setdiff1d(np.arange(len(pred)), rows)
    assert np.array_equal(flips[conv], pred[conv])
    assert np.mean(flips != decoder.flips(model, torch.as_tensor(ref_hard))) <= 0.001


# the mean |reliability - the reference's| over the shots that both fast
# tiers decided, at the CPU cut: the program's bfloat16 fast tier reads
# 0.398-0.413 on seeds 23-25, the reference with float8_e4m3fn messages
# 2.04-2.15
BELIEF_GAP = 1.0


def test_b_reliabilities_follow_the_message_precision(model, small):
    """(b) The reliability of each shot's beliefs (their least |belief|)
    that the step reports is the reference's to within BELIEF_GAP on the
    mean over the shots that both fast tiers decided, while the reference
    with its messages rounded to float8_e4m3fn is further off than that."""
    dets = small.sampler(_gen(23))["detectors"]
    _, tier, beliefs, _ = _tiered(small.decoder, dets)
    rel = np.round(np.abs(beliefs).min(axis=1) * bench_bb.RELIABILITY_UNITS) \
        / bench_bb.RELIABILITY_UNITS
    _, ref_tier, ref_rel = decoder.decode(model, dets, "cpu")
    _, fp8_tier, fp8_rel = decoder.decode(model, dets, "cpu", rounding=torch.float8_e4m3fn)
    fast = (tier == 0) & (ref_tier == 0)
    assert fast.mean() > 0.9
    assert np.mean(np.abs(rel - ref_rel)[fast]) < BELIEF_GAP
    both = (fp8_tier == 0) & (ref_tier == 0)
    assert np.mean(np.abs(fp8_rel - ref_rel)[both]) > 2 * BELIEF_GAP


def _tiered(dec, dets):
    """The program decoder's (pred, tier, beliefs, bad) on the host; tier 0:
    the fast tier decided, 1: the retry, 2: neither (OSD-0's)."""
    pred, bad, beliefs, missed = dec.tiered(dets.to(torch.float32))
    tier = missed.numpy().astype(np.int64) + bad.numpy()
    return pred.numpy(), tier, beliefs.numpy(), bad.numpy()


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_c_the_step_counts_its_failures_and_osd_rows(model, small, seed):
    """(c) The step's failure count is its shots whose prediction misses the
    observables that the same seed draws, and the rows that both BP tiers
    left unconverged carry OSD-0's predictions (the reference's OSD-0 of
    the program's beliefs); each shot's tier and reliability are the
    decoder's, and the last row states the step's failures and k."""
    out = small.step(_gen(seed))
    o = small.sampler(_gen(seed))
    truth = _packed(o["observables"].numpy())
    pred = out[:-1, 0].astype(np.int64)
    assert out.dtype == np.int32 and out.shape == (2048 + 1, 3)
    assert out[-1, 0] == np.sum(pred != truth) and out[-1, 1] == 12
    _, tier, beliefs, _ = _tiered(small.decoder, o["detectors"])
    assert np.array_equal(out[:-1, 1], tier)
    assert np.array_equal(out[:-1, 2], np.round(np.abs(beliefs).min(axis=1)
                                                * bench_bb.RELIABILITY_UNITS))
    _, _, rows = _program_corrections(small.decoder, o["detectors"])
    assert len(rows) > 0 and np.all(tier[rows] == 2)
    est = np.stack([decoder.osd0(model.H, o["detectors"][r].numpy(), beliefs[r])
                    for r in rows])
    assert np.array_equal(pred[rows], _packed((est.astype(np.int64)
                                               @ model.obs.T.astype(np.int64)) % 2))


def _host_osd_answers(w, seed):
    """The step's answers put together as with OSD-0 on the host: the
    decoder's predictions, tiers and reliabilities, the C++ OSD-0 of the
    residue rows written over theirs, the failures counted on the host."""
    o = w.sampler(_gen(seed))
    pred, tier, beliefs, bad = _tiered(w.decoder, o["detectors"])
    rel = np.round(np.abs(beliefs).min(axis=1) * bench_bb.RELIABILITY_UNITS)
    shots = np.stack([pred, tier, rel], axis=1).astype(np.int64)
    rows = np.nonzero(bad)[0]
    est = osd0_batch_native(w.decoder.H, o["detectors"].numpy()[rows], beliefs[rows])
    shots[rows, 0] = _packed((est.astype(np.int64) @ (
        (w.decoder.obs_mask[:, None] >> np.arange(w.k)) & 1)) & 1)
    n_fail = int((shots[:, 0] != _packed(o["observables"].numpy())).sum())
    return bench_bb.answers(shots, n_fail, w.k), len(rows)


@pytest.mark.parametrize("seed", [34, 35])
def test_c_the_step_answers_as_with_host_osd(small, seed):
    """(c) With OSD-0 in `osd_cuda.osd0` (on the CPU its twin, the C++ OSD-0)
    and one copy back, the step answers bit for bit what it answered with
    OSD-0 on the host after the answers' copy."""
    want, n_rows = _host_osd_answers(small, seed)
    assert n_rows > 0
    assert np.array_equal(small.step(_gen(seed)), want)


def test_c_a_residue_above_its_cap_raises():
    """At p = 2e-2 more shots than the cap's 32 of 256 leave both BP tiers
    unconverged: the step raises instead of returning a short count."""
    with pytest.raises(RuntimeError, match="residue cap"):
        _workload(256, p=2e-2).step(_gen(5))


def test_d_the_spans_nest_and_count_the_residue(small):
    """(d) Under a profiler one step records nqs.step around nqs.sample,
    nqs.decode (with both tiers inside) and nqs.osd, in that order, each
    inside the step's time; nqs.osd's count is the step's residue rows."""
    small.step(_gen(41))                      # the first call records in any case
    tobs.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            small.step(_gen(42))
        rec = tobs.spans()
    finally:
        tobs.clear()
    assert [(r.name, r.parent, r.step) for r in rec] == [
        ("nqs.step", -1, 0), ("nqs.sample", 0, 0), ("nqs.decode", 0, 0), ("nqs.osd", 0, 0)]
    step = rec[0]
    for r in rec[1:]:
        assert step.start_ns <= r.start_ns <= r.end_ns <= step.end_ns
    assert rec[1].end_ns <= rec[2].start_ns and rec[2].end_ns <= rec[3].start_ns
    _, _, rows = _program_corrections(small.decoder, small.sampler(_gen(42))["detectors"])
    assert rec[3].count == len(rows) and [r.count for r in rec[:3]] == [None] * 3


def test_d_spans_off_keep_nothing(small):
    small.step(_gen(43))                      # past the first call
    tobs.clear()
    small.step(_gen(44))
    assert tobs.spans() == []
