"""The surface-code memory step (`bench_qec.build_qec_workload`'s `step`) held
to the benchmark's plain reference (`nqs_bench/reference/qec`: a frozen copy
of the circuit and DEM build, its own matching graph, float64 least paths of
each observable parity and an exact subset DP of both logical classes) on the
CPU, at d = 3 and d = 5.

  (a) the reference's graph against the program's, and its class weights
      against a brute-force enumeration of matchings;
  (b) the step's answers: no prediction in a class that weighs more, weights
      within 2 / 1024 of the least, the failure count;
  (c) escalation: shots past 12 defects, and heavy shots past a chunk's
      heavy capacity, go to the host's exact decode (tier 2);
  (d) the fetch cap, and the step's spans."""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu_torch import bench_qec
from noisyquantumsimulator_tpu_torch.qec.decoders import MatchingGraph
from noisyquantumsimulator_tpu_torch.qec.dem import build_dem, dem_to_edges
from noisyquantumsimulator_tpu_torch.qec.exact_matcher import tiered_matcher_for_circuit
from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit
from noisyquantumsimulator_tpu_torch.utils import observability as tobs
from nqs_bench.reference.qec import matching, surface_model

torch.set_num_threads(1)

CPU = "cpu"
# a prediction no heavier than the other class by more than TIE is a tie;
# a weight is a float32 sum rounded to 1 / 1024
TIE = 1e-3
UNITS = bench_qec.WEIGHT_UNITS
# d = 5 at p = 5e-3, 2048 shots, seed 2: at most 14 defects, 4 shots past
# 12, 261 past 6 against a heavy capacity of 128 (one 2048-shot chunk)
D5 = (5, 5e-3, 2048, 2)


def _config(d, p):
    return {"code": {"d": d}, "rounds": d, "p": p, "noise": surface_model.NOISE}


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _stepped(d, p, shots, seed):
    """(workload, answers, detectors (S, n) uint8, observable (S,), the
    reference's class weights (S, 2)) of one step."""
    w = bench_qec.build_qec_workload(d, d, p, shots, CPU)
    out = w.step(_gen(seed))
    o = w.sampler(_gen(seed))
    dets = o["detectors"].numpy()
    W = matching.class_weights(surface_model.build(_config(d, p)).dist, dets)
    return w, out, dets, o["observables"][:, 0].numpy().astype(np.int64), W


@pytest.fixture(scope="module")
def d5():
    return _stepped(*D5)


def _brute(dist, nodes, boundary):
    """(W0, W1) by enumerating every matching of `nodes` and every parity of
    its paths."""
    best = [np.inf, np.inf]

    def walk(rest, weight, c):
        if not rest:
            best[c] = min(best[c], weight)
            return
        i, rest = rest[0], rest[1:]
        for q in (0, 1):
            walk(rest, weight + dist[q, i, boundary], c ^ q)
            for k, j in enumerate(rest):
                walk(rest[:k] + rest[k + 1:], weight + dist[q, i, j], c ^ q)
    walk(list(nodes), 0.0, 0)
    return best


@pytest.mark.parametrize("d", [3, 5])
def test_a_reference_graph_is_the_programs(d):
    """The least path of either parity is the program's float64 shortest
    path (its graph merges parallel mechanisms as the reference's does)."""
    m = surface_model.build(_config(d, 1e-3))
    e, p, o = dem_to_edges(build_dem(surface_model.circuit(m.config)))
    g = MatchingGraph.from_edges(m.n_det, e, p, o)
    assert len(m.edges) == len(e)
    assert np.array_equal(np.minimum(m.dist[0], m.dist[1]), g.dist)


def test_a_class_weights_against_brute_force(d5):
    _, _, dets, _, W = d5
    m = surface_model.build(_config(*D5[:2]))
    rows = np.nonzero(dets.sum(axis=1) <= 6)[0][:150]
    assert len(rows) == 150 and dets[rows].sum(axis=1).max() == 6
    for s in rows:
        want = _brute(m.dist, np.nonzero(dets[s])[0], m.n_det)
        assert np.allclose(W[s], want, rtol=0, atol=1e-9), s


@pytest.mark.parametrize("case", ["d3", "d5"])
def test_b_step_answers_as_the_reference(case, d5):
    w, out, dets, obs, W = d5 if case == "d5" else _stepped(3, 3e-3, 1024, 1)
    shots = len(dets)
    assert out.dtype == np.int32 and out.shape == (shots + 1, 3)
    pred, tier, weight = (out[:-1, k].astype(np.int64) for k in range(3))
    rows = np.arange(shots)
    assert not np.any(W[rows, pred] - W[rows, 1 - pred] > TIE)
    assert np.max(np.abs(weight - W.min(axis=1) * UNITS)) <= 2.0
    assert out[-1, 0] == np.sum(pred != obs)
    assert out[-1, 1] == np.sum(tier >= 2) and out[-1, 2] == 0


def test_c_shots_past_12_defects_escalate(d5):
    w, out, dets, _, W = d5
    nd = dets.sum(axis=1)
    heavy = nd > bench_qec.K_HEAVY
    assert heavy.sum() == 4
    assert np.all(out[:-1, 1][heavy] == 2)


def test_c_heavy_shots_past_the_capacity_escalate(d5):
    """The K = 12 DP serves a chunk's 128 heaviest shots; the other shots of
    7-12 defects were answered from their 6 lowest-index defects, and now
    go to the host, which answers them exactly."""
    w, out, dets, _, W = d5
    nd = dets.sum(axis=1)
    tier = out[:-1, 1]
    past = (nd > w.decoder.k_light) & (nd <= bench_qec.K_HEAVY) & (tier != 1)
    # 261 past 6 defects, of which the 128 served hold the 4 past 12
    assert w.decoder.heavy_capacity == 128 and past.sum() == 261 - 4 - (128 - 4)
    assert np.all(tier[past] == 2)
    rows = np.nonzero(past)[0]
    pred, weight = out[rows, 0].astype(np.int64), out[rows, 2].astype(np.int64)
    assert np.all(W[rows, pred] <= W[rows, 1 - pred] + TIE)
    assert np.max(np.abs(weight - W[rows].min(axis=1) * UNITS)) <= 2.0
    # the truncated K = 6 answers these shots had: 130 of 133 weights miss,
    # and 54 predictions are in the heavier class
    p6, w6 = (t.numpy() for t in
              w.decoder.light.decode_device_weighted(torch.as_tensor(dets[rows])))
    assert np.sum(np.abs(w6 - W[rows].min(axis=1)) > 2.0 / UNITS) == 130
    assert np.sum(W[rows, p6] - W[rows, 1 - p6] > TIE) == 54


def test_c_blocks_decode_as_the_chunk_loop(d5):
    """One pass of each DP over many chunks answers as a pass a chunk: each
    block of `chunk` rows (the last one shorter) keeps its own heavy rows."""
    _, _, dets, _, _ = d5
    dec = tiered_matcher_for_circuit(memory_z_circuit(5, 5, p=D5[1]), chunk=512,
                                     heavy_capacity=32, device=CPU)
    rows = torch.as_tensor(np.concatenate([dets, dets[:300]]))
    whole = dec.decode_device_tiered(rows)
    loop = [dec.decode_device_tiered(rows[s0:s0 + 512]) for s0 in range(0, len(rows), 512)]
    for a, b in zip(whole, zip(*loop)):
        assert torch.equal(a, torch.cat(b))
    assert torch.equal(~whole[3], ~dec.exact_rows(rows))
    assert whole[1].sum() > 0 and (~whole[3]).sum() > 0


def test_d_step_raises_past_the_fetch_cap():
    d, p, shots, seed = D5
    w = bench_qec.build_qec_workload(d, d, p, shots, CPU, cap=64)
    with pytest.raises(RuntimeError, match="fetch cap"):
        w.step(_gen(seed))


def test_d_step_spans():
    """The first call is recorded whole: nqs.step around nqs.sample,
    nqs.match and nqs.escalate, which carries the escalated rows."""
    w = bench_qec.build_qec_workload(3, 3, 3e-3, 1024, CPU)
    tobs.clear()
    out = w.step(_gen(2))
    rec = tobs.spans()
    assert [r.name for r in rec] == ["nqs.step", "nqs.sample", "nqs.match", "nqs.escalate"]
    assert all(r.step == 0 and r.end_ns is not None for r in rec)
    assert rec[3].count == out[-1, 1]
    tobs.clear()
    w.step(_gen(3))
    assert tobs.spans() == []
