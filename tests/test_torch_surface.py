"""The port's surface-code memory path against the JAX reference: layouts,
circuits, DEM edges, the matching graph, both samplers, run_memory, the
erasure path and the bench record on the CPU.

Tolerances: host numpy code (layouts, circuits, metrics, DEM edges, the
APSP dist / parity tables) is bit-equal. The samplers draw from different
random streams (torch.Generator here, jax.random there), so per-detector,
per-observable and per-measurement rates agree within 5 binomial sigma, and
logical error rates through run_memory and run_erasure_memory agree in the
overlap of their Wilson 95% intervals.
"""
import inspect
import json

import jax
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.qec import decoders as jd
from noisyquantumsimulator_tpu.qec import dem as jdem
from noisyquantumsimulator_tpu.qec import surface_code as jsc
from noisyquantumsimulator_tpu.qec.erasure import run_erasure_memory as j_erasure
from noisyquantumsimulator_tpu.qec.fast_sampler import build_fast_sampler as jfs
from noisyquantumsimulator_tpu.qec.memory import run_memory as j_run_memory
from noisyquantumsimulator_tpu.qec.pauli_frame import build_sampler as jframe
from noisyquantumsimulator_tpu.utils.math import wilson_ci
from noisyquantumsimulator_tpu_torch import bench_qec
from noisyquantumsimulator_tpu_torch import qec as tqec
from noisyquantumsimulator_tpu_torch.qec import decoders as td
from noisyquantumsimulator_tpu_torch.qec import dem as tdem
from noisyquantumsimulator_tpu_torch.qec import surface_code as tsc
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler as tfs
from noisyquantumsimulator_tpu_torch.qec.pauli_frame import build_sampler as tframe

torch.set_num_threads(1)

CPU = "cpu"


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _assert_rates_agree(a, b, what):
    """Column rates of two 0/1 samples within 5 binomial sigma."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ra, rb = a.mean(0), b.mean(0)
    sig = np.sqrt(np.maximum(ra * (1 - ra) / len(a) + rb * (1 - rb) / len(b),
                             1e-12))
    z = np.abs(ra - rb) / sig
    assert z.max() <= 5.0, f"{what}: max z {z.max():.2f}"


def _ci_overlap(e0, n0, e1, n1):
    lo0, hi0 = wilson_ci(e0, n0)
    lo1, hi1 = wilson_ci(e1, n1)
    return lo0 <= hi1 and lo1 <= hi0


def _circuits_equal(cj, ct):
    assert (ct.n_qubits, ct.n_measurements, ct.n_detectors) == \
        (cj.n_qubits, cj.n_measurements, cj.n_detectors)
    assert len(ct.instructions) == len(cj.instructions)
    for a, b in zip(ct.instructions, cj.instructions):
        assert (a.name, a.arg) == (b.name, b.arg)
        np.testing.assert_array_equal(a.targets, b.targets)
        np.testing.assert_array_equal(np.asarray(a.probs), np.asarray(b.probs))
    from noisyquantumsimulator_tpu.qec import circuits as jc
    from noisyquantumsimulator_tpu_torch.qec import circuits as tc
    np.testing.assert_array_equal(tc.detector_matrix(ct), jc.detector_matrix(cj))
    np.testing.assert_array_equal(tc.observable_matrix(ct),
                                  jc.observable_matrix(cj))


@pytest.mark.parametrize("w,h", [(3, 3), (5, 5), (7, 7), (5, 3), (4, 6)])
def test_layouts_bit_equal(w, h):
    a, b = jsc.build_rect_layout(w, h), tsc.build_rect_layout(w, h)
    assert (a.d, a.w, a.h, a.n_qubits) == (b.d, b.w, b.h, b.n_qubits)
    assert (a.data, a.x_anc, a.z_anc) == (b.data, b.x_anc, b.z_anc)
    assert a.data_indices == b.data_indices
    assert (a.z_anc_indices, a.x_anc_indices) == (b.z_anc_indices,
                                                  b.x_anc_indices)
    if w == h:
        assert vars(jsc.build_layout(w)) == vars(tsc.build_layout(w))


_PROBS = np.full(16, 1e-3 / 15)
_PROBS[0] = 1 - 1e-3

_CIRCUITS = {
    "z_d3": lambda m: m.memory_z_circuit(3, 3, p=2e-3),
    "z_d5_calibrated": lambda m: m.memory_z_circuit(
        5, 2, noise="calibrated", p=1e-3, cz_pauli_probs=_PROBS),
    "z_d3_erase": lambda m: m.memory_z_circuit(3, 2, p=1e-3, p_erase=0.02),
    "z_rect_seam": lambda m: m.memory_z_circuit(
        3, 2, p=1e-3, layout=m.build_rect_layout(5, 3),
        extra_observables=[[0, 1]], plus_init_data=[(5, 1), (5, 3)],
        indeterminate_z_round1=sorted(m.build_rect_layout(5, 3).z_anc)[:2],
        logical_z_columns=[0, 1]),
    "x_d3": lambda m: m.memory_x_circuit(3, 3, p=2e-3),
    "x_d5_erase": lambda m: m.memory_x_circuit(5, 2, p=1e-3, p_erase=0.01),
}


@pytest.mark.parametrize("which", list(_CIRCUITS))
def test_memory_circuits_bit_equal(which):
    _circuits_equal(_CIRCUITS[which](jsc), _CIRCUITS[which](tsc))


def test_metrics_bit_equal():
    for d in (3, 5, 7, 9):
        assert jsc.code_metrics(d) == tsc.code_metrics(d)
        for basis in ("Z", "X"):
            np.testing.assert_array_equal(
                jsc.memory_detector_rounds(d, d, basis=basis),
                tsc.memory_detector_rounds(d, d, basis=basis))
        np.testing.assert_array_equal(jsc.memory_z_detector_rounds(d, 2),
                                      tsc.memory_z_detector_rounds(d, 2))
    for args in ((0, 100, 3), (7, 1000, 5), (600, 1000, 3), (3, 0, 2)):
        assert jsc.logical_error_rate(*args) == tsc.logical_error_rate(*args)
    for p_round, d in ((1e-4, 5), (3e-3, 3), (0.2, 3), (0.6, 3), (0.0, 3)):
        assert (jsc.teraquop_footprint(p_round, d)
                == tsc.teraquop_footprint(p_round, d))


@pytest.mark.parametrize("d", [3, 5])
def test_dem_edges_and_matching_graph_bit_equal(d):
    cj, ct = jsc.memory_z_circuit(d, d, p=1e-3), tsc.memory_z_circuit(d, d, p=1e-3)
    ej = jdem.dem_to_edges(jdem.build_dem(cj))
    et = tdem.dem_to_edges(tdem.build_dem(ct))
    for a, b in zip(ej, et):
        np.testing.assert_array_equal(a, b)
    gj = jd.MatchingGraph.from_edges(cj.n_detectors, *ej)
    gt = td.MatchingGraph.from_edges(ct.n_detectors, *et)
    np.testing.assert_array_equal(gj.dist, gt.dist)
    np.testing.assert_array_equal(gj.parity, gt.parity)
    dist, par = gt.tables_on(CPU)
    assert dist.dtype == torch.float32 and par.dtype == torch.uint8
    np.testing.assert_array_equal(dist.numpy(), gj.dist.astype(np.float32))


def test_fast_sampler_rates_match_reference():
    c = jsc.memory_z_circuit(3, 3, p=1e-2)
    S = 20000
    oj = jfs(c, S)(jax.random.PRNGKey(2))
    ot = tfs(tsc.memory_z_circuit(3, 3, p=1e-2), S, CPU)(_gen(2))
    for k in ("detectors", "observables"):
        _assert_rates_agree(oj[k], ot[k].numpy(), k)


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_frame_sampler_rates_match_reference(basis):
    S = 12000
    mk = {"Z": lambda m: m.memory_z_circuit(3, 2, p=2e-2, p_erase=0.01),
          "X": lambda m: m.memory_x_circuit(3, 2, p=2e-2)}[basis]
    oj = jframe(mk(jsc), S)(jax.random.PRNGKey(4))
    ot = tframe(mk(tsc), S, CPU)(_gen(4))
    for k in ("detectors", "observables", "measurements"):
        assert ot[k].dtype == torch.uint8 and ot[k].shape == oj[k].shape
        _assert_rates_agree(oj[k], ot[k].numpy(), f"{basis} {k}")


def test_frame_sampler_serves_nondeterministic_detectors():
    """A |+> seam makes round-1 detectors random: the fast sampler refuses
    (ValueError) in both packages, and run_memory takes the frame sampler."""
    mk = lambda m: m.memory_z_circuit(3, 2, p=1e-3, plus_init_data=[(1, 1)])  # noqa: E731
    cj, ct = mk(jsc), mk(tsc)
    with pytest.raises(ValueError):
        jfs(cj, 16)
    with pytest.raises(ValueError):
        tfs(ct, 16, CPU)
    S = 8000
    oj = jframe(cj, S)(jax.random.PRNGKey(6))
    ot = tframe(ct, S, CPU)(_gen(6))
    _assert_rates_agree(oj["detectors"], ot["detectors"].numpy(), "seam")
    assert 0.4 < ot["detectors"].numpy().mean(0).max() < 0.6
    r = tqec.run_memory(3, 2, p=1e-3, shots=512, circuit=ct,
                        decoder="matching", device=CPU)
    assert r.shots == 512 and r.detector_fraction > 0.02   # random checks


@pytest.mark.parametrize("d,p,shots", [(3, 4e-3, 6000), (5, 5e-3, 3000)])
def test_run_memory_ci_overlaps_reference(d, p, shots):
    rj = j_run_memory(d=d, p=p, shots=shots, seed=1)
    rt = tqec.run_memory(d=d, p=p, shots=shots, seed=1, device=CPU)
    assert rj.decoder == rt.decoder == "native"
    assert rt.extras.keys() == rj.extras.keys()
    assert rt.n_logical_errors > 0
    assert _ci_overlap(rj.n_logical_errors, shots, rt.n_logical_errors, shots)


@pytest.mark.parametrize("decoder", ["matching", "uf", "cluster",
                                     "cluster_native", "window",
                                     "window_native"])
def test_run_memory_decoders(decoder):
    """Every decoder choice runs on the same samples (same seed) and lands
    in the native exact decoder's interval; the exact ones on exactly its
    errors."""
    kw = dict(d=3, p=6e-3, shots=3000, seed=3, device=CPU)
    ref = tqec.run_memory(decoder="native", **kw)
    r = tqec.run_memory(decoder=decoder, **kw)
    assert r.decoder == decoder
    key = {"cluster_native": "escalated_fraction",
           "window_native": "escalated_fraction", "cluster": "overflow_fraction",
           "window": "overflow_fraction"}.get(decoder)
    if key:
        assert 0.0 <= r.extras[key] <= 1.0
    if decoder == "cluster_native":
        assert r.n_logical_errors == ref.n_logical_errors
    assert _ci_overlap(r.n_logical_errors, 3000, ref.n_logical_errors, 3000)


def test_run_memory_x_basis_and_frame_sampler():
    rt = tqec.run_memory(d=3, p=4e-3, shots=3000, basis="X",
                         sampler_kind="frame", seed=2, device=CPU)
    rj = j_run_memory(d=3, p=4e-3, shots=3000, basis="X",
                      sampler_kind="frame", seed=2)
    assert _ci_overlap(rj.n_logical_errors, 3000, rt.n_logical_errors, 3000)
    with pytest.raises(ValueError):
        tqec.run_memory(d=3, basis="Y", device=CPU)
    with pytest.raises(ValueError):
        tqec.run_memory(d=3, decoder="window", device=CPU,
                        circuit=tsc.memory_z_circuit(3, 3))


@pytest.mark.parametrize("basis", ["Z", "X"])
def test_erasure_ci_overlaps_reference(basis):
    kw = dict(d=3, p=0.0, p_erase=0.05, shots=6000, seed=8, basis=basis)
    rj = j_erasure(**kw)
    rt = tqec.run_erasure_memory(device=CPU, **kw)
    blind = tqec.run_erasure_memory(device=CPU, use_heralds=False, **kw)
    assert abs(rt["herald_fraction"] - rj["herald_fraction"]) < 5e-3
    assert _ci_overlap(rj["n_errors"], 6000, rt["n_errors"], 6000)
    assert rt["p_logical_shot"] * 5 < blind["p_logical_shot"]


def test_bench_qec_record_on_cpu(capsys):
    assert bench_qec.main(["--d", "3", "--shots", "4096", "--decode-shots",
                           "2048", "--reps-decode", "2", "--device",
                           "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line) <= 1500
    rec = json.loads(line)
    for k in ("metric", "value", "d", "rounds", "p", "shots_per_call",
              "n_detectors", "detector_fraction",
              "e2e_sample_decode_shots_per_sec", "e2e_decoder",
              "e2e_p_logical_shot", "e2e_n_errors", "e2e_n_decoded",
              "e2e_p_logical_ci95", "e2e_escalated_fraction",
              "peak_device_gib", "idle_share_one_rep"):
        assert k in rec, k
    assert rec["metric"] == "surface_code_d3_sample_shots_per_sec"
    assert rec["e2e_n_decoded"] == 4096 and rec["device"] == "cpu"
    assert rec["peak_device_gib"] is None and rec["idle_share_one_rep"] is None


@pytest.mark.parametrize("d,rounds", [(5, 5), (9, 2)])
def test_bench_qec_raises_past_the_fetch_cap(d, rounds):
    """Far above threshold the flagged rows outgrow the 64-row cap: the
    drain raises instead of undercounting."""
    w = bench_qec.build_qec_workload(d=d, rounds=rounds, p=4e-2,
                                     decode_shots=256, device=CPU)
    assert w.cap == 64
    with pytest.raises(RuntimeError, match="fetch cap"):
        w.drain(w.e2e(_gen(1)))


def test_bench_qec_escalates_flagged_rows_on_cpu():
    """Flagged rows under the cap: the count adds the native decode of
    exactly the flagged rows to the device's errors on the rest. The flags
    are every shot the tiered DP did not decode whole, heavy shots past the
    chunk's capacity among them, so p = 5e-3 keeps them under the cap."""
    w = bench_qec.build_qec_workload(d=5, rounds=5, p=5e-3, decode_shots=1024,
                                     device=CPU)
    o = w.sampler(_gen(5))
    dets, obs = o["detectors"], o["observables"][:, 0].numpy()
    preds, flags = bench_qec.device_decode(w.decoder, dets, w.chunk)
    f = flags.numpy()
    assert 0 < f.sum() <= w.cap
    nat = w.native.decode_batch_ex(dets.numpy()[f], mode=0)["pred"] & 1
    want = int(((preds.numpy() ^ obs) & 1)[~f].sum() + (nat != obs[f]).sum())
    assert w.drain(w.e2e(_gen(5))) == want


def test_entry_points_default_to_the_card():
    from noisyquantumsimulator_tpu_torch.qec import (cluster_matcher,
                                                     decoders, erasure,
                                                     exact_matcher, memory,
                                                     pauli_frame,
                                                     window_matcher)
    fns = [memory.run_memory, memory.threshold_scan,
           erasure.run_erasure_memory, pauli_frame.build_sampler,
           pauli_frame.sample_circuit, decoders.decoder_for_circuit,
           decoders.MatchingDecoder, exact_matcher.ExactMatcher,
           exact_matcher.HybridMatcher, exact_matcher.TieredMatcher,
           exact_matcher.exact_matcher_for_circuit,
           exact_matcher.tiered_matcher_for_circuit,
           window_matcher.WindowMatcher, window_matcher.EscalatingWindowMatcher,
           window_matcher.window_matcher_for_circuit,
           window_matcher.escalating_matcher_for_circuit,
           cluster_matcher.ClusterMatcher,
           cluster_matcher.EscalatingClusterMatcher,
           cluster_matcher.cluster_matcher_for_circuit,
           bench_qec.build_qec_workload, bench_qec.main_qec]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_qec_exports_the_references_names():
    import noisyquantumsimulator_tpu.qec as jq
    for name in ("run_memory", "MemoryResult", "memory_z_circuit",
                 "build_layout", "code_metrics", "exact_matcher_for_circuit",
                 "tiered_matcher_for_circuit", "window_matcher_for_circuit",
                 "escalating_matcher_for_circuit",
                 "cluster_matcher_for_circuit", "run_erasure_memory"):
        assert hasattr(jq, name) and hasattr(tqec, name), name
