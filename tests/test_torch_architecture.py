"""The port's architecture loop against the JAX package: topology ->
compiler -> scheduler -> executor on all three platforms, observability,
the BB movement planner (`qec/ldpc_layout`) and the color codes.

Topology, scheduler, compiler, layout planner and color-code layouts are
copied host code: equal to the reference on the same inputs. The executor's
error circuit is equal instruction for instruction; its frame Monte Carlo
(torch, a torch.Generator) is held statistically: every qubit's flip and
phase rate within 5 binomial sigma of the exact marginals
(`test_torch_cuda.exact_frame_rates`) and of the reference's own run. The
reference's executor jits a fully unrolled instruction loop, so its side of
that comparison stays a few dozen instructions; the port runs a d = 3
extraction circuit (2 rounds) compiled for each platform.
"""
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.primitives import cavity_backend as jcb
from noisyquantumsimulator_tpu.primitives import backend as jnb
from noisyquantumsimulator_tpu.primitives import ion_backend as jion
from noisyquantumsimulator_tpu.qec import color_code as jcc
from noisyquantumsimulator_tpu.qec import compiler as jcomp
from noisyquantumsimulator_tpu.qec import executor as jex
from noisyquantumsimulator_tpu.qec import ldpc as jldpc
from noisyquantumsimulator_tpu.qec import ldpc_layout as jlay
from noisyquantumsimulator_tpu.qec import scheduler as jsch
from noisyquantumsimulator_tpu.qec import topology as jtop
from noisyquantumsimulator_tpu_torch import qec as tqec
from noisyquantumsimulator_tpu_torch.primitives import cavity_backend as tcb
from noisyquantumsimulator_tpu_torch.primitives import backend as tnb
from noisyquantumsimulator_tpu_torch.primitives import ion_backend as tion
from noisyquantumsimulator_tpu_torch.qec import color_code as tcc
from noisyquantumsimulator_tpu_torch.qec import compiler as tcomp
from noisyquantumsimulator_tpu_torch.qec import executor as tex
from noisyquantumsimulator_tpu_torch.qec import ldpc as tldpc
from noisyquantumsimulator_tpu_torch.qec import ldpc_layout as tlay
from noisyquantumsimulator_tpu_torch.qec import scheduler as tsch
from noisyquantumsimulator_tpu_torch.qec import topology as ttop
from noisyquantumsimulator_tpu_torch.utils import observability as tobs

from test_torch_cuda import exact_frame_rates, extraction_gates, frame_rate_z
from test_torch_primitives import assert_same

torch.set_num_threads(1)

PLATFORMS = ("neutral_atoms", "trapped_ions", "cavity_qed")
SHOTS = 8000


def _jgates(gates):
    return [jcomp.Gate(g.name, g.qubits, g.angle) for g in gates]


# --- observability --------------------------------------------------------

def test_metrics_registry_roundtrip():
    """The span recorder that replaced the registry: under a profiler, nested
    spans keep their parent's index and the index of their nqs.step span;
    `clear()` drops them."""
    tobs.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tobs.span("nqs.plan"):
            pass
        with tobs.span("nqs.step"):
            with tobs.span("nqs.scan"):
                with tobs.span("inner"):
                    pass
    rec = tobs.spans()
    assert [(r.name, r.parent, r.step) for r in rec] == [
        ("nqs.plan", -1, -1), ("nqs.step", -1, 1), ("nqs.scan", 1, 1), ("inner", 2, 1)]
    assert all(r.start_ns <= r.end_ns for r in rec)
    assert rec[1].start_ns <= rec[2].start_ns and rec[2].end_ns <= rec[1].end_ns
    tobs.clear()
    assert tobs.spans() == []


def test_profile_trace_annotate_and_stamps(tmp_path):
    """A span shares the profiler trace's clock: inside a record_function it
    starts and ends within 1 ms of it, after converting the trace's `ts` by
    its `baseTimeNanoseconds`. The stamp keeps its keys; the registry and
    profiler helpers that nothing read are gone."""
    import json
    # a process's first record_function stamps its start 0.3-1.5 ms before
    # it returns
    with torch.profiler.record_function("warm"), tobs.span("nqs.step"):
        pass
    tobs.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("region"):
                with tobs.span("nqs.step"):
                    torch.ones(64).sum()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace["baseTimeNanoseconds"])
    marks = sorted((e for e in trace["traceEvents"] if e.get("name") == "region"),
                   key=lambda e: e["ts"])
    rec = tobs.spans()
    assert len(marks) == len(rec) == 3
    for e, r in zip(marks, rec):
        a = base + round(e["ts"] * 1e3)
        b = a + round(e["dur"] * 1e3)
        assert a - 1e6 <= r.start_ns <= a + 1e6 and b - 1e6 <= r.end_ns <= b + 1e6
    tobs.clear()
    stamp = tobs.provenance_stamp()
    assert set(stamp) == {"generated_at_commit", "backend", "device",
                          "generated_at"}
    assert stamp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    for gone in ("MetricsRegistry", "metrics", "profile_trace", "annotate",
                 "device_memory_stats", "log_compile_time"):
        assert not hasattr(tobs, gone)


# --- topology -------------------------------------------------------------

TOPOLOGIES = {
    "grid": lambda m: m.grid_topology(3, 3),
    "grid_diag": lambda m: m.grid_topology(3, 4, diagonal=True),
    "graph": lambda m: m.graph_topology([(0, 0), (1, 0), (2, 0), (3, 0)],
                                        [(0, 2), (2, 3)]),
    "zoned": lambda m: m.zoned_topology([3, 2]),
    "reconfigurable": lambda m: m.reconfigurable_topology(2, 3),
}


@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_topology_bit_equal(kind):
    t, j = TOPOLOGIES[kind](ttop), TOPOLOGIES[kind](jtop)
    assert_same(vars(t), vars(j), 0.0)
    n = t.n_qubits
    for a in range(n):
        assert t.get_neighbors(a) == j.get_neighbors(a)
        for b in range(n):
            assert t.get_path(a, b) == j.get_path(a, b)
            assert t.get_hop_distance(a, b) == j.get_hop_distance(a, b)
            assert t.can_interact(a, b) == j.can_interact(a, b)
            assert t.get_distance(a, b) == j.get_distance(a, b)
    pairs = [(0, 1), (1, 2), (n - 2, n - 1)]
    for r in (2e-6, 4e-6, 1e-5):
        assert t.blockade_conflicts(pairs, r) == j.blockade_conflicts(pairs, r)


# --- scheduler ------------------------------------------------------------

SCHEDULES = {
    "parallel_far": ((3, 3), [("cz", (0, 1), 1e-6), ("cz", (7, 8), 1e-6)]),
    "blockade": ((1, 4), [("cz", (0, 1), 1e-6), ("cz", (2, 3), 1e-6)]),
    "dependency": ((1, 3), [("sq", (0,), 1e-6), ("cz", (0, 1), 1e-6)]),
    "measurement": ((1, 2), [("measure", (0,), 5e-6), ("sq", (1,), 1e-6)]),
    "mixed": ((1, 4), [("cz", (0, 1), 1e-6), ("cz", (2, 3), 1e-6),
                       ("sq", (0,), 0.5e-6), ("measure", (3,), 2e-6),
                       ("sq", (1,), 0.3e-6), ("cz", (1, 2), 1e-6)]),
}


@pytest.mark.parametrize("strategy", ["asap", "alap", "list"])
@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_result_equal(case, strategy):
    shape, ops = SCHEDULES[case]
    t = tsch.Scheduler(ttop.grid_topology(*shape)).schedule(
        [tsch.Op(*o) for o in ops], strategy)
    j = jsch.Scheduler(jtop.grid_topology(*shape)).schedule(
        [jsch.Op(*o) for o in ops], strategy)
    assert_same(t, j, 0.0)
    assert t.timeline() == j.timeline()


def test_scheduler_rejects_what_the_reference_rejects():
    top = ttop.grid_topology(3, 3)
    with pytest.raises(ValueError, match="route first"):
        tsch.Scheduler(top).schedule([tsch.Op("cz", (0, 8), 1e-6)])
    with pytest.raises(ValueError, match="Unknown strategy"):
        tsch.Scheduler(top).schedule([], "greedy")


# --- compiler -------------------------------------------------------------

@pytest.fixture(scope="module")
def compiled_d3():
    """The d = 3 extraction circuit (2 rounds) compiled onto a 5 x 5 grid
    for each platform by both packages."""
    gates = extraction_gates(3, 2)
    return {p: (tcomp.compile_circuit(gates, ttop.grid_topology(5, 5),
                                      platform=p),
                jcomp.compile_circuit(_jgates(gates),
                                      jtop.grid_topology(5, 5), platform=p))
            for p in PLATFORMS}


@pytest.mark.parametrize("platform", PLATFORMS)
def test_compiled_circuit_equal(compiled_d3, platform):
    t, j = compiled_d3[platform]
    assert_same(t, j, 0.0)
    assert t.counts() == j.counts() and t.n_swaps > 0
    assert {op.name for op in t.ops} <= tcomp.NATIVE_SETS[platform]


@pytest.mark.parametrize("routing,schedule", [("swap", "asap"),
                                              ("move", "asap"),
                                              ("auto", "alap"),
                                              ("move", "list")])
def test_compile_strategies_equal(routing, schedule):
    ring = [("cz", (0, 1)), ("h", (1,)), ("cz", (1, 2)), ("cx", (2, 3)),
            ("swap", (0, 2)), ("ry", (3,), 0.4), ("cz", (3, 0)),
            ("s", (0,)), ("t", (2,)), ("x", (1,)), ("y", (3,)), ("z", (0,)),
            ("rx", (2,), -0.7), ("rz", (1,), 0.2)]
    for p in PLATFORMS:
        t = tcomp.compile_circuit([tcomp.Gate(*g) for g in ring],
                                  ttop.reconfigurable_topology(2, 3), p,
                                  routing_strategy=routing,
                                  schedule_strategy=schedule)
        j = jcomp.compile_circuit([jcomp.Gate(*g) for g in ring],
                                  jtop.reconfigurable_topology(2, 3), p,
                                  routing_strategy=routing,
                                  schedule_strategy=schedule)
        assert_same(t, j, 0.0)


def test_compiler_stages_equal():
    gates = [("h", (0,)), ("cx", (0, 1)), ("cz", (1, 2)), ("t", (2,)),
             ("swap", (2, 0)), ("rz", (0,), 0.3), ("rz", (0,), -0.3)]
    for p in PLATFORMS:
        assert_same(tcomp.decompose([tcomp.Gate(*g) for g in gates], p),
                    jcomp.decompose([jcomp.Gate(*g) for g in gates], p), 0.0)
    assert_same(tcomp.peephole_optimize([tcomp.Gate(*g) for g in gates]),
                jcomp.peephole_optimize([jcomp.Gate(*g) for g in gates]), 0.0)
    native = tcomp.decompose(extraction_gates(3, 1), "neutral_atoms")
    assert tcomp.map_qubits(native, ttop.grid_topology(5, 5)) == \
        jcomp.map_qubits(_jgates(native), jtop.grid_topology(5, 5))
    with pytest.raises(ValueError, match="do not fit"):
        tcomp.map_qubits(native, ttop.grid_topology(3, 3))
    with pytest.raises(ValueError, match="Cannot decompose"):
        tcomp.decompose([tcomp.Gate("ccx", (0, 1, 2))])


# --- executor -------------------------------------------------------------

@pytest.fixture(scope="module")
def backends():
    """Every backend kind, both packages, from the shipped records."""
    return {"none": (None, None),
            "neutral": (tnb.NeutralAtomBackend(device="cpu"),
                        jnb.NeutralAtomBackend()),
            "ion": (tion.IonBackend(device="cpu"), jion.IonBackend()),
            "cavity": (tcb.CavityBackend(device="cpu"), jcb.CavityBackend())}


PLATFORM_OF = {"none": "neutral_atoms", "neutral": "neutral_atoms",
               "ion": "trapped_ions", "cavity": "cavity_qed"}


def _circuits_equal(t, j):
    assert t.n_qubits == j.n_qubits
    assert len(t.instructions) == len(j.instructions)
    for a, b in zip(t.instructions, j.instructions):
        assert a.name == b.name and np.array_equal(a.targets, b.targets)
        assert (a.arg is None) == (b.arg is None)
        if a.arg is not None:
            assert abs(a.arg - b.arg) <= 1e-12
        assert (a.probs is None) == (b.probs is None)
        if a.probs is not None:
            assert np.abs(np.asarray(a.probs) - np.asarray(b.probs)).max() \
                <= 1e-12


@pytest.mark.parametrize("kind", list(PLATFORM_OF))
def test_error_circuit_equal(compiled_d3, backends, kind):
    t_comp, j_comp = compiled_d3[PLATFORM_OF[kind]]
    tb, jb = backends[kind]
    t = tex.compiled_to_error_circuit(t_comp, tb)
    j = jex.compiled_to_error_circuit(j_comp, jb)
    _circuits_equal(t, j)
    names = {ins.name for ins in t.instructions}
    assert "PAULI_CHANNEL_2" in names if tb is not None else \
        "DEPOLARIZE2" in names
    assert "DEPOLARIZE1" in names and "X_ERROR" in names


@pytest.mark.parametrize("kind", list(PLATFORM_OF))
def test_execute_rates_match_exact_marginals(compiled_d3, backends, kind):
    comp = compiled_d3[PLATFORM_OF[kind]][0]
    b = backends[kind][0]
    res = tex.execute(comp, b, shots=SHOTS, seed=1, device="cpu")
    assert frame_rate_z(res, tex.compiled_to_error_circuit(comp, b)) <= 5.0
    assert res.n_ops == len(comp.ops)
    assert res.total_time == comp.schedule.total_time
    assert res.error_budget == {k: float(v) for k, v in comp.counts().items()}
    assert 0.0 < res.p_any_error <= 1.0


def _small_compiled(m, platform):
    """tests/test_qec.py:360-366's circuit (a few dozen instructions)."""
    gates = [m.Gate("H", (0,)), m.Gate("CX", (0, 1)), m.Gate("CZ", (1, 2)),
             m.Gate("T", (2,))]
    top = (ttop if m is tcomp else jtop).grid_topology(3, 3)
    return m.compile_circuit(gates, top, platform=platform)


@pytest.mark.parametrize("kind", list(PLATFORM_OF))
def test_execute_matches_the_reference_run(backends, kind):
    tb, jb = backends[kind]
    t_comp = _small_compiled(tcomp, PLATFORM_OF[kind])
    j_comp = _small_compiled(jcomp, PLATFORM_OF[kind])
    N = SHOTS
    t = tex.execute(t_comp, tb, shots=N, seed=3, device="cpu")
    j = jex.execute(j_comp, jb, shots=N, seed=3)
    circuit = tex.compiled_to_error_circuit(t_comp, tb)
    assert len(circuit.instructions) <= 40
    assert frame_rate_z(t, circuit) <= 5.0
    assert frame_rate_z(j, circuit) <= 5.0
    for a, b, r in zip((t.per_qubit_flip_rate, t.per_qubit_phase_rate),
                       (j.per_qubit_flip_rate, j.per_qubit_phase_rate),
                       exact_frame_rates(circuit)):
        sd = np.sqrt(2 * r * (1 - r) / N)
        assert np.all(np.abs(a - b) <= 5 * sd)
    assert t.error_budget == j.error_budget
    assert (t.n_ops, t.total_time) == (j.n_ops, j.total_time)


def test_execute_zero_noise_is_exactly_zero(compiled_d3):
    """tests/test_qec.py:383-388 on the port."""
    r = tex.execute(compiled_d3["neutral_atoms"][0], shots=2000, seed=2,
                    device="cpu", cz_pauli_probs=np.eye(16)[0], p1=0.0,
                    p_meas=0.0, t1=1e9, t2=1e9)
    assert r.p_any_error == 0.0
    assert not r.per_qubit_flip_rate.any() and not r.per_qubit_phase_rate.any()


def test_execute_clears_frames_at_mr():
    """A measure op becomes MR, which clears both frames: the measured qubit
    ends clean, the others keep their rates (port and reference alike)."""
    ops = [("rxy", (0,), 1e-6), ("rxy", (1,), 1e-6), ("cz", (0, 1), 1e-6),
           ("measure", (1,), 1e-6), ("rxy", (2,), 1e-6), ("cz", (1, 2), 1e-6)]
    kw = dict(p1=0.03, p_meas=0.01, cz_pauli_probs=None)
    t = tex.execute(tcomp.CompiledCircuit(
        [tsch.Op(*o) for o in ops], {}, 0, 0, "neutral_atoms"),
        shots=SHOTS, seed=4, device="cpu", **kw)
    j = jex.execute(jcomp.CompiledCircuit(
        [jsch.Op(*o) for o in ops], {}, 0, 0, "neutral_atoms"),
        shots=SHOTS, seed=4, **kw)
    circuit = tex.compiled_to_error_circuit(tcomp.CompiledCircuit(
        [tsch.Op(*o) for o in ops], {}, 0, 0, "neutral_atoms"), **kw)
    assert [ins.name for ins in circuit.instructions] == [
        "DEPOLARIZE1", "DEPOLARIZE1", "DEPOLARIZE2", "MR", "DEPOLARIZE1",
        "DEPOLARIZE2"]
    fx, fz = exact_frame_rates(circuit)
    # qubit 1 keeps only what the last DEPOLARIZE2 (p = 10 p1) puts there
    assert abs(fx[1] - 8 * 0.3 / 15) < 1e-12 and abs(fz[1] - 8 * 0.3 / 15) < 1e-12
    assert frame_rate_z(t, circuit) <= 5.0 and frame_rate_z(j, circuit) <= 5.0
    assert t.total_time == j.total_time == 0.0


def test_execute_is_exported():
    assert tqec.execute is tex.execute
    import noisyquantumsimulator_tpu_torch.primitives as tprim
    assert not hasattr(tprim, "CavityBackend")


# --- the BB movement planner and the color codes ----------------------------

def test_bb_extraction_plan_equal():
    Hx, Hz = tldpc.small_bb_code()
    assert_same(tlay.plan_bb_extraction(Hz), jlay.plan_bb_extraction(Hz), 0.0)
    assert_same(tlay.plan_bb_extraction(Hx, spacing=4e-6, T2=0.5),
                jlay.plan_bb_extraction(Hx, spacing=4e-6, T2=0.5), 0.0)
    t, j = tlay.bb_extraction_study(6, 6), jlay.bb_extraction_study(6, 6)
    assert_same(t, j, 0.0)
    assert t["code"] == "[[72,12]]"


@pytest.mark.parametrize("d", [3, 5, 7])
def test_color_code_bit_equal(d):
    t, j = tcc.triangular_color_code(d), jcc.triangular_color_code(d)
    assert_same(t, j, 0.0)
    assert np.array_equal(t.logicals(), j.logicals())
    assert (t.n, t.k) == (j.n, j.k) == ((3 * d * d + 1) // 4, 1)
    assert t.transversal_gates() == j.transversal_gates()
    assert tldpc.check_css(t.H, t.H)
    with pytest.raises(ValueError, match="odd d"):
        tcc.triangular_color_code(4)


@pytest.mark.parametrize("d,p", [(3, 0.02), (5, 0.03)])
def test_color_memory_within_ci(d, p):
    from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci
    shots = 2000
    t = tcc.run_color_memory(d, p=p, shots=shots, device="cpu")
    j = jcc.run_color_memory(d, p=p, shots=shots)
    lo, hi = wilson_ci(int(round(t.p_logical_shot * shots)), shots)
    jlo, jhi = wilson_ci(int(round(j.p_logical_shot * shots)), shots)
    assert lo <= jhi and jlo <= hi
    assert (t.n, t.k, t.syndrome_weight_mean) == (j.n, j.k,
                                                  j.syndrome_weight_mean)
    assert t.decoder_converged_frac == j.decoder_converged_frac == 1.0
    H = tcc.steane_code().H
    assert np.array_equal(H, jcc.steane_code().H)
    assert tldpc.css_n_k(H, H) == jldpc.css_n_k(H, H) == (7, 1)


def _defaults():
    import dataclasses
    import inspect
    from noisyquantumsimulator_tpu_torch.gate import cavity_gate
    from noisyquantumsimulator_tpu_torch.solver import circuit_sim
    fns = {"simulate_cavity_gate": cavity_gate.simulate_cavity_gate,
           "execute": tex.execute,
           "run_color_memory": tcc.run_color_memory,
           "DensityMatrixSimulator": circuit_sim.DensityMatrixSimulator,
           "TrajectorySimulator": circuit_sim.TrajectorySimulator}
    out = {k: inspect.signature(f).parameters["device"].default
           for k, f in fns.items()}
    field, = (f for f in dataclasses.fields(tcb.CavityBackend)
              if f.name == "device")
    out["CavityBackend"] = field.default
    return out


@pytest.mark.parametrize("name", ["simulate_cavity_gate", "execute",
                                  "run_color_memory", "DensityMatrixSimulator",
                                  "TrajectorySimulator", "CavityBackend"])
def test_entry_points_default_to_the_card(name):
    assert _defaults()[name] == "cuda"
