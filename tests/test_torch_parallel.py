"""The port's multi-device layer (parallel/, graft_entry.dryrun_multichip)
on torch.distributed against the JAX reference on the conftest's 8-device
virtual CPU mesh.

One group of 4 gloo ranks is spawned once for the module
(`parallel.mesh.launch`; the ranks run `test_torch_parallel_ranks`, which
imports no JAX) and every check reads its results:

  * the sharded population objective on 13 members (padded to 16) within
    2e-4 of the JAX sharded objective (the reference's own bound between
    its sharded and unsharded objectives; both run complex128 here) and
    equal to the port's unsharded objective;
  * the BB rank body, fed fixed errors, gives per-rank and all_reduced
    counts equal to a numpy recount of its estimates;
  * dryrun_multichip(4)'s fidelities within 1e-5 of the same sweep step
    computed with the JAX package's evolve_rhos and compute_cz_fidelity at
    complex64 (the reference's dry run only prints its value);
  * run_bb_memory_sharded's p_L and convergence overlap the JAX run's 95%
    Wilson intervals, and its mean syndrome weight the JAX run's 95%
    interval (normal, with the exact variance of a shot's syndrome weight
    under iid errors: the checks of a shot are correlated, so a Wilson
    interval over checks would be too narrow). The random streams differ.

The mesh factorization is held for n = 1..8 and three axis layouts; a mesh
larger than its group raises.
"""
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_parallel_ranks as ranks
from noisyquantumsimulator_tpu.gate.fidelity import compute_cz_fidelity
from noisyquantumsimulator_tpu.optimize import apparatus as japp
from noisyquantumsimulator_tpu.optimize import engine as jeng
from noisyquantumsimulator_tpu.parallel import mesh as jmesh
from noisyquantumsimulator_tpu.parallel.bb_mc import (
    run_bb_memory_sharded as jbb_sharded)
from noisyquantumsimulator_tpu.parallel.de_sharded import (
    make_population_objective_sharded as jsharded)
from noisyquantumsimulator_tpu.qec.ldpc import logical_operators, small_bb_code
from noisyquantumsimulator_tpu.solver.propagator import Schedule, evolve_rhos
from noisyquantumsimulator_tpu_torch.graft_entry import dryrun_multichip
from noisyquantumsimulator_tpu_torch.optimize.engine import problem_from_numpy
from noisyquantumsimulator_tpu_torch.parallel import mesh as tmesh
from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

torch.set_num_threads(1)

WORLD = 4
BUILDER_KW = {"n_steps": 48}
BB_P, BB_ITERS, BB_ROWS = 0.02, 20, 64           # fixed errors, rows a rank
STAT = dict(p=0.01, n_iters=20, seed=3)          # 2048 shots on each side
METRICS = ("avg_fidelity", "f00", "f01", "f10", "f11", "cz_phase_fidelity",
           "controlled_phase_deg", "phase_error_deg", "gate_time_us")


@pytest.fixture(scope="module")
def jax_problem():
    app = japp.ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jeng.build_fixed_problem(app, app.make_full_noise())


@pytest.fixture(scope="module")
def pop():
    """13 members: pads to 16 over 4 ranks (and over the reference's 8)."""
    rng = np.random.default_rng(0)
    return np.column_stack([rng.uniform(8.0, 12.0, 13), rng.uniform(0.2, 1.2, 13),
                            rng.uniform(1.0, 1.5, 13), rng.uniform(4.0, 5.5, 13),
                            rng.uniform(0.01, 0.03, 13)])


@pytest.fixture(scope="module")
def bb_errors():
    Hx, Hz = small_bb_code()
    rng = np.random.default_rng(11)
    return Hx, Hz, (rng.random((WORLD * BB_ROWS, Hz.shape[1])) < BB_P).astype(np.uint8)


@pytest.fixture(scope="module")
def spawned(jax_problem, pop, bb_errors):
    Hx, Hz, errors = bb_errors
    problem = problem_from_numpy(vars(jax_problem), device="cpu",
                                 dtype=torch.complex128)
    out = tmesh.launch(ranks.four_rank_checks, WORLD,
                       args=(problem, pop, BUILDER_KW, Hx, Hz, errors, BB_P,
                             BB_ITERS, dict(STAT, shots_per_device=512)),
                       device="cpu", timeout=300)
    assert [o["rank"] for o in out] == list(range(WORLD))
    assert all(o["world"] == WORLD for o in out)
    return out


# ---- the mesh --------------------------------------------------------------

@pytest.mark.parametrize("axes", [("sweep", "shots"), ("pop",), ("a", "b", "c")])
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_reference(n, axes):
    assert tmesh.mesh_shape(n, axes) == jmesh.make_mesh(n, axes).devices.shape


def test_pad_to_multiple_matches_reference():
    x = np.arange(26).reshape(13, 2)
    for m in (1, 4, 8, 13):
        got, n = tmesh.pad_to_multiple(x, m)
        ref, n_ref = jmesh.pad_to_multiple(x, m)
        assert n == n_ref == 13 and np.array_equal(got, ref)


def test_make_mesh_raises_without_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(1)


def test_mesh_raises_when_the_group_is_smaller():
    """One gloo rank: a 1-rank mesh holds every row; a 4-rank mesh and the
    4-rank dry run raise (no virtual provisioning)."""
    with tempfile.TemporaryDirectory() as tmp:
        tmesh.init_rank(0, 1, os.path.join(tmp, "store"), "cpu")
        try:
            mesh = tmesh.make_mesh(axis_names=("pop",))
            x = torch.arange(10)
            assert torch.equal(tmesh.local_rows(x, mesh), x)
            with pytest.raises(ValueError, match="4 ranks requested"):
                tmesh.make_mesh(4)
            with pytest.raises(ValueError, match="4 ranks requested"):
                dryrun_multichip(4, device="cpu")
            with pytest.raises(ValueError, match="lay out"):
                tmesh.make_mesh(1, shape=(2, 1))
        finally:
            dist.destroy_process_group()


# ---- the sharded population objective -------------------------------------

def test_sharded_objective_matches_reference(jax_problem, pop, spawned):
    mesh = jmesh.make_mesh(8, axis_names=("pop",))
    jc, jm = jsharded(jax_problem, "smooth_jp", mesh=mesh, **BUILDER_KW)(pop)
    tc, tm = spawned[0]["sharded"]
    assert tc.shape == (13,)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=2e-4, atol=2e-4)
    for k in METRICS:
        np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=2e-4, atol=2e-4)


def test_sharded_objective_equals_unsharded(spawned):
    uc, um = spawned[0]["unsharded"]
    for o in spawned:
        c, m = o["sharded"]
        assert np.array_equal(c, uc)
        assert all(np.array_equal(m[k], um[k]) for k in METRICS)


# ---- the BB rank body --------------------------------------------------------

def _recount(errors, Hx, Hz, belief):
    """(failures, converged, syndrome weight) in numpy integers."""
    Lz = logical_operators(Hx, Hz).astype(np.int64)
    e = errors.astype(np.int64)
    residual = e ^ (belief < 0).astype(np.int64)
    converged = ~((residual @ Hz.T.astype(np.int64)) % 2).any(axis=1)
    fail = ((residual @ Lz.T) % 2).any(axis=1) | ~converged
    syn = (e @ Hz.T.astype(np.int64)) % 2
    return np.array([fail.sum(), converged.sum(), syn.sum()])


def test_bb_rank_body_counts_equal_numpy_recount(bb_errors, spawned):
    Hx, Hz, errors = bb_errors
    total = np.zeros(3, np.int64)
    for r, o in enumerate(spawned):
        rows = errors[r * BB_ROWS:(r + 1) * BB_ROWS]
        mine = _recount(rows, Hx, Hz, o["bb_belief"])
        assert np.array_equal(o["bb_rank_counts"], mine)
        total += mine
    assert all(np.array_equal(o["bb_counts"], total) for o in spawned)
    assert total[0] > 0 and total[1] > WORLD * BB_ROWS // 2


# ---- the dry run -------------------------------------------------------------

def _graft_reference():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("_reference_graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_sweep_matches_reference(spawned):
    """The same sweep step in the JAX package: scales linspace(0.9, 1.1, 8)
    (a (4, 1) mesh: 2 points a rank, one shot block), 16 segments,
    complex64."""
    L0, Cp, Cm, phases0, dts, rho0s, kets = _graft_reference()._build_small_problem(16)
    r = spawned[0]["dryrun"]
    assert r["sweep"] == 8 and r["shot_blocks"] == 1

    def point(scale):
        sched = Schedule(jnp.ones_like(phases0), scale * phases0, dts)
        rhos = evolve_rhos(jnp.asarray(L0), jnp.asarray(Cp), jnp.asarray(Cm),
                           sched, jnp.asarray(rho0s))
        return compute_cz_fidelity(rhos, kets)[1]

    ref = np.asarray(jax.jit(jax.vmap(point))(jnp.asarray(r["scales"])))
    # a point within the repository's complex64 tier (its 16 segments take 7
    # squarings each, the points differ by up to 2.2e-05); their mean
    # within 1e-5
    assert np.abs(r["per_point"] - ref).max() <= 1e-4
    assert abs(r["mean_F"] - float(ref.mean())) <= 1e-5
    assert all(o["dryrun"]["mean_F"] == r["mean_F"] for o in spawned)


def test_dryrun_qec_and_de_are_physical(spawned):
    r = spawned[0]["dryrun"]
    assert 0.0 < r["qec"]["detector_fraction"] < 0.5
    assert r["qec"]["bb"]["shots"] == 256 * WORLD
    assert 0.0 <= r["qec"]["bb"]["p_logical_shot"] < 0.5
    assert 0.9 < r["de"]["F"] <= 1.0 + 1e-6
    assert np.all(np.diff(r["de"]["history"]) <= 0.0)


# ---- the sharded BB Monte Carlo, statistically -------------------------------

def _overlap(a, b):
    return a[0] <= b[1] and b[0] <= a[1]


def _syndrome_ci(weight, shots, Hz, p):
    """95% interval of the mean syndrome weight a check from `weight`
    fired checks in `shots` shots. A check fires with the parity of its
    support's errors: with X_A = prod(1 - 2 e_i), S_A = (1 - X_A) / 2 and
    E[X_A X_B] = (1 - 2p)^|A xor B|, so Cov(S_A, S_B) =
    ((1-2p)^(|A|+|B|-2|A and B|) - (1-2p)^(|A|+|B|)) / 4."""
    H = Hz.astype(np.int64)
    w = H.sum(axis=1)
    k = H @ H.T
    r = 1.0 - 2.0 * p
    cov = (r ** (w[:, None] + w[None, :] - 2 * k) - r ** (w[:, None] + w[None, :])) / 4
    hw = 1.96 * np.sqrt(cov.sum() / shots) / H.shape[0]
    mean = weight / (shots * H.shape[0])
    return mean - hw, mean + hw


def test_bb_memory_sharded_overlaps_reference_ci(bb_errors, spawned):
    Hx, Hz, _ = bb_errors
    t = spawned[0]["bb_stat"]
    j = jbb_sharded(Hx, Hz, shots_per_device=256, mesh=jmesh.make_mesh(8), **STAT)
    assert t["shots"] == j["shots"] == 2048 and t["code"] == j["code"]
    assert all(o["bb_stat"] == t for o in spawned)
    n = 2048
    for key, count in (("p_logical_shot", "n_fail"),
                       ("bp_converged_frac", "n_converged")):
        assert t[count] == round(t[key] * n)
        assert _overlap(wilson_ci(t[count], n), wilson_ci(round(j[key] * n), n)), key
    m = Hz.shape[0]
    assert t["syndrome_weight"] == round(t["syndrome_weight_mean"] * n * m)
    ref_w = round(j["syndrome_weight_mean"] * n * m)
    assert _overlap(_syndrome_ci(t["syndrome_weight"], n, Hz, STAT["p"]),
                    _syndrome_ci(ref_w, n, Hz, STAT["p"]))


# ---- the port stays free of JAX ----------------------------------------------

_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|noisyquantumsimulator_tpu)(?:[.\s,]|$)",
                     re.M)
_NEW_MODULES = """
import subprocess, sys
calls = []
_Popen = subprocess.Popen
class Spy(_Popen):
    def __init__(self, *a, **k):
        calls.append(a)
        super().__init__(*a, **k)
subprocess.Popen = Spy
import noisyquantumsimulator_tpu_torch.graft_entry
import noisyquantumsimulator_tpu_torch.parallel
import noisyquantumsimulator_tpu_torch.qec.lattice_surgery
import noisyquantumsimulator_tpu_torch.qec.nn_decoder
import noisyquantumsimulator_tpu_torch.solver.reference
import noisyquantumsimulator_tpu_torch.utils.visualization
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "matplotlib")
             or m.startswith("noisyquantumsimulator_tpu."))
assert not bad, bad
assert not calls, calls
print("OK")
"""


def test_port_imports_no_jax():
    """No source file of the port, and neither chip_smoke.py nor the module
    it shares with the tools, imports jax or the JAX package; importing this
    slice's modules loads neither (nor matplotlib, which the plots import
    when they draw) and starts no process."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py"),
             os.path.join(root, "tools", "chip_common.py")]
    for d, _, names in os.walk(os.path.join(root, "noisyquantumsimulator_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 90
    hits = [(f, m.group(0).strip()) for f in files
            for m in _IMPORT.finditer(open(f).read())]
    assert not hits, hits
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert "OK" in out.stdout, out.stderr[-2000:]
