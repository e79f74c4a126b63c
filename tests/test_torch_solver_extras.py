"""The port's zvode oracle and the solver / expm / fidelity leftovers
against the JAX reference.

Tolerances: the zvode functions are the same host scipy code, so bit-equal.
The float engines (total_propagator_phased, evolve_rhos_trajectory,
expm_apply, the schedule builders and their gradients, dominant_phase_amp,
bell_state_fidelity) within 1e-12 at complex128 / float64 and 1e-5 at
complex64 / float32, absolute, on operands of order one: both packages run
the same algorithm with products summed in different orders. The operands
are the entry point's 32-segment problem, whose segment Liouvillians take
6 squarings under Taylor-16: each squaring doubles the complex64 rounding
error of both packages (at 16 segments, 7 squarings, the two trajectories
sit 2.4e-05 and 3.8e-05 from complex128 and 1.5e-05 apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import expm as sexpm

from noisyquantumsimulator_tpu.gate import fidelity as jfid
from noisyquantumsimulator_tpu.ops import expm as jexpm
from noisyquantumsimulator_tpu.solver import propagator as jprop
from noisyquantumsimulator_tpu.solver import reference as jref
from noisyquantumsimulator_tpu_torch.gate import fidelity as tfid
from noisyquantumsimulator_tpu_torch.graft_entry import build_small_problem
from noisyquantumsimulator_tpu_torch.ops import expm as texpm
from noisyquantumsimulator_tpu_torch.ops.hilbert import HS3
from noisyquantumsimulator_tpu_torch.ops.phase_frame import phase_frame_generator
from noisyquantumsimulator_tpu_torch.solver import propagator as tprop
from noisyquantumsimulator_tpu_torch.solver import reference as tref

torch.set_num_threads(1)

TOL = {torch.complex128: 1e-12, torch.complex64: 1e-5,
       torch.float64: 1e-12, torch.float32: 1e-5}
NP = {torch.complex128: np.complex128, torch.complex64: np.complex64,
      torch.float64: np.float64, torch.float32: np.float32}
DTYPES = [torch.complex128, torch.complex64]


def _close(got, ref, dtype):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= TOL[dtype]


@pytest.fixture(scope="module")
def small():
    """The 3-level noisy two-atom problem of the entry point (32 segments),
    complex128, its phase-frame generator and its shared segment
    propagator."""
    L0, Cp, Cm, phases, dts, rho0s, kets = build_small_problem(
        32, dtype=torch.complex128)
    g = phase_frame_generator(L0, Cp, Cm, HS3)
    assert g is not None
    U_base = sexpm((L0 + Cp + Cm) * dts[0])
    return dict(L0=L0, Cp=Cp, Cm=Cm, phases=phases, dts=dts, rho0s=rho0s,
                kets=kets, g=g, U_base=U_base)


# ---- the zvode oracle: the same scipy code, bit-equal ---------------------

@pytest.fixture(scope="module")
def zvode_inputs():
    rng = np.random.default_rng(5)
    D = 3
    Hs = []
    for _ in range(3):
        A = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
        Hs.append(A + A.conj().T)
    c_ops = [0.3 * (rng.standard_normal((D, D))
                    + 1j * rng.standard_normal((D, D))) for _ in range(2)]
    psi = rng.standard_normal(D) + 1j * rng.standard_normal(D)
    psi /= np.linalg.norm(psi)
    return Hs, [0.1, 0.0, 0.25], np.outer(psi, psi.conj()), c_ops, psi


def test_liouvillian_np_bit_equal(zvode_inputs):
    Hs, _, _, c_ops, _ = zvode_inputs
    assert np.array_equal(tref.liouvillian_np(Hs[0], c_ops),
                          jref.liouvillian_np(Hs[0], c_ops))


def test_mesolve_zvode_bit_equal(zvode_inputs):
    Hs, dts, rho0, c_ops, _ = zvode_inputs
    got = tref.mesolve_zvode(Hs, dts, rho0, c_ops)
    assert np.array_equal(got, jref.mesolve_zvode(Hs, dts, rho0, c_ops))
    assert abs(np.trace(got) - 1.0) < 1e-8


def test_mesolve_zvode_liouvillian_bit_equal(zvode_inputs):
    Hs, dts, rho0, c_ops, _ = zvode_inputs
    Ls = [tref.liouvillian_np(H, c_ops) for H in Hs]
    got = tref.mesolve_zvode_liouvillian(Ls, dts, rho0)
    assert np.array_equal(got, jref.mesolve_zvode_liouvillian(Ls, dts, rho0))
    assert np.array_equal(got, tref.mesolve_zvode(Hs, dts, rho0, c_ops))


def test_sesolve_zvode_bit_equal(zvode_inputs):
    Hs, dts, _, _, psi = zvode_inputs
    got = tref.sesolve_zvode(Hs, dts, psi)
    assert np.array_equal(got, jref.sesolve_zvode(Hs, dts, psi))
    assert abs(np.linalg.norm(got) - 1.0) < 1e-7


def test_solver_package_exports_the_oracle():
    from noisyquantumsimulator_tpu_torch import solver
    assert solver.reference is tref
    assert solver.total_propagator_phased is tprop.total_propagator_phased


# ---- total_propagator_phased ---------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 2, 13, 16])
def test_total_propagator_phased_matches_reference(small, dtype, n):
    """Odd and even leaf counts of the telescoped tree, and one leaf."""
    nd = NP[dtype]
    U = small["U_base"].astype(nd)
    ph = small["phases"][:n]
    ref = jprop.total_propagator_phased(jnp.asarray(U), jnp.asarray(small["g"]),
                                        jnp.asarray(ph.astype(U.real.dtype)))
    got = tprop.total_propagator_phased(torch.as_tensor(U), small["g"], ph)
    assert got.dtype == dtype
    _close(got, ref, dtype)


def test_total_propagator_phased_equals_the_segment_product(small):
    """The identity behind the tree: the per-segment product at complex128."""
    n = 13
    ph = small["phases"][:n]
    put = lambda a: torch.as_tensor(a)
    direct = tprop.total_propagator(
        put(small["L0"]), put(small["Cp"]), put(small["Cm"]),
        tprop.Schedule(np.ones(n), ph, small["dts"][:n]))
    got = tprop.total_propagator_phased(put(small["U_base"]), small["g"], ph)
    assert float((got - direct).abs().max()) <= 1e-10


# ---- evolve_rhos_trajectory -----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_evolve_rhos_trajectory_matches_reference(small, dtype):
    nd = NP[dtype]
    n = 8
    rdt = np.float64 if nd == np.complex128 else np.float32
    ops = [small[k].astype(nd) for k in ("L0", "Cp", "Cm", "rho0s")]
    sched = (np.ones(n, rdt), small["phases"][:n].astype(rdt),
             small["dts"][:n].astype(rdt))
    ref = jprop.evolve_rhos_trajectory(
        *[jnp.asarray(a) for a in ops[:3]],
        jprop.Schedule(*[jnp.asarray(a) for a in sched]), jnp.asarray(ops[3]))
    got = tprop.evolve_rhos_trajectory(*[torch.as_tensor(a) for a in ops[:3]],
                                       tprop.Schedule(*sched),
                                       torch.as_tensor(ops[3]))
    assert got.shape == (n + 1, 5, 9, 9) and got.dtype == dtype
    _close(got, ref, dtype)
    last = tprop.evolve_rhos(*[torch.as_tensor(a) for a in ops[:3]],
                             tprop.Schedule(*sched), torch.as_tensor(ops[3]))
    _close(got[-1], last.numpy(), dtype)


# ---- expm_apply -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_expm_apply_matches_reference(dtype):
    rng = np.random.default_rng(7)
    nd = NP[dtype]
    A = (0.4 * (rng.standard_normal((3, 6, 6))
                + 1j * rng.standard_normal((3, 6, 6)))).astype(nd)
    X = (rng.standard_normal((3, 6, 4))
         + 1j * rng.standard_normal((3, 6, 4))).astype(nd)
    ref = jexpm.expm_apply(jnp.asarray(A), jnp.asarray(X))
    got = texpm.expm_apply(torch.as_tensor(A), torch.as_tensor(X))
    _close(got, ref, dtype)


# ---- schedule builders ------------------------------------------------------

def _sched_close(got, ref, dtype):
    for a, b in zip(got[:3], ref[:3]):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_schedule_builders_match_reference(dtype):
    nd = NP[dtype]
    t = lambda x: torch.as_tensor(np.asarray(x, nd))
    j = lambda x: jnp.asarray(np.asarray(x, nd))
    xi, tau = 2.1, 3.3e-7
    _sched_close(tprop.lp_square_schedule(t(xi), t(tau)),
                 jprop.lp_square_schedule(j(xi), j(tau)), dtype)
    sj = (0.311 * np.pi, 1.242, 4.696, 10.09)
    _sched_close(tprop.smooth_jp_schedule(*map(t, sj), n_steps=40),
                 jprop.smooth_jp_schedule(*map(j, sj), n_steps=40), dtype)
    bb = (np.array([1.0, 2.5, 2.4, 7.0]), np.array([0.0, 1.1, -0.4, 2.0, 0.3]),
          9.5, 2.0)
    _sched_close(tprop.bangbang_schedule(t(bb[0]), t(bb[1]), t(bb[2]), bb[3]),
                 jprop.bangbang_schedule(j(bb[0]), j(bb[1]), j(bb[2]), bb[3]),
                 dtype)
    t_env = lambda tm: torch.sin(tm * 1e7) ** 2
    j_env = lambda tm: jnp.sin(tm * 1e7) ** 2
    got = tprop.shaped_lp_schedule(t_env, t(xi), t(tau), n_steps=25)
    _sched_close(got, jprop.shaped_lp_schedule(j_env, j(xi), j(tau), n_steps=25),
                 dtype)
    cat = tprop.concat_schedules(got, tprop.lp_square_schedule(t(xi), t(tau)))
    jcat = jprop.concat_schedules(
        jprop.shaped_lp_schedule(j_env, j(xi), j(tau), n_steps=25),
        jprop.lp_square_schedule(j(xi), j(tau)))
    assert cat.dts.shape == (52,)
    _sched_close(cat, jcat, dtype)


def test_schedule_builders_take_host_numbers():
    s = tprop.smooth_jp_schedule(0.3, 1.2, 4.7, 10.0, n_steps=7)
    assert all(a.dtype == torch.float64 and a.shape == (7,) for a in s[:3])
    b = tprop.bangbang_schedule([1.0, 3.0], [0.0, 1.0, 2.0], 4.0, 2.0)
    assert b.dts.tolist() == [0.5, 1.0, 0.5]


def test_schedule_builder_gradients_match_reference(small):
    """d F / d (A, omega_mod, phi_offset) through smooth_jp_schedule, the
    per-segment propagator and the fidelity, complex128, against jax.grad."""
    n = 24
    tau = 10.09 / (2 * np.pi * 4.6e6)
    x0 = np.array([0.311 * np.pi, 1.242 * 2 * np.pi * 4.6e6, 4.696])
    kets = small["kets"]

    def jf(x):
        s = jprop.smooth_jp_schedule(x[0], x[1], x[2], tau, n_steps=n)
        rhos = jprop.evolve_rhos(*[jnp.asarray(small[k]) for k in ("L0", "Cp", "Cm")],
                                 s, jnp.asarray(small["rho0s"]))
        return jfid.compute_cz_fidelity(rhos, kets)[1]

    x = torch.tensor(x0, requires_grad=True)
    s = tprop.smooth_jp_schedule(x[0], x[1], x[2], tau, n_steps=n)
    rhos = tprop.evolve_rhos(*[torch.as_tensor(small[k]) for k in ("L0", "Cp", "Cm")],
                             s, torch.as_tensor(small["rho0s"]))
    F = tfid.compute_cz_fidelity(rhos, kets)[1]
    (grad,) = torch.autograd.grad(F, x)
    ref = np.asarray(jax.grad(jf)(jnp.asarray(x0)))
    scale = np.array([1.0, 1.0 / x0[1], 1.0])   # d/d omega_mod is per rad/s
    assert float(np.abs((grad.numpy() - ref) / scale).max()) <= 1e-10
    assert abs(float(F.detach()) - float(jf(jnp.asarray(x0)))) <= 1e-12


# ---- fidelity leftovers -----------------------------------------------------

@pytest.fixture(scope="module")
def evolved(small):
    put = lambda a: torch.as_tensor(a)
    n = 32
    return tprop.evolve_rhos(put(small["L0"]), put(small["Cp"]), put(small["Cm"]),
                             tprop.Schedule(np.ones(n), small["phases"],
                                            small["dts"]),
                             put(small["rho0s"])).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_dominant_phase_amp_matches_reference(small, evolved, dtype):
    """The overlap's magnitude for every basis state. Its phase is the
    eigenvector's, which LAPACK anchors to the eigenvector's first
    component: for |00>, |01> and |10> both packages return a real
    eigenvector (the phase is 0 or pi), for |11> the anchor is a component
    at rounding level and each LAPACK build picks its own phase."""
    nd = NP[dtype]
    rhos = evolved.astype(nd)
    for i, k in enumerate(("00", "01", "10", "11")):
        ket = small["kets"][k].astype(nd)
        ja, jm = jfid.dominant_phase_amp(jnp.asarray(rhos[i]), jnp.asarray(ket))
        ta, tm = tfid.dominant_phase_amp(torch.as_tensor(rhos[i]), ket)
        assert float(tm) > 0.9
        _close(tm, jm, dtype)
        if k != "11":
            _close(torch.cos(ta), jnp.cos(ja), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bell_state_fidelity_matches_reference(small, evolved, dtype):
    nd = NP[dtype]
    rho = evolved[4].astype(nd)
    ref = jfid.bell_state_fidelity(jnp.asarray(rho), small["kets"])
    got = tfid.bell_state_fidelity(torch.as_tensor(rho), small["kets"])
    _close(got, ref, dtype)
    assert 0.0 < float(got) <= 1.0
