"""The port's real Hermitian-basis engine and kernel K1's plain twin against
the JAX reference.

Tolerances: float64 1e-12 (same algorithm, same op order; only the matmul
reduction order differs); float32 against the Pallas kernel in interpret
mode 5e-4, the bound of the reference's own kernel test. The Pallas kernel
needs rows % S == 0, so that comparison uses S = 4; the twin itself takes
the bench's S = 5. The CUDA kernel's 3xTF32 float32 numerics, emulated in
plain torch, are held to 1e-4 of the float64 JAX reference after 300 steps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.solver import real_rep as jrr
from noisyquantumsimulator_tpu.solver.scan_pallas import (
    evolve_real_phased_many_pallas)
from noisyquantumsimulator_tpu_torch.solver import real_rep as trr
from noisyquantumsimulator_tpu_torch.solver.scan_cuda import (
    _evolve_real_phased_many_plain, _prologue, evolve_real_phased_many_cuda)

torch.set_num_threads(1)


def _shapes(D, P, B, S, n_seg, dtype, seed=3):
    """Orthogonal U (stable over many steps), integer charges, random
    phases and states, made with numpy."""
    rng = np.random.default_rng(seed)
    n = D + 2 * P
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    cq = rng.integers(1, 5, P).astype(np.float64)
    ph = rng.standard_normal((B, n_seg))
    x0 = rng.standard_normal((S, n))
    return tuple(a.astype(dtype) for a in (Q, cq, ph, x0))


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("D,P", [(9, 36), (16, 120)])
def test_twin_matches_reference_f64(D, P):
    U, cq, ph, x0 = _shapes(D, P, B=3, S=5, n_seg=20, dtype=np.float64)
    ref = np.asarray(jrr.evolve_real_phased_many(*_j(U, cq, ph, x0), D, P))
    got = _evolve_real_phased_many_plain(*_t(U, cq, ph, x0), D, P).numpy()
    assert got.shape == (3, 5, D + 2 * P)
    assert np.abs(got - ref).max() <= 1e-12


def test_twin_matches_pallas_interpret_f32():
    U, cq, ph, x0 = _shapes(9, 36, B=4, S=4, n_seg=12, dtype=np.float32)
    ref = np.asarray(evolve_real_phased_many_pallas(
        *_j(U, cq, ph, x0), 9, 36, block_rows=16, interpret=True))
    got = _evolve_real_phased_many_plain(*_t(U, cq, ph, x0), 9, 36).numpy()
    assert np.abs(got - ref).max() <= 5e-4


def test_single_schedule_matches_reference():
    U, cq, ph, x0 = _shapes(9, 36, B=1, S=5, n_seg=15, dtype=np.float64)
    ref = np.asarray(jrr.evolve_real_phased(*_j(U, cq, ph[0], x0), 9, 36))
    got = trr.evolve_real_phased(*_t(U, cq, ph[0], x0), 9, 36).numpy()
    assert np.abs(got - ref).max() <= 1e-12


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half an ulp of the 10-bit mantissa, clear the 13 low bits
    (the kernel's rounding)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tc_sum(x):
    """A tensor core's float32 result of an exact (float64) sum: rounded
    toward zero (the 29 low mantissa bits cleared), as the tensor cores do
    not round to nearest."""
    return (x.view(torch.int64) & -(1 << 29)).view(torch.float64).float()


def _evolve_3xtf32(U, cq, ph, x0, D, P, running_sum_on_tc=False):
    """Kernel K1's float32 numerics in plain torch. n is zero-padded to
    KT k blocks of 8; U^T is split once, the state as it is loaded each
    step (a = hi + lo, both TF32). For each 8-wide k block the three
    products lo*hi, hi*lo, hi*hi go into a fresh tile on the tensor cores
    (each product exact, each sum rounded as `_tc_sum`), and the tile is
    added to the running sum with float32 adds, k block after k block, as
    csrc/phase_scan.cu does. With `running_sum_on_tc` the tensor cores carry
    the running sum instead (every product accumulates into it)."""
    from noisyquantumsimulator_tpu_torch.solver.real_rep import _rotate
    S, n = x0.shape
    KT = -(-n // 8)
    npad = 8 * KT
    cq, ph, dphi, v = (t.float() for t in _prologue(U.float(), cq, ph, x0, D, P))
    B = ph.shape[0]
    UT = torch.zeros(npad, npad)
    UT[:n, :n] = U.float().T
    Uh = _tf32(UT)
    Ul = _tf32(UT - Uh)
    Uh, Ul = (u.double().view(KT, 8, npad) for u in (Uh, Ul))
    v = torch.cat([v, torch.zeros(B, S, npad - n)], dim=2)
    for k in range(ph.shape[1]):
        v = torch.cat([_rotate(v[..., :n], dphi[:, k, None], cq, D, P),
                       v[..., n:]], dim=2).reshape(B * S, npad)
        vh = _tf32(v)
        vl = _tf32(v - vh)
        ah, al = (a.double().view(-1, KT, 8).transpose(0, 1) for a in (vh, vl))
        terms = (torch.bmm(al, Uh), torch.bmm(ah, Ul), torch.bmm(ah, Uh))
        acc = torch.zeros(B * S, npad)
        if running_sum_on_tc:
            for kb in range(KT):
                for t in terms:
                    acc = _tc_sum(t[kb] + acc.double())
        else:
            tile = _tc_sum(terms[0])
            tile = _tc_sum(terms[1] + tile.double())
            tile = _tc_sum(terms[2] + tile.double())
            for kb in range(KT):
                acc = acc + tile[kb]
        v = acc.reshape(B, S, npad)
    assert torch.equal(v[..., n:], torch.zeros_like(v[..., n:]))
    return _rotate(v[..., :n], ph[:, -1, None], cq, D, P)


def _split_error_300_steps(D, P, running_sum_on_tc=False):
    """max |emulated kernel - JAX reference (float64)| / max |reference|
    after the bench's 300 steps, B = 2 schedules of S = 5 rows."""
    a = _shapes(D, P, B=2, S=5, n_seg=300, dtype=np.float64)
    ref = np.asarray(jrr.evolve_real_phased_many(*_j(*a), D, P))
    got = _evolve_3xtf32(*_t(*a), D, P, running_sum_on_tc).double().numpy()
    assert got.shape == ref.shape == (2, 5, D + 2 * P)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("D,P", [(9, 36), (16, 120)])
def test_3xtf32_split_holds_parity_over_300_steps(D, P):
    """The split and the summation the kernel uses on the tensor cores keep
    float32-level accuracy over the bench's 300 steps (the kernel is held
    to 1e-4 of its twin on the card)."""
    assert _split_error_300_steps(D, P) <= 1e-4
    one_term = _tf32(torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32))
    assert float(one_term) == 1.0       # what one TF32 product alone would drop


def test_3xtf32_running_sum_on_the_tensor_cores_fails_parity():
    """The same split with the tensor cores carrying the running sum drifts
    past 1e-4 within 300 steps: the emulation sees the fault that the
    kernel's fresh tile per k block avoids."""
    assert _split_error_300_steps(9, 36, running_sum_on_tc=True) > 1e-4


def test_wrapper_dispatch():
    """CPU tensors take the twin; other devices raise, never fall back."""
    args = _t(*_shapes(2, 3, B=2, S=5, n_seg=4, dtype=np.float64))
    before = evolve_real_phased_many_cuda.launches
    torch.testing.assert_close(evolve_real_phased_many_cuda(*args, 2, 3),
                               _evolve_real_phased_many_plain(*args, 2, 3),
                               rtol=0, atol=0)
    assert evolve_real_phased_many_cuda.launches == before
    with pytest.raises(ValueError):
        evolve_real_phased_many_cuda(*(a.to("meta") for a in args), 2, 3)
    with pytest.raises(ValueError):
        evolve_real_phased_many_cuda(*args, 3, 3)


def test_real_rep_tables_and_transforms():
    """build_real_rep, to/from real coordinates and the real propagator
    against the reference on a Hermiticity-preserving map."""
    rng = np.random.default_rng(21)
    D = 9
    g = np.repeat(np.arange(D, dtype=np.float64) % 3, D) - np.tile(
        np.arange(D, dtype=np.float64) % 3, D)
    jrep, trep = jrr.build_real_rep(g, D), trr.build_real_rep(g, D)
    for a, b in zip(jrep[:3], trep[:3]):
        np.testing.assert_array_equal(a, b)
    assert (jrep.D, jrep.P) == (trep.D, trep.P)
    # U rho = K rho K^dagger is Hermiticity-preserving: U = K kron conj(K)
    K = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
    U = np.kron(K, K.conj()) / np.abs(K).max() ** 2
    Wr, Wi = trep.Wr, trep.Wi
    ref = np.asarray(jrr.real_propagator_device(*_j(U, Wr, Wi)))
    got = trr.real_propagator_device(*_t(U, Wr, Wi)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    A = rng.standard_normal((2, 5, D, D)) + 1j * rng.standard_normal((2, 5, D, D))
    rhos = A @ np.conj(np.swapaxes(A, -1, -2))
    x_ref = np.asarray(jrr.to_real_coords(*_j(rhos, Wr, Wi)))
    x = trr.to_real_coords(*_t(rhos, Wr, Wi))
    assert np.abs(x.numpy() - x_ref).max() <= 1e-12 * np.abs(x_ref).max()
    back = trr.from_real_coords(x, *_t(Wr, Wi)).numpy()
    assert np.abs(back - rhos).max() <= 1e-12 * np.abs(rhos).max()


@pytest.mark.parametrize("D,P,dtype,tol", [(9, 36, np.float64, 1e-12),
                                           (16, 120, np.float64, 1e-12),
                                           (9, 36, np.float32, 1e-4)])
def test_population_scan_matches_reference(D, P, dtype, tol):
    """One propagator and one schedule per member (the optimizer's scan):
    the reference's single-schedule scan mapped over the population against
    the port's batched one, which folds each rotation into its product."""
    import jax
    M, S, n_seg = 4, 5, 40
    n = D + 2 * P
    rng = np.random.default_rng(17)
    U = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(M)])
    _, cq, ph, x0 = _shapes(D, P, B=M, S=S, n_seg=n_seg, dtype=np.float64)
    ref = np.asarray(jax.vmap(
        lambda u, p: jrr.evolve_real_phased(u, jnp.asarray(cq), p,
                                            jnp.asarray(x0), D, P))(
            jnp.asarray(U), jnp.asarray(ph)))
    got = trr.evolve_real_phased(*_t(U.astype(dtype), cq.astype(dtype),
                                     ph.astype(dtype), x0.astype(dtype)), D, P)
    assert got.shape == (M, S, n) and got.dtype == torch.from_numpy(U.astype(dtype)).dtype
    assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()
    # per-member initial states (M, S, n) give the same as shared ones
    x0m = np.broadcast_to(x0, (M, S, n)).astype(dtype)
    again = trr.evolve_real_phased(*_t(U.astype(dtype), cq.astype(dtype),
                                       ph.astype(dtype), x0m), D, P)
    assert torch.equal(again, got)


def _population(D, P, M, S, n_seg, dtype=np.float64, seed=23):
    """One orthogonal U per member, integer charges, phases, shared states."""
    rng = np.random.default_rng(seed)
    n = D + 2 * P
    U = np.stack([np.linalg.qr(rng.standard_normal((n, n)))[0] for _ in range(M)])
    _, cq, ph, x0 = _shapes(D, P, B=M, S=S, n_seg=n_seg, dtype=np.float64,
                            seed=seed)
    return _t(*(a.astype(dtype) for a in (U, cq, ph, x0)))


def test_population_scan_cpu_takes_the_twin():
    """CPU tensors take the loop (the kernel's plain twin), for shared and
    per-member states, and launch nothing."""
    from noisyquantumsimulator_tpu_torch.solver.population_scan_cuda import (
        _evolve_real_phased_population_plain as plain,
        evolve_real_phased_population_cuda as pscan)
    U, cq, ph, x0 = _population(9, 36, M=3, S=5, n_seg=7)
    before = (pscan.launches, pscan.loop_calls)
    got = trr.evolve_real_phased(U, cq, ph, x0, 9, 36)
    torch.testing.assert_close(got, plain(U, cq, ph, x0, 9, 36), rtol=0, atol=0)
    x0m = x0.expand(3, *x0.shape).contiguous()
    torch.testing.assert_close(pscan(U, cq, ph, x0m, 9, 36), got, rtol=0, atol=0)
    assert (pscan.launches, pscan.loop_calls) == before


def test_population_scan_gradient_flows_through_the_loop():
    """Under autograd a population of one takes the loop, and its gradient
    with respect to the phases and U equals central finite differences."""
    U, cq, ph, x0 = _population(2, 3, M=1, S=2, n_seg=6)
    w = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 2, 8)))

    def loss(u, p):
        return (trr.evolve_real_phased(u, cq, p, x0, 2, 3) * w).sum()

    Ug, pg = U.clone().requires_grad_(True), ph.clone().requires_grad_(True)
    gU, gp = torch.autograd.grad(loss(Ug, pg), (Ug, pg))
    h = 1e-6
    for k in range(ph.shape[1]):
        e = torch.zeros_like(ph)
        e[0, k] = h
        fd = (loss(U, ph + e) - loss(U, ph - e)) / (2 * h)
        assert abs(float(gp[0, k]) - float(fd)) <= 1e-7 * max(1.0, abs(float(fd)))
    for idx in ((0, 0, 0), (0, 3, 5), (0, 7, 1)):
        e = torch.zeros_like(U)
        e[idx] = h
        fd = (loss(U + e, ph) - loss(U - e, ph)) / (2 * h)
        assert abs(float(gU[idx]) - float(fd)) <= 1e-7 * max(1.0, abs(float(fd)))


@pytest.mark.parametrize("n,S,dtype,fits", [
    (81, 5, torch.float32, True), (81, 5, torch.float64, True),
    (256, 5, torch.float32, False), (81, 5, torch.float16, False),
    (81, 700, torch.float32, False), (16, 5, torch.float64, True)])
def test_population_scan_residency_rule(n, S, dtype, fits):
    """A member's U^T and states in one block's shared memory: every
    3-level population (n = 81) at 32 and 64 bits, no 4-level one (n = 256)
    and no other dtype."""
    from noisyquantumsimulator_tpu_torch.solver.population_scan_cuda import (
        resident)
    assert resident(n, S, dtype) is fits


def test_population_scan_wrapper_rejects_shapes_and_devices():
    from noisyquantumsimulator_tpu_torch.solver.population_scan_cuda import (
        evolve_real_phased_population_cuda as pscan)
    U, cq, ph, x0 = _population(2, 3, M=2, S=5, n_seg=4)
    bad = ((U, cq, ph, x0, 3, 3),                   # n != D + 2P
           (U[:, :7], cq, ph, x0, 2, 3),            # U not square
           (U, cq[:2], ph, x0, 2, 3),               # one charge short
           (U, cq, ph[:1], x0, 2, 3),               # phases of one member
           (U, cq, ph, x0[:, :7], 2, 3),            # states of 7 coordinates
           (U, cq, ph, x0.expand(3, 5, 8), 2, 3))   # states of 3 members
    for args in bad:
        with pytest.raises(ValueError):
            pscan(*args)
    with pytest.raises(ValueError):
        pscan(*(a.to("meta") for a in (U, cq, ph, x0)), 2, 3)
