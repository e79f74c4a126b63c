"""The port's real Hermitian-basis engine and kernel K1's plain twin against
the JAX reference.

Tolerances: float64 1e-12 (same algorithm, same op order; only the matmul
reduction order differs); float32 against the Pallas kernel in interpret
mode 5e-4, the bound of the reference's own kernel test. The Pallas kernel
needs rows % S == 0, so that comparison uses S = 4; the twin itself takes
the bench's S = 5.
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
    _evolve_real_phased_many_plain, evolve_real_phased_many_cuda)

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
