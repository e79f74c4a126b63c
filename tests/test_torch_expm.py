"""The port's batched expm and its squaring chain (kernel K2's plain twin)
against the JAX reference.

Tolerances: complex128 1e-12 relative (both are scaling-and-squaring with
the same polynomial at 64 bits: Pade-13); complex64 1e-5 relative (the
reference uses Karatsuba 3-multiply products, the port native complex
products: different float32 rounding); the squaring twin vs the Pallas
kernel in interpret mode 1e-4 absolute, the bound of the reference's own
kernel test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from noisyquantumsimulator_tpu.ops import expm as jexpm
from noisyquantumsimulator_tpu.ops.expm_pallas import (
    fused_masked_squaring as j_fused)
from noisyquantumsimulator_tpu_torch.ops import expm as texpm
from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
    _masked_squaring_plain, fused_masked_squaring)

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _operands(seed, B=4, D=16):
    """Complex operands whose 1-norms span several squaring counts."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, D, D)) + 1j * rng.standard_normal((B, D, D))
    A /= np.abs(A).sum(axis=-2).max(axis=-1)[:, None, None]
    return A * np.array([0.3, 2.0, 11.0, 40.0])[:B, None, None]


@pytest.mark.parametrize("dtype,tol", [(np.complex128, 1e-12),
                                       (np.complex64, 1e-5)])
def test_expm_matches_reference(dtype, tol):
    A = _operands(5).astype(dtype)
    ref = np.asarray(jexpm.expm(jnp.asarray(A), max_squarings=8))
    got = texpm.expm(torch.from_numpy(A), max_squarings=8).numpy()
    assert got.dtype == A.dtype
    assert _rel(got, ref) <= tol


def test_expm_complex128_matches_scipy():
    A = _operands(6)
    got = texpm.expm(torch.from_numpy(A), max_squarings=8).numpy()
    ref = np.stack([scipy.linalg.expm(a) for a in A])
    assert _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("method", ["pade13", "taylor16"])
def test_expm_real_float64(method):
    A = _operands(7).real.copy()
    ref = np.asarray(jexpm.expm(jnp.asarray(A), max_squarings=8, method=method))
    got = texpm.expm(torch.from_numpy(A), max_squarings=8, method=method).numpy()
    assert _rel(got, ref) <= 1e-12


def test_expm_unbatched_and_unknown_method():
    A = _operands(8, B=1)[0]
    got = texpm.expm(torch.from_numpy(A)).numpy()
    assert got.shape == A.shape
    assert _rel(got, scipy.linalg.expm(A)) <= 1e-12
    with pytest.raises(ValueError):
        texpm.expm(torch.from_numpy(A), method="krylov")


def test_chained_product_matches_reference():
    rng = np.random.default_rng(9)
    U = (rng.standard_normal((7, 9, 9)) + 1j * rng.standard_normal((7, 9, 9))) / 3
    ref = np.asarray(jexpm.chained_product(jnp.asarray(U)))
    got = texpm.chained_product(torch.from_numpy(U)).numpy()
    assert _rel(got, ref) <= 1e-12
    seq = np.eye(9)
    for u in U:
        seq = u @ seq
    assert _rel(got, seq) <= 1e-12


def test_squaring_twin_matches_pallas_interpret():
    """K2's plain twin vs the reference Pallas kernel run in interpret mode."""
    rng = np.random.default_rng(1234)
    B, D = 4, 16
    R = ((rng.normal(size=(B, D, D)) + 1j * rng.normal(size=(B, D, D)))
         * 0.1).astype(np.complex64)
    s = np.array([0, 1, 3, 2], np.int32)
    ref = np.asarray(j_fused(jnp.asarray(R), jnp.asarray(s), 4, interpret=True))
    got = _masked_squaring_plain(torch.from_numpy(R), torch.from_numpy(s),
                                 4).numpy()
    assert np.abs(got - ref).max() < 1e-4


@pytest.mark.parametrize("dtype", [np.complex128, np.float64])
def test_squaring_twin_matches_loop(dtype):
    rng = np.random.default_rng(11)
    R = (rng.standard_normal((3, 10, 10)) * 0.3).astype(dtype)
    s = np.array([2, 0, 5], np.int32)
    ref = R.copy()
    for b in range(3):
        for _ in range(min(s[b], 4)):
            ref[b] = ref[b] @ ref[b]
    got = _masked_squaring_plain(torch.from_numpy(R), torch.from_numpy(s),
                                 4).numpy()
    assert _rel(got, ref) <= 1e-13


def test_squaring_wrapper_dispatch():
    """CPU tensors take the twin; no other device falls back to it."""
    rng = np.random.default_rng(12)
    R = torch.from_numpy(rng.standard_normal((2, 5, 5)) + 0j)
    s = torch.tensor([1, 3], dtype=torch.int32)
    before = fused_masked_squaring.launches
    torch.testing.assert_close(fused_masked_squaring(R, s, 3),
                               _masked_squaring_plain(R, s, 3), rtol=0, atol=0)
    assert fused_masked_squaring.launches == before
    with pytest.raises(ValueError):
        fused_masked_squaring(R.to("meta"), s.to("meta"), 3)
    with pytest.raises(ValueError):
        fused_masked_squaring(R, s[:1], 3)


def _cases():
    rng = np.random.default_rng(13)
    N = 12
    R = np.eye(N) + 0.05 * rng.standard_normal((6, N, N)) / np.sqrt(N)
    return {
        # a zero-length segment: exp(0) = I needs no squaring
        "identity_s0": (np.broadcast_to(np.eye(N), (3, N, N)).copy(),
                        np.zeros(3, np.int32), 12),
        # one fixed loop of 12 trips, chains of every length inside it
        "mixed_s_12_trips": (R, np.array([0, 1, 3, 6, 2, 5], np.int32), 12),
        # the loop is shorter than some chains: they stop at its end
        "max_squarings_below_s": (R, np.array([0, 1, 3, 6, 2, 5], np.int32), 2),
        "every_matrix_masked": (R, np.zeros(6, np.int32), 12),
    }


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13), (np.complex128, 1e-13),
                                       (np.float32, 1e-5), (np.complex64, 1e-5)])
@pytest.mark.parametrize("case", list(_cases()))
def test_squaring_twin_matches_reference_loop(case, dtype, tol):
    """K2's plain twin against the reference's own masked squaring loop
    (ops/expm._square) on the cases the optimizer brings."""
    R, s, ms = _cases()[case]
    R = R.astype(dtype)
    if np.iscomplexobj(R):
        R = R * np.exp(0.3j).astype(dtype)
    ref = np.asarray(jexpm._square(jnp.asarray(R), jnp.asarray(s), ms))
    got = fused_masked_squaring(torch.from_numpy(R), torch.from_numpy(s), ms)
    assert got.dtype == torch.from_numpy(R).dtype
    assert _rel(got.numpy(), ref) <= tol
    if not s.any():
        assert np.array_equal(got.numpy(), R)          # untouched, bit for bit


def test_expm_of_zero_is_identity_without_squaring():
    A = torch.zeros((3, 9, 9), dtype=torch.complex64)
    _, s = texpm._scale(A, texpm._THETA16, 12)
    assert int(s.max()) == 0
    got = texpm.expm(A)
    assert torch.equal(got, torch.eye(9, dtype=torch.complex64).expand(3, 9, 9))


@pytest.mark.parametrize("method,norm1", [("taylor16", 1.414e4),
                                          ("pade13", 3.0e4)])
def test_expm_raises_where_the_squaring_count_would_be_clamped(method, norm1):
    """An operand that needs 13 squarings under max_squarings = 12 (the
    sideband-cooling generator's 1-norm, 1.414e4, under Taylor-16) raises
    and names both counts; with the count from squarings_for, or with no
    max_squarings (every squaring it needs), it runs."""
    A = torch.zeros((2, 4, 4), dtype=torch.float64)
    A[1, 0, 1] = norm1
    need = texpm.squarings_for(norm1, method)
    assert need == 13
    with pytest.raises(texpm.SquaringLimitError, match="needs 13 squarings.*= 12"):
        texpm.expm(A, max_squarings=12, method=method)
    ref = np.stack([scipy.linalg.expm(a) for a in A.numpy()])
    for limit in (need, None):
        got = texpm.expm(A, max_squarings=limit, method=method)
        assert _rel(got.numpy(), ref) <= 1e-12


def test_pade13_at_32_bits_holds_single_precision_at_its_theta():
    """Pade-13 at complex64 scales to its single-precision theta (11.25, one
    squaring fewer than at 64 bits); just under it, and at 2-8 times it,
    the result is within the complex64 tier (1e-5 relative) of scipy's
    complex128 expm."""
    rng = np.random.default_rng(11)
    A = rng.standard_normal((5, 16, 16)) + 1j * rng.standard_normal((5, 16, 16))
    A /= np.abs(A).sum(axis=-2).max(axis=-1)[:, None, None]
    A *= (0.999 * texpm._THETA13_SINGLE
          * np.array([1.0, 1.0, 2.0, 4.0, 8.0]))[:, None, None]
    A[1] = 1j * (A[1] + A[1].conj().T) / 2          # skew-Hermitian: unitary
    A64 = torch.from_numpy(A.astype(np.complex64))
    As, s = texpm._scale(A64, texpm._THETA13_SINGLE)
    assert s.tolist()[:1] + s.tolist()[2:] == [0, 1, 2, 3]
    got = texpm.expm(A64, method="pade13").numpy()
    R = texpm._pade13(As, torch.eye(16, dtype=torch.complex64).expand(As.shape))
    assert np.array_equal(got[0], R[0].numpy())      # no squaring at 0.999 theta
    ref = np.stack([scipy.linalg.expm(a) for a in A64.numpy().astype(np.complex128)])
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-5


def test_squarings_for_matches_the_scaling():
    """The host count equals the one the device scaling computes, norm for
    norm, at both thresholds (powers of two of theta included)."""
    for method, theta in (("pade13", texpm._THETA13),
                          ("taylor16", texpm._THETA16)):
        norms = np.concatenate([[0.0, 0.5 * theta, theta, 1.0001 * theta],
                                theta * 2.0 ** np.arange(1, 14),
                                np.geomspace(1e-3, 1e5, 60)])
        A = torch.zeros((len(norms), 2, 2), dtype=torch.float64)
        A[:, 0, 1] = torch.from_numpy(norms)
        need = texpm._needed_squarings(A, theta)
        assert [texpm.squarings_for(n, method) for n in norms] == \
            [int(v) for v in need]
