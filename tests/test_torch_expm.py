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
