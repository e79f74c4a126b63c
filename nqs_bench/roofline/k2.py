"""K2, the masked squaring chain (`csrc/masked_squaring.cu`): member b of a
batch of (N, N) matrices is squared s_b times.

Operations: sum over members of s_b x 2 N^3 (real matrices). Bytes: the batch in and out once, and the counts.
s_b is what member b's generator needs under the program's scheme as of
this benchmark: Taylor-16 at 32 bits scales A to ||A / 2^s||_1 <= 1.8, with
the 1-norm taken in the real Hermitian basis that the optimizer's real core
exponentiates in."""
import math

import numpy as np

THETA_32 = 1.8


def squarings(norm1: np.ndarray, theta: float = THETA_32) -> np.ndarray:
    """The least s >= 0 with norm1 / 2^s <= theta, per member."""
    return np.ceil(np.log2(np.maximum(np.asarray(norm1, np.float64) / theta, 1.0)))


def flops(s: np.ndarray, N: int) -> float:
    return float(np.sum(s)) * 2.0 * N ** 3


def nbytes(B: int, N: int, itemsize: int) -> float:
    return 2.0 * B * N * N * itemsize + 4.0 * B


def hermitian_basis(D: int) -> np.ndarray:
    """The unitary W (D^2, D^2) of the real Hermitian operator basis,
    x = W vec(rho): |i><i|, (|i><j| + |j><i|) / sqrt2 and
    (-i|i><j| + i|j><i|) / sqrt2 for i < j (row-major vec)."""
    n = D * D
    pairs = [(i, j) for i in range(D) for j in range(i + 1, D)]
    W = np.zeros((n, n), np.complex128)
    r = 1.0 / math.sqrt(2.0)
    for k in range(D):
        W[k, k * D + k] = 1.0
    for k, (i, j) in enumerate(pairs):
        W[D + k, i * D + j] = W[D + k, j * D + i] = r
        W[D + len(pairs) + k, i * D + j] = -1j * r
        W[D + len(pairs) + k, j * D + i] = 1j * r
    return W


def population_squarings(config: dict, params) -> np.ndarray:
    """s_b of each member of a smooth-JP population (P, 5): its generator
    (L_static + Delta L_det + L_plus + L_minus) dt in the real Hermitian
    basis, as the optimizer's real core forms it, under `squarings`."""
    from nqs_bench.reference.gate_model import build
    model = build(config, "population")
    W = hermitian_basis(model.dim ** 2)

    def real(L):
        return (W @ L @ W.conj().T).real

    Rs, Rd, Rdr = (real(L) for L in (model.L_static, model.L_det,
                                      model.L_plus + model.L_minus))
    p = np.asarray(params, np.float64)
    dt = p[:, 0] / model.Omega / model.n_steps
    A = (Rs + model.detuning(p[:, 4])[:, None, None] * Rd + Rdr) * dt[:, None, None]
    return squarings(np.abs(A).sum(axis=-2).max(axis=-1))
