"""Batched matrix exponential (scaling and squaring) in PyTorch.

Counterpart of the reference's `ops/expm.py`. For piecewise-constant
Liouvillians the propagator over a segment is exp(L dt) exactly, so the
solver computes batched matrix exponentials instead of integrating an ODE.

  * Two fixed-structure polynomial evaluations:
      - Pade-13 (Higham 2005): 6 matmuls + 1 linear solve, for
        float64/complex128.
      - Taylor-16 via Paterson-Stockmeyer: 6 matmuls, no solve, for
        float32/complex64. With theta = 1.8 the truncation error is ~4e-10,
        below complex64 roundoff for the squaring chain that follows.
  * method="auto" picks Taylor-16 for 32-bit dtypes, Pade-13 for 64-bit.
  * The squaring count s is per batch element and data-dependent; the chain
    runs as a fixed-length masked loop (`ops/expm_cuda.fused_masked_squaring`,
    CUDA kernel K2 on the card), so s never has to reach the host. Callers
    that know their operand norms pass a tight `max_squarings`.
  * The polynomial products are torch.matmul, in full float32 for 32-bit
    dtypes (TF32 is off, see the package's __init__).
"""
from __future__ import annotations

import math

import torch

from .expm_cuda import fused_masked_squaring

# Pade-13 coefficients (Higham, "The scaling and squaring method for the
# matrix exponential revisited", SIAM J. Matrix Anal. 2005).
_B13 = (
    64764752532480000.0, 32382376266240000.0, 7771770303897600.0,
    1187353796428800.0, 129060195264000.0, 10559470521600.0,
    670442572800.0, 33522128640.0, 1323241920.0, 40840800.0,
    960960.0, 16380.0, 182.0, 1.0,
)
_THETA13 = 5.371920351148152
_THETA16 = 1.8
_INVFACT = tuple(1.0 / math.factorial(k) for k in range(17))

_SINGLE = (torch.float32, torch.complex64)


def _scale(A: torch.Tensor, theta: float, max_squarings: int):
    """Per-batch-element scaling: A/2^s with ||A/2^s||_1 <= theta."""
    norm1 = A.abs().sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm1 / theta, min=1.0)))
    s = torch.clamp(s, 0, max_squarings).to(torch.int32)
    scale = torch.exp2(-s.to(norm1.dtype))
    return A * scale[..., None, None].to(A.dtype), s


def _pade13(As: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    b = _B13
    A2 = As @ As
    A4 = A2 @ A2
    A6 = A2 @ A4
    U = As @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2)
              + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * I)
    V = (A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2)
         + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * I)
    return torch.linalg.solve(V - U, V + U)


def _taylor16(As: torch.Tensor, I: torch.Tensor) -> torch.Tensor:
    """Degree-16 Taylor via Paterson-Stockmeyer in powers of A^4:
    p = B0 + A4 (B1 + A4 (B2 + A4 (B3 + c16 A4))), Bj cubic in A."""
    c = _INVFACT
    A2 = As @ As
    A3 = A2 @ As
    A4 = A2 @ A2

    def block(k):
        return c[k] * I + c[k + 1] * As + c[k + 2] * A2 + c[k + 3] * A3

    R = block(12) + c[16] * A4
    R = block(8) + A4 @ R
    R = block(4) + A4 @ R
    return block(0) + A4 @ R


def expm(A: torch.Tensor, max_squarings: int = 12,
         method: str = "auto") -> torch.Tensor:
    """exp(A) for A of shape (..., D, D), real or complex, batched over the
    leading dims.

    `max_squarings` bounds the masked squaring loop; every trip costs a full
    batched product, so pass a tight bound when the operand norms are known
    on the host (the default 12 covers ||A||_1 up to ~7.4e3 with Taylor-16).

    method: "pade13" | "taylor16" | "auto" (taylor16 for 32-bit dtypes,
    pade13 for 64-bit).
    """
    if method == "auto":
        method = "taylor16" if A.dtype in _SINGLE else "pade13"
    if method == "taylor16":
        theta, poly = _THETA16, _taylor16
    elif method == "pade13":
        theta, poly = _THETA13, _pade13
    else:
        raise ValueError(f"Unknown expm method '{method}'; expected "
                         f"'pade13', 'taylor16' or 'auto'")
    D = A.shape[-1]
    batch = A.shape[:-2]
    I = torch.eye(D, dtype=A.dtype, device=A.device).expand(A.shape)
    As, s = _scale(A, theta, max_squarings)
    R = poly(As, I)
    R = fused_masked_squaring(R.reshape(-1, D, D).contiguous(),
                              s.reshape(-1), max_squarings)
    return R.reshape(*batch, D, D)


def chained_product(U: torch.Tensor) -> torch.Tensor:
    """Ordered product U[n-1] @ ... @ U[1] @ U[0] by log-depth pairwise
    reduction: O(log n) batched matmuls instead of an O(n) loop.
    U has shape (n, ..., D, D)."""
    n = U.shape[0]
    while n > 1:
        half = n // 2
        prod = U[1:2 * half:2] @ U[0:2 * half:2]  # later applied after earlier
        U = torch.cat([prod, U[-1:]], dim=0) if n % 2 == 1 else prod
        n = U.shape[0]
    return U[0]


__all__ = ["expm", "chained_product"]
