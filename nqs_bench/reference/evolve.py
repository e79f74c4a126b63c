"""Plain reference of a CZ gate's outputs: one matrix exponential per segment.

For each schedule (phases phi_k, one segment length dt, one detuning Delta)
the reference forms every segment's Liouvillian L(phi_k, Delta)
(`gate_model`), exponentiates it by scaling and squaring of a degree-12
Taylor polynomial, and applies the segments in order to the vectorised
initial states. Then it reads the CZ fidelities and the optimizer's cost.
It shares no code and no method with the program: no phase frame, no real
basis, no kernel, no library matrix exponential.

Precision modes:
  "float64": complex128 throughout (the reference).
  "tf32":    complex64 whose every product rounds both operands' real and
             imaginary planes to TF32 (10 explicit mantissa bits) and
             multiplies them in float32: the control, the step below the
             configuration's full-FP32 products.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

_TAYLOR_DEGREE = 12
_THETA = 0.5        # ||A / 2^s||_1 <= 0.5: truncation 0.5^13 / 13! ~ 2e-14


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "float64":
        return a @ b
    ar, ai, br, bi = (to_tf32(t) for t in (a.real, a.imag, b.real, b.imag))
    return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)


def expm(A: torch.Tensor, mode: str) -> torch.Tensor:
    """exp(A) for A (..., n, n): Taylor-12 by Horner's rule on A / 2^s, then
    s squarings, s per matrix from its 1-norm."""
    norm = A.abs().sum(dim=-2).amax(dim=-1)
    s = torch.ceil(torch.log2(torch.clamp(norm / _THETA, min=1.0)))
    As = A * torch.exp2(-s).to(A.dtype)[..., None, None]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    E = eye + As / _TAYLOR_DEGREE
    for k in range(_TAYLOR_DEGREE - 1, 0, -1):
        E = eye + _mm(As, E, mode) / k
    s = s[..., None, None]
    for i in range(int(s.max()) if s.numel() else 0):
        E = torch.where(s > i, _mm(E, E, mode), E)
    return E


def evolve(model, phases: np.ndarray, dt: np.ndarray, Delta: np.ndarray,
           mode: str = "float64", device="cpu", block_bytes: int = 1 << 30
           ) -> np.ndarray:
    """Final density matrices (M, 5, D, D) complex128 of M schedules:
    phases (M, n_seg), dt (M,), Delta (M,). Segments go in blocks whose
    exponentials take about `block_bytes`."""
    cdt = torch.complex128 if mode == "float64" else torch.complex64
    M, n_seg = phases.shape
    n = model.L_static.shape[0]
    D = int(round(math.sqrt(n)))

    def put(a):
        return torch.as_tensor(np.asarray(a, np.complex128), device=device).to(cdt)

    Ls, Ld, Lp, Lm = (put(a) for a in (model.L_static, model.L_det,
                                       model.L_plus, model.L_minus))
    ph = torch.as_tensor(np.asarray(phases, np.float64), device=device)
    dtt = put(np.asarray(dt, np.float64))[:, None, None, None]
    det = put(np.asarray(Delta, np.float64))[:, None, None, None]
    v = put(model.rho0s.reshape(5, n).T).expand(M, n, 5)
    per_segment = M * n * n * torch.empty((), dtype=cdt).element_size()
    chunk = max(1, min(n_seg, block_bytes // per_segment))
    for k0 in range(0, n_seg, chunk):
        e = torch.exp(1j * ph[:, k0:k0 + chunk]).to(cdt)[..., None, None]
        A = (Ls + det * Ld + e * Lp + e.conj() * Lm) * dtt
        U = expm(A, mode)
        for j in range(U.shape[1]):
            v = _mm(U[:, j], v, mode)
    return v.transpose(1, 2).reshape(M, 5, D, D).to(torch.complex128).cpu().numpy()


def cz_fidelities(rhos: np.ndarray, kets: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
    """The CZ readout of (M, 5, D, D) states ordered 00, 01, 10, 11, ++:
    populations of the four basis states; the controlled phase
    arg<11|rho|00> - arg<01|rho|00> - arg<10|rho|00> of the evolved |++>;
    its fidelity cos^2(e / 2), e its distance from +-pi; F11 = population
    x that fidelity; the average of the four."""
    k = {name: np.asarray(v, np.complex128) for name, v in kets.items()}
    pops = [np.einsum("i,mij,j->m", k[name].conj(), rhos[:, i], k[name]).real
            for i, name in enumerate(("00", "01", "10", "11"))]
    plus = rhos[:, 4]

    def coh(name):
        return np.einsum("i,mij,j->m", k[name].conj(), plus, k["00"])

    phase = np.angle(coh("11")) - np.angle(coh("01")) - np.angle(coh("10"))
    phase = np.remainder(phase + np.pi, 2 * np.pi) - np.pi
    err = np.minimum(np.abs(phase - np.pi), np.abs(phase + np.pi))
    czp = np.cos(err / 2) ** 2
    f11 = pops[3] * czp
    return {"avg_fidelity": (pops[0] + pops[1] + pops[2] + f11) / 4,
            "f00": pops[0], "f01": pops[1], "f10": pops[2], "f11": f11,
            "cz_phase_fidelity": czp}


def failed(avg, f11, czp):
    """Where the optimizer's cost takes its penalty: F < 0.5 or a fidelity
    is NaN."""
    return np.isnan(avg) | np.isnan(f11) | np.isnan(czp) | (avg < 0.5)


def cost(avg, f11, czp, gate_time_us, time_weight: float = 0.01, bad=None):
    """The optimizer's cost: 10 (100 (1 - F))^2 + 5 (100 (1 - F11))^2
    + 2 (100 (1 - F_phase))^2 + 0.01 t_us, and the penalty 1e6 where `bad`
    (by default `failed`: optimize_cz_gate.py:362-433 upstream)."""
    c = (10 * (100 * (1 - avg)) ** 2 + 5 * (100 * (1 - f11)) ** 2
         + 2 * (100 * (1 - czp)) ** 2 + time_weight * gate_time_us)
    return np.where(failed(avg, f11, czp) if bad is None else bad, 1e6, c)
