"""The optimizer's population scan: one CUDA kernel for the whole population,
and its plain twin.

Contract of `real_rep.evolve_real_phased` with one propagator a member:
U_real (M, n, n); cq (P,); phases (M, n_seg); x0s (S, n) shared by every
member or (M, S, n); returns (M, S, n) in U_real's dtype, n = D + 2P. Each
member is rotated by -phases[m, 0], then takes n_seg steps of v <- v U^T
followed by the rotation by phases[m, k] - phases[m, k+1] (after the last
step, by phases[m, -1]).

The kernel (`csrc/population_scan.cu`) keeps each member's U^T and its
states in one block's shared memory for all steps, rotations included: one
launch a call. The twin, `_evolve_real_phased_population_plain`, is the
batched-product loop (300 x one product and one torch.bmm at the optimizer's
size), which also carries autograd.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _kernels

_ENTRY = {torch.float32: "nqs_population_scan_f32",
          torch.float64: "nqs_population_scan_f64"}
# csrc/population_scan.cu: a block's dynamic shared memory, state rows a
# product pass holds, columns a lane owns at most
_SMEM_MAX = 227 * 1024
_ROWS = 5
_MAX_N = 8 * 32


def resident(n: int, S: int, dtype: torch.dtype) -> bool:
    """Whether one member's U^T (n x n, odd row stride) and its S state rows
    (padded to 5 rows of a multiple of 4 elements) fit one block's shared
    memory in `dtype`: the kernel's rule (`nqs_population_scan_is_resident`).
    True at n = 81 in float32 and float64, false at n = 256."""
    if dtype not in _ENTRY or n < 1 or S < 1 or n > _MAX_N:
        return False
    u = (n * (n | 1) + 3) // 4 * 4
    v = -(-S // _ROWS) * _ROWS * ((n + 3) // 4 * 4)
    return (u + v) * dtype.itemsize <= _SMEM_MAX


def _evolve_real_phased_population_plain(U_real, cq, phases, x0s, D: int,
                                         P: int):
    """Plain PyTorch twin of the kernel: a step is two launches, one product
    with the step's factors and one torch.bmm. The pair rotation is linear in
    the coordinates, rot(v) = v * C + v[swap] * Sg with C = (1, cos, cos),
    Sg = (0, -sin, sin) and swap exchanging each pair's re and im, so

        rot(v) @ U^T = [v * C | v * Sg[swap]] @ [U^T ; U^T[swap]]

    with the two halves side by side along the contraction axis (2n long).
    The first rotation (by -phi_0) is folded into step 0, whose own angle is
    zero; the factors of every step are made in one call."""
    M, n_seg = phases.shape
    rdt, dev = U_real.dtype, U_real.device
    ph = phases.to(rdt).transpose(0, 1)                     # (n_seg, M)
    theta = torch.cat([-ph[:1], ph[:-1] - ph[1:], ph[-1:]], dim=0)
    th = theta[:, :, None] * cq.to(rdt)                     # (n_seg + 1, M, P)
    cos, sin = torch.cos(th), torch.sin(th)
    ones = torch.ones((n_seg + 1, M, D), dtype=rdt, device=dev)
    # factors[k]: (M, 1, 2, n) = (C, Sg[swap]) of step k
    factors = torch.stack([torch.cat([ones, cos, cos], dim=-1),
                           torch.cat([torch.zeros_like(ones), sin, -sin], dim=-1)],
                          dim=-2)[:, :, None]
    swap = torch.cat([torch.arange(D), torch.arange(D + P, D + 2 * P),
                      torch.arange(D, D + P)]).to(dev)
    UT = U_real.transpose(-1, -2)
    UT2 = torch.cat([UT, UT.index_select(-2, swap)], dim=-2)   # (M, 2n, n)

    v = x0s.to(rdt).expand(M, *x0s.shape[-2:])
    S, n = v.shape[-2:]
    for k in range(n_seg):
        v = torch.bmm((v.unsqueeze(-2) * factors[k]).reshape(M, S, 2 * n), UT2)
    halves = v.unsqueeze(-2) * factors[n_seg]               # the last rotation
    return halves[..., 0, :] + halves[..., 1, :].index_select(-1, swap)


def evolve_real_phased_population_cuda(U_real, cq, phases, x0s, D: int,
                                       P: int):
    """The population scan, routed by what its operands show:

      * CPU tensors: the plain twin (the loop).
      * an autograd graph being recorded (grad enabled and an operand that
        requires grad): the loop, on any device; the kernel has no backward.
      * CUDA, float32 or float64, and a member's U^T and states fit one
        block's shared memory (`resident`; n = 81 does): the kernel, one
        launch (counted in `evolve_real_phased_population_cuda.launches`).
      * CUDA and not resident (n = 256): the loop, counted in
        `evolve_real_phased_population_cuda.loop_calls` with the CUDA
        autograd route.
      * anything else raises: ValueError for shapes and devices, TypeError
        for dtypes. Nothing falls back from the kernel to the loop."""
    n = D + 2 * P
    if (U_real.ndim != 3 or U_real.shape[1:] != (n, n) or cq.shape != (P,)
            or phases.ndim != 2 or phases.shape[0] != U_real.shape[0]
            or x0s.shape[-1] != n
            or x0s.shape[:-2] not in ((), (U_real.shape[0],))):
        raise ValueError(f"shape mismatch: U {tuple(U_real.shape)}, cq "
                         f"{tuple(cq.shape)}, phases {tuple(phases.shape)}, x0s "
                         f"{tuple(x0s.shape)}, D={D}, P={P}")
    dev = U_real.device
    if dev.type == "cpu":
        return _evolve_real_phased_population_plain(U_real, cq, phases, x0s, D, P)
    if dev.type != "cuda":
        raise ValueError(f"evolve_real_phased_population: unsupported device {dev}")
    for t in (cq, phases, x0s):
        if t.device != dev:
            raise ValueError("all operands must be on U_real's device")
    ops = (U_real, cq, phases, x0s)
    M, n_seg = phases.shape
    S = x0s.shape[-2]
    if ((torch.is_grad_enabled() and any(t.requires_grad for t in ops))
            or (U_real.dtype in _ENTRY and not resident(n, S, U_real.dtype))):
        evolve_real_phased_population_cuda.loop_calls += 1
        return _evolve_real_phased_population_plain(U_real, cq, phases, x0s, D, P)
    if U_real.dtype not in _ENTRY:
        raise TypeError(f"evolve_real_phased_population: unsupported dtype "
                        f"{U_real.dtype}")
    if n_seg < 1:
        raise ValueError("evolve_real_phased_population: needs a segment")
    rdt = U_real.dtype
    out = torch.empty((M, S, n), dtype=rdt, device=dev)
    if M == 0:
        return out
    U = U_real.contiguous()
    cq = cq.to(rdt).contiguous()
    phases = phases.to(rdt).contiguous()
    x0 = x0s.to(rdt).contiguous()
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = getattr(lib, _ENTRY[rdt])(
            _kernels.ptr(U), _kernels.ptr(cq), _kernels.ptr(phases),
            _kernels.ptr(x0), ctypes.c_longlong(S * n if x0.ndim == 3 else 0),
            _kernels.ptr(out), M, S, n, D, P, n_seg,
            _kernels.stream_handle(dev))
        _kernels.check(lib, rc, "population scan kernel")
    evolve_real_phased_population_cuda.launches += 1
    return out


evolve_real_phased_population_cuda.launches = 0
evolve_real_phased_population_cuda.loop_calls = 0

__all__ = ["evolve_real_phased_population_cuda", "resident"]
