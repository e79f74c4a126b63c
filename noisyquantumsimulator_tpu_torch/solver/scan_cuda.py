"""Phase-frame scan of the real-basis gate engine: CUDA kernel K1 and its twin.

Counterpart of the reference's `solver/scan_pallas.py`
(`evolve_real_phased_many_pallas`). Contract of
`real_rep.evolve_real_phased_many`: U_real (n, n); cq (P,);
phases_bn (B, n_seg); x0s (S, n) initial coordinates shared by every
schedule; returns (B, S, n), n = D + 2P.

The first and last frame rotations are torch ops; the n_seg-step loop in
between (rotate by dphi_k * cq, then v <- v U^T) is the kernel
(`csrc/phase_scan.cu`), which keeps each block of schedules in shared memory
for all steps. Its float32 product runs on the tensor cores as a 3xTF32
split (float32-level accuracy); float64 runs on the FP64 pipes. `evolve_real_phased_many_cuda` dispatches on the tensor's
device: CUDA runs the kernel, CPU runs `_evolve_real_phased_many_plain`, any
other device raises. Nothing falls back from the kernel to the twin.
"""
from __future__ import annotations

import torch

from .. import _kernels
from .real_rep import _rotate

_ENTRY = {torch.float32: "nqs_phase_scan_f32",
          torch.float64: "nqs_phase_scan_f64"}


def _prologue(U_real, cq, phases_bn, x0s, D: int, P: int):
    """dphi (B, n_seg) and the first-rotated state v0 (B, S, n), in U's dtype."""
    rdt = U_real.dtype
    cq = cq.to(rdt)
    ph = phases_bn.to(rdt)
    dphi = torch.cat([torch.zeros_like(ph[:, :1]), ph[:, :-1] - ph[:, 1:]],
                     dim=1)
    v0 = _rotate(x0s.to(rdt)[None], -ph[:, 0, None], cq, D, P)
    return cq, ph, dphi, v0


def _evolve_real_phased_many_plain(U_real, cq, phases_bn, x0s, D: int,
                                   P: int):
    """Plain PyTorch twin of kernel K1 (same op order: rotate, then matmul,
    per step)."""
    S, n = x0s.shape
    cq, ph, dphi, v = _prologue(U_real, cq, phases_bn, x0s, D, P)
    B = ph.shape[0]
    UrT = U_real.T
    for k in range(ph.shape[1]):
        v = _rotate(v, dphi[:, k, None], cq, D, P)
        v = (v.reshape(B * S, n) @ UrT).reshape(B, S, n)
    return _rotate(v, ph[:, -1, None], cq, D, P)


def evolve_real_phased_many_cuda(U_real, cq, phases_bn, x0s, D: int, P: int):
    """Kernel K1 on CUDA tensors (launches counted in
    `evolve_real_phased_many_cuda.launches`); the plain twin on CPU tensors."""
    S, n = x0s.shape
    if n != D + 2 * P or U_real.shape != (n, n) or cq.shape != (P,):
        raise ValueError(f"shape mismatch: U {tuple(U_real.shape)}, cq "
                         f"{tuple(cq.shape)}, x0s {tuple(x0s.shape)}, D={D}, "
                         f"P={P}")
    if phases_bn.ndim != 2:
        raise ValueError(f"phases_bn must be (B, n_seg), got "
                         f"{tuple(phases_bn.shape)}")
    dev = U_real.device
    if dev.type == "cpu":
        return _evolve_real_phased_many_plain(U_real, cq, phases_bn, x0s, D, P)
    if dev.type != "cuda":
        raise ValueError(f"evolve_real_phased_many: unsupported device {dev}")
    if U_real.dtype not in _ENTRY:
        raise TypeError(f"evolve_real_phased_many: unsupported dtype "
                        f"{U_real.dtype}")
    for t in (cq, phases_bn, x0s):
        if t.device != dev:
            raise ValueError("all operands must be on U_real's device")
    B, n_seg = phases_bn.shape
    cq, ph, dphi, v0 = _prologue(U_real, cq, phases_bn, x0s, D, P)
    if B == 0:
        return v0
    UT = U_real.T.contiguous()
    v0 = v0.contiguous()
    dphi = dphi.contiguous()
    cq = cq.contiguous()
    out = torch.empty_like(v0)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        rc = getattr(lib, _ENTRY[U_real.dtype])(
            _kernels.ptr(UT), _kernels.ptr(cq), _kernels.ptr(dphi),
            _kernels.ptr(v0), _kernels.ptr(out), B, S, n, D, P, n_seg,
            _kernels.stream_handle(dev))
        _kernels.check(lib, rc, "phase scan kernel")
    evolve_real_phased_many_cuda.launches += 1
    return _rotate(out, ph[:, -1, None], cq, D, P)


evolve_real_phased_many_cuda.launches = 0

__all__ = ["evolve_real_phased_many_cuda"]
