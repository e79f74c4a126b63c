"""Min-sum check-to-variable update of slot-layout BP: CUDA kernel K3 and its twin.

Counterpart of the reference's `qec/bp_kernels.py` (`c2v_pallas`). Contract
of the slab form of `ldpc._bp_slots`'s check-node update: msg3
(w_max, n_chk, S), slot-major with shots last; sgn_syn (n_chk, S) in
{+1, -1}; returns the extrinsics (w_max, n_chk, S) in msg3's dtype. An edge
that holds the unique minimum of its check sees min2, tied minima all see
min1; padding slots carry +1e30 and never win the minimum.

`c2v` dispatches on the tensor's device: a CUDA tensor runs the hand-written
kernel (`csrc/bp_c2v.cu`), a CPU tensor runs the plain twin `_c2v_plain`.
Any other device, dtype, layout or a w_max above the kernel's register
budget raises; nothing falls back from the kernel to the twin.
"""
from __future__ import annotations

import torch

from .. import _kernels

_ENTRY = {torch.float32: "nqs_bp_c2v_f32",
          torch.bfloat16: "nqs_bp_c2v_bf16"}
MAX_SLOTS = 32          # kMaxSlots in csrc/bp_c2v.cu
BIG = 1e30              # padding-slot sentinel, held in the storage dtype


def _c2v_plain(msg3: torch.Tensor, sgn_syn: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Plain PyTorch twin: the slab form of the reference's XLA c2v
    (`ldpc._bp_slots`), op for op, in the storage dtype."""
    sgn = 1 - 2 * (msg3 < 0).to(msg3.dtype)            # padding (+big) -> +1
    mag = msg3.abs()
    m1 = mag.amin(dim=0)                                # (n_chk, S)
    is1 = mag == m1[None]
    cnt = is1.sum(dim=0, dtype=torch.int32)
    m2 = torch.where(is1, BIG, mag).amin(dim=0)
    prod = sgn.prod(dim=0) * sgn_syn                    # (n_chk, S)
    ext_min = torch.where(is1 & (cnt == 1)[None], m2[None], m1[None])
    ext_sgn = prod[None] * sgn
    return scale * ext_sgn * ext_min


def c2v(msg3: torch.Tensor, sgn_syn: torch.Tensor, scale: float) -> torch.Tensor:
    """msg3 (w_max, n_chk, S), sgn_syn (n_chk, S), both float32 or both
    bfloat16 -> extrinsics (w_max, n_chk, S).

    CUDA tensors: kernel K3, one launch per call (counted in
    `c2v.launches`). CPU tensors: the plain twin."""
    if msg3.ndim != 3:
        raise ValueError(f"msg3 must be (w_max, n_chk, S), got {tuple(msg3.shape)}")
    w, n_chk, S = msg3.shape
    if sgn_syn.shape != (n_chk, S):
        raise ValueError(f"sgn_syn must be ({n_chk}, {S}), got "
                         f"{tuple(sgn_syn.shape)}")
    if sgn_syn.dtype != msg3.dtype:
        raise TypeError(f"sgn_syn dtype {sgn_syn.dtype} != msg3 dtype {msg3.dtype}")
    if msg3.device.type == "cpu":
        return _c2v_plain(msg3, sgn_syn, scale)
    if msg3.device.type != "cuda":
        raise ValueError(f"c2v: unsupported device {msg3.device}")
    if msg3.dtype not in _ENTRY:
        raise TypeError(f"c2v: unsupported dtype {msg3.dtype}")
    if sgn_syn.device != msg3.device:
        raise ValueError("msg3 and sgn_syn must be on the same device")
    if not (msg3.is_contiguous() and sgn_syn.is_contiguous()):
        raise ValueError("c2v: msg3 and sgn_syn must be contiguous")
    if not 1 <= w <= MAX_SLOTS:
        raise ValueError(f"c2v: w_max = {w} outside the kernel's 1..{MAX_SLOTS}")
    out = torch.empty_like(msg3)
    if msg3.numel() == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(msg3.device):
        rc = getattr(lib, _ENTRY[msg3.dtype])(
            _kernels.ptr(msg3), _kernels.ptr(sgn_syn), _kernels.ptr(out),
            w, n_chk, S, float(scale), _kernels.stream_handle(msg3.device))
        _kernels.check(lib, rc, "min-sum c2v kernel")
    c2v.launches += 1
    return out


c2v.launches = 0

__all__ = ["c2v", "MAX_SLOTS"]
