"""Masked squaring chain of the batched expm: CUDA kernel K2 and its twin.

Counterpart of the reference's `ops/expm_pallas.py` (`fused_masked_squaring`).
For each batch element b, R[b] is squared in place for every trip
i < s[b] of a fixed loop of `max_squarings` trips, so a batch whose elements
need different squaring counts runs as one fixed-shape computation.

`fused_masked_squaring` dispatches on the tensor's device: a CUDA tensor runs
the hand-written kernel (`csrc/masked_squaring.cu`), a CPU tensor runs the
plain twin `_masked_squaring_plain`. Any other device raises; nothing falls
back from the kernel to the twin.
"""
from __future__ import annotations

import torch

from .. import _kernels

_ENTRY = {
    torch.float32: "nqs_masked_squaring_f32",
    torch.float64: "nqs_masked_squaring_f64",
    torch.complex64: "nqs_masked_squaring_c64",
    torch.complex128: "nqs_masked_squaring_c128",
}


def _masked_squaring_plain(R: torch.Tensor, s: torch.Tensor,
                           max_squarings: int) -> torch.Tensor:
    """Plain PyTorch twin: the same masked fixed-trip loop with torch.matmul."""
    s_b = s.reshape(-1, 1, 1)
    for i in range(max_squarings):
        R = torch.where(s_b > i, torch.matmul(R, R), R)
    return R


def fused_masked_squaring(R: torch.Tensor, s: torch.Tensor,
                          max_squarings: int) -> torch.Tensor:
    """R (B, N, N) float32/float64/complex64/complex128, s (B,) int ->
    R[b]^(2^min(s[b], max_squarings)), batch-element-wise.

    CUDA tensors: kernel K2, one launch per trip (counted in
    `fused_masked_squaring.launches`). CPU tensors: the plain twin."""
    if R.ndim != 3 or R.shape[-1] != R.shape[-2]:
        raise ValueError(f"R must be (B, N, N), got {tuple(R.shape)}")
    if s.shape != R.shape[:1]:
        raise ValueError(f"s must be ({R.shape[0]},), got {tuple(s.shape)}")
    if R.device.type == "cpu":
        return _masked_squaring_plain(R, s, max_squarings)
    if R.device.type != "cuda":
        raise ValueError(f"fused_masked_squaring: unsupported device {R.device}")
    if R.dtype not in _ENTRY:
        raise TypeError(f"fused_masked_squaring: unsupported dtype {R.dtype}")
    if s.device != R.device:
        raise ValueError("R and s must be on the same device")
    B, N, _ = R.shape
    if B == 0 or max_squarings <= 0:
        return R.clone()
    lib = _kernels.load()
    buf0 = R.contiguous().clone()
    buf1 = torch.empty_like(buf0)
    s32 = s.to(torch.int32).contiguous()
    with torch.cuda.device(R.device):
        rc = getattr(lib, _ENTRY[R.dtype])(
            _kernels.ptr(buf0), _kernels.ptr(buf1), _kernels.ptr(s32),
            int(max_squarings), B, N, _kernels.stream_handle(R.device))
        _kernels.check(lib, rc, "masked squaring kernel")
    fused_masked_squaring.launches += int(max_squarings)
    return buf1 if max_squarings % 2 else buf0


fused_masked_squaring.launches = 0

__all__ = ["fused_masked_squaring"]
