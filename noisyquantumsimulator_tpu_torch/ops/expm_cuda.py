"""Masked squaring chain of the batched expm: CUDA kernel K2 and its twin.

Counterpart of the reference's `ops/expm_pallas.py` (`fused_masked_squaring`).
For each batch element b, R[b] is squared in place for every trip
i < s[b] of a fixed loop of `max_squarings` trips, so a batch whose elements
need different squaring counts runs as one fixed-shape computation. With
`max_squarings=None` every element takes its s[b] squarings: the CPU and the
resident route need no bound on the host, and the tiled route reads max(s)
there once (a sync).

`fused_masked_squaring` dispatches on the tensor's device: a CUDA tensor runs
the hand-written kernel (`csrc/masked_squaring.cu`), a CPU tensor runs the
plain twin `_masked_squaring_plain`. Any other device raises; nothing falls
back from the kernel to the twin.

The kernel has two routes, chosen by its launcher from N and the dtype: a
matrix pair that fits in one block's shared memory (N = 81 at every dtype)
runs its whole chain in ONE launch; larger matrices (N = 256) take one
launch per trip through tiles, with two scratch buffers. Either way a trip
past s[b] moves no byte of matrix b.

Gradients: when R requires grad (and grad mode is on) the chain runs as the
autograd Function `_MaskedSquaringFn`. Its forward is the same dispatch and
saves only R and s. Its backward reads T = min(max s, max_squarings) once,
recomputes the inputs R_0 .. R_{T-1} of the trips with the same dispatch
(K2 on the card, one trip a launch with the mask s > i), and runs the
reverse masked loop

    G <- where(s > i, G R_i^H + R_i^H G, G),   i = T-1 .. 0

with torch.matmul: the gradient of Y = R R in PyTorch's conjugate-Wirtinger
convention (^H is ^T for real dtypes). s gets no gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels

# more squarings than any finite 1-norm needs (2^1024 is past float64's range)
_ALL = 1024

# dtype -> (C entry point, type code of nqs_masked_squaring_is_resident)
_ENTRY = {
    torch.float32: ("nqs_masked_squaring_f32", 0),
    torch.float64: ("nqs_masked_squaring_f64", 1),
    torch.complex64: ("nqs_masked_squaring_c64", 2),
    torch.complex128: ("nqs_masked_squaring_c128", 3),
}


def _trips(s: torch.Tensor, max_squarings: Optional[int]) -> int:
    """The loop length: max_squarings, or max(s) (read on the host) if None."""
    if max_squarings is not None:
        return int(max_squarings)
    return min(int(s.max()), _ALL) if s.numel() else 0


def _masked_squaring_plain(R: torch.Tensor, s: torch.Tensor,
                           max_squarings: Optional[int]) -> torch.Tensor:
    """Plain PyTorch twin: the same masked fixed-trip loop with torch.matmul."""
    s_b = s.reshape(-1, 1, 1)
    for i in range(_trips(s, max_squarings)):
        R = torch.where(s_b > i, torch.matmul(R, R), R)
    return R


def fused_masked_squaring(R: torch.Tensor, s: torch.Tensor,
                          max_squarings: Optional[int] = None) -> torch.Tensor:
    """R (B, N, N) float32/float64/complex64/complex128, s (B,) int ->
    R[b]^(2^min(s[b], max_squarings)) (R[b]^(2^s[b]) when max_squarings is
    None), batch-element-wise.

    CUDA tensors: kernel K2, one launch per chain on its resident route and
    one per trip on its tiled route (counted in
    `fused_masked_squaring.launches`). CPU tensors: the plain twin. When R
    requires grad the chain is differentiable in R (`_MaskedSquaringFn`);
    otherwise nothing is recorded."""
    if R.ndim != 3 or R.shape[-1] != R.shape[-2]:
        raise ValueError(f"R must be (B, N, N), got {tuple(R.shape)}")
    if s.shape != R.shape[:1]:
        raise ValueError(f"s must be ({R.shape[0]},), got {tuple(s.shape)}")
    if torch.is_grad_enabled() and R.requires_grad:
        return _MaskedSquaringFn.apply(R, s, max_squarings)
    return _squaring(R, s, max_squarings)


def _squaring(R: torch.Tensor, s: torch.Tensor,
              max_squarings: Optional[int]) -> torch.Tensor:
    """The chain on R's device: the twin on the CPU, K2 on the card."""
    if R.device.type == "cpu":
        return _masked_squaring_plain(R, s, max_squarings)
    if R.device.type != "cuda":
        raise ValueError(f"fused_masked_squaring: unsupported device {R.device}")
    if R.dtype not in _ENTRY:
        raise TypeError(f"fused_masked_squaring: unsupported dtype {R.dtype}")
    if s.device != R.device:
        raise ValueError("R and s must be on the same device")
    B, N, _ = R.shape
    if B == 0 or (max_squarings is not None and max_squarings <= 0):
        return R.clone()
    lib = _kernels.load()
    entry, code = _ENTRY[R.dtype]
    with torch.cuda.device(R.device):
        resident = bool(lib.nqs_masked_squaring_is_resident(code, N))
    if max_squarings is None:
        # the resident route loops to s[b] on the device; the tiled route
        # needs its launch count on the host
        max_squarings = _ALL if resident else _trips(s, None)
        if max_squarings <= 0:
            return R.clone()
    src = R.contiguous()
    out = torch.empty_like(src)
    s32 = s.to(torch.int32).contiguous()
    with torch.cuda.device(R.device):
        # the tiled route ping-pongs between two scratch buffers; trip 0 reads
        # R itself and a matrix's last squaring writes `out`
        scratch = [None if resident or max_squarings < need
                   else torch.empty_like(src) for need in (2, 3)]
        rc = getattr(lib, entry)(
            _kernels.ptr(src), _kernels.ptr(out),
            *(None if t is None else _kernels.ptr(t) for t in scratch),
            _kernels.ptr(s32), int(max_squarings), B, N,
            _kernels.stream_handle(R.device))
        _kernels.check(lib, rc, "masked squaring kernel")
    fused_masked_squaring.launches += 1 if resident else int(max_squarings)
    return out


class _MaskedSquaringFn(torch.autograd.Function):
    """The masked squaring chain with a backward (see the module docstring).
    The trips' inputs are recomputed, not kept: the forward saves R and s."""

    @staticmethod
    def forward(ctx, R, s, max_squarings):
        ctx.save_for_backward(R, s)
        ctx.max_squarings = max_squarings
        return _squaring(R, s, max_squarings)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, G):
        R, s = ctx.saved_tensors
        T = _trips(s, None)
        if ctx.max_squarings is not None:
            T = min(T, max(ctx.max_squarings, 0))
        trips = [R]
        for i in range(T - 1):
            trips.append(_squaring(trips[-1], (s > i).to(torch.int32), 1))
        s_b = s.reshape(-1, 1, 1)
        for i in range(T - 1, -1, -1):
            RH = trips[i].mH
            G = torch.where(s_b > i, G @ RH + RH @ G, G)
        return G, None, None


fused_masked_squaring.launches = 0

__all__ = ["fused_masked_squaring"]
