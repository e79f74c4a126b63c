"""The fault walk of `fast_sampler` on the card: one CUDA launch a sample.

Replaces no Pallas kernel: the reference samples with XLA uniforms and one
int8 product (`qec/fast_sampler.py`). Contract, with the draw table of
`fast_sampler._draw_table` (n_draws draws, n_det detectors, n_obs
observables, n_erase erasures) and S shots:

  dets (S, n_det) uint8, obs (S, n_obs) uint8, heralds (S, n_erase) uint8

the parities of the signatures of every fault bit that the shot's draws
set, and the erasures that fired. The draws come from Philox4x32-10 under a
key of two 32-bit words drawn on the card from the caller's generator
(counter: the draw's group of four, the shot), or, given `draws=(u,
ebits)`, from the op route's uniforms (S, n_draws) float32 and erasure bits
(S, n_erase, 2) uint8: the route of the tests, bit for bit the op route's.

A CUDA table runs the kernel (`csrc/fast_sampler.cu`), one launch a call
(counted in `walk.launches`). The twin is the op route of
`build_fast_sampler` (`sample.op_route`), which every other device takes;
nothing here falls back to it. A table on another device, draws of another
shape, dtype or device, or a signature width whose bitsets do not fit one
warp's shared memory raise.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from .._kernels import MAX_SMEM_BYTES

THREADS = 256              # threads a block, unless one shot's bitset is wide
SPLIT_THREADS = 1 << 18    # split each shot's walk while fewer threads than this run
MIN_SPLIT_DRAWS = 256      # draws a thread walks at least


def tables(table: dict, device) -> dict:
    """The draw table on `device`, as the kernel reads it."""
    dev = torch.device(device)
    out = {k: torch.as_tensor(np.ascontiguousarray(table[k]), device=dev)
           for k in ("rec", "cum", "sig_ptr", "sig_col")}
    out.update({k: int(table[k]) for k in ("n_det", "n_obs", "n_erase")})
    out["n_draws"] = int(table["rec"].shape[0])
    out["strides"] = tuple(int(s) for s in table["strides"])
    return out


def layout(n_out: int, n_draws: int, shots: int):
    """(shots a block, threads a shot, draws a thread) for bitsets of n_out
    bits, one 32-bit word per 32 bits and shot. A shot's draws are split
    over 1, 2, 4 or 8 threads until 2^18 threads run or a thread would walk
    fewer than 256 draws; a block holds 256 threads, fewer where the
    bitsets of 256 / split shots do not fit. Raises where one warp's
    bitsets do not fit."""
    words = (n_out + 31) // 32
    split = 1
    while (split < 8 and shots * split < SPLIT_THREADS
           and n_draws >= 2 * split * MIN_SPLIT_DRAWS):
        split *= 2
    fit = MAX_SMEM_BYTES // max(4 * words, 1) // 32 * 32
    if fit < 32:
        raise ValueError(f"sampler: a bitset of {n_out} bits for one warp's 32 shots "
                         f"needs {128 * words} B of shared memory, above the card's "
                         f"{MAX_SMEM_BYTES}")
    block_shots = min(THREADS // split, fit)
    per_thread = -(-n_draws // split)
    span = -(-per_thread // 4) * 4            # whole Philox groups of four draws
    return block_shots, split, span


def walk(tab: dict, shots: int, generator: torch.Generator = None, draws=None):
    """One sample of `shots` shots under `tables(...)`'s table on the card:
    (dets, obs, heralds) uint8 there. Exactly one of `generator` (a
    torch.Generator on the card) and `draws` ((u, ebits) as the op route's
    `draws` gives them) is given. One kernel launch, counted in
    `walk.launches`; no host synchronisation."""
    dev = tab["rec"].device
    if dev.type != "cuda":
        raise ValueError(f"sampler kernel: table on {dev}, not a CUDA device")
    if (generator is None) == (draws is None):
        raise ValueError("sampler kernel: give a generator or draws, not both")
    n_draws, n_det, n_obs, ne = tab["n_draws"], tab["n_det"], tab["n_obs"], tab["n_erase"]
    key = u = ebits = None
    if draws is None:
        # the key: two words drawn on the card, never read on the host
        key = torch.empty(2, dtype=torch.int64, device=dev).random_(
            0, 1 << 32, generator=generator)
    else:
        u, ebits = draws
        if (u.shape != (shots, n_draws) or ebits.shape != (shots, ne, 2)
                or u.dtype != torch.float32 or ebits.dtype != torch.uint8
                or u.device != dev or ebits.device != dev
                or not (u.is_contiguous() and ebits.is_contiguous())):
            raise ValueError(f"sampler kernel: draws {tuple(u.shape)} {u.dtype} and bits "
                             f"{tuple(ebits.shape)} {ebits.dtype} on {u.device}; takes "
                             f"contiguous ({shots}, {n_draws}) float32 and ({shots}, "
                             f"{ne}, 2) uint8 on {dev}")
    block_shots, split, span = layout(n_det + n_obs + ne, n_draws, shots)
    dets = torch.empty((shots, n_det), dtype=torch.uint8, device=dev)
    obs = torch.empty((shots, n_obs), dtype=torch.uint8, device=dev)
    heralds = torch.empty((shots, ne), dtype=torch.uint8, device=dev)
    if shots == 0:
        return dets, obs, heralds
    lib = _kernels.load()

    def p(t):
        return _kernels.ptr(t) if t is not None and t.numel() else None

    st = tab["strides"]
    with torch.cuda.device(dev):
        rc = lib.nqs_fault_walk(p(tab["rec"]), p(tab["cum"]), p(tab["sig_ptr"]),
                                p(tab["sig_col"]), p(key), p(u), p(ebits), p(dets), p(obs),
                                p(heralds), int(draws is not None), n_draws, n_det, n_obs,
                                ne, st[1], st[2], st[3], st[4], shots, block_shots, split,
                                span,
                                _kernels.stream_handle(dev))
        _kernels.check(lib, rc, "sampler kernel")
    walk.launches += 1
    return dets, obs, heralds


walk.launches = 0

__all__ = ["walk", "tables", "layout"]
