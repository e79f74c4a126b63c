"""Per-instruction Pauli-frame sampler.

Counterpart of the reference's `qec/pauli_frame.py`. The frame (x, z)
tracks a Pauli error relative to the ideal circuit; all shots evolve at
once as (shots, n_qubits) uint8 tensors, instruction by instruction.
Measurement records are the frame's x bits (a Z-basis measurement flips
iff an X-type error is present) plus classical flip noise; detectors and
observables are GF(2) combinations of the record matrix, taken as float32
products of 0/1 operands (exact: every sum is an integer below 2^24, TF32
is off) reduced mod 2.

After a reset the z frame is randomized (Stim's trick, which makes the
frame distribution correct for circuits with resets), so this sampler also
serves circuits whose detectors are not deterministic, where the fast
(signature) sampler refuses.

Randomness comes from an explicit torch.Generator on the sampler's device
where the reference splits jax.random keys: the two agree in distribution,
not bit for bit.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from .circuits import Circuit, detector_matrix, observable_matrix


def _u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.uint8)


def _apply_gate(name, x, z, t):
    """Frame propagation through Clifford gates (Heisenberg picture)."""
    if name in ("I", "X", "Z", "Y"):
        return x, z  # Paulis commute with the frame up to sign
    if name == "H":
        xt, zt = x[:, t], z[:, t]
        x[:, t] = zt
        z[:, t] = xt
        return x, z
    if name == "S":
        z[:, t] = z[:, t] ^ x[:, t]          # X -> Y
        return x, z
    if name == "CX":
        c, tt = t[:, 0], t[:, 1]
        x[:, tt] = x[:, tt] ^ x[:, c]
        z[:, c] = z[:, c] ^ z[:, tt]
        return x, z
    if name == "CZ":
        c, tt = t[:, 0], t[:, 1]
        z[:, tt] = z[:, tt] ^ x[:, c]
        z[:, c] = z[:, c] ^ x[:, tt]
        return x, z
    if name == "SWAP":
        a, b = t[:, 0], t[:, 1]
        xa, xb = x[:, a], x[:, b]
        za, zb = z[:, a], z[:, b]
        x[:, a], x[:, b] = xb, xa
        z[:, a], z[:, b] = zb, za
        return x, z
    raise ValueError(f"Unknown gate: {name}")


def _pair_paulis(x, z, a, b, idx):
    """Apply two-qubit Pauli index idx = 4 * pa + pb (0 I, 1 X, 2 Y, 3 Z)."""
    pa, pb = idx // 4, idx % 4
    x[:, a] = x[:, a] ^ _u8((pa == 1) | (pa == 2))
    z[:, a] = z[:, a] ^ _u8((pa == 2) | (pa == 3))
    x[:, b] = x[:, b] ^ _u8((pb == 1) | (pb == 2))
    z[:, b] = z[:, b] ^ _u8((pb == 2) | (pb == 3))
    return x, z


def _apply_channel(name, gen, x, z, t, p, probs, shots):
    dev = x.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    if name == "X_ERROR":
        x[:, t] = x[:, t] ^ _u8(uniform(shots, len(t)) < p)
        return x, z
    if name == "Z_ERROR":
        z[:, t] = z[:, t] ^ _u8(uniform(shots, len(t)) < p)
        return x, z
    if name == "DEPOLARIZE1":
        u = uniform(shots, len(t))
        x[:, t] = x[:, t] ^ _u8(u < 2.0 * p / 3.0)
        z[:, t] = z[:, t] ^ _u8((u >= p / 3.0) & (u < p))
        return x, z
    if name == "DEPOLARIZE2":
        u = uniform(shots, len(t))
        # error index 1..15 uniform on a hit
        idx = torch.floor(u / max(p, 1e-30) * 15.0).to(torch.int32) + 1
        idx = torch.where(u < p, idx, 0)
        return _pair_paulis(x, z, t[:, 0], t[:, 1], idx)
    if name == "PAULI_CHANNEL_2":
        # probs: host numbers, or a float32 vector already on the device
        cum = torch.cumsum(torch.as_tensor(probs, dtype=torch.float32,
                                           device=dev), 0)
        u = uniform(shots, len(t), 1)
        idx = (u >= cum[None, None, :]).sum(dim=-1).clamp(0, 15)
        return _pair_paulis(x, z, t[:, 0], t[:, 1], idx)
    if name == "ERASE":
        # heralded loss -> a uniformly random Pauli on the erased qubit
        hit = _u8(uniform(shots, len(t)) < p)
        u = torch.randint(0, 2, (shots, len(t), 2), generator=gen,
                          device=dev, dtype=torch.uint8)
        x[:, t] = x[:, t] ^ (hit & u[..., 0])
        z[:, t] = z[:, t] ^ (hit & u[..., 1])
        return x, z
    raise ValueError(f"Unknown channel: {name}")


_GATES = ("H", "S", "X", "Z", "Y", "I", "CX", "CZ", "SWAP")
_CHANNELS = ("X_ERROR", "Z_ERROR", "DEPOLARIZE1", "DEPOLARIZE2",
             "PAULI_CHANNEL_2", "ERASE")


def build_sampler(circuit: Circuit, shots: int,
                  device: Union[str, torch.device] = "cuda"):
    """Compile the circuit into a sampling function on `device`.

    Returns sample(generator) -> dict with
      detectors    (shots, n_detectors) uint8
      observables  (shots, n_observables) uint8
      measurements (shots, n_measurements) uint8
    on `device`; `generator` is a torch.Generator on that device."""
    dev = torch.device(device)
    n = circuit.n_qubits
    Dt = torch.as_tensor(detector_matrix(circuit).T.astype(np.float32),
                         device=dev)
    Ot = torch.as_tensor(observable_matrix(circuit).T.astype(np.float32),
                         device=dev)
    instructions = [(ins.name, torch.as_tensor(np.asarray(ins.targets),
                                               dtype=torch.int64, device=dev),
                     ins.arg or 0.0, ins.probs)
                    for ins in circuit.instructions]
    for name, *_ in instructions:
        if name not in _GATES + _CHANNELS + ("M", "MR", "R"):
            raise ValueError(f"Unknown instruction: {name}")

    def gauge(gen, k):
        return torch.randint(0, 2, (shots, k), generator=gen, device=dev,
                             dtype=torch.uint8)

    def sample(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        x = torch.zeros((shots, n), dtype=torch.uint8, device=dev)
        z = torch.zeros((shots, n), dtype=torch.uint8, device=dev)
        records = []
        for name, t, arg, probs in instructions:
            if name in _GATES:
                x, z = _apply_gate(name, x, z, t)
            elif name in _CHANNELS:
                x, z = _apply_channel(name, generator, x, z, t, arg, probs,
                                      shots)
            elif name in ("M", "MR"):
                rec = x[:, t]
                if arg:  # classical flip noise
                    rec = rec ^ _u8(torch.rand(rec.shape, generator=generator,
                                               device=dev) < arg)
                records.append(rec)
                if name == "MR":
                    x[:, t] = 0
                    z[:, t] = gauge(generator, len(t))
            else:                                   # R
                x[:, t] = 0
                z[:, t] = gauge(generator, len(t))
        meas = (torch.cat(records, dim=1) if records
                else torch.zeros((shots, 0), dtype=torch.uint8, device=dev))
        mf = meas.to(torch.float32)

        def gf2(M):
            if M.shape[1] == 0:
                return torch.zeros((shots, 0), dtype=torch.uint8, device=dev)
            return _u8((mf @ M).to(torch.int32) & 1)

        return {"measurements": meas, "detectors": gf2(Dt),
                "observables": gf2(Ot)}

    return sample


def sample_circuit(circuit: Circuit, shots: int, seed: int = 0,
                   device: Union[str, torch.device] = "cuda") -> Dict:
    """One sample of `shots` shots from a generator seeded with `seed`, as
    host numpy arrays."""
    fn = build_sampler(circuit, shots, device)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return {k: v.cpu().numpy() for k, v in fn(gen).items()}


__all__ = ["build_sampler", "sample_circuit"]
