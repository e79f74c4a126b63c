"""Surface-code memory experiments: sample -> decode -> logical error rate.

Counterpart of the reference's `qec/memory.py`. Sampling runs on the card
with a torch.Generator seeded from `seed`; the decoders are the port's.

The decoder choice `auto` is "native" below d = 9 and "cluster_native" from
d = 9 on, as in the reference when its C++ library is built. The port never
switches to the greedy decoder when the library cannot be built: the native
kinds raise then. One switch stays, the reference's semantics: the fast
sampler refuses circuits whose detectors are not deterministic (ValueError)
and those go to the Pauli-frame sampler, also on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import numpy as np
import torch

from .circuits import Circuit
from .decoders import decoder_for_circuit
from .fast_sampler import build_fast_sampler
from .pauli_frame import build_sampler
from .surface_code import logical_error_rate, memory_z_circuit


@dataclass
class MemoryResult:
    d: int
    rounds: int
    p: float
    shots: int
    n_logical_errors: int
    p_logical_shot: float
    p_logical_round: float
    sample_seconds: float
    decode_seconds: float
    shots_per_second: float
    detector_fraction: float
    decoder: str
    extras: Dict = field(default_factory=dict)

    def __repr__(self):
        return (f"MemoryResult(d={self.d}, rounds={self.rounds}, p={self.p}, "
                f"shots={self.shots}, p_L/shot={self.p_logical_shot:.2e}, "
                f"p_L/round={self.p_logical_round:.2e}, "
                f"{self.shots_per_second:.0f} shots/s)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_memory(
    d: int = 3,
    rounds: Optional[int] = None,
    p: float = 1e-3,
    shots: int = 10000,
    noise: str = "circuit",
    cz_pauli_probs: Optional[np.ndarray] = None,
    decoder: str = "auto",
    seed: int = 0,
    circuit: Optional[Circuit] = None,
    max_defects: int = 32,
    sampler_kind: str = "fast",
    basis: str = "Z",
    device: Union[str, torch.device] = "cuda",
) -> MemoryResult:
    """Surface-code memory experiment (basis "Z" or "X") on `device`.

    sampler_kind: "fast" is the one-matmul sampler (fast_sampler.py),
    "frame" the per-instruction Pauli-frame sampler; "fast" takes the frame
    sampler for circuits with non-deterministic detectors. decoder: "auto",
    "matching" (batched greedy), "uf", "native", "cluster",
    "cluster_native", "window" or "window_native"."""
    dev = torch.device(device)
    rounds = rounds if rounds is not None else d
    built_here = circuit is None
    if circuit is None:
        if basis.upper() == "X":
            from .surface_code import memory_x_circuit
            circuit = memory_x_circuit(d, rounds, noise=noise, p=p,
                                       cz_pauli_probs=cz_pauli_probs)
        elif basis.upper() == "Z":
            circuit = memory_z_circuit(d, rounds, noise=noise, p=p,
                                       cz_pauli_probs=cz_pauli_probs)
        else:
            raise ValueError(f"basis must be 'Z' or 'X', got {basis!r}")

    if decoder == "auto":
        decoder = "cluster_native" if d >= 9 else "native"

    if sampler_kind == "fast":
        try:
            sampler = build_fast_sampler(circuit, shots, dev)
        except ValueError:
            sampler = build_sampler(circuit, shots, dev)
    else:
        sampler = build_sampler(circuit, shots, dev)
    if decoder in ("cluster", "cluster_native"):
        from .cluster_matcher import cluster_matcher_for_circuit
        cchunk = min(4096 if circuit.n_detectors <= 512 else 2048,
                     max(256, shots))
        dec = cluster_matcher_for_circuit(
            circuit, chunk=cchunk, escalating=decoder == "cluster_native",
            device=dev)
    elif decoder in ("window", "window_native"):
        if not built_here:
            raise ValueError(
                f"decoder={decoder!r} needs the round labels of a memory "
                "circuit built by run_memory itself; for external circuits "
                "construct qec.window_matcher_for_circuit (or "
                "qec.escalating_matcher_for_circuit) with your own "
                "det_round labels")
        from .surface_code import memory_detector_rounds
        det_round = memory_detector_rounds(d, rounds, basis=basis)
        K_dp = min(12, max_defects)
        wchunk = min(4096, max(256, shots))
        # W = 7, C = 3: a 4-round commit buffer (the reference's choice)
        W, C = (7, 3) if rounds >= 5 else (5, 2)
        if decoder == "window_native":
            from .window_matcher import escalating_matcher_for_circuit
            dec = escalating_matcher_for_circuit(
                circuit, det_round, window_rounds=W, commit_rounds=C,
                max_defects=K_dp, k_light=6 if K_dp > 6 else 0,
                chunk=wchunk, heavy_capacity=max(wchunk // 16, 64),
                device=dev)
        else:
            # the per-window exact DP stays at min(12, max_defects); windows
            # past it go to the greedy tier with the full budget
            from .window_matcher import window_matcher_for_circuit
            dec = window_matcher_for_circuit(
                circuit, det_round, window_rounds=W, commit_rounds=C,
                max_defects=K_dp, k_light=6 if K_dp > 6 else 0,
                greedy_fallback=max_defects if max_defects > K_dp else 0,
                chunk=wchunk, device=dev)
    else:
        dec = decoder_for_circuit(circuit, kind=decoder,
                                  max_defects=max_defects, device=dev)

    def gen(s):
        g = torch.Generator(device=dev)
        g.manual_seed(s)
        return g

    sampler(gen(seed))                     # warm-up outside the timed region
    _sync(dev)
    t0 = time.perf_counter()
    out = sampler(gen(seed + 1))
    _sync(dev)
    t_sample = time.perf_counter() - t0

    dets = out["detectors"].cpu().numpy()
    obs = out["observables"][:, 0].cpu().numpy()

    pred = dec.decode_batch(dets)
    t_decode = getattr(dec, "last_decode_seconds", 0.0)

    errors = int(np.sum((pred & 1) != (obs & 1)))
    rates = logical_error_rate(errors, shots, rounds)

    extras = {"n_detectors": circuit.n_detectors,
              "n_measurements": circuit.n_measurements}
    if decoder in ("window_native", "cluster_native"):
        # shots escalated to the host exact decoder (decoded exactly)
        extras["escalated_fraction"] = dec.last_flagged_fraction
    elif decoder in ("cluster", "window"):
        # shots the device could not certify exact (cluster: their
        # in-budget components still decoded exactly; window: excess
        # defects deferred or greedy-matched)
        extras["overflow_fraction"] = dec.last_overflow_fraction

    return MemoryResult(
        d=d, rounds=rounds, p=p, shots=shots, n_logical_errors=errors,
        p_logical_shot=rates["p_logical_shot"],
        p_logical_round=rates["p_logical_round"],
        sample_seconds=t_sample, decode_seconds=t_decode,
        shots_per_second=shots / max(t_sample + t_decode, 1e-12),
        detector_fraction=float(dets.mean()), decoder=decoder,
        extras=extras)


def threshold_scan(ds=(3, 5), ps=(1e-3, 2e-3, 4e-3), shots: int = 20000,
                   decoder: str = "matching", seed: int = 0,
                   device: Union[str, torch.device] = "cuda") -> Dict:
    """Logical-vs-physical error scan: {(d, p): p_logical_round}."""
    table = {}
    for d in ds:
        for p in ps:
            r = run_memory(d=d, p=p, shots=shots, decoder=decoder, seed=seed,
                           device=device)
            table[(d, p)] = r.p_logical_round
    return table


__all__ = ["MemoryResult", "run_memory", "threshold_scan"]
