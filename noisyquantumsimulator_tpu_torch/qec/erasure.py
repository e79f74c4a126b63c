"""Heralded-erasure decoding: peel the announced errors, match the rest.

Counterpart of the reference's `qec/erasure.py`. Erased atoms are heralded;
an erasure error is a uniformly random Pauli on a known location:

  1. the fast sampler emits per-shot heralds beside the detectors, and its
     build-time `erasure_meta` holds every erase site's detector and
     observable signatures (X and Z fault components);
  2. peeling (the C++ NativeErasurePeeler): within each shot's heralded
     subgraph, walk leaves inward; a leaf detector's defect state decides
     whether that erasure edge carried an error (maximum likelihood on
     forests; cycles are broken arbitrarily, also maximum likelihood);
  3. the residual defects go to the exact native matcher.

Sampling runs on the card with a generator seeded from `seed`; peeling and
matching run on the host. The reference's Python peeling loop (its fallback
when the C++ library is missing) is not ported: a failed library build
raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Union

import numpy as np
import torch


@dataclass
class ErasureDecoder:
    """decode_batch(detectors, heralds) -> corrected observable-0 flips."""

    n_detectors: int
    x_det: np.ndarray            # (ne, n_det) signatures of the erased faults
    x_obs: np.ndarray            # (ne, n_obs)
    base_decoder: object         # residual decoder (decode_batch -> mask)

    def __post_init__(self):
        # edge form of each erase site's fault: its (u, v) detector pair,
        # v = -1 for the boundary (weight-1 signatures)
        ne = self.x_det.shape[0]
        self._edges = np.full((ne, 2), -1, dtype=np.int64)
        for e in range(ne):
            nz = np.nonzero(self.x_det[e])[0]
            if len(nz) > 2:
                raise ValueError(
                    f"erase site {e} touches {len(nz)} detectors; erasure "
                    "peeling needs matchable (<=2) fault signatures")
            self._edges[e, :len(nz)] = nz
        self._obs0 = (self.x_obs[:, 0].astype(np.int64) if self.x_obs.shape[1]
                      else np.zeros(ne, dtype=np.int64))

    def decode_batch(self, detectors: np.ndarray,
                     heralds: np.ndarray) -> np.ndarray:
        from .native import NativeErasurePeeler
        peeler = NativeErasurePeeler(self.n_detectors, self._edges,
                                     self._obs0.astype(np.uint8))
        residual, obs_flip = peeler.peel_batch(
            np.asarray(detectors, dtype=np.uint8),
            np.asarray(heralds, dtype=np.uint8))
        pred = self.base_decoder.decode_batch(residual)
        return (np.asarray(pred) ^ obs_flip) & 1


def run_erasure_memory(d: int = 3, rounds: Optional[int] = None,
                       p: float = 0.0, p_erase: float = 0.05,
                       shots: int = 20000, seed: int = 0,
                       use_heralds: bool = True, basis: str = "Z",
                       device: Union[str, torch.device] = "cuda") -> Dict:
    """Memory experiment (Z or X basis) with per-round heralded erasure.

    use_heralds=False decodes the same samples ignoring the heralds (erasure
    treated as unheralded depolarization), the comparison that prices
    erasure conversion. The peeling uses the fault plane that threatens the
    chosen basis (X faults for memory-Z, Z faults for memory-X)."""
    from .decoders import decoder_for_circuit
    from .fast_sampler import build_fast_sampler
    from .surface_code import (logical_error_rate, memory_x_circuit,
                               memory_z_circuit)

    dev = torch.device(device)
    rounds = rounds if rounds is not None else d
    if basis.upper() == "X":
        circuit = memory_x_circuit(d, rounds, p=p, p_erase=p_erase)
        det_key, obs_key = "z_det", "z_obs"
    elif basis.upper() == "Z":
        circuit = memory_z_circuit(d, rounds, p=p, p_erase=p_erase)
        det_key, obs_key = "x_det", "x_obs"
    else:
        raise ValueError(f"basis must be 'Z' or 'X', got {basis!r}")
    sampler = build_fast_sampler(circuit, shots, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = sampler(gen)
    dets = out["detectors"].cpu().numpy()
    obs = out["observables"][:, 0].cpu().numpy()
    heralds = out["heralds"].cpu().numpy()

    base = decoder_for_circuit(circuit, kind="native")
    if use_heralds:
        dec = ErasureDecoder(circuit.n_detectors,
                             sampler.erasure_meta[det_key],
                             sampler.erasure_meta[obs_key], base)
        pred = dec.decode_batch(dets, heralds)
    else:
        pred = np.asarray(base.decode_batch(dets)) & 1

    errors = int(np.sum((pred & 1) != (obs & 1)))
    rates = logical_error_rate(errors, shots, rounds)
    return {"d": d, "rounds": rounds, "p": p, "p_erase": p_erase,
            "shots": shots, "use_heralds": use_heralds,
            "herald_fraction": (float(heralds.mean()) if heralds.size
                                else 0.0), **rates}


__all__ = ["ErasureDecoder", "run_erasure_memory"]
