"""The detector error model (DEM) of a BB memory configuration, as plain numpy.

`build(config)` runs the frozen copy of the host code (`frozen/`) on the
numbers that the configuration file states: the code's (l, m, A, B), the
rounds and p. The noise model is the frozen circuit's own; the file states it
(`noise`, in units of p) and `build` refuses a file that states another.

A mechanism j of the merged DEM fires with probability p_j, independently of
the others, and flips the detectors of column j of H and the observables of
bit mask obs_mask[j]. So a detector (or an observable) fires with the exact
probability q = (1 - prod_j (1 - 2 p_j)) / 2 over the mechanisms touching it,
and two detectors fire together with probability
(1 - e_a - e_b + e_ab) / 4, e = prod (1 - 2 p_j) over the mechanisms touching
one, the other, or exactly one of the two.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .frozen.dem import build_dem
from .frozen.ldpc import bb_code, bb_memory_circuit

# the frozen circuit's noise, in units of p: two-qubit depolarizing after
# every CX, one-qubit depolarizing on every data qubit once a round, and a
# flip of every ancilla and final data measurement
NOISE = {"cx_depolarize2": 1.0, "data_depolarize1_per_round": 0.1,
         "measure_flip": 1.0}


@dataclass
class BBModel:
    config: dict
    H: np.ndarray           # (n_det, n_mech) uint8
    obs_mask: np.ndarray    # (n_mech,) int64, bit b flips observable b
    probs: np.ndarray       # (n_mech,) float64
    k: int                  # observables

    @property
    def n_det(self) -> int:
        return self.H.shape[0]

    @property
    def obs(self) -> np.ndarray:
        """(k, n_mech) uint8: the mechanisms that flip each observable."""
        return ((self.obs_mask[None, :] >> np.arange(self.k)[:, None]) & 1).astype(np.uint8)

    def parity_mean(self, rows: np.ndarray) -> np.ndarray:
        """E[(-1)^x] of each row's parity x, for rows (R, n_mech) 0/1 of
        the mechanisms that flip it."""
        f = 1.0 - 2.0 * self.probs
        return np.exp(np.asarray(rows, np.float64) @ np.log(f))

    def marginals(self) -> np.ndarray:
        """(n_det + k,) the exact firing probability of each detector, then
        of each observable."""
        return (1.0 - self.parity_mean(np.concatenate([self.H, self.obs]))) / 2.0

    def joint(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """P(detector a and detector b both fire), for index arrays a, b."""
        Ha, Hb = self.H[a].astype(np.int64), self.H[b].astype(np.int64)
        ea, eb, eab = (self.parity_mean(r) for r in (Ha, Hb, Ha ^ Hb))
        return (1.0 - ea - eb + eab) / 4.0


def circuit(config: dict):
    c = config["code"]
    if config["noise"] != NOISE:
        raise ValueError(f"the reference builds the noise {NOISE}, the "
                         f"configuration states {config['noise']}")
    Hx, Hz = bb_code(int(c["l"]), int(c["m"]), tuple(c["a_powers"]), tuple(c["b_powers"]))
    return bb_memory_circuit(Hx, Hz, int(config["rounds"]), float(config["p"]))


def build(config: dict) -> BBModel:
    """The merged DEM of the configuration's memory-Z circuit."""
    circ = circuit(config)
    dem = build_dem(circ).merged()
    mechs = [m for m in dem.mechanisms if m.probability > 1e-12]
    H = np.zeros((circ.n_detectors, len(mechs)), np.uint8)
    for j, m in enumerate(mechs):
        H[list(m.detectors), j] = 1
    return BBModel(config=config, H=H,
                   obs_mask=np.array([m.observables for m in mechs], np.int64),
                   probs=np.array([m.probability for m in mechs], np.float64),
                   k=circ.n_observables)


def sizes(model: BBModel) -> dict:
    """The sizes a configuration file states under "dem"."""
    return {"n_detectors": int(model.H.shape[0]), "n_mechanisms": int(model.H.shape[1]),
            "n_edges": int(model.H.sum()), "w_max": int(model.H.sum(axis=1).max()),
            "n_observables": int(model.k)}


def sample(model: BBModel, shots: int, generator: torch.Generator, device="cpu"):
    """(detectors (shots, n_det) uint8, observables (shots, k) uint8): one
    Bernoulli draw a mechanism a shot, the signatures summed mod 2 (float32
    products of 0/1 operands, exact with TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = torch.as_tensor(model.probs, dtype=torch.float32, device=device)
    e = (torch.rand((shots, len(p)), generator=generator, device=device) < p).float()
    Ht = torch.as_tensor(model.H.T, dtype=torch.float32, device=device)
    Ot = torch.as_tensor(model.obs.T, dtype=torch.float32, device=device)
    return tuple(((e @ M).to(torch.int64) & 1).to(torch.uint8) for M in (Ht, Ot))
