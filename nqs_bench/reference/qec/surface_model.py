"""The detector error model (DEM) and matching graph of a rotated surface-code
memory configuration, as plain numpy.

`build(config)` runs the frozen copy of the host code (`frozen/surface_code`,
`frozen/dem`) on the numbers that the configuration file states: the distance
d, the rounds and p. The noise model is the frozen circuit's own; the file
states it (`noise`, in units of p) and `build` refuses a file that states
another.

The merged DEM's mechanisms fire independently (`bb_model.BBModel`: the
exact marginals and pairwise firing the sampler is held to). Its matching
graph is built here, not taken from the program: one edge for each pair of
detectors (or a detector and the boundary) that some mechanism flips,
parallel mechanisms merged by XOR probability, the edge's observable parity
the more probable one, and weight log((1 - p) / p) floored at 1e-3. The
merge and the floor are the program's stated choices (a matching decoder
sees one edge a pair), not properties of the circuit; at d = 7, p = 1e-3 no
pair has mechanisms of both parities, so the parity rule decides nothing
there. A DEM whose mechanisms flip more than two detectors has no such graph,
and `build` refuses it.

`least_paths` gives, for each parity q, the least weight of a path between
two nodes whose observable parity is q: float64 Floyd-Warshall over the graph
doubled by parity (node v with parity c is 2v + c), the boundary one node.
Departures from a textbook build: none beyond vectorising each relaxation
over the whole table with numpy."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .bb_model import BBModel
from .frozen.dem import build_dem
from .frozen.surface_code import memory_z_circuit

# the frozen circuit's noise, in units of p: X_ERROR on every ancilla's reset
# and DEPOLARIZE1 on the X ancillas after each of their two H layers, each
# round; DEPOLARIZE2 after every CX layer; DEPOLARIZE1 on the idle data once a
# round at p / 10; a flip of every ancilla MR and final data M
NOISE = {"reset_x_error": 1.0, "x_ancilla_depolarize1": 1.0, "cx_depolarize2": 1.0,
         "data_idle_depolarize1": 0.1, "measure_flip": 1.0}
# the weight floor of an edge (the program's)
W_MIN = 1e-3


@dataclass
class SurfaceModel(BBModel):
    edges: np.ndarray       # (E, 2) int64, the boundary node is n_det
    weights: np.ndarray     # (E,) float64
    parity: np.ndarray      # (E,) int64, the edge's observable parity
    dist: np.ndarray        # (2, n_det + 1, n_det + 1) float64: least_paths


def rounded(x: np.ndarray, dtype: Optional[torch.dtype]) -> np.ndarray:
    """x (float64) rounded to the nearest value of `dtype`, as float64; x
    itself where dtype is None."""
    if dtype is None:
        return x
    return torch.as_tensor(x).to(dtype).to(torch.float64).numpy()


def circuit(config: dict):
    if config["noise"] != NOISE:
        raise ValueError(f"the reference builds the noise {NOISE}, the "
                         f"configuration states {config['noise']}")
    return memory_z_circuit(int(config["code"]["d"]), int(config["rounds"]),
                            p=float(config["p"]))


def graph(n_det: int, H: np.ndarray, obs_mask: np.ndarray, probs: np.ndarray):
    """(edges (E, 2), weights (E,), parity (E,)) of the merged DEM."""
    acc = {}
    for j in range(H.shape[1]):
        dets = np.nonzero(H[:, j])[0]
        if len(dets) > 2:
            raise ValueError("a mechanism flips more than two detectors: no matching graph")
        key = (int(dets[0]), int(dets[1]) if len(dets) == 2 else n_det)
        by_parity = acc.setdefault(key, {})
        q = int(obs_mask[j]) & 1
        p0 = by_parity.get(q, 0.0)
        by_parity[q] = p0 * (1 - probs[j]) + probs[j] * (1 - p0)
    edges, weights, parity = [], [], []
    for key, by_parity in acc.items():
        p = 0.0
        for pq in by_parity.values():
            p = p * (1 - pq) + pq * (1 - p)
        edges.append(key)
        weights.append(max(np.log((1 - p) / max(p, 1e-15)), W_MIN))
        parity.append(max(by_parity, key=by_parity.get))
    return (np.array(edges, np.int64).reshape(-1, 2), np.array(weights, np.float64),
            np.array(parity, np.int64))


def least_paths(n_nodes: int, edges: np.ndarray, weights: np.ndarray,
                parity: np.ndarray, rounding: Optional[torch.dtype] = None) -> np.ndarray:
    """(2, n_nodes, n_nodes) float64: [q, a, b] the least weight of a path
    from a to b of observable parity q (inf where there is none). With
    `rounding`, every edge weight and every path sum is rounded to it."""
    D = np.full((2 * n_nodes, 2 * n_nodes), np.inf)
    np.fill_diagonal(D, 0.0)
    w = rounded(weights, rounding)
    for (a, b), wi, o in zip(edges, w, parity):
        for c in (0, 1):
            u, v = 2 * a + c, 2 * b + (c ^ o)
            D[u, v] = D[v, u] = min(D[u, v], wi)
    for k in range(2 * n_nodes):
        D = np.minimum(D, rounded(D[:, k, None] + D[None, k, :], rounding))
    return np.stack([D[0::2, 0::2], D[0::2, 1::2]])


def build(config: dict) -> SurfaceModel:
    """The merged DEM of the configuration's memory-Z circuit, its matching
    graph and its least paths of each parity."""
    circ = circuit(config)
    dem = build_dem(circ).merged()
    mechs = [m for m in dem.mechanisms if m.probability > 1e-12]
    n_det = circ.n_detectors
    H = np.zeros((n_det, len(mechs)), np.uint8)
    for j, m in enumerate(mechs):
        H[list(m.detectors), j] = 1
    obs_mask = np.array([m.observables for m in mechs], np.int64)
    probs = np.array([m.probability for m in mechs], np.float64)
    edges, weights, parity = graph(n_det, H, obs_mask, probs)
    return SurfaceModel(config=config, H=H, obs_mask=obs_mask, probs=probs,
                        k=circ.n_observables, edges=edges, weights=weights, parity=parity,
                        dist=least_paths(n_det + 1, edges, weights, parity))


def sizes(model: SurfaceModel) -> dict:
    """The sizes a configuration file states under "dem"."""
    return {"n_detectors": int(model.n_det), "n_mechanisms": int(model.H.shape[1]),
            "n_edges": int(len(model.edges)),
            "n_boundary_edges": int((model.edges[:, 1] == model.n_det).sum()),
            "n_observables": int(model.k)}
