"""The gate engine's phase-scale sweep: `bench_gate.build_workload`'s step
over a batch of phase-scale factors -> (B,) average CZ fidelities.

Its settings are the configuration file's "sweep" block (the reference
reads them; the entry takes its own documented defaults, so a change of
those shows as a wrong answer).

Every answer of the window is held: the reference's fidelity is a smooth
function of the scale, so the reference computes it at the mix's
`interpolation_nodes` Chebyshev nodes of the scale range and interpolates
it to every answer's scale; at `check_members` answers drawn from the seed
it also computes the fidelity directly, and the interpolation must agree
with it to INTERPOLATION_TOL (1e-13 on the CPU at 12 nodes)."""
import numpy as np

from nqs_bench import faults
from nqs_bench.reference import evolve, gate_model
from nqs_bench.traffic import cut

SETTINGS = "sweep"
INTERPOLATION_TOL = 1e-9
FAULTS = faults.FAULTS
# the CPU tests' cut by hilbert_space_dim: rows a step, segments
SMALL = {3: (8, 60), 4: (2, 12)}


def model(config: dict):
    return gate_model.build(config, SETTINGS)


def small(config: dict, traffic: dict):
    rows, steps = SMALL[int(config["hilbert_space_dim"])]
    return dict(config, n_steps=steps), cut(traffic, rows)


def planted(fault: str):
    """The fault in the CZ readout that the sweep's step ends in."""
    from noisyquantumsimulator_tpu_torch import bench_gate
    return faults.patched(bench_gate, "compute_cz_fidelity", fault, faults.cz_members)


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        import torch
        from noisyquantumsimulator_tpu_torch import bench_gate
        self.fn, _, _ = bench_gate.build_workload(
            int(traffic["inputs"]["count"]), int(config["n_steps"]),
            getattr(torch, config["dtype"]), dim=int(config["hilbert_space_dim"]),
            device=device)

    def step(self, scales):
        return self.fn(scales).cpu().numpy()


def valid(out: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(out)) and np.all(out >= 0.0)
                and np.all(out <= 1.0 + 1e-4))


def reference(model, scales: np.ndarray, mode: str, device) -> np.ndarray:
    """Average CZ fidelity of the configuration's pulse with its phases
    scaled by each of `scales` (M,)."""
    phases, dt = model.base_schedule()
    M = len(scales)
    rhos = evolve.evolve(model, scales[:, None] * phases, np.full(M, dt),
                         np.full(M, model.Delta_gate), mode, device)
    return evolve.cz_fidelities(rhos, model.kets)["avg_fidelity"]


def chebyshev(lo: float, hi: float, K: int):
    """K Chebyshev points of the first kind on [lo, hi] and their
    barycentric weights."""
    k = np.arange(K)
    t = (2 * k + 1) * np.pi / (2 * K)
    return (lo + hi) / 2 + (hi - lo) / 2 * np.cos(t), (-1.0) ** k * np.sin(t)


def interpolate(nodes, weights, values, s, chunk: int = 1 << 20) -> np.ndarray:
    """The barycentric interpolant of `values` at `nodes`, at every s."""
    out = np.empty(len(s))
    for i in range(0, len(s), chunk):
        d = s[i:i + chunk, None] - nodes[None]
        exact = d == 0
        q = weights / np.where(exact, 1.0, d)
        v = (q * values).sum(1) / q.sum(1)
        hit = exact.any(1)
        v[hit] = values[exact[hit].argmax(1)]
        out[i:i + chunk] = v
    return out


def check(model, traffic: dict, xs: list, outs: list, rng, device,
          control: bool = False) -> dict:
    """fid_gap: the largest |F - F_ref| over every answer of the window."""
    s = np.concatenate(xs).astype(np.float64)
    F = np.concatenate(outs).astype(np.float64)
    spec = traffic["inputs"]
    nodes, w = chebyshev(spec["low"], spec["high"], int(traffic["interpolation_nodes"]))
    at_nodes = reference(model, nodes, "float64", device)
    pick = rng.choice(len(s), min(int(traffic["check_members"]), len(s)), replace=False)
    direct = reference(model, s[pick], "float64", device)
    off = float(np.max(np.abs(interpolate(nodes, w, at_nodes, s[pick]) - direct)))
    if off > INTERPOLATION_TOL:
        raise RuntimeError(f"the reference's interpolation misses its direct values by {off}")
    if control:
        F = interpolate(nodes, w, reference(model, nodes, "tf32", device), s)
    return {"fid_gap": float(np.max(np.abs(F - interpolate(nodes, w, at_nodes, s))))}
