"""The optimizer's population objective: `engine.make_population_objective`
on the fixed problem of `engine.build_fixed_problem`, one call a step over a
population of protocol-parameter vectors -> (P, 7): the cost and the six
fidelities (average, 00, 01, 10, 11, controlled phase) of each member.

Its settings are the configuration file's "population" block: the
apparatus and noise that the fixed problem is planned for."""
import numpy as np

from nqs_bench import faults
from nqs_bench.reference import evolve, gate_model
from nqs_bench.reference.gate_model import smooth_jp_schedule
from nqs_bench.traffic import cut

SETTINGS = "population"
FIDELITIES = ("avg_fidelity", "f00", "f01", "f10", "f11", "cz_phase_fidelity")
# columns of an answer that the cost reads
AVG, F11, CZP = (1 + FIDELITIES.index(k) for k in ("avg_fidelity", "f11", "cz_phase_fidelity"))
FAULTS = faults.FAULTS
# the CPU tests' cut: members a step; segments by hilbert_space_dim
SMALL_ROWS, SMALL_STEPS = 8, {3: 60, 4: 12}


def model(config: dict):
    return gate_model.build(config, SETTINGS)


def small(config: dict, traffic: dict):
    steps = SMALL_STEPS[int(config["hilbert_space_dim"])]
    return dict(config, n_steps=steps), cut(traffic, SMALL_ROWS)


def planted(fault: str):
    """The fault in the CZ readout that the population call ends in."""
    from noisyquantumsimulator_tpu_torch.optimize import engine
    return faults.patched(engine, "compute_cz_fidelity", fault, faults.cz_members)


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        import torch
        from noisyquantumsimulator_tpu_torch.core.configs import NoiseSourceConfig
        from noisyquantumsimulator_tpu_torch.optimize import engine
        from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
        st = config[SETTINGS]
        l1, l2 = st["laser_1"], st["laser_2"]
        app = ApparatusConstraints(
            laser_1_power=l1["power"], laser_1_waist=l1["waist"],
            laser_2_power=l2["power"], laser_2_waist=l2["waist"],
            Delta_e=st["Delta_e"], laser_1_linewidth_hz=l1["linewidth_hz"],
            laser_2_linewidth_hz=l2["linewidth_hz"], temperature=st["temperature"],
            spacing_factor=st["spacing_factor"], n_rydberg=st["n_rydberg"],
            species=st["species"], tweezer_power=st["tweezer_power"],
            tweezer_waist=st["tweezer_waist"], B_field=st["B_field"], NA=st["NA"],
            counter_propagating=st["counter_propagating"])
        dtype = getattr(torch, config["dtype"])
        problem = engine.build_fixed_problem(app, NoiseSourceConfig(**st["noise"]),
                                             include_noise=st["include_noise"],
                                             dtype=dtype, device=device)
        self.fn = engine.make_population_objective(problem, traffic["protocol"],
                                                   n_steps=int(config["n_steps"]))
        self.torch = torch

    def step(self, params):
        cost, metrics = self.fn(params)
        return self.torch.stack([cost] + [metrics[k] for k in FIDELITIES],
                                dim=1).cpu().numpy()


def valid(out: np.ndarray) -> bool:
    f = out[:, 1:]
    return bool(np.all(np.isfinite(out)) and np.all(out[:, 0] >= 0.0)
                and np.all(f >= 0.0) and np.all(f <= 1.0 + 1e-4))


def reference(model, params: np.ndarray, mode: str, device) -> np.ndarray:
    """(M, 7) for smooth-JP parameter vectors (M, 5): omega_tau, A,
    omega_mod_ratio, phi_offset, delta_over_omega. The noise rates are the
    configuration's (planned once, at its own omega_tau, as the fixed
    problem is); a member sets its pulse, segment length and detuning."""
    ot, A, omr, phi0, dow = np.asarray(params, np.float64).T
    phases, dt = smooth_jp_schedule(ot, A, omr, phi0, model.Omega, model.n_steps)
    rhos = evolve.evolve(model, phases, dt, model.detuning(dow), mode, device)
    f = evolve.cz_fidelities(rhos, model.kets)
    c = evolve.cost(f["avg_fidelity"], f["f11"], f["cz_phase_fidelity"],
                    model.n_steps * dt * 1e6)
    return np.stack([c] + [f[k] for k in FIDELITIES], axis=1)


def compare(judged: np.ndarray, ref: np.ndarray, gate_time_us: np.ndarray) -> dict:
    """fid_gap: the widest gap of a fidelity. cost_gap: the widest relative
    gap of the cost from the reference's, on the side of the penalty's cut
    (F < 0.5) that the judged F lies on: a member whose F lies within its
    fid_gap of 0.5 may fall on either side, and fid_gap judges that F."""
    want = evolve.cost(ref[:, AVG], ref[:, F11], ref[:, CZP], gate_time_us,
                       bad=evolve.failed(judged[:, AVG], judged[:, F11], judged[:, CZP]))
    return {"fid_gap": float(np.max(np.abs(judged[:, 1:] - ref[:, 1:]))),
            "cost_gap": float(np.max(np.abs(judged[:, 0] - want) / np.abs(want)))}


def check(model, traffic: dict, xs: list, outs: list, rng, device,
          control: bool = False) -> dict:
    """The gaps of `check_members` answers drawn from the seed over every
    member of every step of the window (all of them where as many)."""
    x, out = np.concatenate(xs), np.concatenate(outs).astype(np.float64)
    pick = rng.choice(len(x), min(int(traffic["check_members"]), len(x)), replace=False)
    ref = reference(model, x[pick], "float64", device)
    judged = reference(model, x[pick], "tf32", device) if control else out[pick]
    return compare(judged, ref, x[pick, 0] / model.Omega * 1e6)
