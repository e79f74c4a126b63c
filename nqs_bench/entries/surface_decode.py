"""The surface-code memory step: `bench_qec.build_qec_workload`'s `step`, one
seed a step -> (shots + 1, 3) int32 (`bench_qec.answers`): each shot's
predicted logical flip after the tiered exact DP and the host's exact
decode of the shots the DP did not decode whole, the tier that decided it
(0: K = 6, 1: K = 12, 2: the host, exact, 3: the host, not certified) and its
matching weight (in 1 / 1024), then the row (the step's failures, the
escalated shots, 0).

A step's shots are data made from its seed: the check rebuilds the program's
sampler and replays each checked step's seed to get them back. It holds whole
steps drawn from the run's rng (`check_members` shots in all) against the
reference's exact matching of both logical classes (`reference/qec/
matching`: W0 and W1 a shot, float64) and returns

  pred_gap:   the share of their shots whose predicted class weighs more
              than the other class by more than TIE: an exact decoder
              predicts a class of least weight;
  weight_gap: the largest |reported weight - min(W0, W1)| over them, in
              units of 1 / 1024: the number that the precision of the
              weights moves (a float32 sum rounded to a unit reads up to
              ~0.5);
  fail_gap:   the largest |reported failures - shots whose prediction
              misses the replayed observable| over the checked steps (0
              when sound);
  rate_z:     the largest |z| of the replayed shots' firing counts of each
              detector and of the observable, and of each pair of detectors
              that share a mechanism firing together, against the reference
              DEM's exact probabilities (where a count is large enough to be
              near normal: MIN_VAR): the sampler, the one piece of the
              program the check relies on, held to the reference on its own.

The control is the reference with every edge weight and path sum rounded to
bfloat16, in the program's place."""
import functools
import json

import numpy as np

from nqs_bench import faults
from nqs_bench.reference.qec import matching, surface_model

FAULTS = faults.FAULTS
# the CPU tests' cut: d = 3, 3 rounds at p = 3e-3, 1024 shots (a few shots a
# step past the K = 6 DP at the heavy capacity the 1024 shots give, 64)
SMALL = {"rounds": 3, "p": 3e-3}
SMALL_CODE = {"d": 3, "data_qubits": 9, "x_ancillas": 4, "z_ancillas": 4}
SMALL_SHOTS = 1024
# a predicted class that weighs more than the other by at most TIE (natural
# units, ~1 / 1024) is a tie: float32 sums of weights near 100 carry ~1e-5
TIE = 1e-3
# rate_z holds the counts whose binomial variance is at least MIN_VAR, where a
# count is near enough normal that |z| >= 6 has odds of ~1.5e-7 or less
MIN_VAR = 25.0
WEIGHT_UNITS = 1024


def _key(config: dict) -> str:
    return json.dumps(config, sort_keys=True)


@functools.lru_cache(maxsize=4)
def _model(key: str):
    return surface_model.build(json.loads(key))


def model(config: dict):
    return _model(_key(config))


def small(config: dict, traffic: dict):
    cut = dict(config, code=dict(config["code"], **SMALL_CODE), **SMALL)
    cut["dem"] = surface_model.sizes(surface_model.build(cut))
    return cut, dict(traffic, shots=SMALL_SHOTS, check_members=SMALL_SHOTS,
                     warmup_steps=1, trace_steps=2)


def _wrong(res, f):
    """An integer answer that the fault moves is a wrong answer: where f
    (applied to a float copy of the answers) changes an entry, its lowest
    bit is flipped."""
    import torch
    moved = (f(torch.as_tensor(res, dtype=torch.float64)) != torch.as_tensor(res)).numpy()
    return np.where(moved, res ^ 1, res).astype(res.dtype)


def planted(fault: str):
    """The fault in the step's answers, where the step puts them together."""
    from noisyquantumsimulator_tpu_torch import bench_qec
    return faults.patched(bench_qec, "answers", fault, _wrong)


def _experiment(config: dict):
    """(d, rounds, p) of the configuration's memory experiment."""
    return int(config["code"]["d"]), int(config["rounds"]), float(config["p"])


def _stated(config: dict, shots: int) -> dict:
    """The decoder settings the configuration states, as the program's."""
    st = config["decoder"]
    chunk = min(int(st["chunk"]), shots)
    return {"k_light": int(st["k_light"]), "k_heavy": int(st["k_heavy"]), "chunk": chunk,
            "heavy_capacity": min(chunk, max(chunk // int(st["heavy_capacity_divisor"]),
                                             int(st["heavy_capacity_min"]))),
            "fetch_cap": min(shots, max(shots // int(st["fetch_cap_divisor"]),
                                        int(st["fetch_cap_min"])))}


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        import torch
        from noisyquantumsimulator_tpu_torch import bench_qec
        if not hasattr(bench_qec, "answers"):
            raise RuntimeError("this program's surface-code workload has no step")
        shots = int(traffic["shots"])
        self.w = bench_qec.build_qec_workload(*_experiment(config), shots, device)
        d = self.w.decoder
        ran = {"k_light": d.k_light, "k_heavy": d.max_defects, "chunk": self.w.chunk,
               "heavy_capacity": d.heavy_capacity, "fetch_cap": self.w.cap}
        if ran != _stated(config, shots):
            raise ValueError(f"the program's decoder settings {ran} are not the "
                             f"configuration's {_stated(config, shots)}")
        self.device = torch.device(device)
        self.torch = torch

    def step(self, seeds):
        g = self.torch.Generator(device=self.device)
        g.manual_seed(int(seeds[0]))
        return self.w.step(g)


def valid(out: np.ndarray) -> bool:
    """int32 answers of `bench_qec.answers`' shape: predictions 0 or 1, tiers
    0 to 3, weights >= 0, failure and escalated counts within the shots."""
    if not (isinstance(out, np.ndarray) and out.dtype == np.int32 and out.ndim == 2
            and out.shape[1] == 3 and out.shape[0] > 1):
        return False
    (n_fail, n_flag, _), shots = out[-1], out[:-1]
    return bool(np.all((shots[:, 0] == 0) | (shots[:, 0] == 1))
                and np.all((shots[:, 1] >= 0) & (shots[:, 1] <= 3))
                and np.all(shots[:, 2] >= 0)
                and 0 <= n_fail <= len(shots) and 0 <= n_flag <= len(shots))


@functools.lru_cache(maxsize=2)
def _sampler(key: str, shots: int, device: str):
    """The program's own sampler of the configuration, rebuilt."""
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit
    d, rounds, p = _experiment(json.loads(key))
    return build_fast_sampler(memory_z_circuit(d, rounds, p=p), shots, device)


def replay(config: dict, shots: int, seed: int, device):
    """(detectors (shots, n_det) uint8, observables (shots, 1) uint8) of the
    step that `seed` drew, on `device`."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    o = _sampler(_key(config), shots, str(device))(g)
    return o["detectors"], o["observables"]


def _pairs(model):
    """(a, b): the pairs of detectors a < b that share a mechanism."""
    H = model.H.astype(np.int64)
    return np.nonzero(np.triu(H @ H.T, 1))


def check(model, traffic: dict, xs: list, outs: list, rng, device,
          control: bool = False) -> dict:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    shots = int(traffic["shots"])
    n = min(len(xs), max(1, int(traffic["check_members"]) // shots))
    pick = np.sort(rng.choice(len(xs), n, replace=False))
    a, b = _pairs(model)
    fired = np.zeros(model.n_det + model.k)
    both = np.zeros(len(a))
    worse = fail_gap = 0
    weight_gap = 0.0
    dist_c = (surface_model.least_paths(model.n_det + 1, model.edges, model.weights,
                                        model.parity, rounding=torch.bfloat16)
              if control else None)
    rows = np.arange(shots)
    for i in pick:
        dets, obs = replay(model.config, shots, xs[i][0], device)
        d = dets.to(torch.float32)
        fired += np.concatenate([d.sum(0).cpu().numpy(),
                                 obs.to(torch.float32).sum(0).cpu().numpy()])
        both += (d.T @ d).cpu().numpy()[a, b]
        dets_h = dets.cpu().numpy()
        truth = obs[:, 0].cpu().numpy().astype(np.int64)
        W = matching.class_weights(model.dist, dets_h)
        if control:
            Wc = matching.class_weights(dist_c, dets_h, rounding=torch.bfloat16)
            pred = np.argmin(Wc, axis=1)
            weight = np.round(Wc.min(axis=1) * WEIGHT_UNITS)
            n_fail = int((pred != truth).sum())
        else:
            out = outs[i].astype(np.int64)
            pred, weight, n_fail = out[:-1, 0], out[:-1, 2], int(out[-1, 0])
        worse += int((W[rows, pred] - W[rows, 1 - pred] > TIE).sum())
        gap = np.abs(weight - W.min(axis=1) * WEIGHT_UNITS)
        weight_gap = max(weight_gap, float(gap.max()))
        fail_gap = max(fail_gap, abs(n_fail - int((pred != truth).sum())))
    N = n * shots
    q = np.concatenate([model.marginals(), model.joint(a, b)])
    var = N * q * (1.0 - q)
    held = var >= MIN_VAR
    z = (np.concatenate([fired, both]) - N * q)[held] / np.sqrt(var[held])
    return {"pred_gap": worse / N, "weight_gap": weight_gap, "fail_gap": float(fail_gap),
            "rate_z": float(np.max(np.abs(z), initial=0.0))}
