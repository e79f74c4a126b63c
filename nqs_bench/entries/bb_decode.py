"""The BB-LDPC memory step: `bench_bb.build_bb_workload`'s `step`, one seed a
step -> (shots + 1, 3) int32 (`bench_bb.answers`): each shot's predicted
observable flips after the tiered BP and host OSD-0 (bit b: observable b),
the tier that decided it (0: the fast tier, 1: the retry, 2: OSD-0) and the
reliability of its beliefs (their least |belief|, in 1 / 1024), then the
row (the step's failures, k, 0).

A step's shots are data made from its seed, as a sweep's scales are drawn on
the card: the check rebuilds the program's sampler and replays each checked
step's seed to get them back. It holds whole steps drawn from the run's rng
(`check_members` shots in all) and returns

  pred_gap:   the share of their shots whose prediction differs from the
              reference decoder's (`reference/qec/decoder`, float32
              min-sum, damped retry, OSD-0) on the same syndrome;
  belief_gap: the mean |reliability - the reference's| over the shots that
              both decoders' fast tier decided: the one number here that
              the precision of the messages moves (at p = 1e-3 almost every
              shot has one clear correction, which any sound decoder finds);
  fail_gap:   the largest |reported failures - shots whose prediction
              misses the replayed observables| over the checked steps (0
              when sound);
  rate_z:     the largest |z| of the replayed shots' firing counts of each
              detector and observable, and of each pair of detectors that
              share a mechanism firing together, against the reference
              DEM's exact probabilities (where a count is large enough to
              be near normal: MIN_VAR): the sampler, the one piece of the
              program that the check relies on, held to the reference on
              its own, correlations included.

The control is the reference decoder with every message rounded to
float8_e4m3fn, in the program's place."""
import functools
import json

import numpy as np

from nqs_bench import faults
from nqs_bench.reference.qec import bb_model, decoder

FAULTS = faults.FAULTS
# the CPU tests' cut: the [[72,12,6]] code, 2 rounds at p = 3e-3, 512 shots,
# under the decoder budgets the program takes above p = 1.5e-3
SMALL_CODE = {"l": 6, "n": 72, "d": 6}
SMALL = {"rounds": 2, "p": 3e-3}
SMALL_DECODER = {"fast_iters": 8, "retry_cap_divisor": 32, "residue_cap_divisor": 16}
SMALL_SHOTS = 512
# rate_z holds the counts whose binomial variance is at least MIN_VAR, where
# a count is near enough normal that |z| >= 6 has odds of ~1.5e-7 or less:
# every count of the cell's 4 checked steps (the least variance is ~74); at
# the CPU cut's 512 shots, the 12 observables alone
MIN_VAR = 25.0


def _key(config: dict) -> str:
    return json.dumps(config, sort_keys=True)


@functools.lru_cache(maxsize=4)
def _model(key: str):
    return bb_model.build(json.loads(key))


def model(config: dict):
    return _model(_key(config))


def small(config: dict, traffic: dict):
    cut = dict(config, code=dict(config["code"], **SMALL_CODE),
               decoder=dict(config["decoder"], **SMALL_DECODER), **SMALL)
    cut["dem"] = bb_model.sizes(bb_model.build(cut))
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
    from noisyquantumsimulator_tpu_torch import bench_bb
    return faults.patched(bench_bb, "answers", fault, _wrong)


def _code(config: dict):
    from noisyquantumsimulator_tpu_torch.qec.ldpc import bb_code
    c = config["code"]
    return bb_code(int(c["l"]), int(c["m"]), tuple(c["a_powers"]), tuple(c["b_powers"]))


def _stated(config: dict, shots: int) -> dict:
    """The decoder settings the configuration states, as the program's."""
    st = config["decoder"]
    return {"fast_iters": int(st["fast_iters"]), "fast_dtype": st["fast_dtype"],
            "scale": float(st["scale"]), "retry_iters": int(st["retry_iters"]),
            "retry_damping": float(st["retry_damping"]),
            "retry_cap_divisor": int(st["retry_cap_divisor"]),
            "residue_cap": min(shots, max(shots // int(st["residue_cap_divisor"]), 32))}


class Program:
    def __init__(self, config: dict, traffic: dict, device):
        import torch
        from noisyquantumsimulator_tpu_torch import bench_bb
        if not hasattr(bench_bb, "answers"):
            raise RuntimeError("this program's BB workload has no step")
        shots = int(traffic["shots"])
        self.w = bench_bb.build_bb_workload(int(config["rounds"]), float(config["p"]),
                                            shots, int(config["decoder"]["fast_iters"]),
                                            device, *_code(config))
        d = self.w.decoder
        ran = {"fast_iters": self.w.fast_iters, "fast_dtype": str(d.fast_dtype).split(".")[-1],
               "scale": d.scale, "retry_iters": d.retry_iters,
               "retry_damping": d.retry_damping, "retry_cap_divisor": d.retry_cap_divisor,
               "residue_cap": self.w.cap}
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
    """int32 answers of `bench_bb.answers`' shape: predictions within the k
    bits that the last row states, tiers 0 to 2, reliabilities >= 0, a
    failure count within the shots."""
    if not (isinstance(out, np.ndarray) and out.dtype == np.int32 and out.ndim == 2
            and out.shape[1] == 3 and out.shape[0] > 1):
        return False
    (n_fail, k, _), shots = out[-1], out[:-1]
    return bool(0 < k < 31 and np.all(shots[:, 0] >= 0) and np.all(shots[:, 0] < (1 << k))
                and np.all((shots[:, 1] >= 0) & (shots[:, 1] <= 2))
                and np.all(shots[:, 2] >= 0) and 0 <= n_fail <= len(shots))


@functools.lru_cache(maxsize=2)
def _sampler(key: str, shots: int, device: str):
    """The program's own sampler of the configuration, rebuilt."""
    from noisyquantumsimulator_tpu_torch.qec.fast_sampler import build_fast_sampler
    from noisyquantumsimulator_tpu_torch.qec.ldpc import bb_memory_circuit
    config = json.loads(key)
    return build_fast_sampler(bb_memory_circuit(*_code(config), int(config["rounds"]),
                                                float(config["p"])), shots, device)


def replay(config: dict, shots: int, seed: int, device):
    """(detectors (shots, n_det) uint8, observables (shots, k) uint8) of the
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
    from noisyquantumsimulator_tpu_torch.bench_bb import RELIABILITY_UNITS
    torch.backends.cuda.matmul.allow_tf32 = False
    shots = int(traffic["shots"])
    n = min(len(xs), max(1, int(traffic["check_members"]) // shots))
    pick = np.sort(rng.choice(len(xs), n, replace=False))
    a, b = _pairs(model)
    fired = np.zeros(model.n_det + model.k)
    both = np.zeros(len(a))
    differ = fail_gap = 0
    gap_sum, n_fast = 0.0, 0
    for i in pick:
        dets, obs = replay(model.config, shots, xs[i][0], device)
        obs_h = obs.cpu().numpy().astype(np.int64)
        d = dets.to(torch.float32)
        fired += np.concatenate([d.sum(0).cpu().numpy(), obs_h.sum(0)])
        both += (d.T @ d).cpu().numpy()[a, b]
        truth = (obs_h << np.arange(model.k)).sum(axis=1)
        ref, ref_tier, ref_rel = decoder.decode(model, dets, device)
        if control:
            pred, tier, rel = decoder.decode(model, dets, device, rounding=torch.float8_e4m3fn)
            n_fail = int((pred != truth).sum())
        else:
            out = outs[i].astype(np.int64)
            pred, tier, rel = out[:-1, 0], out[:-1, 1], out[:-1, 2] / RELIABILITY_UNITS
            n_fail = int(out[-1, 0])
        differ += int((pred != ref).sum())
        fast = (tier == 0) & (ref_tier == 0)
        gap_sum += float(np.abs(rel - ref_rel)[fast].sum())
        n_fast += int(fast.sum())
        fail_gap = max(fail_gap, abs(n_fail - int((pred != truth).sum())))
    N = n * shots
    q = np.concatenate([model.marginals(), model.joint(a, b)])
    var = N * q * (1.0 - q)
    held = var >= MIN_VAR
    z = (np.concatenate([fired, both]) - N * q)[held] / np.sqrt(var[held])
    return {"pred_gap": differ / N, "belief_gap": gap_sum / max(n_fast, 1),
            "fail_gap": float(fail_gap), "rate_z": float(np.max(np.abs(z), initial=0.0))}
