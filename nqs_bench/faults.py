"""Faults planted under the timed path, for the tests and `calibrate.py`
(the benchmark's own runs plant none). Each breaks the program's CZ
readout, which every entry's step ends in:

  half:    half of the batch left out, the mean of the rest in its place;
  altered: one answer altered where it is produced (F - 0.01);
  stale:   a step that returns the previous step's answers unchanged.

No cell spans chips, so there is no exchange between chips to leave out."""
import contextlib
import importlib

import torch

# the module whose compute_cz_fidelity each entry's step calls
READOUT = {"sweep": "noisyquantumsimulator_tpu_torch.bench_gate",
           "population": "noisyquantumsimulator_tpu_torch.optimize.engine"}
FAULTS = ("half", "altered", "stale")


def _per_member(f):
    """f applied to every per-member tensor of a compute_cz_fidelity result."""
    def apply(res):
        fids, avg, info = res
        B = avg.shape[0]

        def g(t):
            return f(t.clone()) if torch.is_tensor(t) and t.shape[:1] == (B,) else t
        return ({k: g(v) for k, v in fids.items()}, g(avg),
                {k: g(v) for k, v in info.items()})
    return apply


def _half(t):
    if t.is_floating_point():
        h = t.shape[0] // 2
        t[h:] = t[:h].mean()
    return t


def _altered(t):
    if t.is_floating_point():
        t[0] -= 0.01
    return t


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """Within the block, the readout of `entry`'s program is broken by
    `fault`."""
    mod = importlib.import_module(READOUT[entry])
    real = mod.compute_cz_fidelity
    last = []

    def broken(rhos, kets):
        res = real(rhos, kets)
        if fault == "stale":
            out = last[0] if last else res
            last[:] = [res]
            return out
        return _per_member(_half if fault == "half" else _altered)(res)

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    mod.compute_cz_fidelity = broken
    try:
        yield
    finally:
        mod.compute_cz_fidelity = real
