"""Faults planted under the timed path, for the tests and `calibrate.py`
(the benchmark's own runs plant none). An entry names the faults its
program can have in `FAULTS`, a subset of these, and plants one with its
context manager `planted(fault)`:

  half:    half of the batch left out, the mean of the rest in its place;
  altered: one answer altered where it is produced (- 0.01);
  stale:   a step that returns the previous step's answers unchanged.

No cell spans chips, so there is no exchange between chips to leave out.
The mechanics the entries share are here: `patched` breaks one function of
the program, and `cz_members` reaches the answers of a CZ readout."""
import contextlib
import os

import torch

from nqs_bench import harness

FAULTS = ("half", "altered", "stale")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cz_members(res, f):
    """f applied to every per-member tensor of a compute_cz_fidelity result."""
    fids, avg, info = res
    B = avg.shape[0]

    def g(t):
        return f(t.clone()) if torch.is_tensor(t) and t.shape[:1] == (B,) else t
    return ({k: g(v) for k, v in fids.items()}, g(avg),
            {k: g(v) for k, v in info.items()})


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
def patched(mod, attr: str, fault: str, members):
    """Within the block, `mod.<attr>` answers broken by `fault`: stale
    returns the previous call's result, half and altered are applied by
    `members(result, f)` to the result's per-member tensors."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real = getattr(mod, attr)
    last = []

    def broken(*args):
        res = real(*args)
        if fault == "stale":
            out = last[0] if last else res
            last[:] = [res]
            return out
        return members(res, _half if fault == "half" else _altered)

    setattr(mod, attr, broken)
    try:
        yield
    finally:
        setattr(mod, attr, real)


@contextlib.contextmanager
def planted(entry: str, fault: str, root: str = ROOT):
    """Within the block, the program of `entry` (the adapter
    `entries/<entry>.py` of the checkout at `root`) is broken by `fault`."""
    mod = harness.entry_module(root, entry)
    if fault not in getattr(mod, "FAULTS", ()):
        raise ValueError(f"entry {entry!r} has no fault {fault!r}")
    with mod.planted(fault):
        yield
