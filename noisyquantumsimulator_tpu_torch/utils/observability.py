"""The port's span recorder, and the provenance stamp of its records.

A span marks one layer boundary of the gate engine:

  nqs.plan   the host plan (`gate/simulate.plan_cz_gate`)
  nqs.step   one call of an entry closure (`bench_gate.build_workload`'s step,
             `optimize/engine.make_population_objective`'s call)
  nqs.scan   the segment scan (`solver/real_rep`: K1's batch of schedules, the
             population's per-member scan)

and of the BB-LDPC memory step (`bench_bb.build_bb_workload`'s step, itself an
nqs.step):

  nqs.sample  one draw of the circuit sampler (`qec/fast_sampler`)
  nqs.decode  the tiered BP decode (`qec/dem_decoder.DemBPDecoder.tiered`:
              both tiers and the compaction between them)
  nqs.osd     the host OSD-0 of the residue, its copy to the host included;
              its count is the residue rows it decoded

and of the surface-code memory step (`bench_qec.build_qec_workload`'s step,
an nqs.step around nqs.sample):

  nqs.match     the tiered exact DP and its flags
  nqs.escalate  the flagged rows' copy to the host, their native exact
                decode and the scatter of their answers; its count is the
                rows it decoded

A record is `Span(name, start_ns, end_ns, parent, step, count)`. Its times
come from `time.time_ns()`, the clock of torch.profiler's chrome trace (an
event's `ts` in us x 1e3 plus the file's `baseTimeNanoseconds`), so a span is
set against the device's events by a subtraction. `parent` is the index in
`spans()` of the enclosing recorded span, or -1; `step` that of the enclosing
`nqs.step` span (a step's own index), or -1. `count` is the one integer a
span may carry (`span.note(n)` inside the block), or None.

A span is recorded while a torch.profiler records (whatever its
activities), and inside a span opened with `always=True`: the program opens
the process's first plan and each entry closure's first call so, which holds
set-up's kernel-library load and first device calls. Otherwise a span tests
its flags and returns, reads no clock and keeps nothing, so an untraced
study that plans thousands of gates keeps a handful of records. Records are
kept in memory, in the order the spans open, for the process's one calling
thread; `clear()` drops them.

Counterpart of the reference's `utils/observability.py`, of which the port
keeps `provenance_stamp` alone: its metrics registry and profiler helpers
had no reader in the port.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

STEP = "nqs.step"


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: Optional[int]        # None while the span is open
    parent: int
    step: int
    count: Optional[int] = None


_records: List[list] = []        # [name, start_ns, end_ns, parent, step, count]
_open: List[int] = []            # indices of the open recorded spans, innermost last
_forced = 0                      # open recorded spans opened with always=True


class span:
    """`with span(name):` records the block as a span while a profiler
    records or an enclosing `always` span is open; `always=True` records it
    (and the spans inside it) in any case."""
    __slots__ = ("name", "always", "rec")

    def __init__(self, name: str, always: bool = False):
        self.name = name
        self.always = always
        self.rec = None

    def __enter__(self):
        global _forced
        if not (self.always or _forced or _profiler._is_profiler_enabled):
            return self
        _forced += self.always
        index = len(_records)
        parent = _open[-1] if _open else -1
        step = index if self.name == STEP else (_records[parent][4] if parent >= 0 else -1)
        self.rec = [self.name, 0, None, parent, step, None]
        _records.append(self.rec)
        _open.append(index)
        self.rec[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _forced
        if self.rec is not None:
            self.rec[2] = time.time_ns()
            self.rec = None
            _forced -= self.always
            if _open:
                _open.pop()
        return False

    def note(self, count: int) -> None:
        """Sets the count of the span's record, if the span is recorded."""
        if self.rec is not None:
            self.rec[5] = int(count)


def spans() -> List[Span]:
    """Every record since the process started or `clear()` ran."""
    return [Span(*r) for r in _records]


def clear() -> None:
    """Drops the records; a span opened after this inside one opened before
    it gets no parent."""
    del _records[:]
    del _open[:]


def provenance_stamp() -> Dict[str, str]:
    """`{generated_at_commit, engine, backend}` for study/bench JSON
    artifacts, so a stale artifact is detectable by commit instead of
    silently contradicting newer records. `backend` is "cuda" when torch
    sees a card, else "cpu"; `device` names the card."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=repo).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    cuda = torch.cuda.is_available()
    return {"generated_at_commit": commit,
            "backend": "cuda" if cuda else "cpu",
            "device": torch.cuda.get_device_name(0) if cuda else "cpu",
            "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}


__all__ = ["Span", "span", "spans", "clear", "provenance_stamp"]
