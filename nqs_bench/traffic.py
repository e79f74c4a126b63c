"""The one generator of the benchmark's traffic. A mix is a data file,
`traffic/<name>.json`:

    {"entry": <entries/ module that drives the program>,
     "inputs": {"kind": "uniform" | "scaled" | "seeds",
                "count": <rows a step>, "on": "device" | "host", ...},
     "warmup_steps": <steps of set-up>, "trace_steps": <steps profiled>,
     "check_members": <answers held directly against the reference a run>,
     "trace_host": <false: the traced steps record the device alone>,
     ...keys of the entry's own, such as the sweep's "interpolation_nodes"}

kind "uniform": rows uniform in [low, high]; low and high are numbers (one
value a row) or lists (one coordinate each). kind "scaled": `center`
scaled coordinate-wise by factors uniform in 1 +- `spread`, clipped to
`bounds` ([[low, high], ...]), on the host. kind "seeds": `count` integers
uniform in [0, 2^63), int64, on the host, each the seed of one draw of the
entry's own (a sampler's shots, say). Inputs "on" the device are float32
from a torch generator on the device; "on" the host float64 (or the seeds)
from numpy.

Each step draws fresh rows from one stream seeded by the run's seed, so the
same seed gives the same inputs, step by step, and no two steps repeat; a
stream counts its draws and draws any run of them again (`replay`).
"""
from __future__ import annotations

import json
import os

import numpy as np


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "nqs_bench", "traffic", f"{name}.json")) as f:
        return json.load(f)


class Stream:
    """The inputs of successive steps of a mix's `inputs` spec."""

    def __init__(self, spec: dict, seed: int, device="cpu"):
        self.spec, self.seed, self.device_name = spec, seed, device
        self.drawn = 0
        self.kind = spec["kind"]
        if self.kind not in ("uniform", "scaled", "seeds"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.count = int(spec["count"])
        self.on_device = spec.get("on", "host") == "device"
        if self.on_device and self.kind != "uniform":
            raise ValueError(f"traffic kind {self.kind!r} is drawn on the host")
        if self.kind == "uniform":
            lo, hi = np.asarray(spec["low"], np.float64), np.asarray(spec["high"], np.float64)
        elif self.kind == "scaled":
            b = np.asarray(spec["bounds"], np.float64)
            lo, hi = b[:, 0], b[:, 1]
            self.center = np.asarray(spec["center"], np.float64)
        else:                   # seeds: one whole integer a row, no range
            lo = hi = np.zeros(())
        self.lo, self.hi = lo, hi
        self.shape = (self.count, *lo.shape)
        if self.on_device:
            import torch
            self.device = torch.device(device)
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed) % (1 << 63))
            self.lo_t = torch.as_tensor(lo, dtype=torch.float32, device=self.device)
            self.hi_t = torch.as_tensor(hi, dtype=torch.float32, device=self.device)
        else:
            self.rng = np.random.default_rng(int(seed) % (1 << 63))

    def _unit(self):
        if self.on_device:
            import torch
            return torch.rand(self.shape, generator=self.gen, device=self.device,
                              dtype=torch.float32)
        return self.rng.random(self.shape)

    def replay(self, start: int, n: int) -> list:
        """Draws start .. start + n - 1 again, from a fresh stream of the
        same spec and seed."""
        again = Stream(self.spec, self.seed, self.device_name)
        for _ in range(start):
            again.next()
        return [again.next() for _ in range(n)]

    def next(self):
        self.drawn += 1
        if self.kind == "seeds":
            return self.rng.integers(0, 1 << 63, self.count, dtype=np.int64)
        u = self._unit()
        if self.kind == "uniform":
            if self.on_device:
                return self.lo_t + (self.hi_t - self.lo_t) * u
            return self.lo + (self.hi - self.lo) * u
        spread = float(self.spec["spread"])
        return np.clip(self.center * (1.0 + spread * (2 * u - 1)), self.lo, self.hi)


def cut(mix: dict, rows: int) -> dict:
    """`mix` at `rows` rows a step, every answer compared, one warm-up step
    and two traced: the size at which a CPU test runs a cell."""
    return dict(mix, inputs=dict(mix["inputs"], count=rows), check_members=rows,
                warmup_steps=1, trace_steps=2)
