"""The one generator of the benchmark's traffic. A mix is a data file,
`traffic/<name>.json`:

    {"entry": <entries/ module that drives the program>,
     "inputs": {"kind": "uniform" | "scaled",
                "count": <rows a step>, "on": "device" | "host", ...},
     "warmup_steps": <steps of set-up>, "trace_steps": <steps profiled>,
     "check_members": <answers held directly against the reference a run>,
     "trace_host": <false: the traced steps record the device alone>,
     ...keys of the entry's own, such as the sweep's "interpolation_nodes"}

kind "uniform": rows uniform in [low, high]; low and high are numbers (one
value a row) or lists (one coordinate each). kind "scaled": `center`
scaled coordinate-wise by factors uniform in 1 +- `spread`, clipped to
`bounds` ([[low, high], ...]), on the host. Inputs "on" the device are
float32 from a torch generator on the device; "on" the host float64 from
numpy.

Each step draws fresh rows from one stream seeded by the run's seed, so the
same seed gives the same inputs, step by step, and no two steps repeat.
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
        self.spec = spec
        self.kind = spec["kind"]
        if self.kind not in ("uniform", "scaled"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        self.count = int(spec["count"])
        self.on_device = spec.get("on", "host") == "device"
        if self.on_device and self.kind != "uniform":
            raise ValueError(f"traffic kind {self.kind!r} is drawn on the host")
        if self.kind == "uniform":
            lo, hi = np.asarray(spec["low"], np.float64), np.asarray(spec["high"], np.float64)
        else:
            b = np.asarray(spec["bounds"], np.float64)
            lo, hi = b[:, 0], b[:, 1]
            self.center = np.asarray(spec["center"], np.float64)
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

    def next(self):
        u = self._unit()
        if self.kind == "uniform":
            if self.on_device:
                return self.lo_t + (self.hi_t - self.lo_t) * u
            return self.lo + (self.hi - self.lo) * u
        spread = float(self.spec["spread"])
        return np.clip(self.center * (1.0 + spread * (2 * u - 1)), self.lo, self.hi)
