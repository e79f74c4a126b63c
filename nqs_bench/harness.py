"""Runs one cell of `BENCHMARK.json` once and prints its result line.

A run, in order:
  1. loads the cell's configuration (`configs/`), traffic mix (`traffic/`)
     and limits (`limits/<cell>.json`), and the adapter its mix names
     (`entries/<entry>.py`);
  2. builds the program's entry (the span `build_s`), warms up the cell's
     own shapes with the mix's first steps, and touches a pool of host
     memory for the window's answers: set-up ends there;
  3. drives the entry in a closed loop for `--seconds`: one caller, which
     draws a step's fresh inputs from the seeded stream and waits for its
     outputs on the host. The loop keeps no inputs (the check draws them
     again from the seed) and copies each step's answers into the pool, so
     that no step faults in fresh pages. A step that raises or answers out
     of range fails. With `--trace 1` the profiler records a fixed number of steady
     steps inside the window: the device's activity, and the host's where
     the mix does not set "trace_host" false;
  4. reads the device's peak memory, frees the program, and holds a sample
     of the timed steps' answers, drawn from the seed, against the entry's
     plain reference model of the configuration (`model`, `check`);
  5. prints the cell's metrics (end-to-end with `--trace 0`, per layer with
     `--trace 1`), each computed by its reader `metrics/<name>.py`.

Configurations, mixes, metrics and limits are files found by the names in
`BENCHMARK.json`: adding a cell adds files and entries, and edits none.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from nqs_bench import traffic, tracing

PKG = "nqs_bench"
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "noisyquantumsimulator_tpu")
# the most host memory that the answers' pool takes (Cell.warm_up)
POOL_BYTES = 2 << 30


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries: list, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module_name(kind: str, name: str) -> str:
    return f"{PKG}_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)


def entry_module(root: str, name: str):
    """The adapter `entries/<name>.py` of the checkout at `root`, loaded once
    a process, as an import is: the harness's cell and a fault planted by
    `faults.planted` act on one module."""
    path = os.path.realpath(os.path.join(root, PKG, "entries", f"{name}.py"))
    key = f"{_module_name('entry', name)}_{hashlib.sha1(path.encode()).hexdigest()[:12]}"
    if key not in sys.modules:
        sys.modules[key] = load_module(path, key)
    return sys.modules[key]


def metric_reader(root: str, name: str):
    return load_module(os.path.join(root, PKG, "metrics", f"{name}.py"),
                       _module_name("metric", name))


def metrics_of(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list the cell, and those without a list whose end-to-end metric the
    cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in e2e)]


def forbidden_modules() -> List[str]:
    """FORBIDDEN names that `sys.modules` holds, by whole top-level name."""
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def _sync(device) -> None:
    if getattr(device, "type", device) == "cuda":
        import torch
        torch.cuda.synchronize(device)


@dataclass
class Window:
    stream: traffic.Stream                          # the steps' inputs came from
    start: int                                      # its draws before the first step
    outputs: list = field(default_factory=list)     # None where a step failed
    durations: List[float] = field(default_factory=list)
    seconds: float = 0.0
    failed: int = 0
    error: Optional[str] = None
    trace: Optional[dict] = None

    @property
    def attempted(self) -> int:
        return len(self.durations)

    def inputs(self) -> list:
        """The steps' inputs, drawn again from the seed: the loop keeps
        none, so that no step takes fresh memory for them."""
        return self.stream.replay(self.start, self.attempted)


class Cell:
    """One cell: its files, the program's entry and the reference."""

    def __init__(self, root: str, bench: dict, name: str, device="cuda"):
        import torch
        self.name = name
        self.device = torch.device(device)
        self.cell = find(bench["workloads"], name)
        cfg = find(bench["configs"], self.cell["config"])
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.traffic = traffic.load(root, self.cell["traffic"])
        self.entry = entry_module(root, self.traffic["entry"])
        self.limits = load_json(os.path.join(root, PKG, "limits", f"{name}.json"))
        self.spans = {}
        self.program = None
        self.pool = None

    def build(self) -> None:
        t0 = time.perf_counter()
        self.program = self.entry.Program(self.config, self.traffic, self.device)
        _sync(self.device)
        self.spans["build_s"] = time.perf_counter() - t0

    def stream(self, seed: int) -> traffic.Stream:
        return traffic.Stream(self.traffic["inputs"], seed, self.device)

    def warm_up(self, stream: traffic.Stream, seconds: float = 0.0) -> None:
        """The mix's warm-up steps. With `seconds`, then the pool that the
        next window copies each step's answers into, touched now: room for
        twice the steps that fit in `seconds` at the last warm-up step's
        pace, so that the window's steps reuse host memory instead of
        faulting in fresh pages; steps beyond it keep their own arrays."""
        out, dt = None, 0.0
        for _ in range(int(self.traffic["warmup_steps"])):
            t0 = time.perf_counter()
            out = self.program.step(stream.next())
            dt = time.perf_counter() - t0
        self.pool = None
        if seconds > 0 and isinstance(out, np.ndarray) and out.nbytes:
            rows = min(int(2 * seconds / max(dt, 1e-4)) + 16, POOL_BYTES // out.nbytes)
            self.pool = np.empty((rows, *out.shape), out.dtype)
            self.pool.fill(0)

    def window(self, stream: traffic.Stream, seconds: float,
               trace: bool = False) -> Window:
        """The closed loop: steps until `seconds` have passed (and the
        traced steps are done). The steps after the first two are
        profiled with `trace`: the device's activity, and the host's ops
        unless the mix sets "trace_host" false."""
        import torch
        win = Window(stream, stream.drawn)
        pool, self.pool = self.pool, None     # one window's answers
        traced = []
        first = 2
        last = first + int(self.traffic["trace_steps"]) if trace else 0
        prof = None
        t_start = time.perf_counter()
        while True:
            k = win.attempted
            if k == first and trace:
                _sync(self.device)
                acts = [torch.profiler.ProfilerActivity.CUDA]
                if self.traffic.get("trace_host", True):
                    acts.append(torch.profiler.ProfilerActivity.CPU)
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
                t_trace = time.perf_counter()
            mark = (torch.profiler.record_function("nqsb.step") if prof is not None
                    else contextlib.nullcontext())
            x = stream.next()
            t0 = time.perf_counter()
            try:
                with mark:
                    out = self.program.step(x)
                ok = bool(self.entry.valid(out))
            except Exception:     # a failed step is counted, and the loop goes on
                out, ok = None, False
                if win.error is None:
                    win.error = traceback.format_exc()
            t1 = time.perf_counter()
            win.durations.append(t1 - t0)
            if prof is not None:
                traced.append(x)
            if (ok and pool is not None and k < len(pool) and isinstance(out, np.ndarray)
                    and out.shape == pool.shape[1:] and out.dtype == pool.dtype):
                pool[k] = out
                out = pool[k]
            win.outputs.append(out if ok else None)
            win.failed += not ok
            if prof is not None and win.attempted == last:
                _sync(self.device)
                traced_s = time.perf_counter() - t_trace
                prof.__exit__(None, None, None)
                win.trace = {"profile": prof, "first": first, "steps": last - first,
                             "inputs": traced, "window_s": traced_s}
                prof = None
            if t1 - t_start >= seconds and (not trace or win.attempted >= last):
                break
        win.seconds = t1 - t_start
        return win

    def judge(self, seed: int, win: Window, control: bool = False):
        """The compared numbers of the window's answers (the entry's
        `check` on the entry's reference `model` of the configuration, with
        a generator seeded by the run's seed for what it samples): the
        program's answers, or (control) the entry's control in their place.
        None if no step answered."""
        done = [k for k, o in enumerate(win.outputs) if o is not None]
        if not done:
            return None
        rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        model = self.entry.model(self.config)
        xs = win.inputs()
        return self.entry.check(model, self.traffic, [_host(xs[k]) for k in done],
                                [win.outputs[k] for k in done], rng, self.device, control)

    def verdict(self, numbers) -> bool:
        return numbers is not None and all(numbers[k] <= lim
                                           for k, lim in self.limits.items())


def _host(v) -> np.ndarray:
    """A step's inputs on the host: integers (seeds) as int64, exact, and
    everything else as float64."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    v = np.asarray(v)
    return v.astype(np.int64 if np.issubdtype(v.dtype, np.integer) else np.float64,
                    copy=False)


def _trace_view(root: str, cell: Cell, win: Window) -> Optional[dict]:
    """The traced steps' device events, read back from the exported
    chrome trace (under nqs_bench/out/, one file a cell)."""
    if win.trace is None:
        return None
    out = os.path.join(root, PKG, "out")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace-{cell.name}.json")
    win.trace["profile"].export_chrome_trace(path)
    evs = tracing.load_events(path)
    return dict(win.trace, events=evs, device=tracing.device_events(evs),
                path=path)


def _short(name: str, width: int = 160) -> str:
    """A kernel's name without its argument list, at most `width` long."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:width]


def measure(root: str, bench: dict, name: str, seed: int, seconds: float,
            trace: bool, device: str, t_process: float) -> dict:
    """One run of cell `name` on `device`: its result line as a dict."""
    import torch
    t_imported = time.perf_counter()
    cell = Cell(root, bench, name, device)
    cell.build()
    stream = cell.stream(seed)
    t_built = time.perf_counter()
    cell.warm_up(stream, seconds)
    _sync(cell.device)
    setup_s = time.perf_counter() - t_process
    print(f"set-up {setup_s:.3f} s: imports {t_imported - t_process:.3f} s, entry "
          f"{t_built - t_imported:.3f} s (build_s {cell.spans['build_s']:.3f}), "
          f"warm-up {t_process + setup_s - t_built:.3f} s", file=sys.stderr)
    win = cell.window(stream, seconds, trace=trace)
    _sync(cell.device)
    on_card = cell.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(cell.device) if on_card else 0
    cell.program = None
    if on_card:
        torch.cuda.empty_cache()
    if win.error:
        print(f"first failed step:\n{win.error}", file=sys.stderr)

    tr = _trace_view(root, cell, win)
    t0 = time.perf_counter()
    numbers = cell.judge(seed, win)
    print(f"reference check of {cell.traffic['check_members']} answers: "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    correct = cell.verdict(numbers) and win.failed == 0

    ctx = SimpleNamespace(root=root, cell=cell.cell, config=cell.config,
                          traffic=cell.traffic, spans=cell.spans,
                          setup_s=setup_s, durations=win.durations,
                          window_s=win.seconds, attempted=win.attempted,
                          trace=tr)
    metrics = {}
    for m in metrics_of(bench, name, "per_layer" if trace else "end_to_end"):
        value = metric_reader(root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else cell.device.type,
           "kind": torch.cuda.get_device_name(cell.device) if on_card else "cpu",
           "count": int(cell.cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        busy, _ = tracing.busy_span(tr["device"])
        dev.update(busy_s=busy * 1e-6, window_s=tr["window_s"])
        result["breakdown"] = {
            "device_ops": [[_short(n), t] for n, t in tracing.top_device_ops(tr["device"])],
            "idle_gaps": [[_short(n), t] for n, t in tracing.idle_gaps(tr["events"], tr["device"])]}
    result["checks"] = {k: {"value": None if numbers is None else numbers.get(k),
                            "limit": lim} for k, lim in cell.limits.items()}
    return result


def run(argv, root: str, t_process: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    bench = load_benchmark(root)
    chips = int(find(bench["workloads"], args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
              "no result", file=sys.stderr)
        return 3
    result = measure(root, bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), "cuda", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"the run's process holds {', '.join(bad)}: no result", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
