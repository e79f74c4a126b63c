"""Run the CZ-gate walkthrough notebook's code cells.

Counterpart of `examples/cz_gate_optimization_demo.ipynb`, whose port is
`cz_gate_optimization_demo.ipynb` beside this module: 16 cells, 8 of them
code. Code cell 0 imports and sets `DEVICE`; code cell k (k = 1..7) is the
notebook's section k (the gate, its noise budget, the protocol comparison,
the optimizer, a hardware sweep, the calibrated channel in a temporary
store, the QEC memory priced with it). `run_cells` executes them in order in
one namespace, with `DEVICE` replaced by the device asked for; the notebook
is read with `json` (no Jupyter package needed).

    python -m noisyquantumsimulator_tpu_torch.studies.demo_notebook
    python -m noisyquantumsimulator_tpu_torch.studies.demo_notebook \\
        --device cpu --skip 4 --out /tmp/demo.json

Writes `studies_out/demo_notebook.json` (or `--out`): each cell's seconds
and the numbers each section prints.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

from ..bench import _device
from . import add_common_args, out_path, stamp, write_json

NAME = "demo_notebook"
NOTEBOOK = Path(__file__).with_name("cz_gate_optimization_demo.ipynb")


def code_cells(path=NOTEBOOK) -> list:
    """The sources of the notebook's code cells, in order."""
    with open(path) as f:
        nb = json.load(f)
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def run_cells(path=NOTEBOOK, device="cuda", skip: Sequence[int] = ()
              ) -> Tuple[dict, Dict[int, float]]:
    """Execute the code cells in order in one namespace, but those whose
    index is in `skip` (code cell k is section k); `DEVICE` is `device`
    from the first cell on. Returns (the namespace, seconds per cell run)."""
    dev = _device(device)
    ns = {"__name__": "__notebook__"}
    seconds = {}
    for i, src in enumerate(code_cells(path)):
        if i in skip:
            continue
        t0 = time.perf_counter()
        exec(compile(src, f"{path}:code cell {i}", "exec"), ns)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[i] = time.perf_counter() - t0
        if i == 0:
            ns["DEVICE"] = str(dev)
    return ns, seconds


def run(device="cuda", skip: Sequence[int] = ()) -> dict:
    """The notebook on `device`, and what its sections computed."""
    dev = _device(device)
    ns, seconds = run_cells(device=dev, skip=skip)
    out = {"notebook": NOTEBOOK.name, "skipped": list(skip),
           "seconds": {str(k): v for k, v in seconds.items()}}
    if "result" in ns:
        out["default_fidelity"] = ns["result"].avg_fidelity
    if "protocols" in ns:
        out["protocol_fidelity"] = dict(ns["protocols"])
    if "opt" in ns:
        out["optimized_fidelity"] = float(ns["opt"].best_metrics["avg_fidelity"])
        out["optimized_cost"] = float(ns["opt"].best_cost)
    if "sw" in ns:
        out["temperature_sweep_fidelity"] = ns["sw"].fidelity.tolist()
    if "rec" in ns:
        out["cz_record_fidelity"] = 1.0 - ns["rec"].error_rates[
            "avg_gate_infidelity"]
    if "r" in ns and hasattr(ns["r"], "p_logical_shot"):
        out["memory_p_logical_shot"] = ns["r"].p_logical_shot
        out["memory_n_errors"] = ns["r"].n_logical_errors
    out.update(stamp(dev))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--skip", default="",
                    help="comma-separated code cells (sections) not to run")
    add_common_args(ap)
    a = ap.parse_args(argv)
    skip = tuple(int(x) for x in a.skip.split(",") if x)
    out = run(device=a.device, skip=skip)
    print(f"wrote {write_json(out_path(NAME, a.out), out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
