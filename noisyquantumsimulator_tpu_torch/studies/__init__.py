"""The repository's research studies on the port.

Counterparts of the gate and QEC study scripts under `examples/`, one module
each, named after its script:

  * `research_parameter_sweeps`: the headline sweep set (nine hardware
    sweeps, two protocol sweeps, species, pulse shapes, the protocol
    summary, the noise breakdown);
  * `grape_optimal_control`: Adam over all 300 segment phases from the
    smooth-JP pulse;
  * `qec_study`: the surface-code threshold table, Lambda and the teraquop
    footprint, decoded by the host native exact matcher;
  * `qec_scale_study`: sample and sample + exact decode throughput for
    d = 3-11;
  * `decoder_accuracy_study`: the window matcher against the native exact
    oracle;
  * `gross_code_study`: the gross code at two error rates through
    `bench.main_bb`.

Each runs as `python -m noisyquantumsimulator_tpu_torch.studies.<name>`
with its script's flags plus `--device` (default `cuda`; `cpu` only when
asked) and `--out PATH` (default `studies_out/<name>.json` at the
repository root). Its `run(...)` takes the size knobs as arguments and
returns the dict the command writes, with the script's JSON keys. Nothing
here writes to `examples/`, `figures/` or `calibration_data/`.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "studies_out"


def out_path(name: str, out: Optional[str] = None) -> Path:
    """`out`, or `studies_out/<name>.json` at the repository root."""
    return Path(out) if out else OUT_DIR / f"{name}.json"


def read_json(path: Path) -> dict:
    """The study's earlier output at `path` ({} when there is none), for the
    `--ds` merges."""
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def write_json(path: Path, obj: dict) -> Path:
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path


def add_common_args(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="output JSON (default studies_out/<name>.json)")


__all__ = ["ROOT", "OUT_DIR", "out_path", "read_json", "write_json",
           "add_common_args"]
