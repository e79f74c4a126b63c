"""Surface-code memory study: threshold scan, Lambda, teraquop footprint.

Counterpart of `examples/qec_study.py`: the rotated surface code (memory Z,
rounds = d) at each distance and physical error rate. Shots are sampled on
the device in 2^18-shot blocks (`fast_sampler`, a generator seeded
`7919 + block`), the uint8 detector rows are copied to the host whole
and decoded there by the native exact matcher (cluster decomposition, true
MWPM; `decode_batch_ex(mode=0)`). `summarize` turns the table into the
error-suppression factor Lambda per p (zero-error steps excluded) and the
teraquop footprint anchored at the largest distance with errors at
p = 1e-3; the output is rewritten after every cell.

    python -m noisyquantumsimulator_tpu_torch.studies.qec_study --quick
    python -m noisyquantumsimulator_tpu_torch.studies.qec_study --ds 9,11
    python -m noisyquantumsimulator_tpu_torch.studies.qec_study --quick \\
        --device cpu --out /tmp/qec_study.json

`--ds` measures a subset of distances and merges it into the existing
output file (this study's own, never `examples/`); it refuses `--quick`.
Writes `studies_out/qec_study.json` (or `--out`) with the script's keys
plus `errors` (logical errors per cell), and the PNG beside it.
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..bench import _device
from ..qec.dem import build_dem, dem_to_edges
from ..qec.fast_sampler import build_fast_sampler
from ..qec.native import NativeMatchingDecoder
from ..qec.surface_code import (logical_error_rate, memory_z_circuit,
                                teraquop_footprint)
from ..utils.observability import provenance_stamp
from . import add_common_args, out_path, read_json, write_json

NAME = "qec_study"
BLOCK = 1 << 18
DECODER = ("native exact cluster decomposition (true MWPM; "
           "uf_decoder.cpp mode=0)")


def measure_p_l(d: int, p: float, shots: int, seed: int = 1,
                device="cuda") -> Tuple[float, float, int, int]:
    """(p_logical_round, p_logical_shot, shots_done, errors): sample on the
    device in blocks, decode on the host with the native exact decoder."""
    dev = torch.device(device)
    rounds = d
    circuit = memory_z_circuit(d, rounds, p=p)
    edges, probs, obs = dem_to_edges(build_dem(circuit))
    nat = NativeMatchingDecoder(circuit.n_detectors, edges, probs, obs)
    block = min(shots, BLOCK)
    sampler = build_fast_sampler(circuit, block, dev)
    errors = 0
    n_blocks = max(1, -(-shots // block))
    for b in range(n_blocks):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 7919 + b)
        o = sampler(gen)
        dets = o["detectors"].cpu().numpy()
        ob = o["observables"][:, 0].cpu().numpy()
        pred = nat.decode_batch_ex(dets, mode=0)["pred"] & 1
        errors += int(np.sum(pred != (ob & 1)))
    shots_done = block * n_blocks
    rates = logical_error_rate(errors, shots_done, rounds)
    return (rates["p_logical_round"], rates["p_logical_shot"], shots_done,
            errors)


def shot_budget(d: int, p: float, quick: bool) -> int:
    if quick:
        return 20000
    if d <= 7:
        return 200000
    # sub-threshold p_L shrinks ~5x per distance step: grow the budget so
    # the estimate keeps >= ~10 expected errors
    if p <= 1.1e-3:
        return (1 << 20) if d == 9 else (3 << 20)
    if d >= 13 and p > 2.2e-3:
        # near threshold 2^19 shots give thousands of errors, and the host
        # exact decode of dense d = 13 syndromes dominates the cost
        return 1 << 19
    return 1 << 19 if d <= 11 else 1 << 20


def shot_rate(p_round: float, rounds: int) -> float:
    """The per-shot logical error rate of a per-round one (the inverse of
    `logical_error_rate`'s map)."""
    return 0.5 * (1.0 - (1.0 - 2.0 * p_round) ** rounds)


def cell_key(d: int, p: float) -> str:
    return f"d{d}_p{p}"


def parse_key(key: str) -> Tuple[int, float]:
    dd, pp = key[1:].split("_p")
    return int(dd), float(pp)


def summarize(table: Dict[Tuple[int, float], float],
              shots: Dict[Tuple[int, float], int]) -> dict:
    """Lambda and the teraquop footprint of a (d, p) -> p_L/round table.

    Lambda at each p is the mean suppression per distance step of 2, over
    the steps whose larger-d cell measured errors (a zero-error cell is a
    shot-budget artifact, not a suppression factor); it spans every p column
    of the table. The teraquop footprint is anchored at the largest d with
    errors at p = 1e-3."""
    lambdas, lambda_steps = {}, {}
    all_ds = sorted({d for d, _ in table})
    for p in sorted({p for _, p in table}):
        col = [d for d in all_ds if (d, p) in table]
        ratios = [table[(col[i], p)] / max(table[(col[i + 1], p)], 1e-12)
                  for i in range(len(col) - 1)]
        ok = [r for i, r in enumerate(ratios) if table[(col[i + 1], p)] > 0]
        lambdas[p] = float(np.mean(ok)) if ok else float("nan")
        lambda_steps[p] = ratios

    p_op = 1e-3
    nonzero = [d for d, pp in table if pp == p_op and table[(d, pp)] > 0]
    if nonzero:
        d_max = max(nonzero)
        tq = teraquop_footprint(table[(d_max, p_op)], d_max)
    else:
        d_max, tq = None, None
    return {
        "table": {cell_key(d, p): v for (d, p), v in table.items()},
        "shots": {cell_key(d, p): v for (d, p), v in shots.items()},
        "lambda": {str(p): v for p, v in lambdas.items()},
        "lambda_per_step": {str(p): v for p, v in lambda_steps.items()},
        "teraquop_d": tq,
        "teraquop_anchored_at_d": d_max,
        "decoder": DECODER,
    }


def run(quick: bool = False, ds: Optional[Sequence[int]] = None,
        ps: Optional[Sequence[float]] = None, shots: Optional[int] = None,
        device="cuda", path: Optional[Path] = None,
        merge: bool = False) -> dict:
    """Measure every (d, p) cell (`shots` overrides `shot_budget`) and
    return the summary. With `path`, the output is written after every
    cell; with `merge`, the cells already in `path` are kept (refused with
    `quick`: reduced-budget cells would mix into a full-budget table
    unmarked)."""
    if merge and quick:
        raise ValueError("--ds cannot be combined with --quick: it merges "
                         "reduced-budget cells into the full-budget table")
    dev = _device(device)
    ds = tuple(ds or ((3, 5) if quick else (3, 5, 7, 9, 11, 13)))
    ps = tuple(ps or ((1e-3, 2e-3, 4e-3) if quick
                      else (5e-4, 1e-3, 2e-3, 4e-3, 8e-3)))
    table, shots_used, errors = {}, {}, {}
    if merge and path is not None:
        prev = read_json(path)
        for key, v in prev.get("table", {}).items():
            table[parse_key(key)] = v
            shots_used[parse_key(key)] = prev.get("shots", {}).get(key, 0)
        for key, v in prev.get("errors", {}).items():
            errors[parse_key(key)] = v
    out = {}
    for d in ds:
        for p in ps:
            plr, pls, sd, ne = measure_p_l(d, p, shots or shot_budget(
                d, p, quick), device=dev)
            table[(d, p)], shots_used[(d, p)], errors[(d, p)] = plr, sd, ne
            print(f"d={d} p={p:.0e}: p_L/round={plr:.3e} p_L/shot={pls:.3e} "
                  f"({ne} errors in {sd} shots, native exact cluster decode)",
                  flush=True)
            out = summarize(table, shots_used)
            out["errors"] = {cell_key(*k): v for k, v in errors.items()}
            out.update(provenance_stamp())
            if path is not None:
                write_json(path, out)
    for p, lam in out["lambda"].items():
        steps = [f"{r:.1f}" for r in out["lambda_per_step"][p]]
        print(f"p={float(p):.0e}: Lambda = {lam:.2f} (per-step: {steps})")
    if out["teraquop_d"] is not None:
        print(f"teraquop distance estimate at p=1e-03: d = {out['teraquop_d']}"
              f" (anchored at measured d={out['teraquop_anchored_at_d']})")
    else:
        print("teraquop estimate skipped: no nonzero p_L cell at p=1e-03")
    return out


def plot(out: dict, png) -> Optional[str]:
    """The threshold plot, when matplotlib is installed (None otherwise)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return None
    from ..utils.visualization import plot_logical_error_scaling
    table = {parse_key(k): v for k, v in out["table"].items()}
    return plot_logical_error_scaling(table, str(png))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="d 3, 5; p 1e-3, 2e-3, 4e-3; 20000 shots a cell")
    ap.add_argument("--ds", default=None,
                    help="comma-separated distances, merged into --out")
    add_common_args(ap)
    a = ap.parse_args(argv)
    path = out_path(NAME, a.out)
    ds = tuple(int(x) for x in a.ds.split(",")) if a.ds else None
    out = run(quick=a.quick, ds=ds, device=a.device, path=path,
              merge=ds is not None)
    print(f"wrote {path}")
    png = plot(out, path.with_suffix(".png"))
    print(f"wrote {png}" if png else "(no plot: matplotlib is not installed)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
