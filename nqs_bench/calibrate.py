"""The readings that a cell's limits are set from, in one process:

    python3 nqs_bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 2] [--fault half|altered|stale]

For each seed, a short window at the cell's own load (the set-up's warm-up
steps first, as a run draws them), then the numbers that decide `correct`,
on as many answers as a run compares: the program's, and for the control
seeds the control's (the reference in TF32 in the program's place). One
JSON line a seed, then the largest program reading and the smallest control
reading of each number. The benchmark's own runs never run the control.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path[0] = ROOT     # the checkout, not this folder, is the import root

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

from nqs_bench import faults, harness  # noqa: E402


def readings(cell, seeds, control_seeds, seconds):
    """{seed: {"program": numbers, "control": numbers or None}}."""
    out = {}
    for seed in seeds:
        stream = cell.stream(seed)
        cell.warm_up(stream)
        win = cell.window(stream, seconds)
        out[seed] = {"steps": win.attempted, "failed": win.failed,
                     "program": cell.judge(seed, win),
                     "control": (cell.judge(seed, win, control=True)
                                 if seed in control_seeds else None)}
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", choices=faults.FAULTS,
                    help="read the program with this fault planted (faults.py)")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    cell = harness.Cell(ROOT, harness.load_benchmark(ROOT), args.workload, args.device)
    cell.build()
    with (faults.planted(cell.traffic["entry"], args.fault) if args.fault
          else contextlib.nullcontext()):
        res = readings(cell, seeds, controls, args.seconds)
    for seed, r in res.items():
        print(json.dumps({"workload": args.workload, "seed": seed, **r}))
    summary = {"workload": args.workload, "fault": args.fault, "limits": cell.limits}
    for k in cell.limits:
        prog = [r["program"][k] if r["program"] else float("inf") for r in res.values()]
        summary[f"{k}_program_max"] = max(prog)    # inf: a seed whose steps all failed
        ctl = [r["control"][k] for r in res.values() if r["control"]]
        summary[f"{k}_control_min"] = min(ctl) if ctl else None
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
