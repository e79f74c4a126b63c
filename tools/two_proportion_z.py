#!/usr/bin/env python3
"""Pool logical-error counts and compare two pools by a two-proportion z.

    python3 tools/two_proportion_z.py --a 125/786432 128/786432 \\
        --b 93/786432 164/1048576

Each argument is one measurement, `errors/shots`. Prints each pool's
errors, shots, rate and Wilson 95% interval, then z = (p_a - p_b) / se with
the pooled rate in se (the usual test of equal proportions), as one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import math


def wilson(k: int, n: int, z: float = 1.96):
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return max(0.0, mid - half), min(1.0, mid + half)


def pool(items):
    k = n = 0
    for it in items:
        e, s = it.split("/")
        k, n = k + int(e), n + int(s)
    return k, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--a", nargs="+", required=True, help="errors/shots ...")
    ap.add_argument("--b", nargs="+", required=True, help="errors/shots ...")
    a = ap.parse_args(argv)
    (ka, na), (kb, nb) = pool(a.a), pool(a.b)
    pa, pb, p = ka / na, kb / nb, (ka + kb) / (na + nb)
    z = (pa - pb) / math.sqrt(p * (1 - p) * (1 / na + 1 / nb))
    print(json.dumps({"a": {"errors": ka, "shots": na, "p": pa,
                            "ci95": wilson(ka, na)},
                      "b": {"errors": kb, "shots": nb, "p": pb,
                            "ci95": wilson(kb, nb)},
                      "z": z}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
