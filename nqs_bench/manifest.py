"""The rules that `BENCHMARK.json` keeps: `problems(bench, root)` lists every
rule a manifest breaks (an empty list: none). The tests hold the committed
manifest to them."""
from __future__ import annotations

import os
import re

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                   r"expansion|experts_per_tok|_dim$|_rank$)")


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def problems(bench: dict, root: str = ".") -> list:
    out = []

    def need(cond, what):
        if not cond:
            out.append(what)

    need(set(bench) == KEYS, f"top-level keys {sorted(bench)}")
    cmd = bench.get("command", [])
    need(isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd),
         "command: 1-32 words of 1-200 characters")
    paths = bench.get("paths", [])
    need(1 <= len(paths) <= 16 and all(PATH.match(p) and not p.startswith("/")
                                       and ".." not in p.split("/") for p in paths),
         "paths: 1-16 relative paths")
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            need(any(w == p or w.startswith(p.rstrip("/") + "/") for p in paths),
                 f"command word {w} lies outside paths")
    rs = bench.get("run_seconds")
    need(isinstance(rs, int) and 1 <= rs <= 51, "run_seconds: a whole number 1-51")

    cfgs, cells = bench.get("configs", []), bench.get("workloads", [])
    e2e, layers = bench.get("end_to_end", []), bench.get("per_layer", [])
    need(1 <= len(cfgs) <= 24, "1-24 configs")
    need(1 <= len(cells) <= 24, "1-24 workloads")
    need(1 <= len(e2e) <= 16, "1-16 end-to-end metrics")
    need(1 <= len(layers) <= 128, "1-128 per-layer metrics")
    for group in (cfgs, cells, e2e + layers):
        names = [e.get("name") for e in group]
        need(len(names) == len(set(names)), f"repeated names in {names}")
    for e in cfgs + cells + e2e + layers:
        need(isinstance(e.get("name"), str) and bool(NAME.match(e["name"])),
             f"name {e.get('name')!r}")

    files = [c.get("file") for c in cfgs]
    need(len(files) == len(set(files)), "a configuration file used twice")
    for c in cfgs:
        need(set(c) == CONFIG_KEYS, f"config {c.get('name')}: keys {sorted(c)}")
        need(_line(c.get("source")) and _line(c.get("why")), f"config {c['name']}: source, why")
        need(any(c["file"].startswith(p.rstrip("/") + "/") for p in paths),
             f"config {c['name']}: file outside paths")
        need(os.path.isfile(os.path.join(root, c["file"])), f"config {c['name']}: no file")
        red = c.get("reduced", [])
        need(isinstance(red, list) and len(red) <= 16
             and all(NAME.match(k) and not WIDTH.search(k) for k in red),
             f"config {c['name']}: reduced {red}")
        need(any(w.get("config") == c["name"] for w in cells), f"config {c['name']} unused")

    four = 0
    pairs = set()
    for w in cells:
        need(set(w) == CELL_KEYS, f"cell {w.get('name')}: keys {sorted(w)}")
        need(w.get("config") in [c["name"] for c in cfgs], f"cell {w['name']}: config")
        need(NAME.match(str(w.get("traffic", ""))) is not None, f"cell {w['name']}: traffic")
        need(w.get("chips") in (1, 4), f"cell {w['name']}: chips")
        need(_line(w.get("why")), f"cell {w['name']}: why")
        four += w.get("chips") == 4
        pairs.add((w.get("config"), w.get("traffic")))
    need(len(pairs) == len(cells), "a pair of config and traffic appears twice")
    need(four <= max(1, len(cells) // 4), "too many four-chip cells")

    for m in e2e:
        need(set(m) - {"workloads"} == E2E_KEYS, f"metric {m.get('name')}: keys {sorted(m)}")
        need(m.get("source") in ("host_clock", "device_trace"), f"metric {m['name']}: source")
        b = m.get("bound")
        need(isinstance(b, (int, float)) and 0.01 <= b <= 0.25, f"metric {m['name']}: bound")
    need("setup_s" in [m["name"] for m in e2e], "setup_s missing")
    for m in e2e + layers:
        need(bool(UNIT.match(str(m.get("unit", "")))), f"metric {m['name']}: unit")
        need(m.get("better") in ("lower", "higher"), f"metric {m['name']}: better")
        need(m.get("source") in SOURCES, f"metric {m['name']}: source")
        for w in m.get("workloads", []):
            need(w in [c["name"] for c in cells], f"metric {m['name']}: cell {w}")

    def reports(cell, metric):
        return cell in metric.get("workloads", [cell])

    by_name = {m["name"]: m for m in e2e}
    for m in layers:
        need(set(m) - {"workloads"} == LAYER_KEYS, f"metric {m.get('name')}: keys {sorted(m)}")
        need(_line(m.get("layer")), f"metric {m['name']}: layer")
        moves = by_name.get(m.get("moves"))
        need(moves is not None, f"metric {m['name']}: moves {m.get('moves')}")
        if moves is not None:
            for w in m.get("workloads", [c["name"] for c in cells if reports(c["name"], moves)]):
                need(reports(w, moves), f"metric {m['name']}: cell {w} lacks {m['moves']}")
        if m["unit"] == "%" and (m["name"].endswith("_roofline") or "mfu" in m["name"]):
            need(m["better"] == "higher", f"metric {m['name']}: a share of a peak")
    for c in cells:
        n = c["name"]
        need(reports(n, by_name.get("setup_s", {})), f"cell {n}: no setup_s")
        need(sum(reports(n, m) for m in e2e) >= 2, f"cell {n}: no end-to-end metric but setup_s")
        need(any(n in m.get("workloads", []) or ("workloads" not in m and reports(
            n, by_name.get(m["moves"], {}))) for m in layers), f"cell {n}: no per-layer metric")
    runs = 2 + 14 * 24
    need(runs * (rs + 60) + 24 * 180 + 1200 <= 43200 if isinstance(rs, int) else False,
         "run_seconds does not fit a full check of 24 cells")
    return out
