"""The surface-code memory record: sample throughput, then sample + exact
decode + logical error rate end to end.

Counterpart of the reference's `bench.py` `main_qec` (`--qec`): the rotated
surface code at distance d, `rounds` rounds of circuit-level noise at rate
p (memory_z_circuit).

1. Sample throughput: the fast sampler at `block` shots a call (2^20 at
   d <= 7, 2^18 above); the median of the timed calls, each fenced by a
   device sync.
2. End to end, per rep of `decode_shots` shots on the device: sample, the
   exact device decode, and finalize (failures among the shots the device
   certifies, the flagged count, and the flagged rows compacted into `cap`
   rows, most-flagged first with ties to the lower index). The decoder is
   the reference's: at d <= 7 the tiered bitmask DP (K = 6 on every shot,
   K = 12 on the `heavy_capacity` heaviest shots of each 16384-shot chunk),
   flagging every shot it did not decode with all its defects (more than
   12, or more than 6 past the chunk's heavy capacity); above d = 7 the exact cluster
   decomposition (size-class DPs, 24 slots, 4096-shot chunks) with its own
   flags. The flagged rows go to the host as uint8 rows by a non-blocking
   copy into pinned memory, and the native C++ exact decoder re-decodes
   them (`decode_batch_ex(mode=0)`) while later reps run on the device:
   every rep is queued before the first is drained. A flagged count above
   the fetch cap raises: a silent undercount is not a result.

`step` (d <= 7) is one rep answered shot by shot, at once: sample
(nqs.sample), the tiered DP (nqs.match: each DP once over every chunk, the
heavy rows chosen chunk by chunk), one read of the
flagged count, the flagged rows alone copied to the host and decoded there
(`decode_batch_ex(mode=0)`), their answers written over the device's
(nqs.escalate, carrying the row count), then one copy back of each shot's
prediction, tier and matching weight and the rep's failures, put together in
one host array (`answers`). The whole is the span nqs.step
(`utils/observability`).

    python -m noisyquantumsimulator_tpu_torch.bench_qec --d 7 --rounds 7
    python -m noisyquantumsimulator_tpu_torch.bench_qec --d 5 --rounds 5 \\
        --shots 32768 --decode-shots 8192 --device cpu

The last line of standard output is one compact JSON record (under 1500
characters) with the reference's keys, plus the peak device memory and the
device idle share of one end-to-end rep (torch.profiler; null on the CPU).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .qec.cluster_matcher import ClusterMatcher, default_tiers
from .qec.dem import build_dem, dem_to_edges
from .qec.decoders import MatchingGraph, stable_top_rows
from .qec.exact_matcher import TieredMatcher
from .qec.fast_sampler import build_fast_sampler
from .qec.native import NativeMatchingDecoder
from .qec.surface_code import memory_z_circuit
from .utils.math import wilson_ci
from .utils.observability import span
from .utils.profiling import profile_window

K_HEAVY = 12
# a matching weight (a sum of log-likelihood ratios) is given in units of
# 1 / WEIGHT_UNITS
WEIGHT_UNITS = 1024


@dataclass
class QecWorkload:
    e2e: Callable            # e2e(generator) -> Rep, queued, no host sync
    drain: Callable          # drain(rep) -> logical errors of the rep
    step: Optional[Callable]  # step(generator) -> `answers`; None above d = 7
    decoder: object          # TieredMatcher (d <= 7) or ClusterMatcher
    native: NativeMatchingDecoder
    circuit: object
    sampler: Callable        # the decode_shots sampler
    d: int
    rounds: int
    p: float
    decode_shots: int
    chunk: int
    cap: int                 # flagged rows fetched to the host per rep
    label: str


@dataclass
class Rep:
    counts: torch.Tensor     # (2,) int64 on the host: errors, flagged count
    dets: torch.Tensor       # (cap, n_det) uint8 on the host, flagged first
    obs: torch.Tensor        # (cap,) int32
    flags: torch.Tensor      # (cap,) bool
    done: Optional[torch.cuda.Event]


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A non-blocking copy into pinned host memory (a plain view on the
    CPU)."""
    if t.device.type != "cuda":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def device_decode(dec, dets: torch.Tensor, chunk: int):
    """(preds (S,) int32, flags (S,) bool) of the device stage, chunk by
    chunk: the tiered DP flags each shot it did not decode with all its
    defects, the cluster decomposition its own uncertified shots."""
    if isinstance(dec, TieredMatcher):
        pred, _, _, exact = dec.decode_device_tiered(dets)
        return pred, ~exact
    outs = [dec.decode_device_with_overflow(dets[s0:s0 + chunk])
            for s0 in range(0, dets.shape[0], chunk)]
    return (torch.cat([p for p, _ in outs]), torch.cat([f for _, f in outs]))


def answers(shots: np.ndarray, n_fail: int, n_flagged: int) -> np.ndarray:
    """A step's answers as one (S + 1, 3) int32 host array. Row i < S is
    shot i: its predicted logical flip (0 / 1), the tier that decided it (0:
    the K = 6 DP, 1: the K = 12 DP, 2: the host's exact decode, 3: the
    host's decode, not certified exact) and its matching weight in units of
    1 / WEIGHT_UNITS. The last row is (the step's failures, the shots
    escalated to the host, 0)."""
    return np.concatenate([shots.astype(np.int32),
                           np.array([[n_fail, n_flagged, 0]], np.int32)])


def build_qec_workload(d: int = 7, rounds: int = 7, p: float = 1e-3,
                       decode_shots: int = 1 << 17,
                       device: Union[str, torch.device] = "cuda",
                       cap: Optional[int] = None) -> QecWorkload:
    """The `main_qec` end-to-end workload on `device`; `cap` (flagged rows
    fetched a rep) defaults to the record's."""
    dev = torch.device(device)
    circuit = memory_z_circuit(d, rounds, p=p)
    n_det = circuit.n_detectors
    edges, eprobs, eobs = dem_to_edges(build_dem(circuit))
    graph = MatchingGraph.from_edges(n_det, edges, eprobs, eobs)
    nat = NativeMatchingDecoder(n_det, edges, eprobs, eobs)
    # fetch capacity: cluster flags reach ~10% of shots at d = 11
    if cap is None:
        cap = min(decode_shots, max(decode_shots // 8 if d <= 11
                                    else (2 * decode_shots) // 5, 64))
    if d <= 7:
        chunk = min(16384, decode_shots)
        dec = TieredMatcher(n_det, edges, eprobs, eobs, k_light=6,
                            k_heavy=K_HEAVY, chunk=chunk,
                            heavy_capacity=min(chunk, max(chunk // 16, 64)),
                            device=dev)
        label = (f"on-device exact MWPM (tiered bitmask DP, K=6 all shots / "
                 f"K={K_HEAVY} heavy tail) + host exact cluster decode of "
                 ">K-defect shots")
    else:
        chunk = min(4096, decode_shots)
        dec = ClusterMatcher(n_det, edges, eprobs, eobs, chunk=chunk,
                             max_slots=24, tiers=default_tiers(n_det),
                             device=dev, graph=graph)
        label = ("on-device exact cluster decomposition (K=6/8/12 size-class "
                 "DPs) + host exact cluster decode of flagged shots")
    sampler = build_fast_sampler(circuit, decode_shots, dev)

    def e2e(generator: torch.Generator) -> Rep:
        o = sampler(generator)
        dets = o["detectors"]
        obs = o["observables"][:, 0].to(torch.int32)
        preds, flags = device_decode(dec, dets, chunk)
        err = (preds ^ obs) & 1
        idx = stable_top_rows(flags, cap)
        counts = torch.stack([torch.where(flags, 0, err).sum(),
                              flags.sum()]).to(torch.int64)
        rep = Rep(counts=_to_host(counts), dets=_to_host(dets[idx]),
                  obs=_to_host(obs[idx]), flags=_to_host(flags[idx]),
                  done=None)
        if dev.type == "cuda":
            rep.done = torch.cuda.Event()
            rep.done.record()
        return rep

    def drain(rep: Rep) -> int:
        """Wait for one rep's copies; re-decode its flagged rows on the
        host; its logical errors."""
        if rep.done is not None:
            rep.done.synchronize()
        n_err, n_flag = (int(v) for v in rep.counts)
        if n_flag > cap:
            raise RuntimeError(f"escalation fetch cap {cap} < flagged "
                               f"{n_flag}: the error count would be short")
        if n_flag == 0:
            return n_err
        sel = rep.flags.numpy()
        pred = nat.decode_batch_ex(rep.dets.numpy()[sel], mode=0)["pred"] & 1
        return n_err + int(np.sum(pred != (rep.obs.numpy()[sel] & 1)))

    first = True

    def step(generator: torch.Generator) -> np.ndarray:
        # the span nqs.step; the first call (the native library's load, the
        # first device calls) is recorded in any case
        nonlocal first
        with span("nqs.step", always=first):
            first = False
            o = sampler(generator)
            obs = o["observables"][:, 0].to(torch.int32)
            with span("nqs.match"):
                pred, tier, weight, exact = dec.decode_device_tiered(o["detectors"])
                weight = (weight * WEIGHT_UNITS).round().clamp(max=2.0 ** 30)
                weight = weight.to(torch.int32)
                flags = ~exact
                n_flag_d = flags.sum()
            # the step's one read before the answers, outside nqs.match (its
            # launches) and nqs.escalate (the host's decode)
            n_flag = int(n_flag_d)
            if n_flag > cap:
                raise RuntimeError(f"escalation fetch cap {cap} < flagged "
                                   f"{n_flag}: the answers would not be exact")
            with span("nqs.escalate") as s:
                s.note(n_flag)
                if n_flag:
                    idx = stable_top_rows(flags, n_flag)
                    r = nat.decode_batch_ex(
                        o["detectors"].index_select(0, idx).cpu().numpy(), mode=0)
                    esc = torch.as_tensor(np.stack([
                        r["pred"] & 1, np.where(r["exact"], 2, 3),
                        np.minimum(np.round(r["cost"] * WEIGHT_UNITS), 2.0 ** 30)],
                        axis=1).astype(np.int32)).to(dev)
                    pred = pred.index_copy(0, idx, esc[:, 0])
                    tier = tier.index_copy(0, idx, esc[:, 1])
                    weight = weight.index_copy(0, idx, esc[:, 2])
            fails = ((pred ^ obs) & 1).sum().to(torch.int32)
            flat = torch.cat([torch.stack([pred, tier, weight], dim=1).flatten(),
                              fails.view(1)]).cpu().numpy()
            return answers(flat[:-1].reshape(-1, 3), int(flat[-1]), n_flag)

    return QecWorkload(e2e=e2e, drain=drain,
                       step=step if isinstance(dec, TieredMatcher) else None,
                       decoder=dec, native=nat,
                       circuit=circuit, sampler=sampler, d=d, rounds=rounds,
                       p=p, decode_shots=decode_shots, chunk=chunk, cap=cap,
                       label=label)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def device_profile(fn, tag: str):
    """One call of fn under torch.profiler (after a warm-up call): (idle
    share of the device within its span, [(kernel name, device us)] of the
    8 largest, trace path); (None, [], path) when the trace holds no device
    events."""
    _, idle, by_name, path, _ = profile_window(fn, tag, n_calls=1)
    top = sorted((by_name or {}).items(), key=lambda kv: -kv[1])[:8]
    return idle, top, path


def main_qec(d: int = 7, rounds: int = 7, p: float = 1e-3,
             shots: int = 1 << 20, decode_shots: int = 1 << 17,
             reps_decode: int = 3, seed: int = 0,
             device: Union[str, torch.device] = "cuda") -> dict:
    """Run the record; returns it as a dict (`main` prints it)."""
    dev = torch.device(device)
    circuit = memory_z_circuit(d, rounds, p=p)
    n_det = circuit.n_detectors
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- 1. sample throughput ----
    block = min(shots, 1 << 20 if d <= 7 else 1 << 18)
    n_blocks = max(1, -(-shots // block))
    sampler = build_fast_sampler(circuit, block, dev)
    sampler(_generator(dev, 0))
    _sync(dev)
    times, tot = [], 0
    for r in range(5 * n_blocks):
        t0 = time.perf_counter()
        out = sampler(_generator(dev, r + 1))
        _sync(dev)
        times.append(time.perf_counter() - t0)
        tot += int(out["detectors"].sum(dtype=torch.int64))
    del out, sampler
    shots_done = block * len(times)
    med = statistics.median(times)

    # ---- 2. sample + exact decode + p_L ----
    w = build_qec_workload(d, rounds, p, decode_shots, dev)
    w.drain(w.e2e(_generator(dev, 100)))          # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    reps = [w.e2e(_generator(dev, 1000 * seed + 200 + r))
            for r in range(reps_decode)]
    errs = n_flag = 0
    for rep in reps:
        errs += w.drain(rep)
        n_flag += int(rep.counts[1])
    _sync(dev)
    dt = time.perf_counter() - t0
    n_dec = decode_shots * reps_decode
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)
    idle, top = None, []
    if dev.type == "cuda":
        idle, top, _ = device_profile(
            lambda: w.drain(w.e2e(_generator(dev, 99))), f"qec_d{d}_rep")

    return {
        "metric": f"surface_code_d{d}_sample_shots_per_sec",
        "value": round(block / med, 1),
        "unit": "shots/s",
        "d": d, "rounds": rounds, "p": p, "shots_per_call": block,
        "sample_calls": len(times),
        "n_detectors": n_det,
        "detector_fraction": round(tot / (shots_done * n_det), 6),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "e2e_sample_decode_shots_per_sec": round(n_dec / dt, 1),
        "e2e_decoder": w.label,
        "e2e_p_logical_shot": errs / n_dec,
        "e2e_n_errors": errs,
        "e2e_n_decoded": n_dec,
        "e2e_p_logical_ci95": [float(x) for x in wilson_ci(errs, n_dec)],
        "e2e_escalated_fraction": n_flag / n_dec,
        "e2e_reps": reps_decode,
        "e2e_fetch_cap": w.cap,
        "peak_device_gib": None if peak is None else round(peak, 3),
        "idle_share_one_rep": None if idle is None else round(idle, 4),
        "top_device_ops_us": [[n[:40], round(t, 1)] for n, t in top[:4]],
        "seed": seed,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--d", type=int, default=7)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--shots", type=int, default=1 << 20)
    ap.add_argument("--decode-shots", type=int, default=1 << 17)
    ap.add_argument("--reps-decode", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    rec = main_qec(a.d, a.rounds or a.d, a.p, a.shots, a.decode_shots,
                   a.reps_decode, a.seed, a.device)
    print(record_line(rec), flush=True)
    return 0


def record_line(rec: dict) -> str:
    """The record as one compact JSON line under 1500 characters (the top
    device ops are dropped when they would push it over)."""
    line = json.dumps(rec, separators=(",", ":"))
    if len(line) > 1500:
        rec = {k: v for k, v in rec.items() if k != "top_device_ops_us"}
        line = json.dumps(rec, separators=(",", ":"))
    return line


if __name__ == "__main__":
    raise SystemExit(main())
