"""The one traffic generator: a seed fixes every step's inputs, another seed
changes them, no two steps repeat, rows keep to the mix's ranges, and a
run of draws is drawn again alike."""
import time

import numpy as np
import pytest
import torch

from conftest import ROOT
from nqs_bench import traffic

MIXES = ["sweep-32768", "sweep-8192", "population-8192"]


def _steps(name, seed, n=3):
    spec = traffic.load(ROOT, name)["inputs"]
    s = traffic.Stream(spec, seed, "cpu")
    return [np.asarray(s.next(), np.float64) for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    seed = 2 ** 31 + 977
    for a, b in zip(_steps(name, seed), _steps(name, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_inputs_and_fresh_steps(name):
    a, b = _steps(name, 5), _steps(name, 6)
    assert not np.array_equal(a[0], b[0])
    assert not np.array_equal(a[0], a[1]) and not np.array_equal(a[1], a[2])


@pytest.mark.parametrize("name", MIXES)
def test_rows_keep_to_the_ranges(name):
    t = traffic.load(ROOT, name)
    spec = t["inputs"]
    x = _steps(name, 11, 1)[0]
    assert x.shape[0] == spec["count"]
    if spec["kind"] == "uniform":
        assert x.min() >= spec["low"] and x.max() <= spec["high"]
        assert x.max() - x.min() > 0.9 * (spec["high"] - spec["low"])
    else:
        b = np.asarray(spec["bounds"])
        c, r = np.asarray(spec["center"]), spec["spread"]
        lo = np.clip(c * (1 - r), b[:, 0], b[:, 1])
        hi = np.clip(c * (1 + r), b[:, 0], b[:, 1])
        assert np.all(x >= lo - 1e-12) and np.all(x <= hi + 1e-12)


def test_device_stream_is_float32_and_seeded():
    spec = {"kind": "uniform", "count": 64, "low": 0.95, "high": 1.05, "on": "device"}
    a = traffic.Stream(spec, 3, "cpu").next()
    b = traffic.Stream(spec, 3, "cpu").next()
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert float(a.min()) >= 0.95 and float(a.max()) <= 1.05


SEEDS = {"kind": "seeds", "count": 4096}


def _seeds(seed, n=3):
    s = traffic.Stream(SEEDS, seed, "cpu")
    return [s.next() for _ in range(n)]


def test_seeds_are_int64_within_their_range():
    x = _seeds(2 ** 31 + 977, 1)[0]
    assert x.dtype == np.int64 and x.shape == (SEEDS["count"],)
    assert x.min() >= 0                      # and below 2^63, as int64 holds
    assert x.max() > 2 ** 62 and x.min() < 2 ** 61 and len(np.unique(x)) == len(x)


def test_seeds_follow_the_run_seed_and_are_fresh():
    seed = 2 ** 31 + 977
    for a, b in zip(_seeds(seed), _seeds(seed)):
        np.testing.assert_array_equal(a, b)
    a, b = _seeds(5), _seeds(6)
    assert not np.intersect1d(a[0], b[0]).size
    assert not np.intersect1d(a[0], a[1]).size and not np.intersect1d(a[1], a[2]).size


def test_seeds_are_drawn_on_the_host():
    with pytest.raises(ValueError):
        traffic.Stream(dict(SEEDS, on="device"), 1, "cpu")


def test_host_inputs_keep_seeds_exact_and_floats_as_before():
    from nqs_bench import harness
    big = 2 ** 53 + 1                        # float64 would round it to 2^53
    for v in (np.array([big, 2 ** 63 - 1], np.int64), torch.tensor([big, 2 ** 63 - 1])):
        h = harness._host(v)
        assert h.dtype == np.int64 and h.tolist() == [big, 2 ** 63 - 1]
    f = torch.rand(5, dtype=torch.float32)
    h = harness._host(f)
    assert h.dtype == np.float64
    np.testing.assert_array_equal(h, np.asarray(f.numpy(), np.float64))
    x = np.random.default_rng(1).random((4, 5))
    np.testing.assert_array_equal(harness._host(x), x)


def test_cut_keeps_every_other_key():
    mix = traffic.load(ROOT, "population-8192")
    small = traffic.cut(mix, 8)
    assert small["inputs"] == dict(mix["inputs"], count=8)
    assert small == dict(mix, inputs=small["inputs"], check_members=8,
                         warmup_steps=1, trace_steps=2)
    assert mix["inputs"]["count"] == 8192      # the mix itself is left as it was


def _np(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


@pytest.mark.parametrize("spec", [pytest.param(traffic.load(ROOT, m)["inputs"], id=m)
                                  for m in MIXES] + [pytest.param(SEEDS, id="seeds")])
def test_replay_draws_the_same_inputs_again(spec):
    s = traffic.Stream(spec, 2 ** 31 + 977, "cpu")
    drawn = [_np(s.next()) for _ in range(5)]
    assert s.drawn == 5
    again = s.replay(2, 3)
    assert s.drawn == 5                      # the stream itself goes on as it was
    for a, b in zip(again, drawn[2:]):
        np.testing.assert_array_equal(_np(a), b)
    assert not np.array_equal(_np(s.next()), drawn[-1])


def test_window_keeps_answers_in_the_pool_and_draws_inputs_again(small_root):
    """A timed window copies each step's answers into the pool that set-up
    touched (a step beyond its rows keeps its own array), keeps no inputs,
    and judges the inputs drawn again: the same rows the steps took."""
    from nqs_bench import harness
    bench = harness.load_benchmark(small_root)
    cell = harness.Cell(small_root, bench, bench["workloads"][0]["name"], "cpu")
    cell.build()
    seed = 2 ** 31 + 7
    stream = cell.stream(seed)
    cell.warm_up(stream, 0.5)
    assert cell.pool is not None and len(cell.pool) >= 16 and not cell.pool.any()
    pool = cell.pool = cell.pool[:1]         # one row: the second step keeps its own
    t0 = time.perf_counter()
    cell.program.step(stream.next())         # a draw before the window, not replayed
    took, draw = [], stream.next
    stream.next = lambda: took.append(draw()) or took[-1]
    win = cell.window(stream, 4 * (time.perf_counter() - t0))
    assert cell.pool is None                 # the pool serves one window
    assert win.attempted == len(took) >= 1 and win.failed == 0
    for k, out in enumerate(win.outputs):
        assert np.shares_memory(out, pool) == (k == 0) and out.any()
    for a, b in zip(win.inputs(), took):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert cell.verdict(cell.judge(seed, win))
