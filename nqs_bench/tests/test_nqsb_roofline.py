"""Operation and byte counts of the kernels' rooflines against hand counts,
and K2's squaring counts against the program's own scheme."""
import json
import math
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from nqs_bench import peaks, traffic
from nqs_bench.roofline import k1, k2, step


def test_k1_counts_by_hand():
    # B=2 schedules, S=3 states, n=4 coordinates (D=2, P=1), 5 segments:
    # 5 x (2 x 16) x 6 rows = 960; bytes 4 x (16 + 1 + 10 + 2 x 24) = 300
    assert k1.flops(2, 3, 4, 5) == 960.0
    assert k1.nbytes(2, 3, 4, 1, 5) == 300.0


def test_k1_at_the_sweep_sizes():
    # dim 3: 300 x 2 x 81^2 x 5 x 32768 = 6.45e11 operations, 1.30 ms at 495 TFLOP/s
    f = k1.flops(32768, 5, 81, 300)
    assert f == pytest.approx(6.449725e11, rel=1e-6)
    assert peaks.bound_s(f, k1.nbytes(32768, 5, 81, 36, 300)) == pytest.approx(
        f / 495e12)


def test_k2_counts_by_hand():
    assert list(k2.squarings([1.0, 1.8, 1.9, 7.2, 7.3])) == [0, 0, 1, 2, 3]
    assert k2.flops(np.array([1, 2]), 3) == 3 * 2 * 27
    assert k2.nbytes(2, 3, 4) == 2 * 2 * 9 * 4 + 8


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(495e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 0.0, bits=64) == pytest.approx(1.0)


@pytest.mark.parametrize("D", [2, 3])
def test_hermitian_basis_is_unitary_and_real_on_hermitian_maps(D):
    W = k2.hermitian_basis(D)
    np.testing.assert_allclose(W @ W.conj().T, np.eye(D * D), atol=1e-14)
    rho = np.random.default_rng(0).standard_normal((D, D)) * (1 + 1j)
    rho = rho + rho.conj().T
    assert np.abs((W @ rho.reshape(-1)).imag).max() < 1e-14


def test_k2_squarings_equal_the_programs():
    """The counts from the members' generators equal those the program's
    expm takes for the same population (its real core, on the CPU)."""
    from noisyquantumsimulator_tpu_torch.ops import expm as pexpm
    from noisyquantumsimulator_tpu_torch.optimize import engine
    from noisyquantumsimulator_tpu_torch.optimize.apparatus import ApparatusConstraints
    with open(os.path.join(ROOT, "nqs_bench", "configs", "rb87-smoothjp-3level.json")) as f:
        config = json.load(f)
    spec = dict(traffic.load(ROOT, "population-8192")["inputs"], count=64)
    x = traffic.Stream(spec, 4, "cpu").next()
    s = k2.population_squarings(config, x)
    app = ApparatusConstraints()
    pr = engine.build_fixed_problem(app, app.make_full_noise(), device="cpu",
                                    dtype=torch.complex128)
    p = torch.as_tensor(x)
    _, dt, det = engine.smooth_jp_uniform_from_params(p, pr)
    R = [torch.as_tensor(getattr(pr, f)) for f in ("R_L0", "R_Cd", "R_drive")]
    A = (R[0] + det[:, None, None] * R[1] + R[2]) * dt[:, None, None]
    theirs = pexpm._needed_squarings(A, pexpm._THETA16).numpy()
    np.testing.assert_array_equal(s, theirs)
    assert s.min() >= 1


def test_step_flops_cover_the_scan():
    with open(os.path.join(ROOT, "nqs_bench", "configs", "rb87-smoothjp-3level.json")) as f:
        config = json.load(f)
    sweep = traffic.load(ROOT, "sweep-32768")
    assert step.flops("sweep", config, sweep) == k1.flops(32768, 5, 81, 300)
    pop = traffic.load(ROOT, "population-8192")
    assert step.flops("population", config, pop, 10.0) == (
        k1.flops(8192, 5, 81, 300) + 8192 * 6 * 2 * 81 ** 3 + 10.0)
    assert step.flops("other", config, pop) is None


def test_step_mfu_reads_the_unprofiled_steps():
    from types import SimpleNamespace
    from nqs_bench import harness
    with open(os.path.join(ROOT, "nqs_bench", "configs", "rb87-smoothjp-3level.json")) as f:
        config = json.load(f)
    mix = traffic.load(ROOT, "sweep-32768")
    # steps 2-3 traced and slowed by the profiler; the others take 20 ms
    ctx = SimpleNamespace(config=config, traffic=mix,
                          durations=[0.02, 0.02, 0.5, 0.5, 0.02, 0.02],
                          trace={"first": 2, "steps": 2, "inputs": [None, None]})
    mfu = harness.metric_reader(ROOT, "step_mfu").read(ctx)
    f = step.flops("sweep", config, mix)
    assert mfu == pytest.approx(100.0 * f / peaks.FLOPS_32 / 0.02)
    untraced = SimpleNamespace(**dict(vars(ctx), trace=None))
    assert harness.metric_reader(ROOT, "step_mfu").read(untraced) is None
