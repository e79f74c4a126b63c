"""The port's gradient paths against the JAX reference, on the CPU.

  * K2 as a torch.autograd.Function (`ops/expm_cuda._MaskedSquaringFn`) and
    the expm above it: torch.autograd.gradcheck at float64 and complex128,
    and the expm's gradient against jax.grad of the reference's expm
    (1e-10 relative). On the CPU the Function runs the plain twin forward
    and recomputes its trips with the twin; the card runs the same backward
    with K2 (tests/test_torch_cuda.py).
  * `make_value_and_grad` against the reference's at x64 (both packages on
    the same operands, `problem_from_numpy`): the cost 1e-9 relative, the
    gradient 1e-7 in relative norm, for every protocol.
  * GRAPE's Adam against optax.adam on one gradient sequence (1e-12), the
    gradient polish, and a short GRAPE run as the reference's test runs it.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noisyquantumsimulator_tpu.ops import expm as jexpm
from noisyquantumsimulator_tpu.optimize import apparatus as japp
from noisyquantumsimulator_tpu.optimize import engine as jeng
from noisyquantumsimulator_tpu_torch.ops.expm import expm
from noisyquantumsimulator_tpu_torch.ops.expm_cuda import (
    _masked_squaring_plain, fused_masked_squaring)
from noisyquantumsimulator_tpu_torch.optimize import engine as teng
from noisyquantumsimulator_tpu_torch.optimize import forward as tfwd

torch.set_num_threads(1)


def _operand(dtype, B=2, N=9, scale=0.8, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, N, N))
    if dtype.is_complex:
        A = A + 1j * rng.standard_normal((B, N, N))
    # batch members of different norms, so their squaring counts differ
    A = A * scale * np.geomspace(1.0, 8.0, B)[:, None, None]
    return torch.as_tensor(A).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_masked_squaring_gradcheck(dtype):
    R = (torch.eye(9, dtype=dtype) + 0.1 * _operand(dtype, scale=1.0)
         ).requires_grad_(True)
    s = torch.tensor([1, 4], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda R: fused_masked_squaring(R, s, 4), (R,))
    # the same gradient as autograd through the twin's own loop
    G = _operand(dtype, seed=1)
    got, = torch.autograd.grad(
        (fused_masked_squaring(R, s, 4) * G).real.sum(), R)
    ref, = torch.autograd.grad(
        (_masked_squaring_plain(R, s, 4) * G).real.sum(), R)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_expm_gradcheck(dtype):
    A = _operand(dtype, scale=0.3).requires_grad_(True)
    s = torch.ceil(torch.log2(A.detach().abs().sum(-2).amax(-1) / 5.37))
    assert s[0] < s[1] <= 4                   # mixed squaring counts
    assert torch.autograd.gradcheck(lambda A: expm(A, max_squarings=4), (A,),
                                    fast_mode=True)


def test_no_graph_without_grad():
    """Under no_grad, or with no input that requires grad, the chain is the
    plain dispatch: nothing is recorded."""
    R = _operand(torch.complex128, scale=0.05) + torch.eye(9)
    s = torch.tensor([2, 3], dtype=torch.int32)
    assert fused_masked_squaring(R, s, 4).grad_fn is None
    with torch.no_grad():
        assert fused_masked_squaring(R.requires_grad_(True), s, 4).grad_fn is None
    assert fused_masked_squaring(R, s, 4).grad_fn is not None


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_expm_grad_matches_jax(dtype):
    A = _operand(dtype, B=3, seed=2)
    W = _operand(dtype, B=3, seed=3)
    An, Wn = A.numpy(), W.numpy()

    def jloss(a):
        return jnp.sum(jnp.real(jexpm.expm(a) * Wn))
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(An)))
    if dtype.is_complex:
        ref = ref.conj()          # JAX's gradient of a real loss is the conjugate
    Ag = A.clone().requires_grad_(True)
    got, = torch.autograd.grad((expm(Ag) * W).real.sum(), Ag)
    assert np.abs(got.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()


@pytest.fixture(scope="module")
def jax_problem():
    app = japp.ApparatusConstraints()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return jeng.build_fixed_problem(app, app.make_full_noise())


@pytest.fixture(scope="module")
def torch_problem(jax_problem):
    return teng.problem_from_numpy(vars(jax_problem), device="cpu",
                                   dtype=torch.complex128)


def _grape_case(jax_problem):
    _, xs = tfwd.get_smooth_jp_bounds_and_x0()
    ph, _, _ = jeng.smooth_jp_uniform_from_params(jnp.asarray(xs), jax_problem,
                                                  n_steps=48)
    return np.asarray(ph), dict(omega_tau=float(xs[0]),
                                delta_over_omega=float(xs[4]))


VG_CASES = {
    "lp": lambda p: (tfwd.get_lp_bounds_and_x0()[1], {}),
    "smooth_jp": lambda p: (tfwd.get_smooth_jp_bounds_and_x0()[1],
                            {"n_steps": 48}),
    "jp_bangbang": lambda p: (tfwd.get_jp_bangbang_bounds_and_x0(5)[1],
                              {"n_segments": 5}),
    "grape": _grape_case,
}


@pytest.mark.parametrize("protocol", list(VG_CASES))
def test_value_and_grad_matches_reference_x64(jax_problem, torch_problem,
                                              protocol):
    """At x0 (bang-bang: distinct switching fractions, so no clip or sort
    tie splits the gradient differently in the two packages)."""
    x, kw = VG_CASES[protocol](jax_problem)
    jc, jg = jeng.make_value_and_grad(jax_problem, protocol, **kw)(x)
    jc, jg = float(jc), np.asarray(jg)
    params = torch.tensor(x)
    tc, tg = teng.make_value_and_grad(torch_problem, protocol, **kw)(params)
    assert tc.ndim == 0 and tc.grad_fn is None
    assert tg.shape == (len(x),) and tg.dtype == torch.float64
    assert params.grad is None and not params.requires_grad
    assert abs(float(tc) - jc) <= 1e-9 * abs(jc)
    assert np.linalg.norm(tg.numpy() - jg) <= 1e-7 * np.linalg.norm(jg)


def test_population_objective_records_no_graph(torch_problem):
    """The population objective stays under no_grad even when its
    parameters require grad: no graph, nothing left on the parameters."""
    x = torch.tensor(tfwd.get_smooth_jp_bounds_and_x0()[1], requires_grad=True)
    cost, metrics = teng.make_population_objective(
        torch_problem, "smooth_jp", n_steps=48)(torch.stack([x, x]))
    assert cost.shape == (2,) and cost.grad_fn is None
    assert not cost.requires_grad and x.grad is None
    assert all(v.grad_fn is None for v in metrics.values())


def test_value_and_grad_real_core_matches_per_segment(torch_problem):
    """The real phase-frame core's gradient against the complex per-segment
    path's (the generator dropped), as their values are pinned."""
    x = tfwd.get_smooth_jp_bounds_and_x0()[1]
    kw = {"n_steps": 48}
    cf, gf = teng.make_value_and_grad(torch_problem, "smooth_jp", **kw)(x)
    cs, gs = teng.make_value_and_grad(
        dataclasses.replace(torch_problem, g=None), "smooth_jp", **kw)(x)
    assert abs(float(cf) - float(cs)) <= 1e-7 * abs(float(cs))
    assert float(torch.linalg.norm(gf - gs)) <= 1e-7 * float(torch.linalg.norm(gs))


def test_grape_adam_matches_optax():
    rng = np.random.default_rng(11)
    grads = rng.standard_normal((10, 48))
    x0 = rng.standard_normal(48)
    opt = optax.adam(2e-3)
    xj = jnp.asarray(x0)
    state = opt.init(xj)
    ph = torch.tensor(x0, requires_grad=True)
    adam = tfwd.grape_adam(ph, 2e-3)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        xj = optax.apply_updates(xj, upd)
        ph.grad = torch.as_tensor(g)
        adam.step()
    assert np.abs(ph.detach().numpy() - np.asarray(xj)).max() <= 1e-12


def test_gradient_polish_no_worse_than_de():
    kw = dict(maxiter=2, popsize=4, device="cpu", dtype=torch.complex128)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        de = tfwd.optimize_cz_gate("smooth_jp", grad_polish=False, **kw)
        pol = tfwd.optimize_cz_gate("smooth_jp", polish_steps=5, **kw)
    assert pol.best_cost <= de.best_cost
    assert pol.history[:len(de.history)] == de.history
    assert de.n_evaluations < pol.n_evaluations <= de.n_evaluations + 5
    if pol.best_cost < de.best_cost:       # a kept step is recorded
        assert pol.history[-1] == pol.best_cost
    assert all(lo <= v <= hi for (lo, hi), v in
               zip(tfwd.get_smooth_jp_bounds_and_x0()[0], pol.best_params))


def test_optimize_cz_gate_grape_protocol():
    """The reference's test_optimize_cz_gate_grape_protocol: 48 phases,
    15 Adam steps."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        r = tfwd.optimize_cz_gate("grape", grape_steps=15, grape_n_steps=48,
                                  device="cpu", dtype=torch.complex128)
    assert r.protocol == "grape"
    assert len(r.best_params) == 48 and len(r.param_names) == 48
    assert r.best_metrics["avg_fidelity"] > 0.95
    assert len(r.history) == 2                 # steps 0 and 14
    assert r.history[-1] <= r.history[0]
    with pytest.raises(ValueError):
        tfwd.optimize_cz_gate("grape", bounds=[(0, 1)], device="cpu")
