"""The port's lattice surgery and NN decoder against the JAX reference.

  * zz_merge_split_circuit: host build, bit-identical (instructions,
    detectors, observables, zz_records, the layout) at d = 3 and 5.
  * The native exact matcher's predictions on the surgery circuit's shared
    detector rows: bit-identical.
  * run_zz_surgery: the raw and decoded rates overlap the reference's 95%
    Wilson intervals at d = 3 (the random streams differ); p = 0 is silent.
  * NNDecoder: the pair features bit-identical (the capped case included);
    with the JAX initial weights carried across by params_from_numpy and the
    same 3 batches fed to both, the loss, every gradient and every parameter
    after each Adam step within 1e-5 (float32); the learning-rate schedule
    equal to optax.cosine_decay_schedule at every step (float32 rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from noisyquantumsimulator_tpu.qec import decoders as jdec
from noisyquantumsimulator_tpu.qec import lattice_surgery as jls
from noisyquantumsimulator_tpu.qec import nn_decoder as jnn
from noisyquantumsimulator_tpu.qec.surface_code import memory_z_circuit as jmem
from noisyquantumsimulator_tpu_torch import qec as tqec
from noisyquantumsimulator_tpu_torch.qec import decoders as tdec
from noisyquantumsimulator_tpu_torch.qec import lattice_surgery as tls
from noisyquantumsimulator_tpu_torch.qec import nn_decoder as tnn
from noisyquantumsimulator_tpu_torch.qec.fast_sampler import sample_circuit_fast
from noisyquantumsimulator_tpu_torch.qec.surface_code import memory_z_circuit as tmem
from noisyquantumsimulator_tpu_torch.utils.math import wilson_ci

torch.set_num_threads(1)
CPU = "cpu"


def _same_circuit(a, b):
    assert a.n_qubits == b.n_qubits and a.n_measurements == b.n_measurements
    assert len(a.instructions) == len(b.instructions)
    for x, y in zip(a.instructions, b.instructions):
        assert x.name == y.name and x.arg == y.arg
        assert x.targets.dtype == y.targets.dtype
        assert np.array_equal(x.targets, y.targets)
        assert (x.probs is None) == (y.probs is None)
        if x.probs is not None:
            assert np.array_equal(x.probs, y.probs)
    assert len(a.detectors) == len(b.detectors)
    assert all(np.array_equal(u, v) for u, v in zip(a.detectors, b.detectors))
    assert a.observables.keys() == b.observables.keys()
    assert all(list(a.observables[k]) == list(b.observables[k])
               for k in a.observables)


@pytest.mark.parametrize("d", [3, 5])
def test_zz_merge_split_circuit_bit_identical(d):
    j, t = jls.zz_merge_split_circuit(d), tls.zz_merge_split_circuit(d)
    _same_circuit(j.circuit, t.circuit)
    assert t.zz_records == j.zz_records and t.n_records == j.n_records
    assert t.zz_lookbacks() == j.zz_lookbacks()
    assert (t.d, t.rounds_merge, t.rounds_after) == (j.d, j.rounds_merge,
                                                     j.rounds_after)
    for k in ("data", "x_anc", "z_anc"):
        assert getattr(t.layout, k) == getattr(j.layout, k)


def test_gf2_helpers_bit_identical():
    rng = np.random.default_rng(3)
    A = (rng.random((9, 14)) < 0.4).astype(np.uint8)
    b = (A @ (rng.random(14) < 0.5).astype(np.uint8)) % 2
    assert np.array_equal(tls._gf2_solve(A, b), jls._gf2_solve(A, b))
    assert tls._gf2_solve(np.zeros((2, 3), np.uint8), np.array([1, 0], np.uint8)) is None
    N = tls._gf2_nullspace(A)
    assert np.array_equal(N, jls._gf2_nullspace(A))
    assert not ((A.astype(int) @ N.T.astype(int)) % 2).any()


def test_surgery_rejects_even_distance():
    with pytest.raises(ValueError, match="odd"):
        tls.zz_merge_split_circuit(4)


@pytest.fixture(scope="module")
def surgery_d3():
    sc = tls.zz_merge_split_circuit(3, p=2e-3)
    out = sample_circuit_fast(sc.circuit, 4000, seed=5, device=CPU)
    return sc, out


def test_native_decoder_bit_identical_on_surgery_rows(surgery_d3):
    sc, out = surgery_d3
    jsc = jls.zz_merge_split_circuit(3, p=2e-3)
    dets = out["detectors"]
    assert dets.any()
    jp = jdec.decoder_for_circuit(jsc.circuit, kind="native").decode_batch(dets)
    tp = tdec.decoder_for_circuit(sc.circuit, kind="native",
                                  device=CPU).decode_batch(dets)
    assert np.array_equal(jp, tp) and tp.dtype == jp.dtype


def test_run_zz_surgery_noiseless_is_silent():
    r = tqec.run_zz_surgery(3, p=0.0, shots=500, device=CPU)
    assert r["zz_error_rate_raw"] == 0.0 and r["detector_fraction"] == 0.0
    assert r["patch1_logical_error_raw"] == r["patch2_logical_error_raw"] == 0.0
    assert "zz_error_rate_decoded" not in r


def test_run_zz_surgery_overlaps_reference_ci():
    kw = dict(p=2e-3, shots=20000, seed=1)
    j = jls.run_zz_surgery(3, **kw)
    t = tqec.run_zz_surgery(3, device=CPU, **kw)
    assert {k: v for k, v in t.items() if not isinstance(v, float)} == \
        {k: v for k, v in j.items() if not isinstance(v, float)}
    n = kw["shots"]
    for name in ("zz_error_rate", "patch1_logical_error", "patch2_logical_error"):
        for key in (name + "_raw", name + "_decoded"):
            a = wilson_ci(round(t[key] * n), n)
            b = wilson_ci(round(j[key] * n), n)
            assert a[0] <= b[1] and b[0] <= a[1], key
        assert t[name + "_decoded"] < t[name + "_raw"]


def test_run_zz_surgery_native_raises_when_unbuildable(monkeypatch):
    """No silent switch to the greedy matcher (the reference's except)."""
    from noisyquantumsimulator_tpu_torch.qec import native

    def fail():
        raise RuntimeError("compiler missing")

    monkeypatch.setattr(native, "load", fail)
    with pytest.raises(RuntimeError, match="compiler missing"):
        tqec.run_zz_surgery(3, p=1e-3, shots=64, device=CPU)


# ---- the NN decoder -----------------------------------------------------------

class _Dets:
    """A circuit stand-in: the decoder's features read only n_detectors."""
    def __init__(self, n):
        self.n_detectors = n


@pytest.mark.parametrize("n_det", [16, 400])
def test_nn_pair_features_bit_identical(n_det):
    """400 detectors make 79800 pairs: both keep np.argsort's first 2^16."""
    j = jnn.NNDecoder(_Dets(n_det), hidden=(2,))
    t = tnn.NNDecoder(_Dets(n_det), hidden=(2,), device=CPU)
    assert np.array_equal(t.pair_i.numpy(), np.asarray(j._pairs[0]))
    assert np.array_equal(t.pair_j.numpy(), np.asarray(j._pairs[1]))
    assert t.layers[0].in_features == j.params[0][0].shape[0]


def test_nn_bits_features_and_module_mode():
    c = tmem(3, 2, p=2e-3)
    t = tnn.NNDecoder(c, features="bits", device=CPU)
    assert t.layers[0].in_features == c.n_detectors
    assert t.eval() is t and not t.training
    with pytest.raises(ValueError):
        tnn.NNDecoder(c, features="triples", device=CPU)


def test_nn_module_train_only_sets_the_mode():
    """nn.Module.train() switches the mode back and trains nothing; the
    reference's training loop is fit() (run by train_nn_decoder below)."""
    t = tnn.NNDecoder(_Dets(6), hidden=(2,), device=CPU).eval()
    before = [q.detach().clone() for q in t.parameters()]
    assert t.train() is t and t.training
    assert t.train(False) is t and not t.training
    assert all(torch.equal(a, b) for a, b in zip(before, t.parameters()))
    assert t.history == []


@pytest.fixture(scope="module")
def nn_pair():
    """The JAX decoder and the port's with its initial weights."""
    jc, tc = jmem(3, 3, p=3e-3), tmem(3, 3, p=3e-3)
    j = jnn.NNDecoder(jc)
    t = tnn.NNDecoder(tc, device=CPU).params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in j.params])
    return j, t, tc


def test_nn_params_from_numpy_and_logits(nn_pair):
    j, t, tc = nn_pair
    for lin, (w, b) in zip(t.layers, j.params):
        # the reference runs float64 under the tests' x64; the port float32
        assert np.array_equal(lin.weight.detach().numpy().T, np.asarray(w, np.float32))
        assert np.array_equal(lin.bias.detach().numpy(), np.asarray(b, np.float32))
    dets = sample_circuit_fast(tc, 512, seed=2, device=CPU)["detectors"]
    x = jnp.asarray(dets, jnp.float32)
    ref = np.asarray(jnn._mlp(j.params, jnp.concatenate(
        [x, x[:, j._pairs[0]] * x[:, j._pairs[1]]], axis=-1)))
    with torch.no_grad():
        got = t(torch.as_tensor(dets)).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    assert np.array_equal(t.decode_batch(dets, chunk=100), (got > 0).astype(np.int64))
    assert np.array_equal(np.asarray(j.decode_batch(dets)), t.decode_batch(dets))


def _flat(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_nn_adam_steps_match_reference(nn_pair):
    """Three Adam steps on the same batches: loss, gradients and parameters
    after each step within 1e-5 (float32)."""
    j0, _, tc = nn_pair
    jc = j0.circuit
    j = jnn.NNDecoder(jc)
    t = tnn.NNDecoder(tc, device=CPU).params_from_numpy(
        [(np.asarray(w), np.asarray(b)) for w, b in j.params])
    steps, lr = 3, 3e-3
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps))
    state = opt.init(j.params)
    params = j.params
    topt, tsched = t.optimizer(steps, lr)
    for k in range(steps):
        out = sample_circuit_fast(tc, 256, seed=10 + k, device=CPU)
        dets, labels = out["detectors"], out["observables"][:, 0]
        loss, grads = j._loss_grad(params, jnp.asarray(dets), jnp.asarray(labels))
        updates, state = opt.update(grads, state)
        params = optax.apply_updates(params, updates)
        tloss = t.train_step(topt, tsched, torch.as_tensor(dets),
                             torch.as_tensor(labels))
        assert abs(float(tloss) - float(loss)) <= 1e-5
        tgrads = [g for lin in t.layers for g in (lin.weight.grad.T, lin.bias.grad)]
        tparams = [q for lin in t.layers for q in (lin.weight.T, lin.bias)]
        for a, b in zip(tgrads, _flat(grads)):
            assert np.abs(a.numpy() - b).max() <= 1e-5
        for a, b in zip(tparams, _flat(params)):
            assert np.abs(a.detach().numpy() - b).max() <= 1e-5


def test_nn_lr_schedule_matches_optax():
    steps, lr = 300, 3e-3
    t = tnn.NNDecoder(_Dets(6), hidden=(2,), device=CPU)
    opt, sched = t.optimizer(steps, lr)
    ref = optax.cosine_decay_schedule(lr, steps)
    got = []
    for _ in range(steps + 2):
        got.append(sched.get_last_lr()[0])
        opt.step()
        sched.step()
    want = np.array([float(ref(i)) for i in range(steps + 2)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_nn_decoder_learns_better_than_trivial():
    """The reference test's bar, on the CPU."""
    dec, ev = tnn.train_nn_decoder(d=3, p=3e-3, steps=150, seed=1, device=CPU)
    assert ev["p_logical_nn"] < 0.6 * ev["p_logical_trivial"]
    assert dec.history[-1] < dec.history[0]
    assert dec.decode_batch(np.zeros((16, dec.circuit.n_detectors), np.uint8)).shape == (16,)
