"""Kernel K3's plain twin and the port's BP decoders against the JAX
reference.

Tolerances: the c2v twin against the Pallas kernel (interpret mode) is
bit-equal at float32 and bfloat16 (every factor but one is +-1 or a
storage-type value, so the one product rounds alike). The BP decoders run
at float32 on both sides and differ only in the order of the variable-side
sums, so hard decisions agree on >= 99.9% of entries and beliefs within
1e-3, the bounds of the reference's own slot-vs-one-hot test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noisyquantumsimulator_tpu.qec import ldpc as jl
from noisyquantumsimulator_tpu.qec.bp_kernels import c2v_pallas
from noisyquantumsimulator_tpu.qec.dem_decoder import DemBPDecoder as JDec
from noisyquantumsimulator_tpu.qec.fast_sampler import build_fast_sampler
from noisyquantumsimulator_tpu_torch.qec import bp_cuda
from noisyquantumsimulator_tpu_torch.qec import ldpc as tl

torch.set_num_threads(1)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(scope="module")
def bb():
    """The small BB circuit (rounds 2, p = 3e-3), a JAX decoder on its DEM,
    its slot tables and 256 shots of detectors."""
    Hx, Hz = jl.small_bb_code()
    c = jl.bb_memory_circuit(Hx, Hz, 2, 3e-3)
    dets = np.asarray(build_fast_sampler(c, 256)(jax.random.PRNGKey(11))
                      ["detectors"], np.float32)
    dec = JDec(c, n_iters=20, kernel="slots", fast_impl="xla")
    chk, var = np.nonzero(dec.H)
    tables = jl.build_slot_tables(chk.astype(np.int64), var.astype(np.int64),
                                  dec.n_det, dec.n_mech)
    llr = np.log((1.0 - dec.probs) / dec.probs).astype(np.float32)
    return dict(dec=dec, dets=dets, tables=tables, chk=chk, var=var, llr=llr)


def _c2v_inputs(w, n_chk, S, seed=7):
    """Messages with a padding slab, forced ties and exact zeros."""
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(w, n_chk, S)).astype(np.float32)
    m[3] = 1e30                          # a padding slab
    m[1, :, :8] = m[0, :, :8]            # ties between slots 0 and 1
    m[2, :, 8:12] = 0.0                  # exact zeros
    m[4, :, 12:16] = -m[0, :, 12:16]     # equal magnitudes, opposite signs
    sgn_syn = np.sign(rng.normal(size=(n_chk, S))).astype(np.float32)
    return m, sgn_syn


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_c2v_twin_matches_pallas_interpret(dt):
    m, sgn_syn = _c2v_inputs(5, 16, 128)
    ref = c2v_pallas(jnp.asarray(m).astype(JAX_DT[dt]),
                     jnp.asarray(sgn_syn).astype(JAX_DT[dt]), 0.75,
                     interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    t = TORCH_DT[dt]
    got = bp_cuda.c2v(torch.from_numpy(m).to(t), torch.from_numpy(sgn_syn).to(t),
                      0.75)
    assert got.dtype == t and got.shape == (5, 16, 128)
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_c2v_tie_rule_and_padding():
    """Unique minimum sees min2, tied minima see min1, padding never wins
    and carries sign +1; the syndrome sign flips every output."""
    m = torch.tensor([[[1.0], [2.0]], [[-3.0], [2.0]], [[1e30], [-5.0]]])
    sgn = torch.tensor([[1.0], [-1.0]])
    out = bp_cuda.c2v(m, sgn, 0.5)[:, :, 0]
    # check 0: slots (1, -3, pad): unique min 1 -> sees 3; others see 1
    assert out[:, 0].tolist() == [-1.5, 0.5, -0.5]
    # check 1: slots (2, 2, -5) tie at 2 -> all see 2; prod = -1 * syn -1
    assert out[:, 1].tolist() == [1.0, 1.0, -1.0]


def test_c2v_rejects_bad_operands():
    m = torch.zeros((3, 4, 5))
    with pytest.raises(ValueError):
        bp_cuda.c2v(m[0], torch.ones(4, 5), 0.75)
    with pytest.raises(ValueError):
        bp_cuda.c2v(m, torch.ones(4, 6), 0.75)
    with pytest.raises(TypeError):
        bp_cuda.c2v(m, torch.ones(4, 5, dtype=torch.bfloat16), 0.75)
    with pytest.raises(ValueError):
        bp_cuda.c2v(m.to("meta"), torch.ones(4, 5, device="meta"), 0.75)


@pytest.mark.parametrize("damping", [0.0, 0.5])
def test_bp_slots_matches_reference_f32(bb, damping):
    kw = dict(n_chk=bb["dec"].n_det, n_var=bb["dec"].n_mech, n_iters=20,
              scale=0.75, damping=damping)
    h0, b0 = jl._bp_slots(jnp.asarray(bb["dets"]), bb["dec"]._llr,
                          bb["tables"], **kw)
    h1, b1 = tl._bp_slots(torch.from_numpy(bb["dets"]),
                          torch.from_numpy(bb["llr"]), bb["tables"], **kw)
    assert h1.dtype == torch.uint8 and b1.dtype == torch.float32
    assert (np.asarray(h0) == h1.numpy()).mean() >= 0.999
    assert np.abs(np.asarray(b0) - b1.numpy()).max() < 1e-3


def test_bp_slots_device_tables_equal_numpy_tables(bb):
    """Tables converted once with slot_tables_on give the same result as
    the numpy tables converted per call."""
    kw = dict(n_chk=bb["dec"].n_det, n_var=bb["dec"].n_mech, n_iters=5,
              scale=0.75)
    syn, llr = torch.from_numpy(bb["dets"][:64]), torch.from_numpy(bb["llr"])
    h0, b0 = tl._bp_slots(syn, llr, bb["tables"], **kw)
    h1, b1 = tl._bp_slots(syn, llr, tl.slot_tables_on(bb["tables"], "cpu"), **kw)
    assert torch.equal(h0, h1) and torch.equal(b0, b1)


def test_bp_slots_refuses_tables_on_another_device(bb):
    tables = tl.slot_tables_on(bb["tables"], "meta")
    with pytest.raises(ValueError):
        tl._bp_slots(torch.from_numpy(bb["dets"][:4]), torch.from_numpy(bb["llr"]),
                     tables, bb["dec"].n_det, bb["dec"].n_mech, 1, 0.75)


def test_bp_edges_matches_reference_f32(bb):
    d = bb["dec"]
    h0, b0 = jl._bp_edges(jnp.asarray(bb["dets"]), d._chk, d._var, d._llr,
                          d.n_det, d.n_mech, 20, 0.75)
    h1, b1 = tl._bp_edges(torch.from_numpy(bb["dets"]),
                          torch.from_numpy(bb["chk"].astype(np.int64)),
                          torch.from_numpy(bb["var"].astype(np.int64)),
                          torch.from_numpy(bb["llr"]), d.n_det, d.n_mech, 20,
                          0.75)
    assert (np.asarray(h0) == h1.numpy()).mean() >= 0.999
    assert np.abs(np.asarray(b0) - b1.numpy()).max() < 1e-3


def test_bp_slots_matches_bp_edges(bb):
    """The port's two layouts share the message schedule and tie rule."""
    d = bb["dec"]
    syn, llr = torch.from_numpy(bb["dets"]), torch.from_numpy(bb["llr"])
    h0, b0 = tl._bp_edges(syn, torch.from_numpy(bb["chk"].astype(np.int64)),
                          torch.from_numpy(bb["var"].astype(np.int64)), llr,
                          d.n_det, d.n_mech, 20, 0.75)
    h1, b1 = tl._bp_slots(syn, llr, bb["tables"], d.n_det, d.n_mech, 20, 0.75)
    assert (h0 == h1).float().mean() >= 0.999
    assert (b0 - b1).abs().max() < 1e-3


def test_dense_bp_decoder_matches_reference():
    """Code-capacity BPDecoder (dense (S, m, n) messages) on the small BB
    code's Hz, same host syndromes, 15 iterations. Under x64 the reference
    carries the prior as a float64 scalar, the port runs float32: beliefs
    agree to 1e-6 relative to their largest magnitude."""
    Hx, Hz = jl.small_bb_code()
    rng = np.random.default_rng(5)
    err = (rng.random((128, Hz.shape[1])) < 0.02).astype(np.uint8)
    syn = (err @ Hz.T) % 2
    e0, b0 = jl.BPDecoder(Hz, error_prob=0.02, n_iters=15)._decode_with_beliefs(syn)
    e1, b1 = tl.BPDecoder(Hz, error_prob=0.02, n_iters=15,
                          device="cpu")._decode_with_beliefs(syn)
    assert (e0 == e1).mean() >= 0.999
    assert np.abs(b0 - b1).max() <= 1e-6 * np.abs(b0).max()


def test_run_bb_memory_matches_reference():
    """Same host error samples and BP+OSD decode: identical syndromes, and
    failure and convergence rates within 0.01 (the BP beliefs differ in the
    last bits, which can flip a hard decision or an OSD column order)."""
    kw = dict(p=0.03, shots=200, seed=3, n_iters=20)
    r0 = jl.run_bb_memory(**kw)
    r1 = tl.run_bb_memory(**kw, device="cpu")
    assert (r1.n, r1.k) == (r0.n, r0.k) == (72, 12)
    assert r1.syndrome_weight_mean == r0.syndrome_weight_mean
    assert abs(r1.p_logical_shot - r0.p_logical_shot) <= 0.01
    assert abs(r1.decoder_converged_frac - r0.decoder_converged_frac) <= 0.01
