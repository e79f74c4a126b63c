"""Kernel K3's plain twin, the variable-side twin and the port's BP
decoders against the JAX reference.

Tolerances: the c2v twin against the Pallas kernel (interpret mode) is
bit-equal at float32 and bfloat16 (every factor but one is +-1 or a
storage-type value, so the one product rounds alike). The BP decoders run
at float32 on both sides and differ only in the order of the variable-side
sums, so hard decisions agree on >= 99.9% of entries and beliefs within
1e-3, the bounds of the reference's own slot-vs-one-hot test. The
variable-side twin (`bp_cuda._v2c_plain`) is bit-equal to the torch ops it
took over and to the kernel's arithmetic written out (a float32 sum in slot
order, each later operation rounded once to the storage dtype).
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


def _inline_v2c(msg_cv, llr_var, tables, msg_vc, damping):
    """The variable side of `_bp_slots` as it was written inline before it
    moved into `bp_cuda._v2c_plain`: (new messages, beliefs)."""
    Ec, S = msg_cv.shape
    n_var, d_max = llr_var.shape[0], tables["d_max"]
    pad_c = tables["pad_c"][:, None]
    zero_row = torch.zeros((1, S), dtype=msg_cv.dtype)
    mc = torch.cat([msg_cv, zero_row], dim=0)
    gathered = mc.index_select(0, tables["cpos_of_vslot"]).view(n_var, d_max, S)
    total = llr_var[:, None] + gathered.sum(dim=1)
    back = total.index_select(0, tables["var_of_cpos"]) - msg_cv
    new_vc = torch.where(pad_c, bp_cuda.BIG, back)
    if damping:
        new_vc = (1.0 - damping) * new_vc + damping * msg_vc
    return new_vc, total


def _kernel_v2c(msg_cv, llr_var, tables, msg_vc, damping):
    """`csrc/bp_v2c.cu`'s arithmetic written out in float32: the sum in
    slot order over each variable's edges, every later operation rounded
    once to the storage dtype. (new messages, beliefs)."""
    dt = msg_cv.dtype
    r = lambda x: x.to(dt).float()                           # noqa: E731
    Ec, S = msg_cv.shape
    n_var, d = llr_var.shape[0], tables["d_max"]
    cpos = tables["cpos_of_vslot"].view(n_var, d)
    m = msg_cv.float()
    acc = torch.zeros((n_var, S))
    for j in range(d):
        live = cpos[:, j] < Ec
        acc[live] = acc[live] + m[cpos[live, j]]
    total = r(llr_var.float()[:, None] + r(acc))
    out = msg_vc.float().clone()
    for j in range(d):
        live = cpos[:, j] < Ec
        p = cpos[live, j]
        new = r(total[live] - m[p])
        if damping:
            new = r(r(np.float32(1.0 - damping) * new) + r(np.float32(damping) * out[p]))
        out[p] = new
    return out.to(dt), total.to(dt)


def _v2c_operands(tables, S, dt, seed=3, dyadic=False):
    """K3-like messages (NaN in the check layout's padding slots, which no
    one may read), previous messages (+big in the padding) and priors.
    dyadic: the messages on the grid 1/16, where float32 sums of a few of
    them are exact in any order."""
    g = torch.Generator().manual_seed(seed)
    Ec, pad = tables["Ec"], tables["pad_c"]
    n_var = tables["cpos_of_vslot"].numel() // tables["d_max"]
    msg_cv = 4 * torch.randn((Ec, S), generator=g)
    if dyadic:
        msg_cv = torch.round(16 * msg_cv) / 16
    msg_cv[pad] = float("nan")
    msg_cv[::5, ::7] = 0.0
    msg_vc = 4 * torch.randn((Ec, S), generator=g)
    msg_vc[pad] = bp_cuda.BIG
    llr = 2 + 6 * torch.rand(n_var, generator=g)
    return msg_cv.to(dt), llr.to(dt), msg_vc.to(dt)


def _random_tables(n_chk=40, n_var=90, seed=4):
    """Slot tables of a random Tanner graph with variable degrees 1 to 7,
    some 8 (the kernel's wider degree tier), and every check used."""
    rng = np.random.default_rng(seed)
    chk, var = [], []
    for v in range(n_var):
        for c in rng.choice(n_chk, rng.integers(1, 8), replace=False):
            chk.append(c)
            var.append(v)
    chk = np.concatenate([chk, np.arange(n_chk)])
    var = np.concatenate([var, rng.integers(0, n_var, n_chk)])
    return tl.build_slot_tables(chk.astype(np.int64), var.astype(np.int64),
                                n_chk, n_var)


@pytest.mark.parametrize("graph", ["bb", "random"])
@pytest.mark.parametrize("damping", [0.0, 0.5, 0.3])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_v2c_twin_reproduces_the_inline_code_and_the_kernel_arithmetic(
        bb, graph, damping, dt):
    """On the small BB DEM (degrees 2 and 3) with generic messages, and on
    a random graph of degrees up to 8 (the kernel's wider tier) with
    messages on a dyadic grid: torch sums more than 3 float32 terms on the
    CPU in another order than the kernel's slot order, so only there the
    sums are made exact."""
    tables = tl.slot_tables_on(bb["tables"] if graph == "bb" else _random_tables(),
                               "cpu")
    msg_cv, llr, msg_vc = _v2c_operands(tables, 37, TORCH_DT[dt],
                                        dyadic=graph == "random")
    new0, total0 = _inline_v2c(msg_cv, llr, tables, msg_vc, damping)
    new1, total1 = _kernel_v2c(msg_cv, llr, tables, msg_vc, damping)
    beliefs = bp_cuda.v2c(msg_cv, llr, tables)
    vc = msg_vc.clone()
    got = bp_cuda.v2c(msg_cv, llr, tables, vc, damping)
    assert got is vc and got.dtype == TORCH_DT[dt]
    assert beliefs.shape == (llr.shape[0], 37) and beliefs.dtype == TORCH_DT[dt]
    assert torch.equal(beliefs, total0) and torch.equal(beliefs, total1)
    live = ~tables["pad_c"]
    assert torch.equal(got[live], new1[live])
    if damping in (0.0, 0.5):
        # the inline blend keeps the padding at exactly +big (and the kernel
        # never writes it) where (1 - g) * big + g * big rounds back to big
        assert torch.equal(got, new0)
        assert torch.equal(got[~live], msg_vc[~live])
    else:
        assert torch.equal(got[live], new0[live])


def test_bp_slots_takes_v2c_each_iteration_and_the_beliefs_pass(bb, monkeypatch):
    calls = []
    real = bp_cuda.v2c

    def spy(msg_cv, llr_var, tables, msg_vc=None, damping=0.0):
        calls.append((msg_vc is None, damping))
        return real(msg_cv, llr_var, tables, msg_vc, damping)

    monkeypatch.setattr(bp_cuda, "v2c", spy)
    tl._bp_slots(torch.from_numpy(bb["dets"][:8]), torch.from_numpy(bb["llr"]),
                 bb["tables"], bb["dec"].n_det, bb["dec"].n_mech, 4, 0.75,
                 dtype=torch.bfloat16, damping=0.5)
    assert calls == [(False, 0.5)] * 4 + [(True, 0.0)]


def test_v2c_rejects_bad_operands(bb):
    tables = tl.slot_tables_on(bb["tables"], "cpu")
    msg_cv, llr, msg_vc = _v2c_operands(tables, 8, torch.float32)
    with pytest.raises(ValueError):                     # not (Ec, S)
        bp_cuda.v2c(msg_cv[:-1], llr, tables, msg_vc)
    with pytest.raises(ValueError):                     # priors of another graph
        bp_cuda.v2c(msg_cv, llr[:-1], tables, msg_vc)
    with pytest.raises(TypeError):                      # mixed dtypes
        bp_cuda.v2c(msg_cv, llr.to(torch.bfloat16), tables, msg_vc)
    with pytest.raises(TypeError):
        bp_cuda.v2c(msg_cv, llr, tables, msg_vc.to(torch.bfloat16))
    with pytest.raises(ValueError):
        bp_cuda.v2c(msg_cv, llr, tables, msg_vc[:, :4])
    with pytest.raises(ValueError):                     # damping needs messages
        bp_cuda.v2c(msg_cv, llr, tables, None, 0.5)
    with pytest.raises(ValueError):                     # d_max above the limit
        bp_cuda.v2c(msg_cv, llr, dict(tables, d_max=bp_cuda.MAX_DEGREE + 1), msg_vc)
    with pytest.raises(ValueError):                     # tables elsewhere
        bp_cuda.v2c(msg_cv, llr, tl.slot_tables_on(bb["tables"], "meta"), msg_vc)
    meta = tl.slot_tables_on(bb["tables"], "meta")
    before = bp_cuda.v2c.launches
    with pytest.raises(ValueError):                     # no kernel, no twin there
        bp_cuda.v2c(msg_cv.to("meta"), llr.to("meta"), meta, msg_vc.to("meta"))
    assert bp_cuda.v2c.launches == before
