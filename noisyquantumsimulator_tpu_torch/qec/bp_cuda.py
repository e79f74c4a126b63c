"""The two half-iterations of slot-layout min-sum BP as CUDA kernels, with
their twins: the check-to-variable update (kernel K3, `c2v`) and the
variable-to-check update with the beliefs (`v2c`).

Counterpart of the reference's `qec/bp_kernels.py` (`c2v_pallas`). Contract
of the slab form of `ldpc._bp_slots`'s check-node update: msg3
(w_max, n_chk, S), slot-major with shots last; sgn_syn (n_chk, S) in
{+1, -1}; returns the extrinsics (w_max, n_chk, S) in msg3's dtype. An edge
that holds the unique minimum of its check sees min2, tied minima all see
min1; padding slots carry +1e30 and never win the minimum.

`v2c` (`csrc/bp_v2c.cu`) has no Pallas counterpart: the reference leaves
the variable side of `_bp_slots` to XLA. It reads K3's messages at each
variable's edges, sums them with the prior into the variable's belief and
writes each edge's new message in place, or with `msg_vc` None returns the
beliefs.

Both dispatch on the tensor's device: a CUDA tensor runs the hand-written
kernel (`csrc/bp_c2v.cu`, `csrc/bp_v2c.cu`), a CPU tensor runs the plain
twin (`_c2v_plain`, `_v2c_plain`). Any other device, dtype, layout or a
width above the kernel's register budget raises; nothing falls back from a
kernel to its twin. Each counts its kernel launches (`.launches`).
"""
from __future__ import annotations

import torch

from .. import _kernels

_ENTRY = {torch.float32: "nqs_bp_c2v_f32",
          torch.bfloat16: "nqs_bp_c2v_bf16"}
_V2C_ENTRY = {torch.float32: "nqs_bp_v2c_f32",
              torch.bfloat16: "nqs_bp_v2c_bf16"}
MAX_SLOTS = 32          # kMaxSlots in csrc/bp_c2v.cu
MAX_DEGREE = 16         # kMaxDegree in csrc/bp_v2c.cu
BIG = 1e30              # padding-slot sentinel, held in the storage dtype


def _c2v_plain(msg3: torch.Tensor, sgn_syn: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Plain PyTorch twin: the slab form of the reference's XLA c2v
    (`ldpc._bp_slots`), op for op, in the storage dtype."""
    sgn = 1 - 2 * (msg3 < 0).to(msg3.dtype)            # padding (+big) -> +1
    mag = msg3.abs()
    m1 = mag.amin(dim=0)                                # (n_chk, S)
    is1 = mag == m1[None]
    cnt = is1.sum(dim=0, dtype=torch.int32)
    m2 = torch.where(is1, BIG, mag).amin(dim=0)
    prod = sgn.prod(dim=0) * sgn_syn                    # (n_chk, S)
    ext_min = torch.where(is1 & (cnt == 1)[None], m2[None], m1[None])
    ext_sgn = prod[None] * sgn
    return scale * ext_sgn * ext_min


def c2v(msg3: torch.Tensor, sgn_syn: torch.Tensor, scale: float) -> torch.Tensor:
    """msg3 (w_max, n_chk, S), sgn_syn (n_chk, S), both float32 or both
    bfloat16 -> extrinsics (w_max, n_chk, S).

    CUDA tensors: kernel K3, one launch per call (counted in
    `c2v.launches`). CPU tensors: the plain twin."""
    if msg3.ndim != 3:
        raise ValueError(f"msg3 must be (w_max, n_chk, S), got {tuple(msg3.shape)}")
    w, n_chk, S = msg3.shape
    if sgn_syn.shape != (n_chk, S):
        raise ValueError(f"sgn_syn must be ({n_chk}, {S}), got "
                         f"{tuple(sgn_syn.shape)}")
    if sgn_syn.dtype != msg3.dtype:
        raise TypeError(f"sgn_syn dtype {sgn_syn.dtype} != msg3 dtype {msg3.dtype}")
    if msg3.device.type == "cpu":
        return _c2v_plain(msg3, sgn_syn, scale)
    if msg3.device.type != "cuda":
        raise ValueError(f"c2v: unsupported device {msg3.device}")
    if msg3.dtype not in _ENTRY:
        raise TypeError(f"c2v: unsupported dtype {msg3.dtype}")
    if sgn_syn.device != msg3.device:
        raise ValueError("msg3 and sgn_syn must be on the same device")
    if not (msg3.is_contiguous() and sgn_syn.is_contiguous()):
        raise ValueError("c2v: msg3 and sgn_syn must be contiguous")
    if not 1 <= w <= MAX_SLOTS:
        raise ValueError(f"c2v: w_max = {w} outside the kernel's 1..{MAX_SLOTS}")
    out = torch.empty_like(msg3)
    if msg3.numel() == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(msg3.device):
        rc = getattr(lib, _ENTRY[msg3.dtype])(
            _kernels.ptr(msg3), _kernels.ptr(sgn_syn), _kernels.ptr(out),
            w, n_chk, S, float(scale), _kernels.stream_handle(msg3.device))
        _kernels.check(lib, rc, "min-sum c2v kernel")
    c2v.launches += 1
    return out


c2v.launches = 0


def _v2c_plain(msg_cv: torch.Tensor, llr_var: torch.Tensor, tables: dict,
               msg_vc: torch.Tensor | None = None,
               damping: float = 0.0) -> torch.Tensor:
    """Plain PyTorch twin of `v2c`: the variable side of `ldpc._bp_slots`
    as torch ops, in the storage dtype. Updates `msg_vc` in place and
    returns it; with `msg_vc` None returns the beliefs (n_var, S)."""
    S = msg_cv.shape[1]
    n_var, d_max = llr_var.shape[0], tables["d_max"]
    # append the sentinel slot (value 0) for var-layout padding
    mc = torch.cat([msg_cv, msg_cv.new_zeros((1, S))], dim=0)
    gathered = mc.index_select(0, tables["cpos_of_vslot"]).view(n_var, d_max, S)
    total = llr_var[:, None] + gathered.sum(dim=1)             # (n_var, S)
    if msg_vc is None:
        return total
    back = total.index_select(0, tables["var_of_cpos"]) - msg_cv
    new_vc = torch.where(tables["pad_c"][:, None], BIG, back)
    # padding slots blend +big with +big: +big again, exactly where g and
    # 1 - g are powers of two (the kernel never writes them)
    if damping:
        new_vc = (1.0 - damping) * new_vc + damping * msg_vc
    return msg_vc.copy_(new_vc)


def v2c(msg_cv: torch.Tensor, llr_var: torch.Tensor, tables: dict,
        msg_vc: torch.Tensor | None = None, damping: float = 0.0) -> torch.Tensor:
    """msg_cv (Ec, S) check-to-variable messages in the check layout (K3's
    output), llr_var (n_var,) priors, both float32 or both bfloat16;
    `tables` from `ldpc.slot_tables_on` on their device.

    With msg_vc (Ec, S), the previous variable-to-check messages: writes
    each edge's new message into it, blended as (1 - damping) * new +
    damping * old when damping > 0, and returns it; the check layout's
    padding slots are left as they are. With msg_vc None: returns the
    beliefs (n_var, S), the priors plus every incoming message.

    CUDA tensors: one kernel launch per call (counted in `v2c.launches`).
    CPU tensors: the plain twin."""
    Ec, d_max = tables["Ec"], tables["d_max"]
    if msg_cv.ndim != 2 or msg_cv.shape[0] != Ec:
        raise ValueError(f"msg_cv must be ({Ec}, S), got {tuple(msg_cv.shape)}")
    if not 1 <= d_max <= MAX_DEGREE:
        raise ValueError(f"v2c: d_max = {d_max} outside the kernel's 1..{MAX_DEGREE}")
    S = msg_cv.shape[1]
    n_var = tables["cpos_of_vslot"].numel() // d_max
    if llr_var.shape != (n_var,):
        raise ValueError(f"llr_var must be ({n_var},), got {tuple(llr_var.shape)}")
    if llr_var.dtype != msg_cv.dtype:
        raise TypeError(f"llr_var dtype {llr_var.dtype} != msg_cv dtype {msg_cv.dtype}")
    if msg_vc is not None:
        if msg_vc.shape != msg_cv.shape:
            raise ValueError(f"msg_vc must be {tuple(msg_cv.shape)}, got "
                             f"{tuple(msg_vc.shape)}")
        if msg_vc.dtype != msg_cv.dtype:
            raise TypeError(f"msg_vc dtype {msg_vc.dtype} != msg_cv dtype "
                            f"{msg_cv.dtype}")
    elif damping:
        raise ValueError("damping blends messages: it needs msg_vc")
    cpos = tables["cpos_of_vslot"]
    operands = [msg_cv, llr_var, cpos] + ([msg_vc] if msg_vc is not None else [])
    devices = {t.device for t in operands}
    if len(devices) != 1:
        raise ValueError(f"v2c: operands and tables on several devices {devices}")
    if msg_cv.device.type == "cpu":
        return _v2c_plain(msg_cv, llr_var, tables, msg_vc, damping)
    if msg_cv.device.type != "cuda":
        raise ValueError(f"v2c: unsupported device {msg_cv.device}")
    if msg_cv.dtype not in _V2C_ENTRY:
        raise TypeError(f"v2c: unsupported dtype {msg_cv.dtype}")
    if cpos.dtype != torch.int64:
        raise TypeError(f"v2c: cpos_of_vslot must be int64, got {cpos.dtype}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("v2c: operands must be contiguous")
    if msg_vc is not None and msg_vc.data_ptr() == msg_cv.data_ptr() and S:
        raise ValueError("v2c: msg_vc must not be msg_cv")
    if Ec >= 2 ** 31:
        raise ValueError(f"v2c: Ec = {Ec} beyond the kernel's int32 positions")
    out = msg_vc if msg_vc is not None else msg_cv.new_empty((n_var, S))
    if S == 0 or n_var == 0:
        return out
    lib = _kernels.load()
    with torch.cuda.device(msg_cv.device):
        rc = getattr(lib, _V2C_ENTRY[msg_cv.dtype])(
            _kernels.ptr(msg_cv), _kernels.ptr(llr_var), _kernels.ptr(cpos),
            _kernels.ptr(out), d_max, n_var, Ec, S, float(1.0 - damping),
            float(damping), int(bool(damping)), int(msg_vc is None),
            _kernels.stream_handle(msg_cv.device))
        _kernels.check(lib, rc, "min-sum v2c kernel")
    v2c.launches += 1
    return out


v2c.launches = 0

__all__ = ["c2v", "v2c", "MAX_SLOTS", "MAX_DEGREE"]
