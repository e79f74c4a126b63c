"""The whole step's operations, for its share of the chip's peak (step_mfu):
the products of the scan and of the matrix exponentials, which are all but
a thousandth of a step's arithmetic. Entries not listed here give None."""
from . import k1


def flops(entry: str, config: dict, traffic: dict, k2_flops: float = 0.0):
    n = int(config["hilbert_space_dim"]) ** 4
    n_seg = int(config["n_steps"])
    B = int(traffic["inputs"]["count"])
    if entry == "sweep":
        # one shared propagator: the scan of B x 5 rows (K1)
        return k1.flops(B, 5, n, n_seg) + k2_flops
    if entry == "population":
        # one propagator a member: the per-member scan of 5 rows, the
        # Taylor-16 polynomial's 6 products and the squarings (k2_flops)
        return k1.flops(B, 5, n, n_seg) + B * 6 * 2.0 * n ** 3 + k2_flops
    return None
