"""The population scan (`csrc/population_scan.cu`): M members, each with its
own (n, n) U^T and S states of n real coordinates, n_seg steps of one
product.

Operations: n_seg x 2 n^2 per row over M S rows, the count `k1.flops` gives
and `step.flops` charges for the population's scan; the frame rotations are
not counted. Bytes, each operand once: every member's U^T (M n^2), the pair
charges (P), the phases (M n_seg), the states in and out (M S n each), all 4
bytes."""
from . import k1


def flops(M: int, S: int, n: int, n_seg: int) -> float:
    return k1.flops(M, S, n, n_seg)


def nbytes(M: int, S: int, n: int, P: int, n_seg: int) -> float:
    return 4.0 * (M * n * n + P + M * n_seg + 2 * M * S * n)
