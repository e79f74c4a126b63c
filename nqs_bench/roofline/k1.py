"""K1, the phase scan (`csrc/phase_scan.cu`): B schedules x S states of n
real coordinates, n_seg steps of one product with the shared (n, n) U^T.

Operations: n_seg x 2 n^2 per row, B S rows; the frame rotations are not
counted. Bytes, each operand once: U^T (n^2), the pair charges (P), the
phase steps (B n_seg), the first-rotated states in and the states out
(B S n each), all 4 bytes."""


def flops(B: int, S: int, n: int, n_seg: int) -> float:
    return float(n_seg) * 2.0 * n * n * B * S


def nbytes(B: int, S: int, n: int, P: int, n_seg: int) -> float:
    return 4.0 * (n * n + P + B * n_seg + 2 * B * S * n)
