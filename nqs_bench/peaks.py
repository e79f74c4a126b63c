"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W power limit). A share of a peak is stated with the card's power limit
beside it."""

# 32-bit products: the dense TF32 tensor-core rate. The program reaches
# FP32-accurate products on the tensor cores only through error-compensated
# splits (3xTF32), and no split runs faster than this.
FLOPS_32 = 495e12
# 64-bit products on the FP64 tensor cores.
FLOPS_64 = 67e12
# HBM3 bandwidth.
BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, bits: int = 32) -> float:
    """The least time the chip could take: the larger of the operations at
    the product peak and the bytes at the memory peak."""
    return max(flops / (FLOPS_32 if bits == 32 else FLOPS_64),
               nbytes / BYTES_PER_S)
