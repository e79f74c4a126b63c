"""noisyquantumsimulator_tpu_torch — the PyTorch / CUDA port of the simulator.

A second package beside the JAX reference (`noisyquantumsimulator_tpu`),
with the same subpackage layout so every counterpart sits at the same path:

  core/     constants, atom data, configuration dataclasses (host numpy)
  physics/  laser, trap, noise-rate, pulse and protocol physics (host numpy)
  ops/      Hilbert space, Hamiltonians, Liouvillians, phase frame (host
            numpy); the batched matrix exponential and its squaring kernel
  solver/   propagators and the real Hermitian-basis phase-frame scan
  gate/     the smooth-JP / LP / bang-bang CZ gate engine and its fidelity

Plain tensor code is PyTorch. The two hot loops of the gate engine run as
hand-written CUDA kernels (`csrc/`), built with nvcc at first use when a CUDA
tensor reaches them (see `_kernels.py`); CPU tensors take each kernel's plain
PyTorch twin.

Precision policy: every float32 matrix product runs in full float32. TF32 is
switched off for matmuls and convolutions, matching the reference, which
pins the highest matmul precision everywhere.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
