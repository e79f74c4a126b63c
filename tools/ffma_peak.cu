// Rate of FP32 FMAs alone, in the two patterns of kernel K2's products
// (csrc/masked_squaring.cu): an 8 x 8 real register tile (64 independent
// FMAs per k step) and a 4 x 4 complex one (64 FMAs per k step, two of them
// back to back on each accumulator). Operands stay in registers; nothing is
// loaded. What the FP32 pipes of the card deliver to compiled CUDA C++: the
// ceiling of K2's routes. Timed by tools/k2_variants.py.
#include <cuda_runtime.h>

namespace {

template <bool COMPLEX> __global__ void ffma_peak(float* out, int iters) {
  float a[8], b[8], acc[8][8];
  for (int i = 0; i < 8; ++i) {
    a[i] = 1.0f + 1e-3f * (threadIdx.x + i);
    b[i] = 1.0f - 1e-3f * (threadIdx.x + 2 * i);
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
    if (COMPLEX) {
      // (a[2r], a[2r+1]) and (b[2c], b[2c+1]) are (re, im) pairs
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float& x = acc[2 * r][2 * c];
          float& y = acc[2 * r][2 * c + 1];
          x = fmaf(a[2 * r], b[2 * c], x);
          x = fmaf(-a[2 * r + 1], b[2 * c + 1], x);
          y = fmaf(a[2 * r], b[2 * c + 1], y);
          y = fmaf(a[2 * r + 1], b[2 * c], y);
        }
    } else {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// 64 FMAs per thread and iteration in either pattern.
extern "C" int nqs_ffma_peak(void* out, int complex_pattern, int blocks, int threads,
                             int iters, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (complex_pattern)
    ffma_peak<true><<<blocks, threads, 0, s>>>(static_cast<float*>(out), iters);
  else
    ffma_peak<false><<<blocks, threads, 0, s>>>(static_cast<float*>(out), iters);
  return cudaGetLastError();
}
