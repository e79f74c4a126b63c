// Rate of `mma.sync.aligned.m16n8k8` TF32 alone: each warp issues 8
// independent products per iteration, nothing else. The ceiling of kernel
// K1's float32 route (csrc/phase_scan.cu), which needs three of them per
// product. Timed by tools/k1_variants.py.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_tf32_peak(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = a[1];
  b[1] = a[2];
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += d[j][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int nqs_mma_tf32_peak(void* out, int blocks, int threads, int iters,
                                 void* stream) {
  mma_tf32_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return cudaGetLastError();
}
