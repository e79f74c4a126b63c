// Masked squaring chain of the batched matrix exponential (kernel K2).
//
// Replaces the Pallas TPU kernel `_kernel` / its caller `_pallas_squaring`
// (noisyquantumsimulator_tpu/ops/expm_pallas.py, public API
// `fused_masked_squaring`), which computes the same thing as the
// `_square` / `_square_3m` loops of ops/expm.py:
//
//   for trip i in 0 .. max_squarings-1:
//     R[b] <- R[b] @ R[b]   for every batch element b with i < s[b]
//
// R is (B, N, N) row-major: complex64 / complex128 (interleaved re, im) or
// float32 / float64; s (B,) int32 lives on the device.
//
// What bounds it on the H100: one squaring is 8 N^3 real FLOPs (complex) on
// an N x N matrix of N^2 elements; at N = 81 or 256 a matrix is 52 KB to
// 1 MB, so a trip reads and writes little and the work per batch element is
// small. With B = 1 (the gate engine's U_base) the card is mostly idle: the
// chain is latency-bound, a few microseconds per trip. At B = 300 (one expm per
// segment) it is bound by the FMA pipes through shared-memory tiles.
//
// Design: the TPU kernel kept each matrix resident in VMEM across all trips.
// Here a complex64 81 x 81 pair of ping-pong buffers would fit in one block's
// shared memory, but 256 x 256 (512 KB) does not, so this is the form that
// fits every shape: a tiled batched GEMM, one launch per trip, ping-ponging
// between two device buffers. The mask i < s[b] is read on the device (one
// int per tile), so the host never syncs; a masked-out tile copies its input
// through. Complex products are native (4 real multiplies per complex FMA):
// the 3-multiply Karatsuba form was a TPU matrix-unit trick.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;

__device__ __forceinline__ float e_zero(float) { return 0.f; }
__device__ __forceinline__ double e_zero(double) { return 0.0; }
__device__ __forceinline__ float2 e_zero(float2) { return make_float2(0.f, 0.f); }
__device__ __forceinline__ double2 e_zero(double2) { return make_double2(0.0, 0.0); }

// c + a * b
__device__ __forceinline__ float e_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double e_fma(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float2 e_fma(float2 a, float2 b, float2 c) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
  return c;
}
__device__ __forceinline__ double2 e_fma(double2 a, double2 b, double2 c) {
  c.x = fma(a.x, b.x, c.x);
  c.x = fma(-a.y, b.y, c.x);
  c.y = fma(a.x, b.y, c.y);
  c.y = fma(a.y, b.x, c.y);
  return c;
}

// One trip: dst[b] = src[b] @ src[b] if trip < s[b], else dst[b] = src[b].
// grid (ceil(N/T), ceil(N/T), B), block (T, T); one output element per thread.
template <typename E>
__global__ void masked_square_kernel(const E* __restrict__ src, E* __restrict__ dst,
                                     const int* __restrict__ s, int trip, int N) {
  __shared__ E As[kTile][kTile];
  __shared__ E Bs[kTile][kTile + 1];
  const int b = blockIdx.z;
  const E* A = src + (size_t)b * N * N;
  E* C = dst + (size_t)b * N * N;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;
  const int col = blockIdx.x * kTile + tx;
  const bool inside = row < N && col < N;
  const E zero = e_zero(E());

  if (trip >= s[b]) {  // uniform across the block: same b for every thread
    if (inside) C[(size_t)row * N + col] = A[(size_t)row * N + col];
    return;
  }
  E acc = zero;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    const int ka = k0 + tx, kb = k0 + ty;
    As[ty][tx] = (row < N && ka < N) ? A[(size_t)row * N + ka] : zero;
    Bs[ty][tx] = (kb < N && col < N) ? A[(size_t)kb * N + col] : zero;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTile; ++k) acc = e_fma(As[ty][k], Bs[k][tx], acc);
    __syncthreads();
  }
  if (inside) C[(size_t)row * N + col] = acc;
}

// Runs all max_squarings trips on buf0 -> buf1 -> buf0 ...; the result ends in
// buf[max_squarings % 2]. One launch per trip, no host synchronisation.
template <typename E>
int launch_masked_squaring(void* buf0, void* buf1, const void* s, int max_squarings, int B,
                           int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || max_squarings < 0) return cudaErrorInvalidValue;
  if (B > 65535) return cudaErrorInvalidValue;  // grid z limit
  const dim3 block(kTile, kTile);
  const dim3 grid((N + kTile - 1) / kTile, (N + kTile - 1) / kTile, B);
  E* bufs[2] = {static_cast<E*>(buf0), static_cast<E*>(buf1)};
  for (int i = 0; i < max_squarings; ++i) {
    masked_square_kernel<E><<<grid, block, 0, stream>>>(
        bufs[i & 1], bufs[(i + 1) & 1], static_cast<const int*>(s), i, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int nqs_masked_squaring_f32(void* buf0, void* buf1, const void* s, int max_squarings, int B,
                            int N, void* stream) {
  return launch_masked_squaring<float>(buf0, buf1, s, max_squarings, B, N,
                                       static_cast<cudaStream_t>(stream));
}

int nqs_masked_squaring_f64(void* buf0, void* buf1, const void* s, int max_squarings, int B,
                            int N, void* stream) {
  return launch_masked_squaring<double>(buf0, buf1, s, max_squarings, B, N,
                                        static_cast<cudaStream_t>(stream));
}

int nqs_masked_squaring_c64(void* buf0, void* buf1, const void* s, int max_squarings, int B,
                            int N, void* stream) {
  return launch_masked_squaring<float2>(buf0, buf1, s, max_squarings, B, N,
                                        static_cast<cudaStream_t>(stream));
}

int nqs_masked_squaring_c128(void* buf0, void* buf1, const void* s, int max_squarings, int B,
                             int N, void* stream) {
  return launch_masked_squaring<double2>(buf0, buf1, s, max_squarings, B, N,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
