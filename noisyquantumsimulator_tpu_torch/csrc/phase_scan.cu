// Phase-frame scan of the real Hermitian-basis gate engine (kernel K1).
//
// Replaces the Pallas TPU kernel `_scan_kernel` / its caller
// `evolve_real_phased_many_pallas` (noisyquantumsimulator_tpu/solver/
// scan_pallas.py). Same contract as solver/real_rep.evolve_real_phased_many
// minus the first and last frame rotations, which the wrapper
// (solver/scan_cuda.py) does with torch ops:
//
//   for step in 0 .. n_seg-1:
//     rotate each (re, im) coordinate pair p of every state row of schedule b
//       by the angle dphi[b, step] * cq[p]          (layout [D diag | P re | P im])
//     v <- v @ U^T                                  (n = D + 2P real coordinates)
//
// State: v0/out (B, S, n) row-major, S state rows per schedule; Ut = U^T
// (n, n) row-major; cq (P,); dphi (B, n_seg).
//
// What bounds it on the H100: the per-step product is (B*S, n) @ (n, n) with
// n = 81 (dim 3) or 256 (dim 4): 2 n^2 FLOPs per state row per step against
// a state of only n values per row. Streaming the state through device memory
// every step (what a framework-level scan does) makes the loop bandwidth-
// bound; kept on chip, it is bound by the FP32 FMA pipes and by the
// shared-memory loads that feed them.
//
// Design:
//   * One thread block owns G whole schedules (G*S state rows) for all n_seg
//     steps. The rows live in shared memory (two ping-pong buffers) and never
//     go back to device memory between steps; the block reads v0 once and
//     writes the final state once. Any S <= rows-per-block works: nothing asks
//     for rows % S == 0, so the bench's S = 5 runs as it is.
//   * U^T sits in shared memory when it fits beside the state (dim 3: 26 KB in
//     f32, 52 KB in f64). At dim 4 (256 KB in f32) it is read from device
//     memory through L1/L2, where all blocks share it.
//   * cos/sin are computed once per (schedule, pair, step) and applied to the
//     S rows of that schedule; the partner of a re column is a plain index.
//     dphi is read per schedule, not per row.
//   * The product is plain FP32 (or FP64) FMA, no tensor cores, no TF32: each
//     thread owns one output column j and RT rows, so every U^T element it
//     loads feeds RT FMAs and every state element it loads is a warp-wide
//     shared-memory broadcast.
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 10;        // RT
constexpr int kMaxThreads = 512;
constexpr size_t kSmemForU = 200 * 1024;  // keep U^T in smem below this total
constexpr size_t kSmemMax = 227 * 1024;

__device__ __forceinline__ void sincos_t(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sincos_t(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T, int RT>
__global__ void phase_scan_kernel(const T* __restrict__ Ut, const T* __restrict__ cq,
                                  const T* __restrict__ dphi, const T* __restrict__ v0,
                                  T* __restrict__ out, int B, int S, int n, int D, int P,
                                  int n_seg, int G, int NC, int u_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int RG = blockDim.x / NC;
  const int rows_pad = RG * RT;
  T* va = sm;                    // current state, rows_pad x n
  T* vb = va + rows_pad * n;     // next state
  T* su = vb + rows_pad * n;     // U^T, n x n (if u_in_smem)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const int rows = nb * S;

  if (u_in_smem)
    for (int i = tid; i < n * n; i += nthr) su[i] = Ut[i];
  const T* U = u_in_smem ? su : Ut;

  const T* src = v0 + (size_t)b0 * S * n;
  for (int i = tid; i < rows_pad * n; i += nthr) va[i] = i < rows * n ? src[i] : T(0);
  __syncthreads();

  const int j = tid % NC;
  const int r0 = (tid / NC) * RT;
  const T* dph = dphi + (size_t)b0 * n_seg;

  for (int step = 0; step < n_seg; ++step) {
    // frame rotation: one (schedule, pair) per work item, applied to S rows
    for (int w = tid; w < nb * P; w += nthr) {
      const int g = w / P;
      const int p = w - g * P;
      T sn, cs;
      sincos_t(dph[(size_t)g * n_seg + step] * cq[p], &sn, &cs);
      T* row = va + (size_t)g * S * n;
      for (int s = 0; s < S; ++s, row += n) {
        const T re = row[D + p];
        const T im = row[D + P + p];
        row[D + p] = cs * re - sn * im;
        row[D + P + p] = sn * re + cs * im;
      }
    }
    __syncthreads();

    // v <- v @ U^T: thread (j, row block) computes RT outputs of column j
    if (j < n) {
      T acc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = T(0);
      const T* vr = va + (size_t)r0 * n;
      for (int k = 0; k < n; ++k) {
        const T u = U[(size_t)k * n + j];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i] = fma_t(vr[i * n + k], u, acc[i]);
      }
      T* wr = vb + (size_t)r0 * n + j;
#pragma unroll
      for (int i = 0; i < RT; ++i) wr[i * n] = acc[i];
    }
    __syncthreads();
    T* t = va; va = vb; vb = t;
  }

  T* dst = out + (size_t)b0 * S * n;
  for (int i = tid; i < rows * n; i += nthr) dst[i] = va[i];
}

template <typename T>
int launch_phase_scan(const void* Ut, const void* cq, const void* dphi, const void* v0,
                      void* out, int B, int S, int n, int D, int P, int n_seg,
                      cudaStream_t stream) {
  constexpr int RT = kRowsPerThread;
  if (B <= 0 || n_seg < 0) return cudaErrorInvalidValue;
  if (n != D + 2 * P || S <= 0) return cudaErrorInvalidValue;
  const int NC = ((n + 31) / 32) * 32;       // column threads, whole warps
  if (NC > kMaxThreads) return cudaErrorInvalidValue;
  const int RG = kMaxThreads / NC;           // row blocks
  const int rows_pad = RG * RT;
  if (S > rows_pad) return cudaErrorInvalidValue;
  const int G = rows_pad / S;                // schedules per thread block
  const size_t smem_v = 2 * (size_t)rows_pad * n * sizeof(T);
  const size_t smem_u = (size_t)n * n * sizeof(T);
  const int u_in_smem = smem_v + smem_u <= kSmemForU;
  const size_t smem = smem_v + (u_in_smem ? smem_u : 0);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = phase_scan_kernel<T, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + G - 1) / G;
  kernel<<<blocks, NC * RG, smem, stream>>>(
      static_cast<const T*>(Ut), static_cast<const T*>(cq), static_cast<const T*>(dphi),
      static_cast<const T*>(v0), static_cast<T*>(out), B, S, n, D, P, n_seg, G, NC,
      u_in_smem);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nqs_phase_scan_f32(const void* Ut, const void* cq, const void* dphi, const void* v0,
                       void* out, int B, int S, int n, int D, int P, int n_seg,
                       void* stream) {
  return launch_phase_scan<float>(Ut, cq, dphi, v0, out, B, S, n, D, P, n_seg,
                                  static_cast<cudaStream_t>(stream));
}

int nqs_phase_scan_f64(const void* Ut, const void* cq, const void* dphi, const void* v0,
                       void* out, int B, int S, int n, int D, int P, int n_seg,
                       void* stream) {
  return launch_phase_scan<double>(Ut, cq, dphi, v0, out, B, S, n, D, P, n_seg,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
