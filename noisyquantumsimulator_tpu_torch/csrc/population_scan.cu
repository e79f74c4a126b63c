// Phase-frame scan of a population, one propagator per member (the
// optimizer's population objective).
//
// Replaces no TPU kernel: the JAX package maps its single-schedule scan
// (noisyquantumsimulator_tpu/solver/real_rep.py `evolve_real_phased`) over
// the population with `vmap`, which XLA lowers to batched products. Same
// contract as solver/real_rep.evolve_real_phased with U_real (M, n, n),
// first and last frame rotations included:
//
//   for each member m (its own U^T, its own phases ph[m, :]):
//     rotate every state row by -ph[0]
//     for step in 0 .. n_seg-1:
//       v <- v @ U^T                                   (n = D + 2P coordinates)
//       rotate by ph[step] - ph[step+1], or by ph[n_seg-1] after the last step
//   the rotation of pair p by angle t: re' = c re - s im, im' = s re + c im,
//   c/s = cos/sin(t * cq[p]), layout [D diag | P re | P im]
//
// U: (M, n, n) row-major (U[m][j][k]: output j, input k); cq (P,); phases
// (M, n_seg); x0: S rows of n per member, `x0_stride` elements apart (0: one
// set shared by every member); out (M, S, n).
//
// What bounds it on the H100: operations. At the optimizer's size (M = 1024,
// S = 5, n = 81, 300 steps) a step of the population is 2 x 5 x 81^2 x 1024 =
// 6.7e7 FLOPs, 2.0e10 a call, on the FP32 pipes (67 TFLOP/s on paper, about
// 46 for compiled FMAs: tools/ffma_peak.cu), 0.30-0.44 ms. Its bytes are few
// once each member's U^T stays on chip: U^T is read from device memory once,
// 27 MB for the population, where a per-step batched product (torch.bmm) reads
// it again every step, 300 x 27 MB (16.1 GB with the rotation folded in as a
// doubled contraction).
//
// Design:
//   * One warp (one block) owns one member for all n_seg steps. Its U^T
//     lives in shared memory, stored as U (row j = output coordinate) with an
//     odd row stride, so the 32 lanes reading column k of 32 different rows
//     hit 32 banks. Its S state rows live in shared memory beside it (rows
//     padded to a multiple of 4 elements for 16-byte reads). At n = 81 in
//     float32 that is 27.9 KB a member: 8 blocks an SM (228 KB), so a
//     population of 1024 runs in one wave on 132 SMs.
//   * The product: lane l owns output columns l, l + 32, l + 64, ... (NC of
//     them, NC = ceil(n / 32)) and kRows state rows at a time, in registers.
//     For every 4 inputs k it reads each state row's 4 values with one
//     16-byte broadcast read, and one U element per owned column, then does
//     kRows x NC x 4 FMAs. Each U element feeds kRows FMAs. Products are plain
//     FP32 (FP64) FMAs, summed in k order: no TF32, no fast math.
//   * The rotation is done on the state in shared memory between products,
//     one pair per lane at a time; cos/sin of each (step, pair) is computed
//     once with the accurate sincosf / sincos, before the step's product (so
//     its latency hides under the products), and applied to the S rows.
//     The first and the last rotation are in the kernel too: a call is one
//     launch, and nothing but U, the phases and the states crosses device
//     memory.
//   * The one-time load of a member's U (26 KB) is a coalesced 4-byte copy
//     through registers: the population's 27 MB take about 10 us of HBM
//     time in a call of about a millisecond, and the member's rows are not
//     16-byte aligned in device memory.
// Residency: the member's U and its state rows must fit one block's 227 KB
// (`nqs_population_scan_is_resident`, mirrored in
// solver/population_scan_cuda.resident); n = 256 (dim 4) does not, and its
// callers keep the batched-product loop.
#include <cuda_runtime.h>

namespace {

constexpr size_t kSmemMax = 227 * 1024;   // dynamic shared memory of one block
constexpr int kRows = 5;                   // state rows a product pass holds
constexpr int kMaxNC = 8;                  // columns a lane owns: n <= 256
constexpr int kPairs = 4;                  // pairs a lane rotates: P <= 128

__host__ __device__ inline int u_ld(int n) { return n | 1; }           // odd stride
__host__ __device__ inline int v_ld(int n) { return (n + 3) & ~3; }    // 16-byte rows
__host__ __device__ inline int rows_pad(int S) { return (S + kRows - 1) / kRows * kRows; }
__host__ __device__ inline size_t u_elems(int n) {   // U, then 4-element aligned
  return ((size_t)n * u_ld(n) + 3) & ~size_t(3);
}

template <typename T>
size_t smem_bytes(int n, int S) {
  return (u_elems(n) + (size_t)rows_pad(S) * v_ld(n)) * sizeof(T);
}

template <typename T>
bool fits(int n, int S) {
  return n >= 1 && S >= 1 && (n + 31) / 32 <= kMaxNC && smem_bytes<T>(n, S) <= kSmemMax;
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) { sincos(x, s, c); }

// Rotate pair p of the S state rows (row stride vld) by the angle of cs, sn.
template <typename T>
__device__ __forceinline__ void rotate_pair(T* vs, int vld, int S, int D, int P, int p,
                                            T cs, T sn) {
  T* re = vs + D + p;
  for (int r0 = 0; r0 < S; r0 += kRows) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r0 + r < S) {
        T* x = re + (r0 + r) * vld;
        const T a = x[0];
        const T b = x[P];
        x[0] = cs * a - sn * b;
        x[P] = sn * a + cs * b;
      }
    }
  }
}

// The hint of 8 blocks an SM lets ptxas use up to 255 registers a lane: with up
// to 4 members an SM (populations up to 528) a call takes 0.81 instead of
// 0.89 ms; with 8 (1024 members) both take 1.15 ms.
template <typename T, int NC>
__global__ void __launch_bounds__(32, 8)
population_scan_kernel(const T* __restrict__ U, const T* __restrict__ cq,
                       const T* __restrict__ phases, const T* __restrict__ x0,
                       long long x0_stride, T* __restrict__ out, int S, int n, int D,
                       int P, int n_seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int uld = u_ld(n);
  const int vld = v_ld(n);
  const int R = rows_pad(S);
  T* us = reinterpret_cast<T*>(smem_raw);
  T* vs = us + u_elems(n);
  const int m = blockIdx.x;
  const int lane = threadIdx.x;

  const T* Um = U + (size_t)m * n * n;
  for (int i = lane; i < n * n; i += 32) {
    const int j = i / n;
    us[j * uld + (i - j * n)] = __ldg(Um + i);
  }
  const T* xm = x0 + (size_t)m * x0_stride;
  for (int i = lane; i < R * vld; i += 32) {
    const int r = i / vld;
    const int c = i - r * vld;
    vs[i] = (r < S && c < n) ? __ldg(xm + (size_t)r * n + c) : T(0);
  }
  const T* ph = phases + (size_t)m * n_seg;
  T cqr[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = lane + 32 * i;
    cqr[i] = p < P ? __ldg(cq + p) : T(0);
  }
  __syncwarp();
  {
    const T theta = -__ldg(ph);
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < P) {
        T sn, cs;
        sin_cos(theta * cqr[i], &sn, &cs);
        rotate_pair(vs, vld, S, D, P, p, cs, sn);
      }
    }
  }
  __syncwarp();

  // U's rows of the columns this lane owns (lanes past n read row n - 1 and
  // keep nothing)
  const T* ucol[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) ucol[c] = us + min(lane + 32 * c, n - 1) * uld;

  for (int step = 0; step < n_seg; ++step) {
    // cos/sin of the rotation after this step's product, ahead of it
    const T theta = step + 1 < n_seg ? __ldg(ph + step) - __ldg(ph + step + 1)
                                     : __ldg(ph + step);
    T cs[kPairs], sn[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (lane + 32 * i < P) sin_cos(theta * cqr[i], &sn[i], &cs[i]);
    }
    for (int r0 = 0; r0 < R; r0 += kRows) {
      T* v0 = vs + r0 * vld;
      T acc[kRows][NC];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = T(0);
      int k = 0;
#pragma unroll 2
      for (; k + 4 <= n; k += 4) {
        T a[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) load4(v0 + r * vld + k, a[r]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const T u = ucol[c][k + kk];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r][c] = fma_rn(a[r][kk], u, acc[r][c]);
          }
        }
      }
      for (; k < n; ++k) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const T u = ucol[c][k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][c] = fma_rn(v0[r * vld + k], u, acc[r][c]);
        }
      }
      __syncwarp();   // every lane has read these rows: overwrite them
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int j = lane + 32 * c;
        if (j < n) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) v0[r * vld + j] = acc[r][c];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = lane + 32 * i;
      if (p < P) rotate_pair(vs, vld, S, D, P, p, cs[i], sn[i]);
    }
    __syncwarp();
  }

  T* om = out + (size_t)m * S * n;
  for (int i = lane; i < S * n; i += 32) {
    const int r = i / n;
    om[i] = vs[r * vld + (i - r * n)];
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const T* U, const T* cq, const T* phases, const T* x0,
                      long long x0_stride, T* out, int M, int S, int n, int D, int P,
                      int n_seg, cudaStream_t stream) {
  auto kernel = population_scan_kernel<T, NC>;
  const size_t smem = smem_bytes<T>(n, S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // the whole of the SM's 228 KB as shared memory: 8 members an SM at n = 81
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<M, 32, smem, stream>>>(U, cq, phases, x0, x0_stride, out, S, n, D, P, n_seg);
  return cudaGetLastError();
}

template <typename T>
int launch_population_scan(const void* U, const void* cq, const void* phases,
                           const void* x0, long long x0_stride, void* out, int M, int S,
                           int n, int D, int P, int n_seg, void* stream) {
  if (M < 1 || n_seg < 1 || n != D + 2 * P || D < 0 || P < 0 || P > 32 * kPairs ||
      x0_stride < 0 || !fits<T>(n, S))
    return cudaErrorInvalidValue;
  const T* u = static_cast<const T*>(U);
  const T* q = static_cast<const T*>(cq);
  const T* f = static_cast<const T*>(phases);
  const T* x = static_cast<const T*>(x0);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((n + 31) / 32) {
    case 1: return launch_nc<T, 1>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
    case 2: return launch_nc<T, 2>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
    case 3: return launch_nc<T, 3>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
    case 4: return launch_nc<T, 4>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
    case 5: return launch_nc<T, 5>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
    case 6: return launch_nc<T, 6>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
  }
  // float32 alone fits n > 192 (float64 stops at n = 168)
  if constexpr (sizeof(T) == 4) {
    switch ((n + 31) / 32) {
      case 7: return launch_nc<T, 7>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
      case 8: return launch_nc<T, 8>(u, q, f, x, x0_stride, o, M, S, n, D, P, n_seg, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// 1 if a member of n coordinates and S state rows, elements of `elem_bytes`
// (4: float32, 8: float64), fits one block: the kernel's routes.
int nqs_population_scan_is_resident(int n, int S, int elem_bytes) {
  if (elem_bytes == 4) return fits<float>(n, S);
  if (elem_bytes == 8) return fits<double>(n, S);
  return 0;
}

int nqs_population_scan_f32(const void* U, const void* cq, const void* phases,
                            const void* x0, long long x0_stride, void* out, int M, int S,
                            int n, int D, int P, int n_seg, void* stream) {
  return launch_population_scan<float>(U, cq, phases, x0, x0_stride, out, M, S, n, D, P,
                                       n_seg, stream);
}

int nqs_population_scan_f64(const void* U, const void* cq, const void* phases,
                            const void* x0, long long x0_stride, void* out, int M, int S,
                            int n, int D, int P, int n_seg, void* stream) {
  return launch_population_scan<double>(U, cq, phases, x0, x0_stride, out, M, S, n, D, P,
                                        n_seg, stream);
}

}  // extern "C"
