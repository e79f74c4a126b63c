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
// a state of only n values per row. Kept on chip for all steps, the scan is
// bound by arithmetic: 67 TFLOP/s on the FP32 pipes, or 495 / 3 TFLOP/s on
// the TF32 tensor cores with the three-product split below (mma.sync alone
// reaches about two thirds of 495). In this design the products, the
// rotation pass, the split of the state as it is loaded and the three
// barriers a step share the time; tools/k1_variants.py measures each.
//
// float32 design (tensor cores, `mma.sync.aligned.m16n8k8` TF32; not wgmma):
//   * 3xTF32 split. Each operand a = a_hi + a_lo, a_hi = a rounded to TF32
//     (round to nearest, ties away: add half an ulp of the 10-bit mantissa
//     and clear the 13 low bits), a_lo = a - a_hi (exact) rounded to TF32.
//     Each 8-wide k block of a 16x8 output tile takes lo*hi + hi*lo + hi*hi
//     on the tensor cores into a fresh float32 tile, which is added to the
//     running sum with FP32 adds; the lo*lo term (2^-22 relative) is
//     dropped. Letting the tensor cores carry the running sum instead
//     failed the 1e-4 parity of the card tests after 300 steps (they do
//     not round it to nearest); plain TF32 (one product) would keep about
//     3 digits.
//   * One thread block owns G whole schedules (G*S <= M state rows, the rest
//     zero) for all n_seg steps. The rows live in shared memory in the mma
//     fragment layout; nothing asks for rows % S == 0.
//   * n is padded to NT = ceil(n/8) tiles of 8. Padded columns of the state
//     and padded rows/columns of U^T are exactly zero, so padded columns stay
//     zero through every product; the rotation never touches them.
//   * Fragment layout and the accumulator -> operand handoff. Within each
//     8-wide k block the sum runs over a permuted k order: the A operand's
//     k = t and t + 4 (t = lane % 4) are the state's columns 2t and 2t + 1,
//     and B's rows likewise. Then a lane's accumulator for output tile (m, j)
//     (c0..c3 = rows g / g + 8, columns 2t / 2t + 1) is exactly its A
//     fragment for k block j of the next step. The state is stored as one
//     float4 per (m tile, k block, lane): each step writes its accumulators
//     with one 16-byte store per tile and every warp reads its operands with
//     one 16-byte load per tile, both free of bank conflicts.
//   * Warp tiling: warp (wm, wn) owns MW m tiles (16 rows each) and NW n
//     tiles (8 columns each), so each A fragment it loads feeds NW products
//     and each B fragment MW products. The state is split as it is loaded.
//   * U^T in shared memory when it fits beside the state (dim 3: 11 x 11
//     tiles, hi and lo pre-split once per block in fragment order, 62 KB,
//     beside 44 KB of state for 128 rows: two blocks an SM).
//     Otherwise (dim 4: 512 KB split, 256 KB in f32) each warp reads its own
//     columns of U^T from L2 and splits them in registers, one k block ahead
//     of the products. Inside a block each U^T element feeds exactly one
//     warp, so staging it in shared memory would add a store and a load with
//     no reuse; the 80-row block makes each L2 byte feed 80 rows.
//   * cos/sin are computed once per (schedule, pair, step) and applied to the
//     S rows of that schedule, in shared memory, between products.
//
// float64 design (complex128 parity path, not the timed sweep): plain FP64
// FMA, one output column and RT rows per thread, U^T in shared memory when
// it fits and read through L1/L2 otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kSmemMax = 227 * 1024;

// ---------------------------------------------------------------- float32

constexpr int kNW = 4;     // n tiles (8 columns) per warp
// Each route: m tiles (16 rows) per warp, threads per block at most, and
// blocks an SM holds (the registers a thread may use follow: 65,536 /
// (threads * blocks), 170 and 255 here). Measured on the H100 at the bench
// shapes (tools/k1_variants.py): the L2 route with 4 m tiles a warp and 2
// blocks an SM spills; at 1 block an SM, 5 m tiles (80 rows, 512 blocks =
// 3.9 waves of 132) beat 4, 6 and 8.
//
// tools/k1_variants.py alone sets these with -D, to time other L2-route
// tilings and ablations (1: no rotation, 2: the state not split, hi only,
// 3: the hi*hi product only; their results are wrong by design).
#ifndef NQS_K1_MW_L2
#define NQS_K1_MW_L2 5
#endif
#ifndef NQS_K1_BLOCKS_L2
#define NQS_K1_BLOCKS_L2 1
#endif
#ifndef NQS_K1_ABLATE
#define NQS_K1_ABLATE 0
#endif
constexpr int kMWUSmem = 4, kThreadsUSmem = 192, kBlocksUSmem = 2;
constexpr int kMWUL2 = NQS_K1_MW_L2, kThreadsUL2 = 256, kBlocksUL2 = NQS_K1_BLOCKS_L2;
constexpr int kAblate = NQS_K1_ABLATE;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float4& d, const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product into a fresh tile: d = a b (C = 0).
__device__ __forceinline__ void mma_tf32_zero(float4& d, const uint32_t a[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d.x), "=f"(d.y), "=f"(d.z), "=f"(d.w)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Offset (in floats) of state element (row r, column c) in the fragment
// layout [m tile][k block][lane][c0 c1 c2 c3], lane = 4 (r % 8) + (c % 8) / 2,
// component c % 2 + 2 ((r / 8) % 2). It is a sum of a row and a column part.
__device__ __forceinline__ int row_off(int r, int KT) {
  return (r >> 4) * KT * 128 + (r & 7) * 16 + ((r >> 3) & 1) * 2;
}
__device__ __forceinline__ int col_off(int c) {
  return (c >> 3) * 128 + ((c & 7) >> 1) * 4 + (c & 1);
}
__device__ __forceinline__ int frag_off(int r, int c, int KT) {
  return row_off(r, KT) + col_off(c);
}

// B fragment (k block ks, n tile nt) of this lane, straight from U^T: rows
// 8ks + 2t and 8ks + 2t + 1, column 8nt + g; zero outside n.
__device__ __forceinline__ float2 load_b(const float* __restrict__ Ut, int n, int ks,
                                         int nt, int lane) {
  const int k0 = 8 * ks + 2 * (lane & 3);
  const int col = 8 * nt + (lane >> 2);
  float2 b = make_float2(0.f, 0.f);
  if (col < n) {
    if (k0 < n) b.x = __ldg(Ut + (size_t)k0 * n + col);
    if (k0 + 1 < n) b.y = __ldg(Ut + (size_t)(k0 + 1) * n + col);
  }
  return b;
}

template <bool kUSmem, int kMW = kUSmem ? kMWUSmem : kMWUL2>
__global__ void __launch_bounds__(kUSmem ? kThreadsUSmem : kThreadsUL2,
                                  kUSmem ? kBlocksUSmem : kBlocksUL2)
phase_scan_tc_kernel(const float* __restrict__ Ut, const float* __restrict__ cq,
                     const float* __restrict__ dphi, const float* __restrict__ v0,
                     float* __restrict__ out, int B, int S, int n, int D, int P,
                     int n_seg, int G, int Wn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int KT = (n + 7) >> 3;               // k blocks = n tiles
  const int nthr = blockDim.x;
  const int M = (nthr / 32 / Wn) * kMW * 16;  // rows per block (padded)
  float* sv = reinterpret_cast<float*>(smem_raw);           // M x 8KT, fragments
  float4* sv4 = reinterpret_cast<float4*>(sv);
  float4* su4 = reinterpret_cast<float4*>(sv + (size_t)M * KT * 8);  // U^T hi/lo

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wn = warp % Wn;
  const int wm = warp / Wn;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const int rows = nb * S;

  if (kUSmem) {
    for (int i = tid; i < KT * KT * 32; i += nthr) {
      const int l = i & 31;
      const int f = i >> 5;                  // ks * KT + nt
      const float2 b = load_b(Ut, n, f / KT, f % KT, l);
      uint32_t h0, l0, h1, l1;
      split_tf32(b.x, h0, l0);
      split_tf32(b.y, h1, l1);
      su4[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                           __uint_as_float(l0), __uint_as_float(l1));
    }
  }
  const float* src = v0 + (size_t)b0 * S * n;
  for (int i = tid; i < M * KT * 8; i += nthr) {
    const int r = i / (KT * 8);
    const int c = i - r * (KT * 8);
    sv[frag_off(r, c, KT)] = (r < rows && c < n) ? src[(size_t)r * n + c] : 0.f;
  }
  __syncthreads();

  const float* dph = dphi + (size_t)b0 * n_seg;
  const int mt0 = wm * kMW;
  const int nt0 = wn * kNW;

  for (int step = 0; step < n_seg; ++step) {
    // frame rotation: one (schedule, pair) per work item, applied to S rows
    for (int w = tid; w < (kAblate == 1 ? 0 : nb * P); w += nthr) {
      const int g = w / P;
      const int p = w - g * P;
      float sn, cs;
      sincosf(dph[(size_t)g * n_seg + step] * cq[p], &sn, &cs);
      const int cre = col_off(D + p), cim = col_off(D + P + p);
      for (int s = 0, r = g * S; s < S; ++s, ++r) {
        const int o = row_off(r, KT);
        const float re = sv[o + cre];
        const float im = sv[o + cim];
        sv[o + cre] = cs * re - sn * im;
        sv[o + cim] = sn * re + cs * im;
      }
    }
    __syncthreads();

    // v <- v @ U^T on the tensor cores, 3xTF32
    float4 acc[kMW][kNW];
#pragma unroll
    for (int i = 0; i < kMW; ++i)
#pragma unroll
      for (int j = 0; j < kNW; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

    float2 braw[kNW];   // L2 route: U^T fragments of the next k block
    if (!kUSmem) {
#pragma unroll
      for (int j = 0; j < kNW; ++j) braw[j] = load_b(Ut, n, 0, nt0 + j, lane);
    }
    for (int ks = 0; ks < KT; ++ks) {
      uint32_t bh[kNW][2], bl[kNW][2];
      if (kUSmem) {
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          if (nt0 + j < KT) {
            const float4 q = su4[(ks * KT + nt0 + j) * 32 + lane];
            bh[j][0] = __float_as_uint(q.x);
            bh[j][1] = __float_as_uint(q.y);
            bl[j][0] = __float_as_uint(q.z);
            bl[j][1] = __float_as_uint(q.w);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          split_tf32(braw[j].x, bh[j][0], bl[j][0]);
          split_tf32(braw[j].y, bh[j][1], bl[j][1]);
        }
        if (ks + 1 < KT) {
#pragma unroll
          for (int j = 0; j < kNW; ++j) braw[j] = load_b(Ut, n, ks + 1, nt0 + j, lane);
        }
      }
#pragma unroll
      for (int i = 0; i < kMW; ++i) {
        const float4 q = sv4[((mt0 + i) * KT + ks) * 32 + lane];
        uint32_t ah[4], al[4];
        // A registers: (g, k=t), (g+8, t), (g, t+4), (g+8, t+4) = c0, c2, c1, c3
        if (kAblate == 2) {
          ah[0] = __float_as_uint(q.x);
          ah[1] = __float_as_uint(q.z);
          ah[2] = __float_as_uint(q.y);
          ah[3] = __float_as_uint(q.w);
          al[0] = al[1] = al[2] = al[3] = 0u;
        } else {
          split_tf32(q.x, ah[0], al[0]);
          split_tf32(q.z, ah[1], al[1]);
          split_tf32(q.y, ah[2], al[2]);
          split_tf32(q.w, ah[3], al[3]);
        }
        // This k block's three products go into a fresh tile, added to the
        // running sum on the FP32 pipe (round to nearest): the tensor cores
        // do not round a long running sum to nearest, and over 300 steps
        // that bias costs a digit. Term-major order keeps kNW independent
        // products between two that depend on each other.
        float4 part[kNW];
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          if (kAblate == 3) part[j] = make_float4(0.f, 0.f, 0.f, 0.f);
          else if (nt0 + j < KT) mma_tf32_zero(part[j], al, bh[j][0], bh[j][1]);
        }
#pragma unroll
        for (int j = 0; j < kNW; ++j)
          if (kAblate != 3 && nt0 + j < KT) mma_tf32(part[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < kNW; ++j)
          if (nt0 + j < KT) mma_tf32(part[j], ah, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < kNW; ++j) {
          if (nt0 + j < KT) {
            acc[i][j].x += part[j].x;
            acc[i][j].y += part[j].y;
            acc[i][j].z += part[j].z;
            acc[i][j].w += part[j].w;
          }
        }
      }
    }
    __syncthreads();   // every warp has read the state: overwrite it
#pragma unroll
    for (int i = 0; i < kMW; ++i)
#pragma unroll
      for (int j = 0; j < kNW; ++j)
        if (nt0 + j < KT) sv4[((mt0 + i) * KT + nt0 + j) * 32 + lane] = acc[i][j];
    __syncthreads();
  }

  float* dst = out + (size_t)b0 * S * n;
  for (int i = tid; i < rows * n; i += nthr) {
    const int r = i / n;
    dst[i] = sv[frag_off(r, i - r * n, KT)];
  }
}

int launch_phase_scan_f32(const float* Ut, const float* cq, const float* dphi,
                          const float* v0, float* out, int B, int S, int n, int D,
                          int P, int n_seg, cudaStream_t stream) {
  const int KT = (n + 7) / 8;
  const int Wn = (KT + kNW - 1) / kNW;       // warps across the columns
  // U^T in shared memory if the block fits, else the L2 route
  for (int route = 0; route < 2; ++route) {
    const bool u_smem = route == 0;
    const int tile_rows = (u_smem ? kMWUSmem : kMWUL2) * 16;  // a row of warps
    const int max_threads = u_smem ? kThreadsUSmem : kThreadsUL2;
    if (32 * Wn > max_threads) continue;
    int Wm = max_threads / (32 * Wn) >= 2 ? 2 : 1;   // warps down the rows
    while (Wm * tile_rows < S) ++Wm;                 // >= 1 schedule a block
    const int threads = 32 * Wn * Wm;
    if (threads > max_threads) continue;
    const int M = Wm * tile_rows;
    const size_t smem_v = (size_t)M * KT * 8 * sizeof(float);
    const size_t smem_u = u_smem ? (size_t)KT * KT * 32 * sizeof(float4) : 0;
    const size_t smem = smem_v + smem_u;
    if (smem > kSmemMax) continue;
    auto kernel = u_smem ? phase_scan_tc_kernel<true> : phase_scan_tc_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int G = M / S;
    const int blocks = (B + G - 1) / G;
    kernel<<<blocks, threads, smem, stream>>>(Ut, cq, dphi, v0, out, B, S, n, D, P,
                                              n_seg, G, Wn);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;   // n > 256, or S too large for one block
}

// ---------------------------------------------------------------- float64

constexpr int kRowsPerThread = 10;        // RT
constexpr int kMaxThreads = 512;
constexpr size_t kSmemForU = 200 * 1024;  // keep U^T in smem below this total

template <int RT>
__global__ void phase_scan_f64_kernel(const double* __restrict__ Ut,
                                      const double* __restrict__ cq,
                                      const double* __restrict__ dphi,
                                      const double* __restrict__ v0,
                                      double* __restrict__ out, int B, int S, int n,
                                      int D, int P, int n_seg, int G, int NC,
                                      int u_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sm = reinterpret_cast<double*>(smem_raw);
  const int RG = blockDim.x / NC;
  const int rows_pad = RG * RT;
  double* va = sm;                    // current state, rows_pad x n
  double* vb = va + rows_pad * n;     // next state
  double* su = vb + rows_pad * n;     // U^T, n x n (if u_in_smem)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b0 = blockIdx.x * G;
  const int nb = min(G, B - b0);
  const int rows = nb * S;

  if (u_in_smem)
    for (int i = tid; i < n * n; i += nthr) su[i] = Ut[i];
  const double* U = u_in_smem ? su : Ut;

  const double* src = v0 + (size_t)b0 * S * n;
  for (int i = tid; i < rows_pad * n; i += nthr) va[i] = i < rows * n ? src[i] : 0.0;
  __syncthreads();

  const int j = tid % NC;
  const int r0 = (tid / NC) * RT;
  const double* dph = dphi + (size_t)b0 * n_seg;

  for (int step = 0; step < n_seg; ++step) {
    for (int w = tid; w < nb * P; w += nthr) {
      const int g = w / P;
      const int p = w - g * P;
      double sn, cs;
      sincos(dph[(size_t)g * n_seg + step] * cq[p], &sn, &cs);
      double* row = va + (size_t)g * S * n;
      for (int s = 0; s < S; ++s, row += n) {
        const double re = row[D + p];
        const double im = row[D + P + p];
        row[D + p] = cs * re - sn * im;
        row[D + P + p] = sn * re + cs * im;
      }
    }
    __syncthreads();

    if (j < n) {
      double acc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = 0.0;
      const double* vr = va + (size_t)r0 * n;
      for (int k = 0; k < n; ++k) {
        const double u = U[(size_t)k * n + j];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i] = fma(vr[i * n + k], u, acc[i]);
      }
      double* wr = vb + (size_t)r0 * n + j;
#pragma unroll
      for (int i = 0; i < RT; ++i) wr[i * n] = acc[i];
    }
    __syncthreads();
    double* t = va; va = vb; vb = t;
  }

  double* dst = out + (size_t)b0 * S * n;
  for (int i = tid; i < rows * n; i += nthr) dst[i] = va[i];
}

int launch_phase_scan_f64(const double* Ut, const double* cq, const double* dphi,
                          const double* v0, double* out, int B, int S, int n, int D,
                          int P, int n_seg, cudaStream_t stream) {
  constexpr int RT = kRowsPerThread;
  const int NC = ((n + 31) / 32) * 32;       // column threads, whole warps
  if (NC > kMaxThreads) return cudaErrorInvalidValue;
  const int RG = kMaxThreads / NC;           // row blocks
  const int rows_pad = RG * RT;
  if (S > rows_pad) return cudaErrorInvalidValue;
  const int G = rows_pad / S;                // schedules per thread block
  const size_t smem_v = 2 * (size_t)rows_pad * n * sizeof(double);
  const size_t smem_u = (size_t)n * n * sizeof(double);
  const int u_in_smem = smem_v + smem_u <= kSmemForU;
  const size_t smem = smem_v + (u_in_smem ? smem_u : 0);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  auto kernel = phase_scan_f64_kernel<RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + G - 1) / G;
  kernel<<<blocks, NC * RG, smem, stream>>>(Ut, cq, dphi, v0, out, B, S, n, D, P,
                                            n_seg, G, NC, u_in_smem);
  return cudaGetLastError();
}

bool valid_args(int B, int S, int n, int D, int P, int n_seg) {
  return B > 0 && n_seg >= 0 && S > 0 && n == D + 2 * P;
}

}  // namespace

extern "C" {

int nqs_phase_scan_f32(const void* Ut, const void* cq, const void* dphi, const void* v0,
                       void* out, int B, int S, int n, int D, int P, int n_seg,
                       void* stream) {
  if (!valid_args(B, S, n, D, P, n_seg)) return cudaErrorInvalidValue;
  return launch_phase_scan_f32(
      static_cast<const float*>(Ut), static_cast<const float*>(cq),
      static_cast<const float*>(dphi), static_cast<const float*>(v0),
      static_cast<float*>(out), B, S, n, D, P, n_seg, static_cast<cudaStream_t>(stream));
}

int nqs_phase_scan_f64(const void* Ut, const void* cq, const void* dphi, const void* v0,
                       void* out, int B, int S, int n, int D, int P, int n_seg,
                       void* stream) {
  if (!valid_args(B, S, n, D, P, n_seg)) return cudaErrorInvalidValue;
  return launch_phase_scan_f64(
      static_cast<const double*>(Ut), static_cast<const double*>(cq),
      static_cast<const double*>(dphi), static_cast<const double*>(v0),
      static_cast<double*>(out), B, S, n, D, P, n_seg, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
