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
// in (B, N, N) row-major: complex64 / complex128 (interleaved re, im) or
// float32 / float64; s (B,) int32 on the device; out (B, N, N) receives
// R[b]^(2^min(s[b], max_squarings)).
//
// What bounds it on the H100: operations. A squaring is 8 N^3 real FLOP
// (complex) or 2 N^3 (real) on a matrix of N^2 elements, so at N = 81 one
// squaring does 40 to 160 FLOP per byte of the matrix, and a chain of s
// squarings that touches device memory once does s times that: far above the
// card's 20 FLOP per byte (67 TFLOP/s FP32 over 3.35 TB/s). Only a batch of
// one or a few matrices is bound by the launch instead.
//
// Design, two routes chosen here by N and the element type, never by the
// caller:
//
//  * Resident route (the pair of buffers fits in one block's shared memory:
//    float32 up to N about 168, complex64 and float64 up to 120, complex128
//    up to 84). ONE launch for the whole chain, one block per matrix: it
//    copies R[b] in once with cp.async (every copy in flight before the
//    first is waited for), squares it min(s[b], max_squarings) times between
//    two shared-memory buffers and writes it once, as the TPU kernel kept
//    the matrix in VMEM. A matrix with no squaring is copied through
//    registers: no shared memory, no barrier. The product is
//    register-blocked: a thread owns a TM x TN tile of outputs (7 x 4 at
//    float32, so that N = 81 pads to 84 x 84 and fills 252 of 256 threads;
//    4 x 4 at complex64) and reads its A rows as 16-byte words along k and
//    the B row as words of its columns: 28 float32 FMAs, or 32 for complex64,
//    per 16-byte shared load.
//  * Tiled route (N = 256 and whatever does not fit): one launch per trip,
//    64 x 64 output tiles, 4 x 4 per thread, k panels staged with cp.async
//    in two buffers, as 16-byte words where the rows of the matrix are whole
//    words (each thread's addresses set up once per block), else element by
//    element. A matrix whose chain has ended is not touched: trip t of
//    matrix b reads `in` (t = 0) or the scratch buffer of trip t - 1 and
//    writes `out` if it is b's last squaring, else scratch buffer t & 1; a
//    block of a trip past s[b] returns before any load. Only a matrix with
//    s[b] = 0 is copied, once, by trip 0 (its result has to reach `out`).
//
// Complex products are native (4 real FMAs per complex FMA): the 3-multiply
// Karatsuba form was a TPU matrix-unit trick. Nothing here uses the tensor
// cores, so float32 stays full float32.
//
// Shared-memory layout of both routes: a thread's register tile is TM rows
// by TN = G * W columns, W the elements of one 16-byte word. Its columns are
// G groups of W, group g at column g * (tile columns of the block / G), so the
// lanes of a warp read consecutive 16-byte words of a B row (no bank
// conflict); on the resident route its rows are strided by the number of row
// tiles, so the A words that the lanes of a warp broadcast lie in different
// banks whatever the row stride.
//
// -D switches (tools/k2_variants.py builds each variant):
//   NQS_K2_TM_F32 / NQS_K2_TN_F32   a float32 thread's register tile, resident
//   NQS_K2_THREADS_F32 / _C64       threads of a resident block (a block
//                      launches no more than it has tiles for)
//   NQS_K2_BLOCKS_F32 / _C64 / _TILED   blocks per SM that the launch bounds
//                      of the float32 and complex64 resident kernels and of
//                      the 32-bit tiled kernels leave room for
//   NQS_K2_SYNC_LOAD   1: the resident route loads R through registers, a
//                      warp per row, instead of cp.async
//   NQS_K2_ELEM_PANELS 1: the tiled route stages its panels element by
//                      element even where 16-byte copies are possible
//   NQS_K2_FORCE_TILED 1: every shape takes the tiled route
//   NQS_K2_ABLATE      1: operands loaded once per tile, outside the k loop
//                         (the FMA pipes alone); 2: TM + TN adds per k step
//                         in place of TM x TN FMAs (the shared loads alone).
//                         Both give wrong results by design.
#include <cuda_runtime.h>

#include <cstdint>

#ifndef NQS_K2_TM_F32
#define NQS_K2_TM_F32 7
#endif
#ifndef NQS_K2_TN_F32
#define NQS_K2_TN_F32 4
#endif
#ifndef NQS_K2_THREADS_F32
#define NQS_K2_THREADS_F32 256
#endif
#ifndef NQS_K2_THREADS_C64
#define NQS_K2_THREADS_C64 256
#endif
#ifndef NQS_K2_BLOCKS_F32
#define NQS_K2_BLOCKS_F32 2
#endif
#ifndef NQS_K2_BLOCKS_C64
#define NQS_K2_BLOCKS_C64 2
#endif
#ifndef NQS_K2_BLOCKS_TILED
#define NQS_K2_BLOCKS_TILED 1
#endif
#ifndef NQS_K2_SYNC_LOAD
#define NQS_K2_SYNC_LOAD 0
#endif
#ifndef NQS_K2_ELEM_PANELS
#define NQS_K2_ELEM_PANELS 0
#endif
#ifndef NQS_K2_FORCE_TILED
#define NQS_K2_FORCE_TILED 0
#endif
#ifndef NQS_K2_ABLATE
#define NQS_K2_ABLATE 0
#endif

namespace {

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

__device__ __forceinline__ float e_add(float a, float b) { return a + b; }
__device__ __forceinline__ double e_add(double a, double b) { return a + b; }
__device__ __forceinline__ float2 e_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double2 e_add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

// One 16-byte word <-> the 16 / sizeof(E) elements it holds, through vector
// types so the elements stay in registers.
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void load16(const float2* p, float2* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = make_float2(t.x, t.y), v[1] = make_float2(t.z, t.w);
}
__device__ __forceinline__ void load16(const double* p, double* v) {
  const double2 t = *reinterpret_cast<const double2*>(p);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void load16(const double2* p, double2* v) { v[0] = *p; }
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(float2* p, const float2* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0].x, v[0].y, v[1].x, v[1].y);
}
__device__ __forceinline__ void store16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store16(double2* p, const double2* v) { *p = v[0]; }

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory; with
// `valid` false nothing is read and the destination is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem_src),
                 "n"(BYTES), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Register tile TM x TN of a resident thread (TN a multiple of W, the
// elements of a 16-byte word) and the launch bounds of the resident kernel.
template <typename E> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int TM = NQS_K2_TM_F32, TN = NQS_K2_TN_F32, kThreads = NQS_K2_THREADS_F32,
                       kBlocks = NQS_K2_BLOCKS_F32;
};
template <> struct Cfg<float2> {
  static constexpr int TM = 4, TN = 4, kThreads = NQS_K2_THREADS_C64,
                       kBlocks = NQS_K2_BLOCKS_C64;
};
template <> struct Cfg<double> {
  static constexpr int TM = 4, TN = 4, kThreads = 448, kBlocks = 1;
};
template <> struct Cfg<double2> {
  static constexpr int TM = 4, TN = 2, kThreads = 512, kBlocks = 1;
};

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

// acc (TM x TN) += A[tile rows][0 .. kend) @ A[0 .. kend)[tile columns],
// operands in shared memory. Row r of the tile is at `arow + r * a_step`
// (elements), contiguous along k; column group g of row k of the right
// operand at `bcol + k * ldb + g * b_step`. A thread reads its A rows as
// 16-byte words along k, so W steps of k cost TM + TN word loads.
template <typename E, int TM, int TN>
__device__ __forceinline__ void tile_product(const E* __restrict__ arow, int a_step,
                                             const E* __restrict__ bcol, int ldb, int b_step,
                                             int kend, E (&acc)[TM][TN]) {
  constexpr int W = 16 / sizeof(E), G = TN / W;
  static_assert(TN % W == 0, "a tile's columns are whole 16-byte words");
  E a[TM][W];
  E bv[W][TN];
#pragma unroll 2
  for (int k0 = 0; k0 < kend; k0 += W) {
    if (NQS_K2_ABLATE != 1 || k0 == 0) {
#pragma unroll
      for (int r = 0; r < TM; ++r) load16(arow + r * a_step + k0, a[r]);
#pragma unroll
      for (int kk = 0; kk < W; ++kk)
#pragma unroll
        for (int g = 0; g < G; ++g) load16(bcol + (k0 + kk) * ldb + g * b_step, bv[kk] + g * W);
    }
#pragma unroll
    for (int kk = 0; kk < W; ++kk) {
#if NQS_K2_ABLATE == 2
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r][0] = e_add(acc[r][0], a[r][kk]);
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[0][c] = e_add(acc[0][c], bv[kk][c]);
#else
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = e_fma(a[r][kk], bv[kk][c], acc[r][c]);
#endif
    }
  }
}

// ---------------------------------------------------------------------------
// Resident route: grid (B), one block per matrix, the whole chain in one
// launch. Dynamic shared memory: two buffers of NR rows x LD elements, zero
// outside the N x N matrix: NR = ntm * TM rows (rounded up to the k range,
// whole 16-byte words) of LD = ntn * TN columns; the strided tiles need no
// padding against bank conflicts. Tile (ti, tj) owns rows ti + r * ntm and, in column group g,
// columns g * ntn * W + tj * W ...
// ---------------------------------------------------------------------------
template <typename E> struct ResidentGeometry {
  int ntm, ntn, NR, LD;
  size_t bytes;
  explicit ResidentGeometry(int N)
      : ntm((N + Cfg<E>::TM - 1) / Cfg<E>::TM),
        ntn((N + Cfg<E>::TN - 1) / Cfg<E>::TN),
        NR(round_up(ntm * Cfg<E>::TM, 16 / static_cast<int>(sizeof(E)))),
        LD(ntn * Cfg<E>::TN),
        bytes(2 * static_cast<size_t>(NR) * LD * sizeof(E)) {}
};

template <typename E>
__global__ void __launch_bounds__(Cfg<E>::kThreads, Cfg<E>::kBlocks)
masked_square_resident_kernel(const E* __restrict__ in, E* __restrict__ out,
                              const int* __restrict__ s, int max_squarings, int N, int ntm,
                              int ntn, int NR, int LD) {
  constexpr int TM = Cfg<E>::TM, TN = Cfg<E>::TN, W = 16 / sizeof(E), G = TN / W;
  extern __shared__ uint4 k2_smem[];
  E* cur = reinterpret_cast<E*>(k2_smem);
  E* nxt = cur + NR * LD;
  const int b = blockIdx.x, tid = threadIdx.x, nthreads = blockDim.x;
  const E* A = in + static_cast<size_t>(b) * N * N;
  E* C = out + static_cast<size_t>(b) * N * N;
  const int trips = min(s[b], max_squarings);  // uniform across the block

  if (trips <= 0) {  // no squaring: the matrix goes through registers
    for (int idx = tid; idx < N * N; idx += nthreads) C[idx] = A[idx];
    return;
  }
  const E zero = e_zero(E());
  const int lane = tid % 32, warp = tid / 32, nwarps = nthreads / 32;
  // a warp per row; every copy of the matrix is in flight before any is
  // waited for, zeros outside N x N
  for (int r = warp; r < NR; r += nwarps) {
    E* dst = cur + r * LD;
    const int ncopy = r < N ? N : 0;
#if NQS_K2_SYNC_LOAD
    for (int c = lane; c < ncopy; c += 32) dst[c] = A[r * N + c];
#else
    for (int c = lane; c < ncopy; c += 32) cp_async<sizeof(E)>(dst + c, A + r * N + c, true);
#endif
    for (int c = ncopy + lane; c < LD; c += 32) dst[c] = zero;
  }
  // rows of the k range that no tile owns stay zero in the other buffer too
  for (int idx = ntm * TM * LD + tid; idx < NR * LD; idx += nthreads) nxt[idx] = zero;
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int ntiles = ntm * ntn;
  const int kend = round_up(N, W);
  const int b_step = ntn * W;
  for (int t = 0; t < trips; ++t) {
    for (int tile = tid; tile < ntiles; tile += nthreads) {
      const int ti = tile / ntn, tj = tile - ti * ntn;
      E acc[TM][TN];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = zero;
      tile_product<E, TM, TN>(cur + ti * LD, ntm * LD, cur + tj * W, LD, b_step, kend, acc);
      // whole tiles: entries outside N x N are sums of zeros, so the other
      // buffer's padding is zero after its first trip
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g)
          store16(nxt + (ti + r * ntm) * LD + g * b_step + tj * W, acc[r] + g * W);
    }
    __syncthreads();
    E* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int r = warp; r < N; r += nwarps)
    for (int c = lane; c < N; c += 32) C[r * N + c] = cur[r * LD + c];
}

// Whether (N, E) takes the resident route on the current device.
template <typename E> bool fits_resident(int N) {
  if (NQS_K2_FORCE_TILED) return false;
  int dev = 0, max_optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return false;
  return ResidentGeometry<E>(N).bytes <= static_cast<size_t>(max_optin);
}

template <typename E>
cudaError_t launch_resident(const void* in, void* out, const void* s, int max_squarings, int B,
                            int N, cudaStream_t stream) {
  const ResidentGeometry<E> g(N);
  auto kernel = masked_square_resident_kernel<E>;
  // above 48 KB a block's dynamic shared memory has to be asked for
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.bytes));
  if (err != cudaSuccess) return err;
  const int threads = min(Cfg<E>::kThreads, round_up(g.ntm * g.ntn, 32));
  kernel<<<B, threads, g.bytes, stream>>>(static_cast<const E*>(in), static_cast<E*>(out),
                                          static_cast<const int*>(s), max_squarings, N, g.ntm,
                                          g.ntn, g.NR, g.LD);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tiled route: one launch per trip, grid (ceil(N/64), ceil(N/64), B), 256
// threads as 16 x 16, a 64 x 64 output tile per block and 4 x 4 per thread:
// rows ty * 4 + r, columns g * 64 / G + tx * W ... in column group g.
// ---------------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kTT = 4;  // block tile, thread tile

template <typename E> struct Is64 { static constexpr bool value = false; };
template <> struct Is64<double> { static constexpr bool value = true; };
template <> struct Is64<double2> { static constexpr bool value = true; };

template <typename E> struct TiledCfg {
  static constexpr int W = 16 / sizeof(E);           // elements of a 16-byte word
  static constexpr int KP = sizeof(E) == 16 ? 8 : 16;  // k panel
  static constexpr int LDA = KP + W;                 // padded against bank conflicts
  static constexpr int kBlocks = Is64<E>::value ? 1 : NQS_K2_BLOCKS_TILED;
};

// The copies of one k panel that a thread starts, as 16-byte words: A_N words
// of the block's 64 rows by KP columns, B_N of its KP rows by 64 columns.
// Set up once per block; `start` issues panel p. Only for matrices whose rows
// are whole 16-byte words at 16-byte aligned addresses, so a word lies inside
// the matrix or outside it, never across its edge.
template <typename E> struct PanelWords {
  static constexpr int W = TiledCfg<E>::W, KP = TiledCfg<E>::KP, LDA = TiledCfg<E>::LDA;
  static constexpr int A_N = kBM * KP / W / 256, B_N = KP * kBN / W / 256;
  static_assert(A_N >= 1 && B_N >= 1, "every thread copies words of both operands");
  const E* a_src[A_N];
  const E* b_src[B_N];
  int a_dst[A_N], a_k[A_N], b_dst[B_N], b_k[B_N];
  bool a_in[A_N], b_in[B_N];
  const E* base;
  int N;

  __device__ __forceinline__ PanelWords(const E* A, int N_, int row0, int col0, int tid)
      : base(A), N(N_) {
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const int q = tid + i * 256, r = q / (KP / W), k = q % (KP / W) * W;
      a_in[i] = row0 + r < N;
      a_src[i] = A + static_cast<size_t>(row0 + r) * N + k;
      a_dst[i] = r * LDA + k;
      a_k[i] = k;
    }
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      const int q = tid + i * 256, k = q / (kBN / W), c = q % (kBN / W) * W;
      b_in[i] = col0 + c < N;
      b_src[i] = A + static_cast<size_t>(k) * N + col0 + c;
      b_dst[i] = k * kBN + c;
      b_k[i] = k;
    }
  }

  __device__ __forceinline__ void start(int panel, E* As, E* Bs) const {
    const int k0 = panel * KP;
#pragma unroll
    for (int i = 0; i < A_N; ++i) {
      const bool ok = a_in[i] && k0 + a_k[i] < N;
      cp_async<16>(As + a_dst[i], ok ? a_src[i] + k0 : base, ok);
    }
#pragma unroll
    for (int i = 0; i < B_N; ++i) {
      const bool ok = b_in[i] && k0 + b_k[i] < N;
      cp_async<16>(Bs + b_dst[i], ok ? b_src[i] + static_cast<size_t>(k0) * N : base, ok);
    }
    cp_async_commit();
  }
};

// The same panel element by element, for any N and alignment.
template <typename E>
__device__ __forceinline__ void start_panel_elements(const E* __restrict__ A, int N, int row0,
                                                     int col0, int panel, E* As, E* Bs,
                                                     int tid) {
  constexpr int KP = TiledCfg<E>::KP, LDA = TiledCfg<E>::LDA;
  const int k0 = panel * KP;
  for (int idx = tid; idx < kBM * KP; idx += 256) {
    const int r = idx / KP, k = idx % KP;
    const bool ok = row0 + r < N && k0 + k < N;
    cp_async<sizeof(E)>(As + r * LDA + k,
                        ok ? A + static_cast<size_t>(row0 + r) * N + k0 + k : A, ok);
  }
  for (int idx = tid; idx < KP * kBN; idx += 256) {
    const int k = idx / kBN, c = idx % kBN;
    const bool ok = k0 + k < N && col0 + c < N;
    cp_async<sizeof(E)>(Bs + k * kBN + c,
                        ok ? A + static_cast<size_t>(k0 + k) * N + col0 + c : A, ok);
  }
  cp_async_commit();
}

template <typename E, bool WORDS>
__global__ void __launch_bounds__(256, TiledCfg<E>::kBlocks)
masked_square_tiled_kernel(const E* __restrict__ in, E* __restrict__ scratch0,
                           E* __restrict__ scratch1, E* __restrict__ out,
                           const int* __restrict__ s, int trip, int max_squarings, int N) {
  constexpr int W = TiledCfg<E>::W, KP = TiledCfg<E>::KP, LDA = TiledCfg<E>::LDA;
  constexpr int G = kTT / W;  // column groups of a thread
  static_assert(kTT % W == 0, "a thread's 4 columns are whole 16-byte words");
  __shared__ __align__(16) E As[2][kBM * LDA];
  __shared__ __align__(16) E Bs[2][KP * kBN];
  const int b = blockIdx.z, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const size_t off = static_cast<size_t>(b) * N * N;
  const int trips = min(s[b], max_squarings);  // uniform across the block

  if (trip >= trips) {
    if (trip == 0) {  // no squaring at all: the matrix still has to reach `out`
      for (int idx = tid; idx < kBM * kBN; idx += 256) {
        const int r = row0 + idx / kBN, c = col0 + idx % kBN;
        if (r < N && c < N) out[off + static_cast<size_t>(r) * N + c] =
            in[off + static_cast<size_t>(r) * N + c];
      }
    }
    return;  // this matrix's chain has ended: nothing is loaded or stored
  }
  const E* A = (trip == 0 ? in : ((trip - 1) & 1 ? scratch1 : scratch0)) + off;
  E* C = (trip == trips - 1 ? out : (trip & 1 ? scratch1 : scratch0)) + off;

  const E zero = e_zero(E());
  E acc[kTT][kTT];
#pragma unroll
  for (int r = 0; r < kTT; ++r)
#pragma unroll
    for (int c = 0; c < kTT; ++c) acc[r][c] = zero;

  const int panels = (N + KP - 1) / KP;
  const PanelWords<E> words(A, N, row0, col0, tid);
  auto start = [&](int p) {
    if (WORDS) words.start(p, As[p & 1], Bs[p & 1]);
    else start_panel_elements<E>(A, N, row0, col0, p, As[p & 1], Bs[p & 1], tid);
  };
  start(0);
  for (int p = 0; p < panels; ++p) {
    if (p + 1 < panels) {
      start(p + 1);
      cp_async_wait<1>();  // panel p has landed, p + 1 is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    tile_product<E, kTT, kTT>(As[p & 1] + ty * kTT * LDA, LDA, Bs[p & 1] + tx * W, kBN,
                              kBN / G, KP, acc);
    __syncthreads();  // before panel p + 2 overwrites this stage
  }
#pragma unroll
  for (int r = 0; r < kTT; ++r) {
    const int row = row0 + ty * kTT + r;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = col0 + g * (kBN / G) + tx * W;
      if (row >= N) continue;
      if (WORDS) {
        if (col < N) store16(C + static_cast<size_t>(row) * N + col, acc[r] + g * W);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (col + w < N) C[static_cast<size_t>(row) * N + col + w] = acc[r][g * W + w];
      }
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename E>
cudaError_t launch_tiled(const void* in, void* scratch0, void* scratch1, void* out, const void* s,
                         int max_squarings, int B, int N, cudaStream_t stream) {
  if (B > 65535) return cudaErrorInvalidValue;  // grid z limit
  if ((max_squarings >= 2 && scratch0 == nullptr) || (max_squarings >= 3 && scratch1 == nullptr))
    return cudaErrorInvalidValue;
  const bool words = !NQS_K2_ELEM_PANELS && N * sizeof(E) % 16 == 0 && aligned16(in) &&
                     aligned16(out) && aligned16(scratch0) && aligned16(scratch1);
  auto kernel = words ? masked_square_tiled_kernel<E, true> : masked_square_tiled_kernel<E, false>;
  const dim3 grid((N + kBN - 1) / kBN, (N + kBM - 1) / kBM, B);
  for (int trip = 0; trip < max_squarings; ++trip) {
    kernel<<<grid, 256, 0, stream>>>(static_cast<const E*>(in), static_cast<E*>(scratch0),
                                     static_cast<E*>(scratch1), static_cast<E*>(out),
                                     static_cast<const int*>(s), trip, max_squarings, N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The whole chain, in -> out (distinct buffers, max_squarings >= 1). The
// resident route ignores the scratch buffers; the tiled route needs scratch0
// for max_squarings >= 2 and scratch1 for >= 3, each the size of `in`.
template <typename E>
int launch_masked_squaring(const void* in, void* out, void* scratch0, void* scratch1,
                           const void* s, int max_squarings, int B, int N,
                           cudaStream_t stream) {
  if (B <= 0 || N <= 0 || max_squarings < 1 || in == out) return cudaErrorInvalidValue;
  if (fits_resident<E>(N)) return launch_resident<E>(in, out, s, max_squarings, B, N, stream);
  return launch_tiled<E>(in, scratch0, scratch1, out, s, max_squarings, B, N, stream);
}

}  // namespace

extern "C" {

// 1 if (element type, N) takes the resident route (one launch per chain, no
// scratch), 0 for the tiled route (one launch per trip). Types: 0 float32,
// 1 float64, 2 complex64, 3 complex128.
int nqs_masked_squaring_is_resident(int type, int N) {
  switch (type) {
    case 0: return fits_resident<float>(N);
    case 1: return fits_resident<double>(N);
    case 2: return fits_resident<float2>(N);
    case 3: return fits_resident<double2>(N);
  }
  return 0;
}

int nqs_masked_squaring_f32(const void* in, void* out, void* scratch0, void* scratch1,
                            const void* s, int max_squarings, int B, int N, void* stream) {
  return launch_masked_squaring<float>(in, out, scratch0, scratch1, s, max_squarings, B, N,
                                       static_cast<cudaStream_t>(stream));
}

int nqs_masked_squaring_f64(const void* in, void* out, void* scratch0, void* scratch1,
                            const void* s, int max_squarings, int B, int N, void* stream) {
  return launch_masked_squaring<double>(in, out, scratch0, scratch1, s, max_squarings, B, N,
                                        static_cast<cudaStream_t>(stream));
}

int nqs_masked_squaring_c64(const void* in, void* out, void* scratch0, void* scratch1,
                            const void* s, int max_squarings, int B, int N, void* stream) {
  return launch_masked_squaring<float2>(in, out, scratch0, scratch1, s, max_squarings, B, N,
                                        static_cast<cudaStream_t>(stream));
}

int nqs_masked_squaring_c128(const void* in, void* out, void* scratch0, void* scratch1,
                             const void* s, int max_squarings, int B, int N, void* stream) {
  return launch_masked_squaring<double2>(in, out, scratch0, scratch1, s, max_squarings, B, N,
                                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
