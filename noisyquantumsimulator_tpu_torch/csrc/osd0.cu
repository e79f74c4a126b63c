// OSD-0 over GF(2) of the shots that BP leaves unconverged: one block a shot.
//
// Replaces no Pallas kernel: the reference runs OSD-0 on the host
// (noisyquantumsimulator_tpu/qec/ldpc.py `_osd0`; native/uf_decoder.cpp
// `osd0_batch`). The twin is qec/native.osd0_batch_native, that same C++,
// held bit-equal to ldpc._osd0 by the tests; qec/osd_cuda.osd0 runs it for
// CPU tensors.
//
// Contract (H (m, n) over GF(2), W = ceil((n + 1) / 64), S shots):
//
//   Hp (m, W) uint64       H packed by rows: bit c & 63 of word c >> 6 is
//                          H[r, c]; the bits from n on are 0
//   obs_mask (n,) int64    each column's observable bitmask
//   dets (S, m) uint8      the shots' detectors (nonzero: fired)
//   beliefs (S, n) f32     the shots' beliefs (no NaN)
//   obs (S, k) int32       the shots' observables (nonzero: flipped), k < 64
//   est (S, n) uint8       out: OSD-0's estimate, osd0_batch's bit for bit
//   pred (S,) int64        out: the XOR of obs_mask over the estimate's ones,
//                          its low k bits
//   fail (S,) uint8        out: 1 where pred differs from the packed obs row
//
// The algorithm is osd0_batch's. The columns are visited in ascending
// belief, ties by column index: std::sort's comparator, under which -0.0
// equals +0.0 (the keys map both to +0.0 before they are ordered as
// integers). Gauss-Jordan on [H | s]: a column's pivot is the first row
// holding its bit in the list of unused rows, which is kept as osd0_batch
// keeps it (the pivot's place goes to the list's last row), and the pivot
// row is XOR-ed into every other row holding the bit. Which row pivots
// matters only where s lies outside H's column space; keeping the host's
// list keeps the estimate bit-equal there too. The walk stops once it holds
// rank(H) pivots (`rank`, from the host): no unused row holds a bit of H
// after that, so the host's walk over the remaining columns finds nothing.
//
// What bounds it on the H100: latency, not bytes or operations. A shot reads
// H (66.8 KB at the gross code's DEM, m = 288, n = 1833, from L2 after the
// first block) and its n beliefs; its eliminations are 2.3-3.1 k row XORs of
// 29 words. But each pivot waits on the previous pivot's eliminations,
// rank(H) = 282 of them there, and the walk passes 1290-1640 columns of a
// residue row's order before it has them all (both counted on the CPU on
// residue rows of the bb-gross step). On the card a shared-memory load that
// waits on the one before cost ~160 cycles in the one-warp walk below, so
// the design keeps such chains short and issues loads together.
//
// Design: [H | s] lives in dynamic shared memory (m x W words, m padded to
// whole groups of 32 rows with zero rows), so a pivot costs two block
// barriers and shared-memory traffic alone, and a column that no unused row
// holds costs no barrier. Each warp owns groups of 32 rows and keeps, for
// each, the OR of its unused rows (`uor`, W words). Every warp finds the
// next column on its own, 32 of the order at a time: a lane tests its
// column against the groups' ORs, and a ballot gives the first one that an
// unused row holds. For that column each warp ballots its rows that hold it
// and takes the least (list position, row) among its unused ones
// (__reduce_min_sync); after a barrier every thread reads the groups'
// minima: the pivot. Each warp then XORs the pivot row into its groups'
// rows that hold the bit and ORs their unused rows anew, a lane a word,
// eight rows' words loaded before any is stored; a word is left alone
// where it cannot change (the pivot row's word is 0 or no row holds the
// bit, and the group keeps its unused rows). Thread 0 updates the list, and
// a barrier ends the pivot. The order comes from a bitonic sort of (belief,
// index) keys in shared memory. One block a shot: a step's 33-48 shots run
// side by side on as many SMs.
//
// Measured on an H100 80GB HBM3 at 700 W (37 residue rows of the gross DEM):
// this design 0.47 ms; one barrier a column instead of the ORs 0.94 ms;
// 16 columns tested a round 0.75 ms; the walk in one warp, no barriers,
// 1.5 ms (a lane's ~9 dependent loads a column cost ~1600 cycles).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMinThreads = 256;
constexpr unsigned kNone = 0xffffffffu;
constexpr unsigned kAll = 0xffffffffu;

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// dynamic shared memory of one block, in the order the kernel lays it out
size_t smem_bytes(int m, int n) {
  const size_t W = (static_cast<size_t>(n) + 64) / 64;
  const size_t groups = (static_cast<size_t>(m) + 31) / 32;
  const size_t words = 32 * groups * W                       // [H | s], padded
                       + static_cast<size_t>(next_pow2(n))   // sort keys
                       + groups * W                          // unused rows' ORs
                       + W                                   // the solution's bits
                       + kMaxThreads / 32;                   // per-warp XORs
  return 8 * words + 4 * (3 * groups + 3 * static_cast<size_t>(m));
}

// the column's sort key: its belief as an ordered integer, then its index
__device__ __forceinline__ unsigned long long sort_key(float b, int c) {
  unsigned u = __float_as_uint(b == 0.0f ? 0.0f : b);   // -0.0 equals +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(c);
}

__global__ void __launch_bounds__(kMaxThreads)
osd0_kernel(const unsigned long long* __restrict__ Hp, const long long* __restrict__ obs_mask,
            const unsigned char* __restrict__ dets, const float* __restrict__ beliefs,
            const int* __restrict__ obs, unsigned char* __restrict__ est,
            long long* __restrict__ pred, unsigned char* __restrict__ fail, int m, int n,
            int W, int P, int rank, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int groups = (m + 31) >> 5;
  const int mpad = groups << 5;
  unsigned long long* A = reinterpret_cast<unsigned long long*>(smem);   // (mpad, W)
  unsigned long long* keys = A + static_cast<size_t>(mpad) * W;
  unsigned long long* uor = keys + P;                       // (groups, W)
  unsigned long long* sol = uor + static_cast<size_t>(groups) * W;
  unsigned long long* red = sol + W;
  unsigned* gkey = reinterpret_cast<unsigned*>(red + kMaxThreads / 32);
  unsigned* gmask = gkey + groups;                          // rows holding the column
  unsigned* gunused = gmask + groups;                       // unused rows
  int* pos = reinterpret_cast<int*>(gunused + groups);      // list position, or INT_MAX
  int* list = pos + m;                                      // the unused rows
  int* pcol = list + m;                                     // a pivot row's column, or -1

  // [H | s] and its zero rows, the list of unused rows, the keys
  const int sw = n >> 6;
  const unsigned long long sbit = 1ull << (n & 63);
  const unsigned char* d = dets + static_cast<size_t>(s) * m;
  for (int i = tid; i < mpad * W; i += blockDim.x) {
    const int r = i / W;
    unsigned long long v = 0;
    if (r < m) {
      v = Hp[i];
      if (i - r * W == sw && d[r]) v |= sbit;
    }
    A[i] = v;
  }
  for (int r = tid; r < m; r += blockDim.x) {
    pos[r] = r;
    list[r] = r;
    pcol[r] = -1;
  }
  for (int w = tid; w < W; w += blockDim.x) sol[w] = 0;
  const float* bel = beliefs + static_cast<size_t>(s) * n;
  for (int c = tid; c < P; c += blockDim.x) keys[c] = c < n ? sort_key(bel[c], c) : ~0ull;
  __syncthreads();

  // ascending bitonic sort of the keys (all distinct: the index is in them)
  for (int len = 2; len <= P; len <<= 1) {
    for (int j = len >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (P >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const unsigned long long a = keys[i], b = keys[i + j];
        if ((a > b) == ((i & len) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }

  // each group's OR of its rows, all unused yet
  for (int g = warp; g < groups; g += nwarps) {
    const unsigned long long* rows = A + static_cast<size_t>(g << 5) * W;
    for (int q = lane; q < W; q += 32) {
      unsigned long long acc = 0;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) acc |= rows[static_cast<size_t>(i) * W + q];
      uor[static_cast<size_t>(g) * W + q] = acc;
    }
  }
  __syncthreads();

  // the walk, one pivot a round
  int npiv = 0, n_unused = m, ci = 0;
  while (npiv < rank) {
    // the next column of the order that an unused row holds
    int c = -1;
    for (; ci < n; ci += 32) {
      const int j = ci + lane;
      const int col = static_cast<int>(keys[j < n ? j : n - 1] & 0xffffffffu);
      const unsigned long long* uw = uor + (col >> 6);
      unsigned long long u = 0;
#pragma unroll 4
      for (int g = 0; g < groups; ++g) u |= uw[static_cast<size_t>(g) * W];
      const unsigned b = __ballot_sync(kAll, j < n && ((u >> (col & 63)) & 1ull));
      if (b) {
        const int first = __ffs(b) - 1;
        c = __shfl_sync(kAll, col, first);
        ci += first + 1;
        break;
      }
    }
    if (c < 0) break;   // not reached: rank(H) pivots come first
    const int w = c >> 6;
    const unsigned long long bit = 1ull << (c & 63);

    // each group's rows that hold it, its unused rows, its least unused holder
    for (int g = warp; g < groups; g += nwarps) {
      const int r = (g << 5) + lane;
      const bool has = (A[static_cast<size_t>(r) * W + w] & bit) != 0;   // zero rows: no
      const bool avail = r < m && pos[r] != INT_MAX;
      const unsigned mask = __ballot_sync(kAll, has);
      const unsigned unused = __ballot_sync(kAll, avail);
      const unsigned key = (has && avail)
                               ? (static_cast<unsigned>(pos[r]) << 16) | static_cast<unsigned>(r)
                               : kNone;
      const unsigned least = __reduce_min_sync(kAll, key);
      if (lane == 0) {
        gkey[g] = least;
        gmask[g] = mask;
        gunused[g] = unused;
      }
    }
    __syncthreads();

    unsigned best = kNone;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) best = min(best, gkey[g]);
    const int piv = static_cast<int>(best & 0xffffu);
    const unsigned long long* prow = A + static_cast<size_t>(piv) * W;
    // eliminate, then OR each group's unused rows anew
    for (int g = warp; g < groups; g += nwarps) {
      unsigned hit = gmask[g], unused = gunused[g];
      const bool left = g == (piv >> 5);   // the group loses the pivot row
      if (left) {
        hit &= ~(1u << (piv & 31));
        unused &= ~(1u << (piv & 31));
      }
      unsigned long long* rows = A + static_cast<size_t>(g << 5) * W;
      for (int q = lane; q < W; q += 32) {
        const unsigned long long pq = prow[q];
        if (!left && (!hit || !pq)) continue;   // no row's word q changes
        unsigned long long acc = 0;
#pragma unroll
        for (int h = 0; h < 32; h += 8) {
          unsigned long long v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = rows[static_cast<size_t>(h + i) * W + q];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if ((hit >> (h + i)) & 1u) {
              v[i] ^= pq;
              rows[static_cast<size_t>(h + i) * W + q] = v[i];
            }
            acc |= v[i] & (0ull - ((unused >> (h + i)) & 1u));
          }
        }
        uor[static_cast<size_t>(g) * W + q] = acc;
      }
    }
    if (tid == 0) {
      const int upos = static_cast<int>(best >> 16);
      const int last = list[n_unused - 1];
      list[upos] = last;
      pos[last] = upos;
      pos[piv] = INT_MAX;
      pcol[piv] = c;
    }
    --n_unused;
    ++npiv;
    __syncthreads();
  }

  // the estimate: the pivot columns whose row holds the syndrome bit
  for (int r = tid; r < m; r += blockDim.x) {
    const int c = pcol[r];
    if (c >= 0 && (A[static_cast<size_t>(r) * W + sw] & sbit))
      atomicOr(&sol[c >> 6], 1ull << (c & 63));
  }
  __syncthreads();
  unsigned long long acc = 0;
  unsigned char* e = est + static_cast<size_t>(s) * n;
  for (int c = tid; c < n; c += blockDim.x) {
    const bool one = (sol[c >> 6] >> (c & 63)) & 1ull;
    e[c] = one;
    if (one) acc ^= static_cast<unsigned long long>(obs_mask[c]);
  }
  for (int o = 16; o > 0; o >>= 1) acc ^= __shfl_xor_sync(kAll, acc, o);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    unsigned long long p = 0;
    for (int q = 0; q < nwarps; ++q) p ^= red[q];
    p &= (1ull << k) - 1;
    unsigned long long truth = 0;
    for (int b = 0; b < k; ++b)
      if (obs[static_cast<size_t>(s) * k + b]) truth |= 1ull << b;
    pred[s] = static_cast<long long>(p);
    fail[s] = p != truth;
  }
}

}  // namespace

extern "C" {

// bytes of dynamic shared memory a block takes at (m, n), INT_MAX beyond
int nqs_osd0_smem_bytes(int m, int n) {
  const size_t bytes = smem_bytes(m, n);
  return bytes < static_cast<size_t>(INT_MAX) ? static_cast<int>(bytes) : INT_MAX;
}

int nqs_osd0(const void* Hp, const void* obs_mask, const void* dets, const void* beliefs,
             const void* obs, void* est, void* pred, void* fail, int m, int n, int rank,
             int k, int S, void* stream) {
  if (m < 1 || m > 0xffff || n < 1 || rank < 0 || rank > m || rank > n || k < 0 || k > 63 ||
      S < 0)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const size_t bytes = smem_bytes(m, n);
  cudaError_t err = cudaFuncSetAttribute(
      osd0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  int threads = ((m + 31) / 32) * 32;
  threads = threads < kMinThreads ? kMinThreads : (threads > kMaxThreads ? kMaxThreads : threads);
  osd0_kernel<<<S, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(Hp), static_cast<const long long*>(obs_mask),
      static_cast<const unsigned char*>(dets), static_cast<const float*>(beliefs),
      static_cast<const int*>(obs), static_cast<unsigned char*>(est),
      static_cast<long long*>(pred), static_cast<unsigned char*>(fail), m, n, (n + 64) / 64,
      next_pow2(n), rank, k);
  return cudaGetLastError();
}

}  // extern "C"
