// The circuit sampler's fault walk: one launch a sample, one thread a shot
// (or a share of a shot's draws).
//
// Replaces no Pallas kernel: the reference's sampler is XLA uniforms plus one
// int8 matmul (noisyquantumsimulator_tpu/qec/fast_sampler.py). The port's op
// route (qec/fast_sampler.py `op_route`: uniforms, compares, 0/1 float32
// products with the sites' signature matrices) is the twin, which every device
// but CUDA takes. Fed the op route's uniforms (`given`), the kernel gives its
// detectors, observables and heralds bit for bit.
//
// Contract (the draw table of fast_sampler._draw_table; S shots; n_out =
// n_det + n_obs + ne output columns):
//
//   rec (n_draws, 4) int32    kind | b0 << 3, then the float32 bits of the
//                             hit threshold t and of a, b
//   cum (n_pair, 15) f32      PAULI_CHANNEL_2's cumulative tables
//   sig_ptr, sig_col int32    each fault bit's signature (CSR): its output
//                             columns, detectors then n_det + observables
//   key (2,) int64            Philox's key (the low 32 bits of each), drawn
//                             on the card
//   u (S, n_draws) f32,       given: the draws and the erasures' two bits
//   ebits (S, ne, 2) uint8
//   dets (S, n_det), obs (S, n_obs), heralds (S, ne) uint8: out
//
// A draw u of kind k sets fault bits b0 + j * stride[k]:
//   Bernoulli         bit 0 if u < t
//   DEPOLARIZE1       x (j = 0) if u < a = 2p/3; z (j = 1) if b = p/3 <= u < t = p
//   DEPOLARIZE2       on u < t = p the outcome o = min(floor(u / p * 15) + 1, 15)
//                     (IEEE division and product, as the op route's torch
//                     ops), then xa, za, xb, zb of the Paulis o / 4 and o % 4
//                     (1 X, 2 Y, 3 Z)
//   PAULI_CHANNEL_2   on u < t = cum[14], o = 1 + #{i : u >= cum[i]}, as above
//   ERASE             on u < t the herald (column n_det + n_obs + a), and the
//                     x and z bits by two more random bits
// Without `given`, draw d of shot s is word d % 4 of Philox4x32-10 at counter
// (d / 4, s, 0, 0): u is its high 24 bits times 2^-24 (as torch.rand makes a
// float32), an erasure's bits are its bits 0 and 1.
//
// What bounds it on the H100: integer operations. The work is one
// Philox4x32-10 call (10 rounds of two 32 x 32-bit products and four XORs,
// ~70 integer operations) per four draws of a shot and a compare per draw: 34 M
// calls in a gross-code step (65536 shots x 2088 draws), 84 M at d = 7 (131072
// x 2576), ~0.1 / 0.25 ms on the integer pipes. Hits are rare (p ~ 1e-3) and
// flip at most 3 detector columns each. The bytes are the uint8 rows, 19.7 /
// 25.3 MB a step, 6-8 us at 3.35 TB/s.
//
// Design: every lane of a warp walks the same draw sequence for its own shot,
// so a table entry (16 bytes, through the read-only cache) is one broadcast
// load. A shot's parities live in a bitset in shared memory, word w of the
// block's shot r at [w * block_shots + r] (a warp's 32 shots on 32 banks),
// touched only on a hit. At the end the block writes its shots' rows,
// contiguous in each output, coalesced from the bitsets. Where a call has
// fewer than 2^18 shots, a shot's draws are split over 2-8 threads, each a
// whole number of Philox groups, which XOR into the shot's bitset with
// shared-memory atomics, so the card runs enough warps to hide latency. The
// Philox counter is (draw / 4, shot): the result depends on neither the split
// nor the block size.
#include <cuda_runtime.h>

namespace {

enum Kind { kBern = 0, kDep1 = 1, kDep2 = 2, kPair = 3, kErase = 4 };
constexpr int kMaxThreads = 256;
constexpr float kTwoPow24Inv = 5.9604644775390625e-8f;   // 2^-24

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const unsigned hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

// one shot's bitset and the signatures it XORs in
struct Bitset {
  unsigned* word0;   // the shot's word 0; word w at word0[w * ld]
  int ld;
  const int* sig_ptr;
  const int* sig_col;

  __device__ __forceinline__ void flip(int c) const {
    atomicXor(word0 + (c >> 5) * ld, 1u << (c & 31));
  }
  __device__ __forceinline__ void flip_bit(int b) const {
    const int end = __ldg(sig_ptr + b + 1);
    for (int j = __ldg(sig_ptr + b); j < end; ++j) flip(__ldg(sig_col + j));
  }
  // bits xa, za, xb, zb of the two-qubit Pauli o (1..15)
  __device__ __forceinline__ void pauli_pair(int o, int b0, int stride) const {
    const int pa = o >> 2, pb = o & 3;
    if (pa == 1 || pa == 2) flip_bit(b0);
    if (pa >= 2) flip_bit(b0 + stride);
    if (pb == 1 || pb == 2) flip_bit(b0 + 2 * stride);
    if (pb >= 2) flip_bit(b0 + 3 * stride);
  }
};

// the rows [row0, row0 + rows) of one (S, n) output, columns c0.. of the bitsets
__device__ __forceinline__ void write_rows(unsigned char* __restrict__ out, int n, int c0,
                                           const unsigned* bits, int ld, long long row0,
                                           int rows) {
  if (n == 0) return;
  unsigned char* base = out + row0 * n;
  const int total = rows * n;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / n, c = c0 + (i - r * n);
    base[i] = static_cast<unsigned char>((bits[(c >> 5) * ld + r] >> (c & 31)) & 1u);
  }
}

template <bool kGiven>
__global__ void __launch_bounds__(kMaxThreads)
fault_walk_kernel(const int4* __restrict__ rec, const float* __restrict__ cum,
                  const int* __restrict__ sig_ptr, const int* __restrict__ sig_col,
                  const long long* __restrict__ key, const float* __restrict__ u_given,
                  const unsigned char* __restrict__ ebits_given,
                  unsigned char* __restrict__ dets, unsigned char* __restrict__ obs,
                  unsigned char* __restrict__ heralds, int n_draws, int n_det, int n_obs,
                  int ne, int4 stride, int shots, int block_shots, int span) {
  extern __shared__ unsigned bits[];   // (words, block_shots)
  const int tid = threadIdx.x;
  const int r = tid % block_shots, part = tid / block_shots;
  const long long row0 = static_cast<long long>(blockIdx.x) * block_shots;
  const long long shot = row0 + r;
  const int words = (n_det + n_obs + ne + 31) >> 5;
  for (int i = tid; i < words * block_shots; i += blockDim.x) bits[i] = 0u;
  __syncthreads();

  if (shot < shots) {
    const Bitset set{bits + r, block_shots, sig_ptr, sig_col};
    uint2 k = make_uint2(0u, 0u);
    if (!kGiven) k = make_uint2(static_cast<unsigned>(key[0]), static_cast<unsigned>(key[1]));
    const int d0 = part * span;
    const int d1 = min(n_draws, d0 + span);
    for (int d = d0; d < d1; d += 4) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (!kGiven)
        x = philox4x32_10(
            make_uint4(static_cast<unsigned>(d >> 2), static_cast<unsigned>(shot), 0u, 0u), k);
      const unsigned xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int dj = d + j;
        if (dj >= d1) break;
        const int4 e = __ldg(rec + dj);
        const float u = kGiven ? u_given[shot * n_draws + dj]
                               : static_cast<float>(xs[j] >> 8) * kTwoPow24Inv;
        if (u < __int_as_float(e.y)) {           // a hit: rare
          const int b0 = e.x >> 3;
          switch (e.x & 7) {
            case kBern:
              set.flip_bit(b0);
              break;
            case kDep1:
              if (u < __int_as_float(e.z)) set.flip_bit(b0);
              if (u >= __int_as_float(e.w)) set.flip_bit(b0 + stride.x);
              break;
            case kDep2: {
              const float q =
                  __fmul_rn(__fdiv_rn(u, fmaxf(__int_as_float(e.y), 1e-30f)), 15.0f);
              set.pauli_pair(min(static_cast<int>(floorf(q)) + 1, 15), b0, stride.y);
              break;
            }
            case kPair: {
              const float* c = cum + 15 * static_cast<long long>(e.z);
              int o = 1;
#pragma unroll
              for (int i = 0; i < 15; ++i) o += u >= __ldg(c + i);
              set.pauli_pair(o, b0, stride.z);
              break;
            }
            default: {                             // kErase
              set.flip(n_det + n_obs + e.z);
              unsigned xb, zb;
              if (kGiven) {
                const unsigned char* eb = ebits_given + (shot * ne + e.z) * 2;
                xb = eb[0];
                zb = eb[1];
              } else {
                xb = xs[j] & 1u;
                zb = xs[j] & 2u;
              }
              if (xb) set.flip_bit(b0);
              if (zb) set.flip_bit(b0 + stride.w);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  const long long left = shots - row0;
  const int rows = left < block_shots ? static_cast<int>(left) : block_shots;
  write_rows(dets, n_det, 0, bits, block_shots, row0, rows);
  write_rows(obs, n_obs, n_det, bits, block_shots, row0, rows);
  write_rows(heralds, ne, n_det + n_obs, bits, block_shots, row0, rows);
}

}  // namespace

extern "C" {

int nqs_fault_walk(const void* rec, const void* cum, const void* sig_ptr, const void* sig_col,
                   const void* key, const void* u, const void* ebits, void* dets, void* obs,
                   void* heralds, int given, int n_draws, int n_det, int n_obs, int ne,
                   int st_dep1, int st_dep2, int st_pair, int st_erase, int shots,
                   int block_shots, int split, int span, void* stream) {
  if (n_draws < 0 || n_det < 0 || n_obs < 0 || ne < 0 || shots < 0 || block_shots < 32 ||
      block_shots % 32 != 0 || split < 1 || block_shots * split > kMaxThreads || span < 0 ||
      span % 4 != 0 || static_cast<long long>(span) * split < n_draws)
    return cudaErrorInvalidValue;
  if (n_draws > 0 && (rec == nullptr || (given ? u == nullptr : key == nullptr)))
    return cudaErrorInvalidValue;
  if (shots == 0) return cudaSuccess;
  const size_t words = (static_cast<size_t>(n_det) + n_obs + ne + 31) / 32;
  const size_t bytes = 4 * words * block_shots;
  const int4 stride = make_int4(st_dep1, st_dep2, st_pair, st_erase);
  const unsigned blocks = static_cast<unsigned>((shots + block_shots - 1) / block_shots);
  const int threads = block_shots * split;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (given) {
    err = cudaFuncSetAttribute(fault_walk_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    fault_walk_kernel<true><<<blocks, threads, bytes, s>>>(
        static_cast<const int4*>(rec), static_cast<const float*>(cum),
        static_cast<const int*>(sig_ptr), static_cast<const int*>(sig_col),
        static_cast<const long long*>(key), static_cast<const float*>(u),
        static_cast<const unsigned char*>(ebits), static_cast<unsigned char*>(dets),
        static_cast<unsigned char*>(obs), static_cast<unsigned char*>(heralds), n_draws, n_det,
        n_obs, ne, stride, shots, block_shots, span);
  } else {
    err = cudaFuncSetAttribute(fault_walk_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    fault_walk_kernel<false><<<blocks, threads, bytes, s>>>(
        static_cast<const int4*>(rec), static_cast<const float*>(cum),
        static_cast<const int*>(sig_ptr), static_cast<const int*>(sig_col),
        static_cast<const long long*>(key), static_cast<const float*>(u),
        static_cast<const unsigned char*>(ebits), static_cast<unsigned char*>(dets),
        static_cast<unsigned char*>(obs), static_cast<unsigned char*>(heralds), n_draws, n_det,
        n_obs, ne, stride, shots, block_shots, span);
  }
  return cudaGetLastError();
}

}  // extern "C"
