// Normalized min-sum check-to-variable update of slot-layout BP (kernel K3).
//
// Replaces the Pallas TPU kernel `_c2v_kernel` / its caller `c2v_pallas`
// (noisyquantumsimulator_tpu/qec/bp_kernels.py). Same contract as the slab
// form of ldpc._bp_slots.c2v:
//
//   msg (w, n_chk, S) slot-major, shots last; sgn_syn (n_chk, S) in {+1, -1}.
//   For every (check c, shot s) column over its w slots:
//     min1 = min |m_i|, cnt = #{i : |m_i| == min1},
//     min2 = min over the slots that are not minima (the padding value if none),
//     prod = sgn_syn[c, s] * prod_i sgn(m_i)          (sgn(x) = -1 iff x < 0)
//     out_i = scale * prod * sgn(m_i) * (min2 if |m_i| == min1 and cnt == 1
//                                         else min1)
//   Padding slots hold +1e30 in the storage type. They are ordinary values
//   here: they never win the minimum and their sign is +1.
//
// Arithmetic is float32; storage is float32 or bfloat16. Values are upcast
// with __bfloat162float and the result is rounded once with
// __float2bfloat16_rn, the rounding of torch's .to(torch.bfloat16). `scale`
// and the min2 start value are first rounded to the storage type, as the
// plain twin (qec/bp_cuda._c2v_plain) holds them in that type. Every factor
// but one is +-1 or a storage-type value, so the single product rounds the
// same way in both and the kernel is bit-exact against its twin.
//
// What bounds it on the H100: bytes. Per column it reads w messages and one
// syndrome sign and writes w extrinsics, and does ~10 flops per message. At
// the BB gross-code shape (26, 288, 65536) in bfloat16 that is 0.98 GB in,
// 0.98 GB out and 38 MB of signs per call: ~0.6 ms at 3.35 TB/s.
//
// Design: one thread per (check, shot) column, neighbouring threads on
// neighbouring shots, so every slot's load and store is coalesced across
// the warp. The column's w <= kMaxSlots values stay in registers between
// the two passes (fully unrolled loops with compile-time indices), so the
// messages are read from device memory once and written once. Any n_chk and
// any S: the ragged last block of shots is masked, and checks beyond the
// grid's y extent are walked with a stride. Wider (vector) loads, fusing the
// variable-side gathers of the next half-iteration, and TMA are left out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 32;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
c2v_kernel(const T* __restrict__ msg, const T* __restrict__ sgn_syn, T* __restrict__ out,
           int w, int n_chk, int S, float scale) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= S) return;
  const float sc = to_f32(from_f32<T>(scale));
  const float big = to_f32(from_f32<T>(1e30f));
  const size_t plane = (size_t)n_chk * S;   // distance between two slots

  for (int c = blockIdx.y; c < n_chk; c += gridDim.y) {
    const size_t col = (size_t)c * S + s;
    float v[kMaxSlots];
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i)
      if (i < w) v[i] = to_f32(msg[col + i * plane]);

    // pass 1: running min1, min2, count of minima, sign product
    float mag1 = fabsf(v[0]);
    float mag2 = big;
    int cnt = 1;
    float prod = v[0] < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int i = 1; i < kMaxSlots; ++i) {
      if (i < w) {
        const float mag = fabsf(v[i]);
        const bool lt = mag < mag1;
        const bool eq = mag == mag1;
        // on ties min2 drifts to min1; unobservable, as cnt > 1 then
        mag2 = lt ? mag1 : fminf(mag2, mag);
        mag1 = lt ? mag : mag1;
        cnt = lt ? 1 : (eq ? cnt + 1 : cnt);
        prod = v[i] < 0.0f ? -prod : prod;
      }
    }
    prod *= to_f32(sgn_syn[col]);
    const float sp = sc * prod;
    const bool unique = cnt == 1;

    // pass 2: every slot's extrinsic
#pragma unroll
    for (int i = 0; i < kMaxSlots; ++i) {
      if (i < w) {
        const float mag = fabsf(v[i]);
        const float ext = (unique && mag == mag1) ? mag2 : mag1;
        const float sgn_sp = v[i] < 0.0f ? -sp : sp;
        out[col + i * plane] = from_f32<T>(sgn_sp * ext);
      }
    }
  }
}

template <typename T>
int launch_c2v(const void* msg, const void* sgn_syn, void* out, int w, int n_chk, int S,
               float scale, cudaStream_t stream) {
  if (w < 1 || w > kMaxSlots || n_chk < 0 || S < 0) return cudaErrorInvalidValue;
  if (n_chk == 0 || S == 0) return cudaSuccess;
  const dim3 grid((S + kThreads - 1) / kThreads, n_chk < kMaxGridY ? n_chk : kMaxGridY);
  c2v_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(msg), static_cast<const T*>(sgn_syn), static_cast<T*>(out), w,
      n_chk, S, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nqs_bp_c2v_max_slots() { return kMaxSlots; }

int nqs_bp_c2v_f32(const void* msg, const void* sgn_syn, void* out, int w, int n_chk, int S,
                   float scale, void* stream) {
  return launch_c2v<float>(msg, sgn_syn, out, w, n_chk, S, scale,
                           static_cast<cudaStream_t>(stream));
}

int nqs_bp_c2v_bf16(const void* msg, const void* sgn_syn, void* out, int w, int n_chk, int S,
                    float scale, void* stream) {
  return launch_c2v<__nv_bfloat16>(msg, sgn_syn, out, w, n_chk, S, scale,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
