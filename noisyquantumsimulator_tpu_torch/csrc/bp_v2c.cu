// Min-sum variable-to-check update of slot-layout BP, the beliefs included.
//
// Replaces no Pallas kernel: the reference leaves this half-iteration of
// ldpc._bp_slots to XLA (noisyquantumsimulator_tpu/qec/ldpc.py, `v2c`), a
// row gather, a sum, a gather back and a mask. Done as torch ops on the card
// that is seven passes over (Ec, S) tensors (a cat with the sentinel row, two
// gathers, the sum, the add, the subtract, the padding's `where`): ~10 GB a
// pass at the gross code's shape, where the work reads each edge's message
// once and writes each edge's message once. The plain twin is
// qec/bp_cuda._v2c_plain.
//
// Contract (the variable side of ldpc._bp_slots; Ec = w_max * n_chk):
//
//   c2v (Ec, S)        K3's check-to-variable messages in the check layout,
//                      shots last
//   llr (n_var,)       the priors in the storage type
//   cpos (n_var, d)    int64 check-layout positions of each variable's edges
//                      in slot order; the value Ec marks an empty slot
//   out                messages mode: the (Ec, S) variable-to-check messages,
//                      updated in place at the variables' edges (the check
//                      layout's padding rows are never read or written);
//                      beliefs mode: the (n_var, S) beliefs
//
//   For every (variable v, shot s), with R() the rounding to the storage type:
//     t     = R(sum over v's edges j, in slot order, of c2v[cpos[v, j], s])
//     total = R(llr[v] + t)                          (the belief)
//     new_j = R(total - c2v[cpos[v, j], s])           (each edge's message)
//     out   = new_j, or with damping g > 0 R(R((1 - g) * new_j) + R(g * old_j))
//
// The sum is float32 (as torch's bf16 sum accumulates), and every later
// operation is one float32 operation rounded once, at the points where the
// twin's torch ops round: the results are bit-equal to the twin's where the
// twin sums the <= d values in slot order. Products and sums are written with
// the _rn intrinsics, so no multiply-add is contracted into an FMA that the
// twin does not make. (1 - g) and g come from the host as float32, as torch
// casts a Python scalar.
//
// What bounds it on the H100: bytes. Per edge and shot it reads one c2v
// message and writes one message (and reads the old one when damped); per
// variable one prior and d indices, shared by the block. At the gross code's
// fast tier (5283 edges, 65536 shots, bf16) that is 1.38 GB a pass: ~0.41 ms
// at 3.35 TB/s.
//
// Design: one thread per (variable, shot), kShots shots a thread, strided by
// the block's width, so neighbouring threads hold neighbouring shots and
// every row access is coalesced. The block's variable is blockIdx.y
// (variables beyond the grid's y extent are walked with a stride); its <= d
// positions are loaded once into registers. The thread loads all its
// messages before it sums, keeping several loads in flight, and keeps them
// in registers between the sum and the writes. Compile-time degree tiers (4
// and kMaxDegree) keep the registers of the common low-degree graphs small:
// on an H100 80GB HBM3 at 700 W the kMaxDegree instantiation alone (148-160
// registers, against 32) took 4.213 ms for the fast tier's pass below and
// 0.0426 ms for the retry tier's, against 0.592 and 0.0181 ms with the tier
// at 4.
// Two shots a thread: on an H100 80GB HBM3 at 700 W, 1 / 2 / 4 took 0.706 /
// 0.592 / 0.547 ms for the fast tier's pass above and 0.0205 / 0.0178 /
// 0.0272 ms for the retry tier's (512 shots, float32, damped), so 2 costs the
// least over a BB step's 7 + 91 launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 16;
constexpr int kLowDegree = 4;
constexpr int kThreads = 256;
constexpr int kShots = 2;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the storage type, back in float32
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
v2c_kernel(const T* __restrict__ c2v, const T* __restrict__ llr,
           const long long* __restrict__ cpos, T* __restrict__ out, int d, int n_var,
           int Ec, int S, float keep_new, float keep_old, int damped, int beliefs) {
  const int s0 = blockIdx.x * (kThreads * kShots) + threadIdx.x;
  if (s0 >= S) return;

  for (int v = blockIdx.y; v < n_var; v += gridDim.y) {
    int row[D];
#pragma unroll
    for (int j = 0; j < D; ++j)
      row[j] = j < d ? static_cast<int>(cpos[(size_t)v * d + j]) : Ec;
    const float lv = to_f32(llr[v]);

    float m[kShots][D];
#pragma unroll
    for (int k = 0; k < kShots; ++k) {
      const int s = s0 + k * kThreads;
#pragma unroll
      for (int j = 0; j < D; ++j)
        m[k][j] = (row[j] < Ec && s < S) ? to_f32(c2v[(size_t)row[j] * S + s]) : 0.0f;
    }

#pragma unroll
    for (int k = 0; k < kShots; ++k) {
      const int s = s0 + k * kThreads;
      if (s >= S) break;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < D; ++j)
        if (row[j] < Ec) acc = __fadd_rn(acc, m[k][j]);
      const float total = rnd<T>(__fadd_rn(lv, rnd<T>(acc)));
      if (beliefs) {
        out[(size_t)v * S + s] = from_f32<T>(total);
        continue;
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (row[j] < Ec) {
          const size_t at = (size_t)row[j] * S + s;
          float nv = rnd<T>(__fsub_rn(total, m[k][j]));
          if (damped)
            nv = __fadd_rn(rnd<T>(__fmul_rn(keep_new, nv)),
                           rnd<T>(__fmul_rn(keep_old, to_f32(out[at]))));
          out[at] = from_f32<T>(nv);
        }
      }
    }
  }
}

template <typename T>
int launch_v2c(const void* c2v, const void* llr, const void* cpos, void* out, int d,
               int n_var, int Ec, int S, float keep_new, float keep_old, int damped,
               int beliefs, cudaStream_t stream) {
  if (d < 1 || d > kMaxDegree || n_var < 0 || Ec < 0 || S < 0) return cudaErrorInvalidValue;
  if (n_var == 0 || S == 0) return cudaSuccess;
  const dim3 grid((S + kThreads * kShots - 1) / (kThreads * kShots),
                  n_var < kMaxGridY ? n_var : kMaxGridY);
  const T* c = static_cast<const T*>(c2v);
  const T* l = static_cast<const T*>(llr);
  const long long* p = static_cast<const long long*>(cpos);
  T* o = static_cast<T*>(out);
  if (d <= kLowDegree)
    v2c_kernel<T, kLowDegree><<<grid, kThreads, 0, stream>>>(
        c, l, p, o, d, n_var, Ec, S, keep_new, keep_old, damped, beliefs);
  else
    v2c_kernel<T, kMaxDegree><<<grid, kThreads, 0, stream>>>(
        c, l, p, o, d, n_var, Ec, S, keep_new, keep_old, damped, beliefs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int nqs_bp_v2c_max_degree() { return kMaxDegree; }

int nqs_bp_v2c_f32(const void* c2v, const void* llr, const void* cpos, void* out, int d,
                   int n_var, int Ec, int S, float keep_new, float keep_old, int damped,
                   int beliefs, void* stream) {
  return launch_v2c<float>(c2v, llr, cpos, out, d, n_var, Ec, S, keep_new, keep_old,
                           damped, beliefs, static_cast<cudaStream_t>(stream));
}

int nqs_bp_v2c_bf16(const void* c2v, const void* llr, const void* cpos, void* out, int d,
                    int n_var, int Ec, int S, float keep_new, float keep_old, int damped,
                    int beliefs, void* stream) {
  return launch_v2c<__nv_bfloat16>(c2v, llr, cpos, out, d, n_var, Ec, S, keep_new,
                                   keep_old, damped, beliefs,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
