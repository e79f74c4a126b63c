// An empty kernel: what one launch costs on this card. No kernel can take
// less, so its time is the third term of every small kernel's bound (beside
// bytes and operations); chip_smoke.py measures it in the same run as the
// kernels it bounds.
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int nqs_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
