// Error strings for the C entry points of the kernel library: each entry
// point returns a cudaError_t, which the Python wrappers turn into a message.
#include <cuda_runtime.h>

extern "C" const char* nqs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
