// The CUDA runtime's message for an error code returned by a launcher,
// so the Python wrappers can raise with it.
#include <cuda_runtime.h>

extern "C" const char* rk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
