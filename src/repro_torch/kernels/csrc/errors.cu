// Text of a CUDA error code, for the Python wrappers' exceptions; and an
// empty kernel, which chip_smoke.py times beside each kernel as the card's
// launch floor.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One block of 32 threads that does nothing, on `stream`.
extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
