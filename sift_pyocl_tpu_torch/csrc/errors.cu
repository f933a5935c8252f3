// Error text for the codes the launchers return (cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* sift_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
