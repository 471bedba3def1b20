// Text of a CUDA error code, for the Python wrappers' exceptions, and the
// device limit the launch plans read (ops/_launch.py smem_limit).
#include <cuda_runtime.h>

extern "C" const char* rrtmgp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most dynamic shared memory a block of `device` may opt in to.
extern "C" int rrtmgp_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
