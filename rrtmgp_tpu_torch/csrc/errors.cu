// Text of a CUDA error code, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* rrtmgp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
