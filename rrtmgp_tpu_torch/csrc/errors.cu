// Text of a CUDA error code, for the Python wrappers' exceptions, and the
// device limits the launch plans read (ops/_launch.py smem_limit and
// max_threads).
#include <cuda_runtime.h>

#include <cstring>

namespace rrtmgp {

// Each kernel's block limit (defined beside the kernel): the most threads a
// block of its instance `variant` may have on the current device.
cudaError_t lw_clear_mega_max_threads(int variant, int* threads);
cudaError_t sw_clear_mega_max_threads(int variant, int* threads);
cudaError_t lw2_mega_max_threads(int variant, int* threads);
cudaError_t mcica_export_max_threads(int variant, int* threads);
cudaError_t optics_fused_max_threads(int variant, int* threads);
cudaError_t interp_pt_eta_max_threads(int variant, int* threads);
cudaError_t interp_minor_max_threads(int variant, int* threads);
cudaError_t lw_noscat_banded_max_threads(int variant, int* threads);
cudaError_t lw_noscat_reduced_max_threads(int variant, int* threads);
cudaError_t lw_noscat_gpt_max_threads(int variant, int* threads);
cudaError_t lw_2stream_reduced_max_threads(int variant, int* threads);
cudaError_t sw_2stream_reduced_max_threads(int variant, int* threads);
cudaError_t sw_2stream_gpt_max_threads(int variant, int* threads);

}  // namespace rrtmgp

extern "C" const char* rrtmgp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The most dynamic shared memory a block of `device` may opt in to.
extern "C" int rrtmgp_smem_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// The most threads a block of `kernel` (its wrapper's name in ops/) may have
// on `device`: cudaFuncAttributes.maxThreadsPerBlock of the instance
// `variant` (what it means is the kernel's: see its *_max_threads), the
// smaller of its variants with the level sums in the block and split.
// cudaErrorInvalidValue for a name not listed here.
extern "C" int rrtmgp_max_threads(const char* kernel, int variant, int device, int* threads) {
  using namespace rrtmgp;
  static const struct {
    const char* name;
    cudaError_t (*query)(int, int*);
  } kernels[] = {
      {"lw_clear_mega", lw_clear_mega_max_threads},
      {"sw_clear_mega", sw_clear_mega_max_threads},
      {"lw2_mega", lw2_mega_max_threads},
      {"mcica_mask_export", mcica_export_max_threads},
      {"optics_fused", optics_fused_max_threads},
      {"interp_pt_eta", interp_pt_eta_max_threads},
      {"interp_minor", interp_minor_max_threads},
      {"lw_noscat_banded", lw_noscat_banded_max_threads},
      {"lw_noscat_reduced", lw_noscat_reduced_max_threads},
      {"lw_noscat_gpt", lw_noscat_gpt_max_threads},
      {"lw_2stream_reduced", lw_2stream_reduced_max_threads},
      {"sw_2stream_reduced", sw_2stream_reduced_max_threads},
      {"sw_2stream_gpt", sw_2stream_gpt_max_threads},
  };
  int current;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaErrorInvalidValue;
  for (const auto& k : kernels) {
    if (std::strcmp(k.name, kernel) == 0) {
      err = k.query(variant, threads);
      break;
    }
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
