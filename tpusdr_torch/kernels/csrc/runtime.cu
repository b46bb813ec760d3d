// Small runtime queries shared by the kernel wrappers (plain C interface).

#include <cuda_runtime.h>

#include <cstdint>

extern "C" int64_t tpusdr_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}

extern "C" const char* tpusdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
