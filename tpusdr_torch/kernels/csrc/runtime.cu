// Small runtime queries shared by the kernel wrappers, and the tracer's
// one-thread stamp kernel (plain C interface).

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

// The tracer's stamp (tpusdr_torch/utils/tracing.py): one thread reads the
// card's nanosecond clock (%globaltimer) and writes it to ring[row][k], ring
// (R, K) int64 in device memory.  `slot` (one uint64 in device memory)
// counts the ticks begun: the tick's first stamp (k == 0) advances it, and
// every stamp writes the row (slot - 1) % R.  Because the counter lives on
// the card, each replay of a captured graph that holds the stamps writes a
// row of its own.  It replaces no TPU kernel; its cost is one launch.
extern "C" __global__ void tpusdr_stamp_kernel(long long* ring, unsigned long long* slot,
                                               long long R, int K, int k) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long s = *slot;
  if (k == 0) *slot = ++s;
  ring[static_cast<long long>((s - 1) % static_cast<unsigned long long>(R)) * K + k] =
      static_cast<long long>(now);
}

// Launches one stamp on `stream`; returns the cudaError_t of the launch.
extern "C" int tpusdr_stamp(void* ring, void* slot, int64_t R, int K, int k, int device,
                            void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  tpusdr_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(slot), R, K, k);
  return static_cast<int>(cudaGetLastError());
}
