// Polyphase decimating FIR, complex64 data x float32 taps, float32 sums:
//
//   y[m] = sum_{u<T} h_rev[u] * x[m*D + u],  h_rev[u] = h[T-1-u],  m < M,
//
// which is K4's y[m] = sum_p frames[m+p] . h_poly[p] with frames the rows
// of D input samples and h_poly the reversed taps cut into rows of D.
//
// Replaces tpusdr/kernels/fir_pallas.py: fir_decim_pallas (_kernel), the
// gsdrFirFC case.  The TPU kernel pads each frame to 128 lanes, rounds its
// DMA window up to 8 rows and pads the output to a block multiple; none of
// that is needed here, and none is ported.
//
// What bounds it: each 8-byte input sample is read once from device memory
// and costs about 2T/D FLOP (35 FLOP at T=868, D=250; 46 at T=46, D=2), so
// 4-6 FLOP/B, far below the card's fp32 balance (~20 FLOP/B): the kernel
// is bound by memory traffic, and by launch latency at the small shapes.
// The design takes one of two forms, chosen from D by the wrapper:
//   * D >= 32 (kWarpPerOutput): one warp per output.  Its lanes run across
//     the taps, so each step loads 32 consecutive samples of x (a row of
//     the polyphase layout) in one coalesced 256-byte transaction; the
//     P = ceil(T/D) outputs that reuse a sample find it in L1/L2.  The
//     reversed taps sit in shared memory and a warp shuffle reduces the
//     32 partial sums.
//   * D < 32: one thread per output, looping over the taps; neighbouring
//     threads read samples D apart, and every thread reads the same tap
//     (a shared-memory broadcast).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void load_reversed_taps(const float* __restrict__ taps,
                                                   int T, float* hr) {
  for (int u = threadIdx.x; u < T; u += kThreads) hr[u] = taps[T - 1 - u];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    fir_poly_warp(const float2* __restrict__ x, const float* __restrict__ taps,
                  int T, int D, int64_t M, float2* __restrict__ y) {
  extern __shared__ float hr[];
  load_reversed_taps(taps, T, hr);
  const int lane = threadIdx.x & 31;
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (m >= M) return;
  const float2* xm = x + m * D;
  float ar = 0.f;
  float ai = 0.f;
#pragma unroll 4
  for (int u = lane; u < T; u += 32) {
    const float h = hr[u];
    const float2 s = xm[u];
    ar = fmaf(h, s.x, ar);
    ai = fmaf(h, s.y, ai);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ar += __shfl_xor_sync(0xffffffffu, ar, off);
    ai += __shfl_xor_sync(0xffffffffu, ai, off);
  }
  if (lane == 0) y[m] = make_float2(ar, ai);
}

__global__ void __launch_bounds__(kThreads)
    fir_poly_thread(const float2* __restrict__ x, const float* __restrict__ taps,
                    int T, int D, int64_t M, float2* __restrict__ y) {
  extern __shared__ float hr[];
  load_reversed_taps(taps, T, hr);
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const float2* xm = x + m * D;
  float ar = 0.f;
  float ai = 0.f;
#pragma unroll 4
  for (int u = 0; u < T; ++u) {
    const float h = hr[u];
    const float2 s = xm[u];
    ar = fmaf(h, s.x, ar);
    ai = fmaf(h, s.y, ai);
  }
  y[m] = make_float2(ar, ai);
}

}  // namespace

// Dynamic shared memory one block needs, in bytes (the reversed taps).
extern "C" int64_t tpusdr_fir_poly_smem(int T) {
  return static_cast<int64_t>(T) * sizeof(float);
}

// x holds at least (M-1)*D + T samples.  warp_per_output selects the form
// (the wrapper passes D >= 32).  Launches on `stream`; returns the
// cudaError_t of the launch (0 = ok).
extern "C" int tpusdr_fir_poly(const void* x, const void* taps, int T, int D,
                               int64_t M, int warp_per_output, void* y,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0) return cudaSuccess;
  const int64_t smem = tpusdr_fir_poly_smem(T);
  auto kernel = warp_per_output ? fir_poly_warp : fir_poly_thread;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t per_block = warp_per_output ? kWarps : kThreads;
  const int64_t blocks = (M + per_block - 1) / per_block;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(taps), T, D, M,
      static_cast<float2*>(y));
  return static_cast<int>(cudaGetLastError());
}
