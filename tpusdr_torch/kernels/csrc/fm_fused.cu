// Fused NCO mix -> decimating real-tap FIR -> FM discriminator.
//
// Replaces tpusdr/kernels/fm_pallas.py: fused_fm_demod_pallas (_kernel).
// Contract (fm_pallas.py:18-20): ext of length (T-1) + (M+1)*D gives M
// outputs
//
//   u[n]  = ext[n] * exp(j * float(phase0 + n*inc mod 2^32) * 2pi/2^32)
//   v[k]  = sum_{u<T} h_rev[u] * u[k*D + u]
//   y[m]  = gain * atan2(v[m+1] * conj(v[m])).
//
// The NCO phase is uint32 arithmetic, so it wraps exactly; the angle is
// (float)phase * 2pi/2^32 as in tpusdr_torch/ops/osc.py.  atan2f replaces
// the TPU kernel's polynomial atan (a Mosaic workaround, not ported).
//
// What bounds it: the real-tap MAC costs about 2T/D FLOP per input sample
// plus one sincosf, and the discriminator is one atan2f per output, so it
// runs on the CUDA cores (tensor cores have nothing to do here).  The
// design: one block per tile of kOut outputs; the mixed window of the
// tile (kOut*D + T samples) and the reversed taps sit in shared memory,
// each warp filters kPerWarp samples at once (one tap load per kPerWarp
// MACs, lanes split the taps, warp-shuffle reduction), the kOut+1
// filtered samples stay in shared memory for the discriminator, and only
// the audio-rate outputs are written.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOut = 63;        // discriminator outputs per block
constexpr int kV = kOut + 1;    // filtered samples per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = kV / kWarps;
constexpr float kPhaseScale =
    static_cast<float>(6.283185307179586 / 4294967296.0);  // 2pi / 2^32

int64_t window_len(int T, int D) {
  return static_cast<int64_t>(kV - 1) * D + T;
}

__global__ void __launch_bounds__(kThreads)
    fm_fused_kernel(const float2* __restrict__ ext, int64_t L,
                    const float* __restrict__ taps, int T, int D,
                    uint32_t inc, uint32_t phase0, float gain, int64_t M,
                    float* __restrict__ out) {
  extern __shared__ float2 smem[];
  const int W = (kV - 1) * D + T;
  float2* win = smem;
  float2* v = win + W;
  float* hr = reinterpret_cast<float*>(v + kV);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kOut;
  const int64_t base = m0 * D;

  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int64_t n = base + i;
    float2 u = make_float2(0.f, 0.f);
    if (n < L) {
      const float2 s = ext[n];
      const uint32_t ph = phase0 + static_cast<uint32_t>(n) * inc;
      float sn, cs;
      sincosf(static_cast<float>(ph) * kPhaseScale, &sn, &cs);
      u = make_float2(s.x * cs - s.y * sn, s.x * sn + s.y * cs);
    }
    win[i] = u;
  }
  for (int u = threadIdx.x; u < T; u += kThreads) hr[u] = taps[T - 1 - u];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j0 = warp * kPerWarp;
  const float2* wj = win + j0 * D;
  float ar[kPerWarp];
  float ai[kPerWarp];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    ar[j] = 0.f;
    ai[j] = 0.f;
  }
  for (int u = lane; u < T; u += 32) {
    const float h = hr[u];
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const float2 s = wj[j * D + u];
      ar[j] = fmaf(h, s.x, ar[j]);
      ai[j] = fmaf(h, s.y, ai[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ar[j] += __shfl_xor_sync(0xffffffffu, ar[j], off);
      ai[j] += __shfl_xor_sync(0xffffffffu, ai[j], off);
    }
  }
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    if (lane == j) v[j0 + j] = make_float2(ar[j], ai[j]);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kOut; t += kThreads) {
    const int64_t m = m0 + t;
    if (m < M) {
      const float2 a = v[t + 1];
      const float2 b = v[t];
      const float pr = a.x * b.x + a.y * b.y;
      const float pi = a.y * b.x - a.x * b.y;
      // + 0.0f: arg(0) = 0 (atan2f(+-0, -0) would give +-pi); see
      // tpusdr_torch/ops/demod.py arg()
      out[m] = gain * atan2f(pi, pr + 0.0f);
    }
  }
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.
extern "C" int64_t tpusdr_fm_fused_smem(int T, int D) {
  return (window_len(T, D) + kV) * static_cast<int64_t>(sizeof(float2)) +
         static_cast<int64_t>(T) * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int tpusdr_fm_fused(const void* ext, int64_t L, const void* taps,
                               int T, int D, uint32_t inc, uint32_t phase0,
                               float gain, int64_t M, void* out, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0) return cudaSuccess;
  const int64_t smem = tpusdr_fm_fused_smem(T, D);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fm_fused_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (M + kOut - 1) / kOut;
  fm_fused_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(ext), L, static_cast<const float*>(taps), T,
      D, inc, phase0, gain, M, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
