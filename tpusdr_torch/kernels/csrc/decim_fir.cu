// Decimating complex FIR over a virtual concatenation s = [hist, x]:
//
//   y[m] = sum_{u<T} h_rev[u] * s[s0 + m*D + u],   m < M,
//
// with s read through two pointers, so no history is ever copied in front
// of the block.  Complex64 data, real or complex taps, float32 sums.
//
// Replaces both banded TPU kernels of tpusdr/kernels/fir_banded_pallas.py:
//   * banded_fir_pallas (_kernel), the history form: s0 = 0;
//   * banded_fir_prelude (_kernel_prelude), the zero-copy streaming form:
//     hist = 8 carried rows of G = 128*D samples, s0 = 8G - (T-1).
// On the TPU both are banded matmuls on the MXU with a manual bf16 hi/lo
// split; that split is a TPU workaround and is not ported.  Here the FIR is
// plain fp32 FMA on the CUDA cores.
//
// What bounds it: at the main shape (T=546, D=50, complex folded-shift
// taps) each 8-byte input sample costs about 546/50 * 8 ~ 87 FLOP, about
// 11 FLOP/B -- near the card's fp32 CUDA-core balance (67 TFLOP/s over
// 3.35 TB/s ~ 20 FLOP/B), so a simple kernel is bound by FMA issue and
// shared-memory loads as much as by device-memory bytes.  The design:
// one block per tile of kTile outputs; the tile's input window and the
// reversed taps sit in shared memory (one coalesced read of the signal,
// window overlap (T-D)/(kTile*D) ~ 15% at the main shape); each warp owns
// kPerWarp outputs at once, so one tap load feeds kPerWarp MACs; lanes
// split the tap loop and the partial sums are reduced with warp shuffles.
// A tensor-core banded form (3xTF32 or fp32) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 64;  // outputs per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = kTile / kWarps;  // outputs per warp, in registers

int64_t window_len(int T, int D) {
  return static_cast<int64_t>(kTile - 1) * D + T;
}

template <bool kComplexTaps>
__global__ void __launch_bounds__(kThreads)
    decim_fir_kernel(const float2* __restrict__ hist, int64_t H,
                     const float2* __restrict__ x, int64_t N,
                     const void* __restrict__ taps, int T, int D, int64_t s0,
                     int64_t M, float2* __restrict__ y) {
  extern __shared__ float2 smem[];
  const int W = (kTile - 1) * D + T;
  float2* win = smem;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t base = s0 + m0 * D;
  const int64_t S = H + N;

  // The tile's window of s, zero past either end (masks the ragged tile).
  for (int i = threadIdx.x; i < W; i += kThreads) {
    const int64_t g = base + i;
    float2 v = make_float2(0.f, 0.f);
    if (g >= 0 && g < H) {
      v = hist[g];
    } else if (g >= H && g < S) {
      v = x[g - H];
    }
    win[i] = v;
  }
  // Reversed taps after the window.
  if constexpr (kComplexTaps) {
    float2* hr = win + W;
    const float2* h = static_cast<const float2*>(taps);
    for (int u = threadIdx.x; u < T; u += kThreads) hr[u] = h[T - 1 - u];
  } else {
    float* hr = reinterpret_cast<float*>(win + W);
    const float* h = static_cast<const float*>(taps);
    for (int u = threadIdx.x; u < T; u += kThreads) hr[u] = h[T - 1 - u];
  }
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
    if constexpr (kComplexTaps) {
      const float2 h = (win + W)[u];
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const float2 s = wj[j * D + u];
        ar[j] = fmaf(h.x, s.x, ar[j]);
        ar[j] = fmaf(-h.y, s.y, ar[j]);
        ai[j] = fmaf(h.x, s.y, ai[j]);
        ai[j] = fmaf(h.y, s.x, ai[j]);
      }
    } else {
      const float h = reinterpret_cast<const float*>(win + W)[u];
#pragma unroll
      for (int j = 0; j < kPerWarp; ++j) {
        const float2 s = wj[j * D + u];
        ar[j] = fmaf(h, s.x, ar[j]);
        ai[j] = fmaf(h, s.y, ai[j]);
      }
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
    const int64_t m = m0 + j0 + j;
    if (lane == j && m < M) y[m] = make_float2(ar[j], ai[j]);
  }
}

template <bool kComplexTaps>
cudaError_t launch(const void* hist, int64_t H, const void* x, int64_t N,
                   const void* taps, int T, int D, int64_t s0, int64_t M,
                   void* y, int64_t smem, cudaStream_t stream) {
  auto kernel = decim_fir_kernel<kComplexTaps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (M + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float2*>(hist), H, static_cast<const float2*>(x), N,
      taps, T, D, s0, M, static_cast<float2*>(y));
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.
extern "C" int64_t tpusdr_decim_fir_smem(int T, int D, int complex_taps) {
  return window_len(T, D) * static_cast<int64_t>(sizeof(float2)) +
         static_cast<int64_t>(T) *
             (complex_taps ? sizeof(float2) : sizeof(float));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int tpusdr_decim_fir(const void* hist, int64_t H, const void* x,
                                int64_t N, const void* taps, int T,
                                int complex_taps, int D, int64_t s0,
                                int64_t M, void* y, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0) return cudaSuccess;
  const int64_t smem = tpusdr_decim_fir_smem(T, D, complex_taps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = complex_taps
            ? launch<true>(hist, H, x, N, taps, T, D, s0, M, y, smem, s)
            : launch<false>(hist, H, x, N, taps, T, D, s0, M, y, smem, s);
  return static_cast<int>(err);
}
