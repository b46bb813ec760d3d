// Decimating FIR of a complex stream with real taps over a virtual
// concatenation s = [hist, x], read through two pointers:
//
//   y[m] = sum_{u<T} h_rev[u] * s[m*D + u],   h_rev[u] = h[T-1-u],  m < M,
//
// complex64 data, float32 taps and sums.
//
// Replaces tpusdr/kernels/fir_pallas.py: fir_decim_pallas (_kernel), the
// gsdrFirFC case.  The TPU kernel takes one ref, so its streaming caller
// concatenates [history, tick] in front of every launch; here the history
// is a second pointer, and Fir in mode 'pallas' (graph/blocks.py) copies
// nothing in front of the launch.  The TPU kernel also pads each frame to
// 128 lanes, rounds its DMA window up to 8 rows and pads the output to a
// block multiple; none of that is needed here, and none is ported.
//
// What bounds it: each 8-byte input sample is read once and costs 4T/D
// operations (two FMAs a tap and output: 44 at (546, /50), 14 at
// (868, /250)), so by bytes moved once the memory rate is the bound at
// every shape the receivers build, and at a short tick the launch itself.
// A launch is parts that add up, because every block of the grid is
// resident at once: the launch, the fill of the shared-memory windows and
// taps, the arithmetic.  The fill is D-FIR's (decim_fir.cu): every sample
// of a block's window and every tap is an asynchronous copy (cp.async), all
// started before one wait, zero past the last sample a tap reads.
//
// The arithmetic has three forms behind the one entry point; the wrapper's
// rule (kernels/fir_poly.py, fir_decim_plan) picks one by shape.
//
// Form 1, phase-major, for a long tick at D >= 8 (the JSON graph's
// (546, /50)): FM-fused's loop without the mix and the discriminator
// (fir_common.cuh, phase_sums): lanes across outputs, R a lane, a register
// window slid down each phase, the 8 warps splitting the D phases and adding
// their partial sums through shared memory, window rows at the odd pitch
// D | 1, and a phase's own tap count (with Q = ceil(T/D) only the phases
// p < T - (Q-1)*D have a Q-th tap).  A lane's phase is R tap loads and R
// sample loads a group for R*R MACs, against one tap and one sample load a
// MAC in the other forms.  Built for R = 5 and R = 7.
//
// Form 0, lanes across taps, for a large D or a short tick ((868, /250),
// (6665, /500)): D-FIR's form 0 with real taps: one block per tile of 8k
// outputs (k = 1 .. 8) over a contiguous window of (tile-1)*D + T samples;
// each warp owns k outputs, its lanes split the taps and a warp shuffle
// adds them.  Little shared memory a block, so it fits a large D.  At such
// a shape the fill leads a launch: each SM pulls its blocks' windows from
// the L2 at a few tens of bytes a cycle, so the tile that fills the card
// best is the one whose busiest SM stages the fewest samples, which a tile
// of any multiple of 8 can match to M (at (868, /250) on a 1,280,000-sample
// tick 40 outputs, 128 blocks: 10,618 samples where 8 outputs, 640 blocks,
// five on an SM, staged 13,090).  Where even 8 outputs do not fit with all
// T taps, the block loops over the taps in chunks.
//
// Form 2, lanes across outputs, for D < 8, where six of the eight warps of
// the phase-major form would have no phase ((46, /2)): one block per tile
// of 256, 128, 64 or 32 outputs over the same window; thread t owns output
// t % tile and takes every (256/tile)-th tap from t / tile on, and the
// groups' partial sums are added through shared memory.  A tile of 32 gives
// the AM receiver's second stage (M = 2,560) 80 blocks where a thread an
// output in blocks of 256 gave 10.
//
// A warp an output with x read from L1/L2 instead of a staged window lost
// to these forms at every shape the receivers build.  The times are in
// PERF.md.

#include <cuda_runtime.h>

#include <cstdint>

#include "fir_common.cuh"

namespace {

using namespace tpusdr_fir;

constexpr int kFormTaps = 0;
constexpr int kFormPhase = 1;
constexpr int kFormOutputs = 2;

struct Args {
  const float2* hist;
  int64_t H;
  const float2* x;
  int64_t N;
  const float* taps;
  int T, D;
  int64_t M;
  float2* y;
};

// One past the last sample of s a tap reads for an output below M, capped
// at the length of s: what lies beyond is staged as zero.
__device__ __forceinline__ int64_t read_end(const Args& a) {
  const int64_t used = (a.M - 1) * a.D + a.T;
  const int64_t S = a.H + a.N;
  return used < S ? used : S;
}

// Stage the window of `tile` outputs over taps u0 .. u0 + tc of the block
// from output m0 on, and those taps reversed, at win and hr; waits for the
// copies and the block.
__device__ __forceinline__ void stage_chunk(const Args& a, float2* win, float* hr, int tile, int64_t m0,
                                            int u0, int tc, int64_t end) {
  const int W = (tile - 1) * a.D + tc;
  const Staging st = staging(win, W, a.hist, a.H, a.x, m0 * a.D + u0, end);
  for (int i = threadIdx.x; i < W; i += kThreads) stage(st, win, i, i);
  for (int u = threadIdx.x; u < tc; u += kThreads) stage_tap(hr + u, a.taps + (a.T - 1 - (u0 + u)));
  commit_copies();
  wait_copies(0);
  __syncthreads();
}

// ---- form 0: lanes across taps ---------------------------------------------

template <int kPerWarp>
__global__ void __launch_bounds__(kThreads) fir_poly_taps(const Args a, int chunk) {
  constexpr int kTile = kPerWarp * kWarps;  // outputs per block
  const int T = a.T, D = a.D;
  extern __shared__ float2 smem[];
  float2* win = smem;
  float* hr = reinterpret_cast<float*>(win + (kTile - 1) * D + chunk);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t end = read_end(a);

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
  for (int u0 = 0; u0 < T; u0 += chunk) {
    const int tc = min(chunk, T - u0);
    if (u0 > 0) __syncthreads();  // the previous chunk is consumed
    stage_chunk(a, win, hr, kTile, m0, u0, tc, end);
    for (int u = lane; u < tc; u += 32) {
      const float h = hr[u];
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
    if (lane == j && m < a.M) a.y[m] = make_float2(ar[j], ai[j]);
  }
}

// ---- form 1: phase-major -----------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads) fir_poly_phase(const Args a, int Q, uint32_t magic) {
  constexpr int kTile = kPhaseLanes * R;  // outputs per block
  const int T = a.T, D = a.D;
  const int rows = kTile + Q - 1;
  const int pitch = D | 1;  // odd, so that a lane stride of R * pitch is too
  extern __shared__ float2 smem[];
  float2* win = smem;                // [rows][pitch]: sample (row, p)
  float2* red = win + rows * pitch;  // [warps][R][32]: partial sums
  float* hq = reinterpret_cast<float*>(red + kWarps * kTile);  // [D][Q]

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const Staging st = staging(win, rows * D, a.hist, a.H, a.x, m0 * D, read_end(a));
  stage_rows(st, win, rows * D, D, pitch, magic);
  stage_phase_taps(hq, a.taps, T, D, Q, magic);
  commit_copies();
  wait_copies(0);
  __syncthreads();

  float2 acc[R];
  phase_sums<R>(acc, win, hq, T, D, Q, pitch);
  float2* y = a.y;
  const int64_t M = a.M;
  add_phase_sums<R>(acc, red, [=](int j, float2 sum) {
    if (m0 + j < M) y[m0 + j] = sum;
  });
}

// ---- form 2: lanes across outputs ---------------------------------------------

template <int kTile>
__global__ void __launch_bounds__(kThreads) fir_poly_outputs(const Args a, int chunk) {
  constexpr int kGroups = kThreads / kTile;  // groups of threads that split the taps
  const int T = a.T, D = a.D;
  extern __shared__ float2 smem[];
  float2* win = smem;
  float2* red = win + (kTile - 1) * D + chunk;  // [groups][tile]: partial sums
  float* hr = reinterpret_cast<float*>(red + kThreads);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t end = read_end(a);

  const int o = threadIdx.x % kTile;
  const int g = threadIdx.x / kTile;
  const float2* wo = win + o * D;
  float2 acc = make_float2(0.f, 0.f);
  for (int u0 = 0; u0 < T; u0 += chunk) {
    const int tc = min(chunk, T - u0);
    if (u0 > 0) __syncthreads();  // the previous chunk is consumed
    stage_chunk(a, win, hr, kTile, m0, u0, tc, end);
    for (int u = g; u < tc; u += kGroups) mac(acc, hr[u], wo[u]);
  }
  if constexpr (kGroups > 1) {
    red[threadIdx.x] = acc;
    __syncthreads();
    if (g != 0) return;
#pragma unroll
    for (int k = 1; k < kGroups; ++k) {
      const float2 part = red[k * kTile + o];
      acc.x += part.x;
      acc.y += part.y;
    }
  }
  if (m0 + o < a.M) a.y[m0 + o] = acc;
}

// ---- the launch ------------------------------------------------------------------

int64_t smem_bytes(int T, int D, int form, int tile, int chunk) {
  switch (form) {
    case kFormPhase: return phase_block_bytes(T, D, tile);
    case kFormOutputs:
      return (static_cast<int64_t>(tile - 1) * D + chunk + kThreads) * sizeof(float2) +
             static_cast<int64_t>(chunk) * sizeof(float);
    default:
      return (static_cast<int64_t>(tile - 1) * D + chunk) * sizeof(float2) +
             static_cast<int64_t>(chunk) * sizeof(float);
  }
}

template <typename Kernel, typename... Extra>
cudaError_t launch(Kernel kernel, int tile, const Args& a, int64_t smem, cudaStream_t s,
                   Extra... extra) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = (a.M + tile - 1) / tile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a, extra...);
  return cudaGetLastError();
}

cudaError_t launch_form(const Args& a, int form, int tile, int chunk, cudaStream_t s) {
  const int64_t smem = smem_bytes(a.T, a.D, form, tile, chunk);
  if (form == kFormPhase) {
    if (chunk != a.T || a.D > 65535) return cudaErrorInvalidValue;
    const int Q = (a.T + a.D - 1) / a.D;
    const uint32_t magic = div_magic(a.D);
    switch (tile) {
      case kPhaseLanes * 5: return launch(fir_poly_phase<5>, tile, a, smem, s, Q, magic);
      case kPhaseLanes * 7: return launch(fir_poly_phase<7>, tile, a, smem, s, Q, magic);
      default: return cudaErrorInvalidValue;
    }
  }
  if (chunk < 1 || chunk > a.T) return cudaErrorInvalidValue;
  if (form == kFormTaps) {
    switch (tile) {
      case 64: return launch(fir_poly_taps<8>, tile, a, smem, s, chunk);
      case 56: return launch(fir_poly_taps<7>, tile, a, smem, s, chunk);
      case 48: return launch(fir_poly_taps<6>, tile, a, smem, s, chunk);
      case 40: return launch(fir_poly_taps<5>, tile, a, smem, s, chunk);
      case 32: return launch(fir_poly_taps<4>, tile, a, smem, s, chunk);
      case 24: return launch(fir_poly_taps<3>, tile, a, smem, s, chunk);
      case 16: return launch(fir_poly_taps<2>, tile, a, smem, s, chunk);
      case 8: return launch(fir_poly_taps<1>, tile, a, smem, s, chunk);
      default: return cudaErrorInvalidValue;
    }
  }
  if (form == kFormOutputs) {
    switch (tile) {
      case 256: return launch(fir_poly_outputs<256>, tile, a, smem, s, chunk);
      case 128: return launch(fir_poly_outputs<128>, tile, a, smem, s, chunk);
      case 64: return launch(fir_poly_outputs<64>, tile, a, smem, s, chunk);
      case 32: return launch(fir_poly_outputs<32>, tile, a, smem, s, chunk);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.  form 0 (lanes across
// taps): the window of `tile` outputs over `chunk` taps, then the chunk's
// taps.  form 1 (phase-major): the window of tile + Q - 1 rows at an odd
// pitch, the warps' partial sums, the taps by phase.  form 2 (lanes across
// outputs): the window, 256 partial sums, the chunk's taps.
extern "C" int64_t tpusdr_fir_poly_smem(int T, int D, int form, int tile, int chunk) {
  return smem_bytes(T, D, form, tile, chunk);
}

// s = [hist (H samples), x (N samples)]; M outputs into y.  form 0: tile a
// multiple of 8 up to 64 outputs a block, chunk (<= T) taps a pass.  form
// 1: tile 160 or 224 (R = 5 or 7), all taps in one pass.  form 2: tile 256,
// 128, 64 or 32, chunk taps a pass.  D >= 2.  Launches on `stream`;
// returns the cudaError_t of the launch (0 = ok).
extern "C" int tpusdr_fir_poly(const void* hist, int64_t H, const void* x, int64_t N,
                               const void* taps, int T, int D, int64_t M, int form, int tile,
                               int chunk, void* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0) return cudaSuccess;
  if (D < 2 || T < 1) return cudaErrorInvalidValue;
  const Args a{static_cast<const float2*>(hist), H, static_cast<const float2*>(x), N,
               static_cast<const float*>(taps), T, D, M, static_cast<float2*>(y)};
  return static_cast<int>(launch_form(a, form, tile, chunk, static_cast<cudaStream_t>(stream)));
}
