// Fused NCO mix -> decimating real-tap FIR -> FM discriminator over a
// virtual concatenation s = [hist, x], read through two pointers.
//
// Replaces tpusdr/kernels/fm_pallas.py: fused_fm_demod_pallas (_kernel).
// Contract (fm_pallas.py:18-20): s of length (T-1) + (M+1)*D gives M
// outputs
//
//   u[n]  = s[n] * exp(j * angle(phase0 + n*inc mod 2^32))
//   v[k]  = sum_{u<T} h_rev[u] * u[k*D + u]
//   y[m]  = gain * atan2(v[m+1] * conj(v[m])).
//
// The NCO phase is uint32 arithmetic, so it wraps exactly.  atan2f replaces
// the TPU kernel's polynomial atan and a sine per sample its angle-addition
// recurrence (both Mosaic workarounds, not ported).
//
// What bounds it: the real-tap MAC costs about 2T/D FLOP and the mix one
// sine and cosine per 8-byte input sample, the discriminator one atan2f per
// output, so it runs on the CUDA cores (tensor cores have nothing to do
// here) and, by bytes moved once, the memory rate is the bound.  A launch
// is parts that add up, because every block of the grid is resident at
// once: the launch itself, the fill of the shared-memory windows, the mix,
// the arithmetic, the discriminator.
//
// The fill, both forms: a block's raw window and its taps are asynchronous
// copies (cp.async, 8 and 4 bytes), all started before one wait.  Then each
// thread mixes in place the samples it copied itself, so no barrier stands
// between fill and mix.  The mix takes the phase as a signed angle in
// [-pi, pi) and __sincosf (two special-function operations, absolute
// error about 4e-7 there): at (728, /66) it costs 1.7 us of a launch where
// sincosf cost 4.3 and sincospif 2.9, and the outputs stay within 1e-5 *
// gain of the plain version.  The block's filtered samples stay in shared
// memory for the discriminator, a block of n filtered samples owns n - 1
// outputs and recomputes one overlap sample, and only the audio-rate
// outputs are written.
//
// The arithmetic has three forms behind the one entry point; the wrapper's
// rule (kernels/fm_fused.py, fm_fused_plan) picks by shape.
//
// Channels: one launch may demodulate C channels of the same s, each with
// an NCO increment and a carried phase of its own, read from two device
// arrays of C int64 words (the low 32 bits of each); channel c is
// blockIdx.y and writes row c of a (C, M) output.  Every channel reads the
// same s through the same two pointers.  With C = 1 and no increment array
// the grid and every block are those of the single-channel launch.  Over
// many channels the arithmetic, not the bytes, bounds the launch: each
// channel filters the whole of s.  Forms 0 and 1 give a block one channel
// (blockIdx.y), so each channel stages and mixes its own copy of every
// window; form 2 stages a window once for the channels that read it.
//
// Form 0, lanes across taps: one block per tile of 64, 32, 16 or 8
// filtered samples over a contiguous window of (tile-1)*D + T samples; each
// warp filters tile/8 samples at once (one tap load per tile/8 MACs, lanes
// split the taps, warp-shuffle reduction).  It needs little shared memory,
// so it is the form for a large D, and any tile fills the card, so it is
// the form for a small M.  Where even 8 filtered samples do not fit with
// all T taps, the block loops over the taps in chunks, restaging and
// re-mixing the window per chunk and keeping the sums in registers.
//
// Form 1, phase-major with register reuse (decim_fir.cu describes the loop
// and its counts): lanes across filtered samples, R a lane, a register
// window slid down each phase p over groups of R taps, the 8 warps
// splitting the D phases and adding their partial sums through shared
// memory, window rows of D samples at an odd pitch.  Real taps here, and a
// phase's own tap count: with Q = ceil(T/D) only the phases p < T - (Q-1)*D
// have a Q-th tap, the rest stop at Q - 1 (at (728, /66) 2 phases of 66
// have the twelfth).  The loop is fir_common.cuh's phase_sums, shared with
// K4 (fir_poly.cu).  The sums land where the window was; the
// discriminator reads them there.  R = 5 is the rule's: a block of 160
// filtered samples is 105 KB, the NBFM tick of 20,000 outputs is 126 blocks
// on 132 SMs, and a launch takes as long as its longest block (9.5 us
// where R = 7, 90 blocks of 224, takes 11.3 and R = 3, 211 blocks of 96,
// took 10.5).  R = 7 stays built for the timing probe.  The times are in
// PERF.md.
//
// Form 2, shared (many channels): the mix moves from the samples to the
// taps, exactly, as in a frequency-translating FIR.  With channel c's NCO
// angle th(n) = 2 pi (phase_c + n inc_c mod 2^32) / 2^32,
//
//   v[k]  = sum_u h_rev[u] s[kD+u] e^{j th(kD+u)} = e^{j th(kD)} w[k],
//   w[k]  = sum_u g[u] s[kD+u],  g[u] = h_rev[u] e^{j 2 pi (u inc_c mod 2^32) / 2^32},
//   v[k+1] conj v[k] = rho w[k+1] conj w[k],  rho = e^{j 2 pi (D inc_c mod 2^32) / 2^32},
//
// so y[k] = gain * arg(rho w[k+1] conj w[k]): the carried phase cancels,
// the raw window is never mixed, and one staged window serves every
// channel.  The taps g are complex (twice form 1's FMAs, 4 a tap and
// output), built by phase in shared memory from incs[c] for each work item
// (T sincospif of the exact uint32 product u inc_c, not a sine a sample),
// so a retune that writes incs in place reaches a captured launch.
//
// Schedule: a work item is a (tile of 160 filtered samples, channel) pair,
// in tile-major order, tiles * C of them.  The grid is persistent, as many
// blocks as are resident at once (two an SM at (728, /66)), which the plan
// gives (fm_fused_grid); block b walks the contiguous items
// [items b / grid, items (b+1) / grid) and restages the raw window
// (cp.async, rows at the odd pitch, as form 1) only where the tile
// changes, once or twice a block at the nbfm.capture shape (57 channels:
// 122 x 57 items, 26 or 27 a block).  Each item: the channel's taps (from
// the real taps by phase, staged once a block), barrier, the sums
// (fir_common.cuh's phase_sums_whole: a lane loads its whole column of a
// phase, R + Qp - 1 samples, before the phase's Qp taps, so a phase waits
// on its loads once; a build for each Q from 2 to 16, since a loop over
// a tap count known only when it runs took 448 us against 207 at the
// nbfm.capture shape), the warps' partial sums added in place in
// their own buffer (the window stays for the next item), barrier, the
// discriminator with rho.  Shared memory: the complex taps, the partial
// sums, the real taps and the window (tile + Q - 1 rows of D | 1 samples):
// 111,400 B at (728, /66).  PERF.md has the designs measured against it
// (two channels an item, 128 filtered samples; phase_sums' groups of R
// taps; the largest shared-memory carveout).
//
// The kernel does not read the carried phases; the block that carries them
// still advances them, since the plain version (the CPU path), checkpoints
// and forms 0 and 1 read them.

#include <cuda_runtime.h>

#include <cstdint>

#include "fir_common.cuh"

namespace {

using namespace tpusdr_fir;

constexpr float kPhaseScale =
    static_cast<float>(6.283185307179586 / 4294967296.0);  // 2pi / 2^32

// What a launch does: everything, or (for the timing probe) only the first
// parts of it.
constexpr int kPartAll = 0;
constexpr int kPartFill = 1;
constexpr int kPartFillMix = 2;

struct Args {
  const float2* hist;
  int64_t H;
  const float2* x;
  int64_t N;
  const float* taps;
  int T, D;
  uint32_t inc;          // every channel's increment where incs is null
  const int64_t* incs;   // C increments on the device, or null
  const int64_t* phase;  // C carried phases on the device, or null
  uint32_t phase0;       // added to each carried phase (or alone where it is null)
  float gain;
  int64_t M;
  float* out;  // (C, M)
};

// (cos, sin) of the NCO phase: the uint32 phase read as a signed angle in
// [-pi, pi), where __sincosf is two special-function operations with an
// absolute error of about 4e-7.
__device__ __forceinline__ float2 nco(uint32_t ph) {
  float sn, cs;
  __sincosf(static_cast<float>(static_cast<int32_t>(ph)) * kPhaseScale, &sn, &cs);
  return make_float2(cs, sn);
}

// The NCO phase of s[0] in the block's channel: the carried phase, read
// from device memory when the kernel runs (so a captured launch replays
// with its tick's phase), plus the offset passed by value.  Each thread
// reads the same 8 bytes: one broadcast load a warp, before the fill's wait.
__device__ __forceinline__ uint32_t start_phase(const Args& a) {
  return a.phase0 +
         (a.phase ? static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(a.phase) + blockIdx.y))
                  : 0u);
}

// The NCO increment of the block's channel.
__device__ __forceinline__ uint32_t channel_inc(const Args& a) {
  return a.incs ? static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(a.incs) + blockIdx.y))
                : a.inc;
}

// The block's channel's output row.
__device__ __forceinline__ float* out_row(const Args& a) {
  return a.out + static_cast<int64_t>(blockIdx.y) * a.M;
}

__device__ __forceinline__ float2 rotate(float2 s, float2 lo) {
  return make_float2(s.x * lo.x - s.y * lo.y, s.x * lo.y + s.y * lo.x);
}

// One past the last sample of s a tap reads for an output below M, capped
// at the length of s: what lies beyond is staged as zero.
__device__ __forceinline__ int64_t read_end(const Args& a) {
  const int64_t used = (a.T - 1) + (a.M + 1) * a.D;
  const int64_t S = a.H + a.N;
  return used < S ? used : S;
}

// y[m0 + t] = gain * arg(v[t+1] conj v[t]) for the block's n_out outputs.
__device__ __forceinline__ void discriminate(const float2* v, int n_out, int64_t m0,
                                             const Args& a) {
  float* out = out_row(a);
  for (int t = threadIdx.x; t < n_out; t += kThreads) {
    const int64_t m = m0 + t;
    if (m < a.M) {
      const float2 c = v[t + 1];
      const float2 b = v[t];
      const float pr = c.x * b.x + c.y * b.y;
      const float pi = c.y * b.x - c.x * b.y;
      // + 0.0f: arg(0) = 0 (atan2f(+-0, -0) would give +-pi); see
      // tpusdr_torch/ops/demod.py arg()
      out[m] = a.gain * atan2f(pi, pr + 0.0f);
    }
  }
}

// Mix samples 0 .. n of the window in place, sample i at win[at(i)] with the
// NCO phase ph0 + i * inc.  Thread t takes the samples t, t + 256, ..: the
// ones it staged itself, so it needs no barrier after its own wait.
template <typename At>
__device__ __forceinline__ void mix_in_place(float2* win, int n, uint32_t ph0, uint32_t inc, At at) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float2* w = win + at(i);
    *w = rotate(*w, nco(ph0 + static_cast<uint32_t>(i) * inc));
  }
}

// A launch cut short for the probe: one thread a block stores a staged
// sample, so that the parts before it are not dead code.
__device__ __forceinline__ void part_sink(const float2* win, int64_t m0, const Args& a) {
  if (threadIdx.x == 0 && m0 < a.M) out_row(a)[m0] = win[blockIdx.x & 63].x;
}

// ---- form 0: lanes across taps --------------------------------------------

int64_t taps_smem_bytes(int D, int nv, int chunk) {
  return (static_cast<int64_t>(nv - 1) * D + chunk + nv) * sizeof(float2) +
         static_cast<int64_t>(chunk) * sizeof(float);
}

template <int kPerWarp, int kPart>
__global__ void __launch_bounds__(kThreads) fm_fused_kernel(const Args a, int chunk) {
  constexpr int kV = kPerWarp * kWarps;  // filtered samples per block
  constexpr int kOut = kV - 1;           // discriminator outputs per block
  const int T = a.T, D = a.D;
  extern __shared__ float2 smem[];
  float2* win = smem;
  float2* v = win + (kV - 1) * D + chunk;
  float* hr = reinterpret_cast<float*>(v + kV);
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kOut;
  const int64_t end = read_end(a);
  const uint32_t ph0 = start_phase(a);
  const uint32_t inc = channel_inc(a);

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
    const int W = (kV - 1) * D + tc;
    const int64_t base = m0 * D + u0;
    if (u0 > 0) __syncthreads();  // the previous chunk is consumed
    const Staging st = staging(win, W, a.hist, a.H, a.x, base, end);
    for (int i = threadIdx.x; i < W; i += kThreads) stage(st, win, i, i);
    for (int u = threadIdx.x; u < tc; u += kThreads) stage_tap(hr + u, a.taps + (T - 1 - (u0 + u)));
    commit_copies();
    wait_copies(0);
    if constexpr (kPart != kPartFill) {
      mix_in_place(win, W, ph0 + static_cast<uint32_t>(base) * inc, inc, [](int i) { return i; });
    }
    __syncthreads();
    if constexpr (kPart != kPartAll) continue;

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
  if constexpr (kPart != kPartAll) {
    part_sink(win, m0, a);
    return;
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
  discriminate(v, kOut, m0, a);
}

template <int kPerWarp, int kPart>
cudaError_t launch_taps(const Args& a, int C, int chunk, int64_t smem, cudaStream_t stream) {
  auto kernel = fm_fused_kernel<kPerWarp, kPart>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kOut = kPerWarp * kWarps - 1;
  const int64_t blocks = (a.M + kOut - 1) / kOut;
  kernel<<<dim3(static_cast<unsigned>(blocks), C), kThreads, smem, stream>>>(a, chunk);
  return cudaGetLastError();
}

// ---- form 1: phase-major ----------------------------------------------------

template <int R, int kPart>
__global__ void __launch_bounds__(kThreads)
    fm_fused_phase_kernel(const Args a, int Q, uint32_t magic) {
  constexpr int kV = kPhaseLanes * R;  // filtered samples per block
  constexpr int kOut = kV - 1;         // discriminator outputs per block
  const int T = a.T, D = a.D;
  const int rows = kV + Q - 1;
  const int pitch = D | 1;  // odd, so that a lane stride of R * pitch is too
  extern __shared__ float2 smem[];
  float2* win = smem;                // [rows][pitch]: mixed sample (row, p)
  float2* red = win + rows * pitch;  // [warps][R][32]: partial sums
  float* hq = reinterpret_cast<float*>(red + kWarps * kV);  // [D][Q]

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kOut;
  const int64_t base = m0 * D;
  const uint32_t ph0 = start_phase(a);
  const uint32_t inc = channel_inc(a);
  const Staging st = staging(win, rows * D, a.hist, a.H, a.x, base, read_end(a));
  stage_rows(st, win, rows * D, D, pitch, magic);
  stage_phase_taps(hq, a.taps, T, D, Q, magic);
  commit_copies();
  wait_copies(0);
  if constexpr (kPart != kPartFill) {
    mix_in_place(win, rows * D, ph0 + static_cast<uint32_t>(base) * inc, inc,
                 [=](int i) { return i + static_cast<int>(__umulhi(i, magic)) * (pitch - D); });
  }
  __syncthreads();
  if constexpr (kPart != kPartAll) {
    part_sink(win, m0, a);
    return;
  }

  // The phase-major sums (fir_common.cuh); filtered sample j lands where
  // the window was.
  float2 acc[R];
  phase_sums<R>(acc, win, hq, T, D, Q, pitch);
  add_phase_sums<R>(acc, red, [=](int j, float2 sum) { win[j] = sum; });
  __syncthreads();
  discriminate(win, kOut, m0, a);
}

template <int R, int kPart>
cudaError_t launch_phase(const Args& a, int C, int64_t smem, cudaStream_t stream) {
  auto kernel = fm_fused_phase_kernel<R, kPart>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kOut = kPhaseLanes * R - 1;
  const int64_t blocks = (a.M + kOut - 1) / kOut;
  kernel<<<dim3(static_cast<unsigned>(blocks), C), kThreads, smem, stream>>>(
      a, (a.T + a.D - 1) / a.D, div_magic(a.D));
  return cudaGetLastError();
}

// ---- form 2: shared --------------------------------------------------------------

constexpr int kSharedR = 5;      // filtered samples a lane: 160 a work item
constexpr int kSharedMinQ = 2;   // taps a phase (ceil(T/D)) the kernel is built for
constexpr int kSharedMaxQ = 16;

// The item's complex taps by phase, the warps' partial sums (the sums are
// added in place), the real taps by phase, the window of nv + Q - 1 rows at
// an odd pitch.
int64_t shared_smem_bytes(int T, int D, int nv) {
  const int Q = (T + D - 1) / D;
  const int64_t rows = nv + Q - 1;
  return (static_cast<int64_t>(D) * Q + static_cast<int64_t>(kWarps) * nv + rows * (D | 1)) *
             sizeof(float2) +
         static_cast<int64_t>(D) * Q * sizeof(float);
}

// Channel c's NCO increment and output row: a form-2 block serves many
// channels, where forms 0 and 1 take blockIdx.y's.
__device__ __forceinline__ uint32_t shared_inc(const Args& a, int c) {
  return a.incs ? static_cast<uint32_t>(__ldg(reinterpret_cast<const long long*>(a.incs) + c))
                : a.inc;
}

__device__ __forceinline__ float* shared_row(const Args& a, int c) {
  return a.out + static_cast<int64_t>(c) * a.M;
}

// (cos, sin) of 2 pi ph / 2^32, the uint32 phase read as a signed angle in
// [-pi, pi), at full precision.
__device__ __forceinline__ float2 turn(uint32_t ph) {
  float sn, cs;
  sincospif(static_cast<float>(static_cast<int32_t>(ph)) * 0x1p-31f, &sn, &cs);
  return make_float2(cs, sn);
}

// Channel inc's folded taps by phase, hq[p][q] = h_rev[u] e^{j 2 pi (u inc
// mod 2^32) / 2^32} with u = p + q*D, from the real taps by phase hr (zero
// past T).
__device__ __forceinline__ void fold_taps(float2* hq, const float* hr, int D, int Q, uint32_t magic,
                                          uint32_t inc) {
  for (int u = threadIdx.x; u < Q * D; u += kThreads) {
    const int q = static_cast<int>(__umulhi(u, magic));
    const int at = (u - q * D) * Q + q;
    const float h = hr[at];
    const float2 e = turn(static_cast<uint32_t>(u) * inc);
    hq[at] = make_float2(h * e.x, h * e.y);
  }
}

// kQ: Q, built in for the sums; the parts stop before them.
template <int kPart, int kQ>
__global__ void __launch_bounds__(kThreads)
    fm_fused_shared_kernel(const Args a, int C, int Q, uint32_t magic, int64_t tiles) {
  constexpr int R = kSharedR;
  constexpr int kV = kPhaseLanes * R;  // filtered samples per tile
  constexpr int kOut = kV - 1;         // discriminator outputs per tile
  const int T = a.T, D = a.D;
  const int rows = kV + Q - 1;
  const int pitch = D | 1;
  extern __shared__ float2 smem[];
  float2* hq = smem;                                        // [D][Q]: the item's taps
  float2* red = hq + D * Q;                                 // [warps][R][32]: partial sums
  float* hr = reinterpret_cast<float*>(red + kWarps * kV);  // [D][Q]: real taps
  float2* win = reinterpret_cast<float2*>(hr + D * Q);      // [rows][pitch]: raw sample (row, p)
  const int64_t end = read_end(a);
  const int64_t items = tiles * C;
  const int64_t last = items * (blockIdx.x + 1) / gridDim.x;
  int64_t staged = -1;  // the tile whose window is in win

  stage_phase_taps(hr, a.taps, T, D, Q, magic);
  commit_copies();
  wait_copies(0);
  __syncthreads();
  for (int64_t it = items * blockIdx.x / gridDim.x; it < last; ++it) {
    const int64_t tile = it / C;
    const int c = static_cast<int>(it - tile * C);
    const int64_t m0 = tile * kOut;
    const uint32_t inc = shared_inc(a, c);
    // The item before read win and hq before its second barrier and red
    // after its third: this item writes red only after its first.
    if (tile != staged) {
      stage_rows(staging(win, rows * D, a.hist, a.H, a.x, m0 * D, end), win, rows * D, D, pitch,
                 magic);
      commit_copies();
      staged = tile;
    }
    if constexpr (kPart != kPartFill) fold_taps(hq, hr, D, Q, magic, inc);
    wait_copies(0);
    __syncthreads();
    if constexpr (kPart != kPartAll) {
      // the probe's cut: a staged sample (and, after the taps, a tap) kept
      if (threadIdx.x == 0 && m0 < a.M)
        shared_row(a, c)[m0] = win[blockIdx.x & 63].x + (kPart == kPartFill ? 0.f : hq[Q].y);
      __syncthreads();
      continue;
    }

    float2 acc[R];
    phase_sums_whole<R, kQ>(acc, win, hq, T, D, pitch);
    add_phase_sums<R>(acc, red, [=](int j, float2 sum) { red[phase_sum_at(R, j)] = sum; });
    __syncthreads();
    // y = gain * arg(rho w[t+1] conj w[t])
    const float2 rho = turn(static_cast<uint32_t>(D) * inc);
    float* out = shared_row(a, c);
    for (int t = threadIdx.x; t < kOut; t += kThreads) {
      if (m0 + t < a.M) {
        const float2 e = red[phase_sum_at(R, t + 1)];
        const float2 b = red[phase_sum_at(R, t)];
        const float pr = e.x * b.x + e.y * b.y;
        const float pi = e.y * b.x - e.x * b.y;
        // + 0.0f: arg(0) = 0, as in discriminate
        out[m0 + t] = a.gain * atan2f(rho.x * pi + rho.y * pr, rho.x * pr - rho.y * pi + 0.0f);
      }
    }
  }
}

// blocks: the persistent grid the plan gives (kernels/fm_fused.py,
// fm_fused_grid), at most one a work item.
// The kernel built for Q taps a phase; the parts, cut before the sums, have
// one build.
template <int kPart, int kQ = kSharedMinQ>
auto shared_kernel(int Q) -> decltype(&fm_fused_shared_kernel<kPart, kQ>) {
  if constexpr (kPart != kPartAll || kQ == kSharedMaxQ)
    return fm_fused_shared_kernel<kPart, kQ>;
  else
    return Q == kQ ? fm_fused_shared_kernel<kPart, kQ> : shared_kernel<kPart, kQ + 1>(Q);
}

template <int kPart>
cudaError_t launch_shared(const Args& a, int C, int64_t blocks, int64_t smem, cudaStream_t stream) {
  const int Q = (a.T + a.D - 1) / a.D;
  auto kernel = shared_kernel<kPart>(Q);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  constexpr int kOut = kPhaseLanes * kSharedR - 1;
  const int64_t tiles = (a.M + kOut - 1) / kOut;
  if (blocks < 1 || blocks > tiles * C) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(a, C, Q, div_magic(a.D),
                                                                    tiles);
  return cudaGetLastError();
}

// ---- every form ------------------------------------------------------------------

int64_t smem_bytes(int T, int D, int form, int nv, int chunk) {
  switch (form) {
    case 1: return phase_block_bytes(T, D, nv);
    case 2: return shared_smem_bytes(T, D, nv);
    default: return taps_smem_bytes(D, nv, chunk);
  }
}

template <int kPart>
cudaError_t launch(const Args& a, int C, int form, int nv, int chunk, int64_t blocks,
                   cudaStream_t s) {
  if (a.M <= 0) return cudaSuccess;
  if (C < 1 || C > 65535 || (C > 1 && a.phase == nullptr)) return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(a.T, a.D, form, nv, chunk);
  if (form == 2) {
    if (chunk != a.T || a.D < 2 || a.D > 65535 || nv != kPhaseLanes * kSharedR ||
        (a.T + a.D - 1) / a.D < kSharedMinQ || (a.T + a.D - 1) / a.D > kSharedMaxQ)
      return cudaErrorInvalidValue;
    return launch_shared<kPart>(a, C, blocks, smem, s);
  }
  if (nv < 2 || blocks != static_cast<int64_t>(C) * ((a.M + nv - 2) / (nv - 1)))
    return cudaErrorInvalidValue;
  if (form == 1) {
    if (chunk != a.T || a.D < 2 || a.D > 65535) return cudaErrorInvalidValue;
    switch (nv) {
      case kPhaseLanes * 5: return launch_phase<5, kPart>(a, C, smem, s);
      case kPhaseLanes * 7: return launch_phase<7, kPart>(a, C, smem, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (form != 0 || chunk < 1 || chunk > a.T) return cudaErrorInvalidValue;
  switch (nv) {
    case 64: return launch_taps<8, kPart>(a, C, chunk, smem, s);
    case 32: return launch_taps<4, kPart>(a, C, chunk, smem, s);
    case 16: return launch_taps<2, kPart>(a, C, chunk, smem, s);
    case 8: return launch_taps<1, kPart>(a, C, chunk, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// What both entry points do: all of a launch (part 0) or, for the probe, a
// launch cut after a part.
int run(const void* hist, int64_t H, const void* x, int64_t N, const void* taps, int T, int D,
        uint32_t inc, const void* incs, const void* phase, uint32_t phase0, float gain, int64_t M,
        int C, int form, int nv, int chunk, int64_t blocks, int part, void* out, int device,
        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float2*>(hist), H, static_cast<const float2*>(x), N,
               static_cast<const float*>(taps), T, D, inc, static_cast<const int64_t*>(incs),
               static_cast<const int64_t*>(phase), phase0, gain, M, static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (part) {
    case kPartAll: return launch<kPartAll>(a, C, form, nv, chunk, blocks, s);
    case kPartFill: return launch<kPartFill>(a, C, form, nv, chunk, blocks, s);
    case kPartFillMix: return launch<kPartFillMix>(a, C, form, nv, chunk, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.  form 0 (lanes across
// taps): the mixed window of nv filtered samples over `chunk` taps, the nv
// filtered samples, the chunk's taps.  form 1 (phase-major): the window of
// nv + Q - 1 rows at an odd pitch, the warps' partial sums, the taps by
// phase.  form 2 (shared): the complex taps by phase, the partial sums,
// the real taps by phase, form 1's window.
extern "C" int64_t tpusdr_fm_fused_smem(int T, int D, int form, int nv, int chunk) {
  return smem_bytes(T, D, form, nv, chunk);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// s = [hist (H samples), x (N samples)]; C channels (1 to 65535) write the
// rows of out (C, M).  Channel c's NCO phase of s[0] is phase0 plus, where
// `phase` is not null, the low 32 bits of phase[c] on the device (the
// carried phase, read when the kernel runs; C > 1 needs it); its increment
// is the low 32 bits of incs[c] on the device, or `inc` where incs is null.
// form 0: nv is 64, 32, 16 or 8 filtered samples per block, chunk (<= T)
// taps per pass.  form 1: nv is 160 (or, for the timing probe, 224), all
// taps in one pass, D >= 2.  form 2: nv is 160 filtered samples a work
// item, all taps, D >= 2, 2 <= ceil(T / D) <= 16; the carried phases are not
// read (the mix is folded into the taps).  blocks: the grid the plan gives
// (fm_fused_grid), C x ceil(M / (nv - 1)) in forms 0 and 1, the persistent
// grid, 1 to the work items, in form 2.
extern "C" int tpusdr_fm_fused(const void* hist, int64_t H, const void* x, int64_t N,
                               const void* taps, int T, int D, uint32_t inc, const void* incs,
                               const void* phase, uint32_t phase0, float gain, int64_t M, int C,
                               int form, int nv, int chunk, int64_t blocks, void* out,
                               int device, void* stream) {
  return run(hist, H, x, N, taps, T, D, inc, incs, phase, phase0, gain, M, C, form, nv, chunk,
             blocks, kPartAll, out, device, stream);
}

// The timing probe's entry point (benchmarks/plan_probe.py; no receiver
// path reaches it): the same launch cut after a part (0 all, 1 the fill,
// 2 fill and mix, in form 2 fill and taps; a cut launch stores one word a
// block, form 2 one a work item).
extern "C" int tpusdr_fm_fused_probe(const void* hist, int64_t H, const void* x, int64_t N,
                                     const void* taps, int T, int D, uint32_t inc,
                                     const void* incs, const void* phase, uint32_t phase0,
                                     float gain, int64_t M, int C, int form, int nv, int chunk,
                                     int64_t blocks, int part, void* out, int device,
                                     void* stream) {
  return run(hist, H, x, N, taps, T, D, inc, incs, phase, phase0, gain, M, C, form, nv, chunk,
             blocks, part, out, device, stream);
}
