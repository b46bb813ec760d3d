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
// The arithmetic has two forms behind the one entry point; the wrapper's
// rule (kernels/fm_fused.py, fm_fused_plan) picks by shape.
//
// Channels: one launch may demodulate C channels of the same s, each with
// an NCO increment and a carried phase of its own, read from two device
// arrays of C int64 words (the low 32 bits of each); channel c is
// blockIdx.y and writes row c of a (C, M) output.  Every channel reads the
// same s through the same two pointers.  With C = 1 and no increment array
// the grid and every block are those of the single-channel launch.  Over
// many channels the arithmetic, not the bytes, bounds the launch: each
// channel mixes and filters the whole of s.
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

// ---- both forms ---------------------------------------------------------------

int64_t smem_bytes(int T, int D, int form, int nv, int chunk) {
  return form == 1 ? phase_block_bytes(T, D, nv) : taps_smem_bytes(D, nv, chunk);
}

template <int kPart>
cudaError_t launch(const Args& a, int C, int form, int nv, int chunk, cudaStream_t s) {
  if (a.M <= 0) return cudaSuccess;
  if (C < 1 || C > 65535 || (C > 1 && a.phase == nullptr)) return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(a.T, a.D, form, nv, chunk);
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
        int C, int form, int nv, int chunk, int part, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float2*>(hist), H, static_cast<const float2*>(x), N,
               static_cast<const float*>(taps), T, D, inc, static_cast<const int64_t*>(incs),
               static_cast<const int64_t*>(phase), phase0, gain, M, static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (part) {
    case kPartAll: return launch<kPartAll>(a, C, form, nv, chunk, s);
    case kPartFill: return launch<kPartFill>(a, C, form, nv, chunk, s);
    case kPartFillMix: return launch<kPartFillMix>(a, C, form, nv, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.  form 0 (lanes across
// taps): the mixed window of nv filtered samples over `chunk` taps, the nv
// filtered samples, the chunk's taps.  form 1 (phase-major): the window of
// nv + Q - 1 rows at an odd pitch, the warps' partial sums, the taps by
// phase.
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
// taps in one pass, D >= 2.
extern "C" int tpusdr_fm_fused(const void* hist, int64_t H, const void* x, int64_t N,
                               const void* taps, int T, int D, uint32_t inc, const void* incs,
                               const void* phase, uint32_t phase0, float gain, int64_t M, int C,
                               int form, int nv, int chunk, void* out, int device,
                               void* stream) {
  return run(hist, H, x, N, taps, T, D, inc, incs, phase, phase0, gain, M, C, form, nv, chunk,
             kPartAll, out, device, stream);
}

// The timing probe's entry point (benchmarks/plan_probe.py; no receiver
// path reaches it): the same launch cut after a part (0 all, 1 the fill,
// 2 fill and mix; a cut launch stores one word a block).
extern "C" int tpusdr_fm_fused_probe(const void* hist, int64_t H, const void* x, int64_t N,
                                     const void* taps, int T, int D, uint32_t inc,
                                     const void* incs, const void* phase, uint32_t phase0,
                                     float gain, int64_t M, int C, int form, int nv, int chunk,
                                     int part, void* out, int device, void* stream) {
  return run(hist, H, x, N, taps, T, D, inc, incs, phase, phase0, gain, M, C, form, nv, chunk,
             part, out, device, stream);
}
