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
// taps, a tick of 1,280,000 samples) each 8-byte input sample costs about
// 546/50 * 8 ~ 87 FLOP, about 11 FLOP/B -- near the card's fp32 CUDA-core
// balance (67 TFLOP/s over 3.35 TB/s ~ 20 FLOP/B).  One launch is three
// parts that add up, because every block of the grid is resident at once
// and so the whole card first fills its windows and then computes: the
// launch itself, the fill of the shared-memory windows, the arithmetic.
//
// The fill, both forms: every sample of a block's window is an asynchronous
// 8-byte copy (cp.async), all started before one wait, and so are the taps.
// A thread that loads, stores and loops has a few loads in flight, and one
// block an SM then fills at about 3 bytes a cycle; with the copies the
// launch at (6665, /500), a 177 KB window a block, takes 17 us in place of
// 30 (NVIDIA H100 80GB HBM3 at 700 W).
//
// The arithmetic has two forms behind the one entry point; the wrapper's
// rule (kernels/fir_banded.py, decim_fir_plan) picks by shape.
//
// Form 0, lanes across taps: one block per tile of 64, 32, 16 or 8
// outputs; the tile's contiguous input window and the reversed taps sit in
// shared memory; each warp owns tile/8 outputs, lanes split the tap loop
// and the partial sums are reduced with warp shuffles.  A lane's step is
// one tap load and tile/8 sample loads for tile/8 MACs: at tile 64, 9
// 64-bit loads (18 shared-memory wavefronts) for 8 MACs, 1.1 loads and
// 2.25 wavefronts a warp-MAC against 1 cycle of FMA dispatch, and T mod 32
// lanes idle in the last step.  It needs little shared memory, so it is
// the form for a large D, and any tile fills the card, so it is the form
// for a small M.  Where even 8 outputs do not fit with all T taps, the
// block loops over the taps in chunks, restaging the window per chunk.
//
// Form 1, phase-major with register reuse: with Q = ceil(T/D) and h_rev
// zero past T,  y[m] = sum_{p<D} sum_{q<Q} h_rev[p + q*D] * s[s0 + (m+q)*D + p].
// For one phase p the samples s[n*D + p] are a stride-1 sequence in n, and
// R consecutive outputs need R+Q-1 of them for R*Q MACs.  Lanes run across
// outputs: lane l owns the R = 7 outputs l*R .. l*R+R-1 of a tile of 224 and
// slides a register window of 2R-1 samples down the phase, R taps a group:
// R tap loads (one address for the whole warp, a broadcast) and R sample
// loads feed R*R MACs, and the last Q mod R taps go as one shorter group, so
// no MAC meets a padding tap but those past T.  The 8 warps split the
// phases and add their partial sums through shared memory at the end: no
// lane is idle for T mod 32 and there is no shuffle.  The window is rows of
// D samples at a pitch of D made odd, so that the lane stride R * pitch is
// odd and the 16 lanes of a half-warp fall into 16 different 8-byte banks.
// The count at (546, /50), Q = 11: a lane's phase is 6 + 11 sample loads
// and 11 tap loads for 77 MACs: 0.36 loads and 0.58 wavefronts a warp-MAC
// (45 wavefronts for 77) against 1 cycle of FMA dispatch, a quarter of form
// 0's shared-memory traffic.  A block is 114 KB, so one block an SM; a tick
// of 1,280,000 samples is 115 blocks in one round on 132 SMs, and 229
// blocks at twice the tick are two rounds on 97 of them.  Form 1 wins once
// the grid covers two thirds of the SMs (88 blocks); below, form 0's small
// tiles spread the same work over every SM.  The times are in PERF.md.
//
// A tensor-core banded form (3xTF32 or fp32) is later work.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ceil(2^32 / D): i / D == __umulhi(i, magic) for i, D < 65536.
uint32_t div_magic(int D) {
  return D > 1 ? static_cast<uint32_t>(((1ull << 32) + D - 1) / D) : 0u;
}

// Where the n samples base .. base + n of s = [hist, x] come from, as
// 32-bit offsets into that range: below `zero` and from `end` on nothing is
// read and a zero is staged; below `hist` the sample is in hist, else in x.
struct Staging {
  int zero, hist, end;
  const char* from_hist;  // address of sample i is from_hist + 8 * i
  const char* from_x;
  uint32_t win;  // shared-space address of the window
};

__device__ __forceinline__ Staging staging(float2* win, int n,
                                           const float2* hist, int64_t H,
                                           const float2* x, int64_t base,
                                           int64_t end) {
  auto clamp = [n](int64_t v) { return static_cast<int>(v < 0 ? 0 : (v > n ? n : v)); };
  return {clamp(-base), clamp(H - base), clamp(end - base),
          reinterpret_cast<const char*>(hist) + base * 8,
          reinterpret_cast<const char*>(x) + (base - H) * 8,
          static_cast<uint32_t>(__cvta_generic_to_shared(win))};
}

// Stage sample i of the range at win[at]: an asynchronous 8-byte copy (no
// register holds it, so a thread keeps as many loads in flight as it starts
// before it waits), or a zero where there is no sample, whatever memory
// holds there.
__device__ __forceinline__ void stage(const Staging& st, float2* win, int at, int i) {
  if (i >= st.zero && i < st.end) {
    const char* src = (i < st.hist ? st.from_hist : st.from_x) + i * 8;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(st.win + at * 8), "l"(src)
                 : "memory");
  } else {
    win[at] = make_float2(0.f, 0.f);
  }
}

// The same for one tap, 4 bytes (real) or 8 (complex).
template <typename Tap>
__device__ __forceinline__ void stage_tap(Tap* dst, const Tap* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(Tap) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` (0..7) of this thread's committed groups of
// copies are still in flight; the instruction takes an immediate.
__device__ __forceinline__ void wait_copies(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

int64_t smem_bytes(int D, int complex_taps, int tile, int chunk) {
  return (static_cast<int64_t>(tile - 1) * D + chunk) * sizeof(float2) +
         static_cast<int64_t>(chunk) * (complex_taps ? sizeof(float2) : sizeof(float));
}

template <int kPerWarp, bool kComplexTaps>
__global__ void __launch_bounds__(kThreads)
    decim_fir_kernel(const float2* __restrict__ hist, int64_t H,
                     const float2* __restrict__ x, int64_t N,
                     const void* __restrict__ taps, int T, int D, int64_t s0,
                     int64_t M, int chunk, float2* __restrict__ y) {
  constexpr int kTile = kPerWarp * kWarps;  // outputs per block
  extern __shared__ float2 smem[];
  float2* win = smem;
  void* hr = win + (kTile - 1) * D + chunk;  // reversed taps of the chunk
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t S = H + N;

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
    const int W = (kTile - 1) * D + tc;
    const int64_t base = s0 + m0 * D + u0;
    if (u0 > 0) __syncthreads();  // the previous chunk is consumed
    // The chunk's window of s, zero past either end (masks the ragged tile).
    const Staging st = staging(win, W, hist, H, x, base, S);
    for (int i = threadIdx.x; i < W; i += kThreads) stage(st, win, i, i);
    if constexpr (kComplexTaps) {
      const float2* h = static_cast<const float2*>(taps);
      for (int u = threadIdx.x; u < tc; u += kThreads)
        stage_tap(static_cast<float2*>(hr) + u, h + (T - 1 - (u0 + u)));
    } else {
      const float* h = static_cast<const float*>(taps);
      for (int u = threadIdx.x; u < tc; u += kThreads)
        stage_tap(static_cast<float*>(hr) + u, h + (T - 1 - (u0 + u)));
    }
    commit_copies();
    wait_copies(0);
    __syncthreads();

    for (int u = lane; u < tc; u += 32) {
      if constexpr (kComplexTaps) {
        const float2 h = static_cast<const float2*>(hr)[u];
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j) {
          const float2 s = wj[j * D + u];
          ar[j] = fmaf(h.x, s.x, ar[j]);
          ar[j] = fmaf(-h.y, s.y, ar[j]);
          ai[j] = fmaf(h.x, s.y, ai[j]);
          ai[j] = fmaf(h.y, s.x, ai[j]);
        }
      } else {
        const float h = static_cast<const float*>(hr)[u];
#pragma unroll
        for (int j = 0; j < kPerWarp; ++j) {
          const float2 s = wj[j * D + u];
          ar[j] = fmaf(h, s.x, ar[j]);
          ai[j] = fmaf(h, s.y, ai[j]);
        }
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

template <int kPerWarp, bool kComplexTaps>
cudaError_t launch(const void* hist, int64_t H, const void* x, int64_t N,
                   const void* taps, int T, int D, int64_t s0, int64_t M,
                   int chunk, void* y, int64_t smem, cudaStream_t stream) {
  auto kernel = decim_fir_kernel<kPerWarp, kComplexTaps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kTile = kPerWarp * kWarps;
  const int64_t blocks = (M + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float2*>(hist), H, static_cast<const float2*>(x), N,
      taps, T, D, s0, M, chunk, static_cast<float2*>(y));
  return cudaGetLastError();
}

template <bool kComplexTaps>
cudaError_t launch_tile(int tile, const void* hist, int64_t H, const void* x,
                        int64_t N, const void* taps, int T, int D, int64_t s0,
                        int64_t M, int chunk, void* y, int64_t smem,
                        cudaStream_t stream) {
  switch (tile) {
    case 64:
      return launch<8, kComplexTaps>(hist, H, x, N, taps, T, D, s0, M, chunk, y, smem, stream);
    case 32:
      return launch<4, kComplexTaps>(hist, H, x, N, taps, T, D, s0, M, chunk, y, smem, stream);
    case 16:
      return launch<2, kComplexTaps>(hist, H, x, N, taps, T, D, s0, M, chunk, y, smem, stream);
    case 8:
      return launch<1, kComplexTaps>(hist, H, x, N, taps, T, D, s0, M, chunk, y, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---- the phase-major form ------------------------------------------------

constexpr int kPhaseLanes = 32;  // lanes of a warp, all across outputs
constexpr int kPhaseR = 7;       // outputs of one lane

int64_t phase_smem_bytes(int T, int D, int complex_taps, int tile) {
  const int Q = (T + D - 1) / D;
  const int64_t rows = tile + Q - 1;
  const int64_t pitch = D | 1;
  return (rows * pitch + static_cast<int64_t>(kWarps) * tile) * sizeof(float2) +
         static_cast<int64_t>(D) * Q *
             (complex_taps ? sizeof(float2) : sizeof(float));
}

__device__ __forceinline__ void mac(float2& a, float2 h, float2 s) {
  a.x = fmaf(h.x, s.x, a.x);
  a.x = fmaf(-h.y, s.y, a.x);
  a.y = fmaf(h.x, s.y, a.y);
  a.y = fmaf(h.y, s.x, a.y);
}

__device__ __forceinline__ void mac(float2& a, float h, float2 s) {
  a.x = fmaf(h, s.x, a.x);
  a.y = fmaf(h, s.y, a.y);
}

// K <= R taps of one phase against the lane's register window: w[0..R-2]
// holds the rows before, K more rows are loaded, and tap j meets rows
// j .. j+R-1, one for each of the lane's R outputs.
template <int R, int K, typename Tap>
__device__ __forceinline__ void phase_group(float2 (&acc)[R], float2 (&w)[2 * R - 1],
                                            const Tap* hp, const float2* sp, int pitch) {
  Tap h[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    h[j] = hp[j];
    w[R - 1 + j] = sp[j * pitch];
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) mac(acc[r], h[j], w[j + r]);
  }
}

// The last Q % R taps of a phase: phase_group<R, rest>.
template <int R, int K, typename Tap>
struct PhaseRest {
  static __device__ __forceinline__ void run(int rest, float2 (&acc)[R], float2 (&w)[2 * R - 1],
                                             const Tap* hp, const float2* sp, int pitch) {
    if (rest == K) {
      phase_group<R, K>(acc, w, hp, sp, pitch);
    } else {
      PhaseRest<R, K - 1, Tap>::run(rest, acc, w, hp, sp, pitch);
    }
  }
};
template <int R, typename Tap>
struct PhaseRest<R, 0, Tap> {
  static __device__ __forceinline__ void run(int, float2 (&)[R], float2 (&)[2 * R - 1],
                                             const Tap*, const float2*, int) {}
};

template <int R, bool kComplexTaps>
__global__ void __launch_bounds__(kThreads)
    decim_fir_phase_kernel(const float2* __restrict__ hist, int64_t H,
                           const float2* __restrict__ x, int64_t N,
                           const void* __restrict__ taps, int T, int D,
                           int Q, uint32_t magic, int64_t s0, int64_t M,
                           float2* __restrict__ y) {
  using Tap = typename std::conditional<kComplexTaps, float2, float>::type;
  constexpr int kTile = kPhaseLanes * R;  // outputs per block
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rows = kTile + Q - 1;
  const int pitch = D | 1;  // odd, so that a lane stride of R * pitch is too
  extern __shared__ float2 smem[];
  float2* win = smem;                // [rows][pitch]: sample (row, p)
  float2* red = win + rows * pitch;  // [warps][R][32]: partial sums
  Tap* hq = reinterpret_cast<Tap*>(red + kWarps * kTile);  // [D][Q]

  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kTile;
  // One past the last sample a tap of the filter reads: what lies beyond
  // meets only the zero taps past T and is staged as zero.
  const int64_t S = H + N;
  const int64_t used = s0 + (M - 1) * D + T;
  const Staging st = staging(win, rows * D, hist, H, x, s0 + m0 * D, used < S ? used : S);
  for (int i = threadIdx.x; i < rows * D; i += kThreads)
    stage(st, win, i + static_cast<int>(__umulhi(i, magic)) * (pitch - D), i);
  // The reversed taps by phase, hq[p][q] = h_rev[p + q*D], zero past T.
  {
    const Tap* h = static_cast<const Tap*>(taps);
    for (int u = threadIdx.x; u < Q * D; u += kThreads) {
      const int q = static_cast<int>(__umulhi(u, magic));
      Tap* dst = hq + (u - q * D) * Q + q;
      if (u < T) {
        stage_tap(dst, h + (T - 1 - u));
      } else {
        *dst = Tap{};
      }
    }
  }
  commit_copies();
  wait_copies(0);
  __syncthreads();

  // Lane l owns outputs l*R .. l*R+R-1 of the tile; output r of a lane
  // needs rows l*R + r + q of each phase.  Down a phase the lane slides a
  // register window of 2R-1 samples over groups of R taps: R broadcast tap
  // loads and R sample loads feed R*R MACs; the last Q % R taps go as one
  // shorter group.
  float2 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
  const float2* lane_rows = win + lane * R * pitch;
  const int groups = Q / R;
  const int rest = Q - groups * R;
  for (int p = warp; p < D; p += kWarps) {
    const float2* sp = lane_rows + p;
    const Tap* hp = hq + p * Q;
    float2 w[2 * R - 1];
#pragma unroll
    for (int j = 0; j < R - 1; ++j) w[j] = sp[j * pitch];
    sp += (R - 1) * pitch;
    for (int g = 0; g < groups; ++g) {
      phase_group<R, R>(acc, w, hp, sp, pitch);
      hp += R;
      sp += R * pitch;
#pragma unroll
      for (int j = 0; j < R - 1; ++j) w[j] = w[R + j];
    }
    PhaseRest<R, R - 1, Tap>::run(rest, acc, w, hp, sp, pitch);
  }

  // Add the warps' partial sums; thread j stores output j of the tile.
#pragma unroll
  for (int r = 0; r < R; ++r) red[(warp * R + r) * kPhaseLanes + lane] = acc[r];
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int at = (j % R) * kPhaseLanes + j / R;
    float2 sum = red[at];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 v = red[w * kTile + at];
      sum.x += v.x;
      sum.y += v.y;
    }
    if (m0 + j < M) y[m0 + j] = sum;
  }
}

template <int R, bool kComplexTaps>
cudaError_t launch_phase(const void* hist, int64_t H, const void* x, int64_t N,
                         const void* taps, int T, int D, int64_t s0, int64_t M,
                         void* y, int64_t smem, cudaStream_t stream) {
  auto kernel = decim_fir_phase_kernel<R, kComplexTaps>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kTile = kPhaseLanes * R;
  const int64_t blocks = (M + kTile - 1) / kTile;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const float2*>(hist), H, static_cast<const float2*>(x), N,
      taps, T, D, (T + D - 1) / D, div_magic(D), s0, M,
      static_cast<float2*>(y));
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs, in bytes.  form 0 (lanes across
// taps): the window of `tile` outputs over `chunk` taps, then the chunk's
// taps.  form 1 (phase-major): the window of tile + Q - 1 rows at an odd
// pitch, the warps' partial sums, the taps by phase.
extern "C" int64_t tpusdr_decim_fir_smem(int T, int D, int complex_taps,
                                         int form, int tile, int chunk) {
  if (form == 1) return phase_smem_bytes(T, D, complex_taps, tile);
  return smem_bytes(D, complex_taps, tile, chunk);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// form 0: tile is 64, 32, 16 or 8 outputs per block, chunk (<= T) taps per
// pass.  form 1: tile is 224 outputs per block, all taps in one pass,
// D >= 2.
extern "C" int tpusdr_decim_fir(const void* hist, int64_t H, const void* x,
                                int64_t N, const void* taps, int T,
                                int complex_taps, int D, int64_t s0,
                                int64_t M, int form, int tile, int chunk,
                                void* y, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (M <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (tile != kPhaseLanes * kPhaseR || chunk != T || D < 2 || D > 65535)
      return cudaErrorInvalidValue;
    const int64_t smem = phase_smem_bytes(T, D, complex_taps, tile);
    err = complex_taps
              ? launch_phase<kPhaseR, true>(hist, H, x, N, taps, T, D, s0, M, y, smem, s)
              : launch_phase<kPhaseR, false>(hist, H, x, N, taps, T, D, s0, M, y, smem, s);
    return static_cast<int>(err);
  }
  if (form != 0 || chunk < 1 || chunk > T) return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(D, complex_taps, tile, chunk);
  err = complex_taps
            ? launch_tile<true>(tile, hist, H, x, N, taps, T, D, s0, M, chunk, y, smem, s)
            : launch_tile<false>(tile, hist, H, x, N, taps, T, D, s0, M, chunk, y, smem, s);
  return static_cast<int>(err);
}
