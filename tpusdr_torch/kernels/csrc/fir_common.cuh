// What the FIR kernels share (decim_fir.cu, fm_fused.cu, fir_poly.cu): the
// block size, the staging of a window of s = [hist, x] into shared memory
// by asynchronous copies, the phase-major inner loop's building blocks, and
// that loop with real taps and a phase's own tap count (FM-fused and K4).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tpusdr_fir {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ceil(2^32 / D): i / D == __umulhi(i, magic) for i, D < 65536.
inline uint32_t div_magic(int D) {
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
// copies are still in flight; the opcode takes an immediate.
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

constexpr int kPhaseLanes = 32;  // lanes of a warp, all across outputs

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

// ---- the phase-major form with real taps (fm_fused.cu, fir_poly.cu) ----------
//
// A block owns 32 R consecutive sums.  Its window is tile + Q - 1 rows of D
// samples at the odd pitch D | 1 (Q = ceil(T/D)), then the warps' partial
// sums [warps][R][32], then the reversed taps by phase, hq[p][q] =
// h_rev[p + q*D], zero past T.

// Shared memory of one such block of `tile` = 32 R sums, in bytes.
inline int64_t phase_block_bytes(int T, int D, int tile) {
  const int Q = (T + D - 1) / D;
  const int64_t rows = tile + Q - 1;
  const int64_t pitch = D | 1;
  return (rows * pitch + static_cast<int64_t>(kWarps) * tile) * sizeof(float2) +
         static_cast<int64_t>(D) * Q * sizeof(float);
}

// Stage the n = rows * D samples of st's range, sample i at row i / D,
// column i % D of the window.
__device__ __forceinline__ void stage_rows(const Staging& st, float2* win, int n, int D,
                                           int pitch, uint32_t magic) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    stage(st, win, i + static_cast<int>(__umulhi(i, magic)) * (pitch - D), i);
}

// Stage the reversed taps by phase, hq[p][q] = h_rev[p + q*D], zero past T.
__device__ __forceinline__ void stage_phase_taps(float* hq, const float* taps, int T, int D, int Q,
                                                 uint32_t magic) {
  for (int u = threadIdx.x; u < Q * D; u += kThreads) {
    const int q = static_cast<int>(__umulhi(u, magic));
    float* dst = hq + (u - q * D) * Q + q;
    if (u < T) {
      stage_tap(dst, taps + (T - 1 - u));
    } else {
      *dst = 0.f;
    }
  }
}

// The lane's partial sums: lane l of warp w owns sums l*R .. l*R+R-1 of the
// block and takes the phases w, w + 8, ..; sum r of the lane needs rows
// l*R + r + q of each phase.  Phases below `full` = T - (Q-1)*D have Q
// taps, the rest Q - 1.  Down a phase the lane slides a register window of
// 2R-1 samples over groups of R taps: R broadcast tap loads and R sample
// loads feed R*R MACs; the last Qp % R taps go as one shorter group.
template <int R>
__device__ __forceinline__ void phase_sums(float2 (&acc)[R], const float2* win, const float* hq,
                                           int T, int D, int Q, int pitch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float2(0.f, 0.f);
  const float2* lane_rows = win + lane * R * pitch;
  const int full = T - (Q - 1) * D;
  for (int p = warp; p < D; p += kWarps) {
    const int Qp = p < full ? Q : Q - 1;
    const int groups = Qp / R;
    const int rest = Qp - groups * R;
    const float2* sp = lane_rows + p;
    const float* hp = hq + p * Q;
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
    PhaseRest<R, R - 1, float>::run(rest, acc, w, hp, sp, pitch);
  }
}

// Add the warps' partial sums through red; store(j, sum) takes sum j of the
// block, from thread j % 256.  Every warp is past its last read of the
// window when store runs.
template <int R, typename Store>
__device__ __forceinline__ void add_phase_sums(const float2 (&acc)[R], float2* red, Store store) {
  constexpr int kTile = kPhaseLanes * R;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) red[(warp * R + r) * kPhaseLanes + lane] = acc[r];
  __syncthreads();
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int at = (j % R) * kPhaseLanes + j / R;
    float2 sum = red[at];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 part = red[w * kTile + at];
      sum.x += part.x;
      sum.y += part.y;
    }
    store(j, sum);
  }
}

}  // namespace tpusdr_fir
