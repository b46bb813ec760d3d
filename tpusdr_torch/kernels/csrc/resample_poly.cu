// Rational polyphase resampler over a batch of rows, real float32, through
// a virtual concatenation s = [hist, x] of each row read through two
// pointers (upfirdn's contract, tpusdr_torch/ops/resample.py):
//
//   y[m] = sum_{i<P} h[p_m + i*U] * x[n_m - i],   p_m = (m*D) mod U,
//                                                 n_m = (m*D) div U,
//
// with H = P-1 carried samples in front of the tick, so that in s the sum
// is over s[n_m .. n_m + P-1] against class p_m's taps reversed.  Outputs of
// phase class c (m = c + U*t) share their taps, hr_c[j] = h[p_c +
// (P-1-j)*U], and start at n_c + t*D, n_c = (c*D) div U.  float32 products
// and sums, every tap of every class, in one launch for every row.  The
// kernel also writes each row's next carry, the last H samples of s.
//
// It replaces no TPU kernel: the JAX package's resampler is plain jnp
// (tpusdr/ops/resample.py), and the port's plain version of it
// (ops/resample.py, _resample_real) stacks U shifted copies of the whole
// row, framed by D, then adds one gemv a frame tap, behind a cat of [hist,
// x].  On the card that moved each input sample about U*P/D times through
// device memory (147 MB to use 4.4 MB at the 57-row 33/125 shape).
//
// What bounds it: each input sample is read once and each output written
// once (4 bytes each), with 2P operations an output: at 33/125 (P = 138)
// and 6/25 (P = 152) bytes and operations both take 1.2-2 us a tick on an
// H100.  A sample is used by about T/D outputs of different classes, and
// within a class by P/D outputs (about 1 at 33/125), so what limits a loop
// that reads its operands from shared memory is the loads a multiply-add.
//
// The design: a product of the window and a banded tap table.  Group the
// classes by four, g = c / 4, and let nb_g = n_{4g}.  Then
//
//   y[c, t] = sum_{k<L} s[t*D + nb_g + k] * G[g][k][c % 4],
//
// with G[g][k][r] = hr_c[k + nb_g - n_c] inside class c's band and 0
// outside it (or past U); L covers the widest group's band, P plus the
// spread of its four n_c (``group_taps`` builds G on the host once a plan).
// An item is one t and one group: four outputs.
//  * A block owns `tile` consecutive t of one row and a run of `groups`
//    groups, all of them unless the table would not fit (a resampler with
//    U in the thousands).  It stages its part of G by 16-byte asynchronous
//    copies and its window of s, from t0*D + nb of its first group for
//    (tile-1)*D + the groups' spread + L samples (zero past the stream's
//    end), by 4-byte ones, all before one wait.
//  * S threads take an item, each the k = s, s + S, ..: per step one
//    sample load and one 16-byte tap load, a broadcast where the lanes
//    share a group, for four multiply-adds into four registers.  With S = 1
//    the lanes of a warp are consecutive t of one group: their sample loads
//    stride by D (odd in every receiver, so no bank conflicts).  S > 1
//    splits the taps of an item for a launch with few outputs (WBFM's one
//    row: S = 32, a warp an item), and a butterfly adds the S parts.  The
//    tap table read from the read-only cache instead cost 60% more at
//    33/125 and 6/25 (PERF.md).
//  * Results go to shared memory in their interleaved place, so a block of
//    all the groups writes its part of the row once, contiguous.
// The wrapper's rule (kernels/resample_poly.py, resample_plan) picks S, the
// tile and the groups a block from the shape.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 4;          // classes an item: one 16-byte tap load
constexpr int kMaxThreads = 1024;  // a block: groups * tile * S threads, rounded up to a warp

struct Args {
  const float* hist;  // sample k of row r at hist[r * hist_row + k * es]
  int64_t hist_row;
  const float* x;
  int64_t x_row;
  int64_t H, N;  // carried samples and tick a row
  int es;        // element stride: 1, or 2 for one plane of complex data
  const float4* taps;  // G: [ceil(U/4)][L] of four classes' taps
  int L;
  int U, D;
  int64_t M;  // outputs a row, a multiple of U
  float* y;
  int64_t y_row;
  float* carry;  // (rows, H) at the same element stride
  int64_t carry_row;
  int tile;    // t a block
  int tiles;   // tiles a row
  int groups;  // groups a block
  int runs;    // runs of groups a tile
};

__device__ __forceinline__ const float* sample_at(const Args& a, int64_t row, int64_t k) {
  return k < a.H ? a.hist + row * a.hist_row + k * a.es : a.x + row * a.x_row + (k - a.H) * a.es;
}

__host__ __device__ __forceinline__ int groups_of(int U) { return (U + kGroup - 1) / kGroup; }

// Samples a block's window may need: `tile` t of a run of `groups` groups,
// whose first classes' n spread by at most 4 (groups-1) D / U + 1.
__host__ __device__ __forceinline__ int window_of(int U, int D, int L, int tile, int groups) {
  return (tile - 1) * D + (kGroup * (groups - 1) * D) / U + 1 + L;
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads) resample_poly_kernel(const Args a) {
  const int U = a.U, D = a.D, L = a.L, tile = a.tile;
  const int run = blockIdx.x % a.runs;
  const int64_t row = blockIdx.x / a.runs / a.tiles;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x / a.runs % a.tiles) * tile;
  const int64_t t_count = a.M / U;
  const int64_t left = t_count - t0;
  const int tt = left < tile ? static_cast<int>(left) : tile;  // t of this block
  const int g0 = run * a.groups;
  const int gn = min(a.groups, groups_of(U) - g0);  // groups of this block
  const int c0 = kGroup * g0;
  const int cw = min(U, kGroup * (g0 + gn)) - c0;  // classes of this block
  const int nb0 = c0 * D / U;
  const int W = (tile - 1) * D + kGroup * (g0 + gn - 1) * D / U - nb0 + L;

  extern __shared__ float4 smem4[];
  float4* taps = smem4;                                        // [gn][L]
  float* win = reinterpret_cast<float*>(taps + a.groups * L);  // [W]: s[t0*D + nb0 ..]
  float* out = win + window_of(U, D, L, tile, a.groups);       // [tile][cw]: outputs in place
  {
    const uint32_t taps_at = static_cast<uint32_t>(__cvta_generic_to_shared(taps));
    const float4* tp = a.taps + static_cast<int64_t>(g0) * L;
    for (int i = threadIdx.x; i < gn * L; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(taps_at + i * 16), "l"(tp + i) : "memory");
    // the window in three runs: carried samples, the tick, zeros past its end
    const int64_t e0 = t0 * D + nb0;
    auto clamp = [W](int64_t v) { return static_cast<int>(v < 0 ? 0 : (v > W ? W : v)); };
    const int in_hist = clamp(a.H - e0), in_x = clamp(a.H + a.N - e0);
    const uint32_t win_at = static_cast<uint32_t>(__cvta_generic_to_shared(win));
    const float* hp = a.hist + row * a.hist_row + e0 * a.es;
    for (int i = threadIdx.x; i < in_hist; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(win_at + i * 4), "l"(hp + i * a.es) : "memory");
    const float* xp = a.x + row * a.x_row + (e0 - a.H) * a.es;
    for (int i = in_hist + threadIdx.x; i < in_x; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(win_at + i * 4), "l"(xp + i * a.es) : "memory");
    for (int i = in_x + threadIdx.x; i < W; i += blockDim.x) win[i] = 0.f;
    asm volatile("cp.async.commit_group;" ::: "memory");
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }

  const int item = threadIdx.x / S;  // group-major: item = gl * tile + tl
  const int s = threadIdx.x % S;
  const int gl = item / tile;
  const int tl = item - gl * tile;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (gl < gn) {
    const float* w = win + tl * D + kGroup * (g0 + gl) * D / U - nb0;
    const float4* h = taps + gl * L;
#pragma unroll 4
    for (int k = s; k < L; k += S) {
      const float v = w[k];
      const float4 hk = h[k];
      acc.x = fmaf(v, hk.x, acc.x);
      acc.y = fmaf(v, hk.y, acc.y);
      acc.z = fmaf(v, hk.z, acc.z);
      acc.w = fmaf(v, hk.w, acc.w);
    }
  }
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) {  // the S parts of an item, in consecutive lanes
    acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
    acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    acc.z += __shfl_xor_sync(0xffffffffu, acc.z, off);
    acc.w += __shfl_xor_sync(0xffffffffu, acc.w, off);
  }
  if (s == 0 && gl < gn && tl < tt) {
    const int c = kGroup * gl;  // the item's first class in the block
    float* o = out + c + cw * tl;
    o[0] = acc.x;
    if (c + 1 < cw) o[1] = acc.y;
    if (c + 2 < cw) o[2] = acc.z;
    if (c + 3 < cw) o[3] = acc.w;
  }
  __syncthreads();

  float* y = a.y + row * a.y_row + (t0 * U + c0) * a.es;
  if (cw == U) {  // every class: the block's part of the row is one run
    for (int i = threadIdx.x; i < tt * U; i += blockDim.x) y[static_cast<int64_t>(i) * a.es] = out[i];
  } else {
    for (int i = threadIdx.x; i < tt * cw; i += blockDim.x)
      y[(static_cast<int64_t>(i / cw) * U + i % cw) * a.es] = out[i];
  }
  if (t0 + tile >= t_count && run == 0) {  // the row's last block writes its carry: s[N .. N+H)
    float* carry = a.carry + row * a.carry_row;
    for (int k = threadIdx.x; k < a.H; k += blockDim.x) carry[static_cast<int64_t>(k) * a.es] = *sample_at(a, row, a.N + k);
  }
}

int64_t smem_bytes(int U, int D, int L, int tile, int groups) {
  return static_cast<int64_t>(groups) * L * sizeof(float4) +
         (static_cast<int64_t>(window_of(U, D, L, tile, groups)) + static_cast<int64_t>(kGroup) * groups * tile) *
             sizeof(float);
}

template <int S>
cudaError_t launch(const Args& a, int64_t blocks, int threads, int64_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(resample_poly_kernel<S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  resample_poly_kernel<S><<<static_cast<unsigned>(blocks), threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block, in bytes: its groups' part of G
// (float4), the window of `tile` t of those groups, then their outputs.
extern "C" int64_t tpusdr_resample_poly_smem(int U, int D, int L, int tile, int groups) {
  return smem_bytes(U, D, L, tile, groups);
}

// `rows` rows of s = [hist (H samples), x (N samples)], each at its row
// stride and the element stride `es`; M = (N / D) * U outputs a row into y
// and the last H samples of s into carry.  taps: the table G, [ceil(U/4)]
// [L] of float4, 16-byte aligned.  tile: t a block; groups: groups of four
// classes a block; S (1, 2, 4, 8, 16 or 32): threads an item; a block has
// groups * tile * S threads, at most 1024.  Launches on `stream`; returns
// the cudaError_t of the launch (0 = ok).
extern "C" int tpusdr_resample_poly(const void* hist, int64_t hist_row, const void* x, int64_t x_row,
                                    int64_t H, int64_t N, int es, const void* taps, int L, int U,
                                    int D, int64_t M, int64_t rows, int tile, int S, int groups,
                                    void* y, int64_t y_row, void* carry, int64_t carry_row,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows <= 0 || M <= 0) return cudaSuccess;
  const bool s_ok = S == 1 || S == 2 || S == 4 || S == 8 || S == 16 || S == 32;
  if (U < 1 || D < 1 || L < 1 || tile < 1 || groups < 1 || M % U != 0 || H < 0 ||
      (es != 1 && es != 2) || !s_ok || (reinterpret_cast<uintptr_t>(taps) & 15) != 0)
    return cudaErrorInvalidValue;
  if (static_cast<int64_t>(groups) * tile * S > kMaxThreads) return cudaErrorInvalidValue;
  const int threads = (groups * tile * S + 31) / 32 * 32;
  const int64_t tiles = (M / U + tile - 1) / tile;
  const int runs = (groups_of(U) + groups - 1) / groups;
  const int64_t blocks = rows * tiles * runs;
  if (blocks > 0x7fffffff || tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(hist), hist_row, static_cast<const float*>(x), x_row, H, N,
               es, static_cast<const float4*>(taps), L, U, D, M, static_cast<float*>(y), y_row,
               static_cast<float*>(carry), carry_row, tile, static_cast<int>(tiles), groups, runs};
  const int64_t smem = smem_bytes(U, D, L, tile, groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 1: return static_cast<int>(launch<1>(a, blocks, threads, smem, st));
    case 2: return static_cast<int>(launch<2>(a, blocks, threads, smem, st));
    case 4: return static_cast<int>(launch<4>(a, blocks, threads, smem, st));
    case 8: return static_cast<int>(launch<8>(a, blocks, threads, smem, st));
    case 16: return static_cast<int>(launch<16>(a, blocks, threads, smem, st));
    default: return static_cast<int>(launch<32>(a, blocks, threads, smem, st));
  }
}
