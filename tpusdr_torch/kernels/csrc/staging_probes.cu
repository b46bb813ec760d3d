// Staging probes: three small kernels that stage rows of a (rows, W)
// float32 array in shared memory by asynchronous copies and then write
// from it.
//
// Replace the probes W4, X1 and X2 of benchmarks/pallas_mosaic_probes.py
// (pl.pallas_call at :55, :76, :96):
//   OP 0 (W4, K6): probe block g copies rows [g*B, g*B + B) from an offset
//              computed at run time from the block index, writes s + 1;
//   OP 1 (X1, K7): probe block g copies the window [g*B, g*B + B + P-1),
//              whose row count is not a multiple of 8 and which overlaps
//              the next block's by P-1 rows, and writes rows 0:B of it
//              times 2;
//   OP 2 (X2, K8): out[r] = sum_{p<P} x[r + p]: shared memory is read at
//              every row offset p = 0..P-1.
//
// What bounds them: bytes (each element read once, written once) and, at
// the probes' sizes (2 MB in, 2 MB out, 16 KB an SM), the launch, the
// first byte's latency and the tail.  They are capability checks, not hot
// kernels.
//
// K6 and K7 (staged_kernel).  What K7 stages is the TPU's: the windows of
// B + P-1 rows one after another, S = window 0, window 1, ... (the last
// window ends with x), n_out + (probe blocks) * (P-1) rows in all; window
// g holds output rows [g*B, g*B + B) and then its halo.  K6 is the same
// with no halo and the whole output as one window.  Full-width rows are
// contiguous, so byte r of window g is byte g*B*row + r of x, and of the
// output where it is not halo.
//  * S is cut into one span a block of a persistent grid (one block an SM,
//    fewer where the bytes are few, so that no span is empty), in whole
//    units of `unit` (128) bytes, so that the SMs stage equal bytes and
//    every copy of a window starts on a 128-byte line of it; the tail that
//    is no whole unit goes with the last span.  The host divides out the
//    quotient and remainder; all index arithmetic on the card is 32-bit
//    (the wrapper refuses x or S of 4 GB).
//  * A block walks its span in pieces of `piece` bytes through a ring of
//    `stages` shared-memory buffers, one mbarrier a stage.  The threads are
//    cut into `groups` groups of whole warps; group g takes pieces g,
//    g + groups, ..., and so owns the stages s with s % groups == g.  The
//    group's first thread initialises its barriers, arms each with its
//    piece's bytes and issues a bulk copy (cp.async.bulk) for each window
//    the piece meets (one or two at the probes' shapes), all completing on
//    it; the groups do so at once, and no block-wide barrier follows.  The
//    group's threads wait on the barrier of each of its pieces in turn and
//    store its output bytes, so the first pieces are stored while the later
//    ones are in flight, each by its own warps.  A group meets (a named
//    barrier) after its set-up and before it refills one of its stages.
//  * Stores of 16 bytes: each thread reads a float4 from the stage, applies
//    the op and stores it, neighbouring threads on neighbouring addresses.
//    (A bulk store of each piece after the op in place lost 0.1-0.3 us at
//    every plan on an H100 and went.)
// The kernels' attribute is set once per device; a launch makes no query.
//
// K8 (shift_sum_kernel): out[r] = x[r] + x[r+1] + ... + x[r+P-1], added
// in that order (X2's kernel body, :89-93), so it is exact against the
// plain version.  Bytes bound it (x read once, out written once); at the
// probe's 0.5 MB in, the launch, the first byte's latency and the busiest
// SM do.
//  * The output rows are cut into `runs` runs of R or R+1 rows, the columns
//    into tiles of `tile` floats; a unit is a run of one tile.  A
//    persistent grid: block b takes units b, b + blocks, ... (one unit a
//    block at the probe's shape: 132 runs of 7-8 rows on 132 SMs).
//  * A unit's window, its rows and the P-1 after them, of its columns, is
//    staged by bulk copies (cp.async.bulk) into one stage of a ring, on the
//    stage's mbarrier: full rows are contiguous, one copy; a tile narrower
//    than the row takes one copy a row, issued by the lanes of warp 0
//    (all the block's threads where it has fewer than 32).
//    Warp 0 issues the block's first stages before the block meets, and
//    refills a stage once every thread is done with it, so unit k + stages
//    is in flight while unit k is summed.
//  * Threads (tile/4, groups): thread (c, g) owns float4 column c of the
//    tile and a contiguous slice of the unit's rows (group g).  Its reads of
//    the stage are 16 bytes, at every row offset 0..P-1, neighbouring
//    threads on neighbouring addresses, issued before the add chain; its
//    stores are 16 bytes.  P = 11 (the probe's) is a template parameter,
//    its 11 loads unrolled; other P run a loop unrolled by 4.
//  * All index arithmetic on the card is 32-bit (the wrapper refuses x of 4
//    GB); the host divides (div_magic), the attribute is set once a device.
//
// Alignment rule of the copies: source, destination and size of every copy
// are multiples of 16 bytes, so W must be a multiple of 4 floats and x
// 16-byte aligned; there is no rule on the number of rows.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tma_common.cuh"

namespace {

using namespace tpusdr_tma;

constexpr int kThreads = 256;
constexpr int kProbeTaps = 11;  // K8: the P of probe X2, known at compile time
constexpr int kMaxDevices = 64;

// the threads of group g (1..8 groups of kThreads / groups) meet
__device__ __forceinline__ void group_sync(uint32_t g, uint32_t per_group) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(per_group) : "memory");
}

template <int OP>
__device__ __forceinline__ float4 apply(float4 f) {
  if (OP == 0) return make_float4(f.x + 1.0f, f.y + 1.0f, f.z + 1.0f, f.w + 1.0f);
  return make_float4(f.x * 2.0f, f.y * 2.0f, f.z * 2.0f, f.w * 2.0f);
}

// K6 (OP 0) and K7 (OP 1), as above.  Byte offsets into S, x and out;
// n_out is the output's bytes, blk a probe block's output bytes (B rows),
// halo its P-1 rows (0 for K6), n_win the windows; (win_magic, win_shift)
// divide by a window's bytes (div_magic).
template <int OP>
__global__ void __launch_bounds__(kThreads)
    staged_kernel(const unsigned char* __restrict__ x, uint32_t unit, uint32_t units_per_block,
                  uint32_t extra_units, uint32_t tail, uint32_t n_out, uint32_t blk,
                  uint32_t halo, uint32_t n_win, uint32_t win_magic, uint32_t win_shift,
                  uint32_t piece, int stages, int groups, float4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * piece);
  // this block's span [begin, begin + span) of S
  const uint32_t b = blockIdx.x;
  const uint32_t begin = (b * units_per_block + min(b, extra_units)) * unit;
  const uint32_t span =
      (units_per_block + (b < extra_units ? 1u : 0u)) * unit + (b + 1 == gridDim.x ? tail : 0u);
  // piece j is bytes [j * piece, min((j + 1) * piece, span)) of the span
  const uint32_t win = blk + halo;
  const uint32_t last = n_win - 1;
  auto win_bytes = [&](uint32_t w) { return w == last ? n_out - w * blk + halo : win; };
  // the window w0 and the offset r0 in it of the span's first byte (K6:
  // one window, so no division), and of the byte `off` after it
  uint32_t w0 = 0, r0 = begin;
  if (OP == 1) {
    const uint32_t hi = __umulhi(begin, win_magic);
    w0 = min((hi + ((begin - hi) >> 1)) >> (win_shift - 1), last);  // begin / win
    r0 = begin - w0 * win;
  }
  auto seek = [&](uint32_t off, uint32_t& w, uint32_t& r) {
    w = w0, r = r0 + off;
    if (OP == 1) {
      while (r >= win_bytes(w)) r -= win_bytes(w), ++w;
    }
  };
  // one bulk copy for each window that piece j meets, on stage s's barrier
  auto issue = [&](uint32_t j, int s) {
    const uint32_t off = j * piece;
    const uint32_t len = span - off < piece ? span - off : piece;
    const uint32_t bar = smem_u32(bars + s);
    const uint32_t dst = smem_u32(smem + static_cast<size_t>(s) * piece);
    uint32_t w, r;
    seek(off, w, r);
    mbar_expect_tx(bar, len);
    if (OP == 0 || r + len <= win_bytes(w)) {  // one window: one copy
      bulk_load(dst, x + w * blk + r, len, bar);
      return;
    }
    for (uint32_t done = 0, n; done < len; done += n, ++w, r = 0) {
      n = min(len - done, win_bytes(w) - r);
      bulk_load(dst + done, x + w * blk + r, n, bar);
    }
  };

  // group g of the block's threads takes pieces g, g + groups, ... and so
  // the stages s with s % groups == g (groups divides stages); its first
  // thread sets up those stages and issues their first pieces
  const uint32_t per_group = kThreads / groups;
  const uint32_t g = threadIdx.x / per_group, t = threadIdx.x - g * per_group;
  // the threads of a group store n bytes of a stage from `in` to byte `at`
  // of the output, 16 a thread at a time
  auto store = [&](const unsigned char* in, uint32_t at, uint32_t n) {
    const float4* from = reinterpret_cast<const float4*>(in);
    float4* to = out + at / 16;
#pragma unroll 4
    for (uint32_t v = t; v < n / 16; v += per_group) to[v] = apply<OP>(from[v]);
  };
  if (t == 0) {
    for (int s = g; s < stages; s += groups) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = g; s < stages && s * piece < span; s += groups) issue(s, s);
  }
  group_sync(g, per_group);  // the group's barriers are initialised before it waits
  uint32_t phase = 0;
  int s = static_cast<int>(g);
  for (uint32_t j = g; j * piece < span; j += groups) {
    const unsigned char* buf = smem + static_cast<size_t>(s) * piece;
    const uint32_t off = j * piece;
    const uint32_t len = span - off < piece ? span - off : piece;
    uint32_t w, r;
    seek(off, w, r);
    // all output, in one window (K6 always; K7 but where a halo is)
    const bool plain = OP == 0 || r + len <= (w == last ? n_out - w * blk : blk);
    while (!mbar_try_wait(smem_u32(bars + s), phase)) {
    }
    if (plain) {
      store(buf, w * blk + r, len);
    } else {  // the output bytes of each window the piece meets: all but its halo
      for (uint32_t done = 0, n; done < len; done += n, ++w, r = 0) {
        n = min(len - done, win_bytes(w) - r);
        const uint32_t o = w == last ? n_out - w * blk : blk;
        if (r < o) store(buf + done, w * blk + r, min(o - r, n));
      }
    }
    if (stages * piece < span - off) {  // piece j + stages exists
      group_sync(g, per_group);  // the group is done with this stage and past its wait
      if (t == 0) issue(j + stages, s);
    }
    if ((s += groups) >= stages) s -= stages, phase ^= 1;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One output from P staged rows, added in order: `at` its first row's
// float4 in the stage, `pitch` float4 a staged row.  PS is P where the
// kernel takes it as a template parameter (the probe's 11), all P loads
// issued before the add chain; PS = 0 takes P at run time, the loads
// issued 4 at a time before their adds.
template <int PS>
__device__ __forceinline__ float4 shifted_sum(const float4* at, uint32_t pitch, uint32_t P) {
  if constexpr (PS > 0) {
    float4 v[PS];
#pragma unroll
    for (int p = 0; p < PS; ++p) v[p] = at[p * pitch];
    float4 a = v[0];
#pragma unroll
    for (int p = 1; p < PS; ++p) a = add4(a, v[p]);
    return a;
  } else {
    float4 a = at[0];
    uint32_t p = 1;
    for (; p + 4 <= P; p += 4) {
      const float4 v0 = at[p * pitch], v1 = at[(p + 1) * pitch], v2 = at[(p + 2) * pitch],
                   v3 = at[(p + 3) * pitch];
      a = add4(add4(add4(add4(a, v0), v1), v2), v3);
    }
    for (; p < P; ++p) a = add4(a, at[p * pitch]);
    return a;
  }
}

// K8, as above.  x holds rows_out + P-1 rows of W floats, out rows_out
// rows (as float4); `runs` runs of R rows, the first `extra` of them R+1;
// n_ct column tiles of `tile` floats (the last may be narrower), (ct_magic,
// ct_shift) divide by n_ct (div_magic; unused for one tile); a group of
// threads takes n_long rows of a run of R+1 and n_short of one of R; the
// ring is `stages` stages of `stage` bytes, then a barrier a stage.  PS is
// P as a template parameter, 0 for P at run time.
template <int PS>
__global__ void __launch_bounds__(kThreads)
    shift_sum_kernel(const float* __restrict__ x, uint32_t W, uint32_t P, uint32_t R,
                     uint32_t extra, uint32_t n_units, uint32_t n_ct, uint32_t ct_magic,
                     uint32_t ct_shift, uint32_t tile, uint32_t n_long, uint32_t n_short,
                     uint32_t stage, int stages, float4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * stage);
  const uint32_t halo = (PS > 0 ? PS : P) - 1;
  const uint32_t threads = blockDim.x * blockDim.y;
  const uint32_t tid = threadIdx.y * blockDim.x + threadIdx.x;
  const uint32_t lane_count = threads < 32 ? threads : 32;  // warp 0's threads
  const uint32_t lanes = lane_count == 32 ? 0xffffffffu : (1u << lane_count) - 1;
  const uint32_t step = gridDim.x;
  // unit u: run u / n_ct, column tile u % n_ct
  struct Unit {
    uint32_t row0, rows, col0, cols;
  };
  auto unit = [&](uint32_t u) {
    uint32_t r = u, t = 0;
    if (n_ct > 1) {
      const uint32_t hi = __umulhi(u, ct_magic);
      r = (hi + ((u - hi) >> 1)) >> (ct_shift - 1);
      t = u - r * n_ct;
    }
    const uint32_t col0 = t * tile;
    return Unit{r * R + min(r, extra), R + (r < extra ? 1u : 0u), col0, min(tile, W - col0)};
  };
  // warp 0 stages unit u's window, its rows and the P-1 after them, in stage s
  auto issue = [&](uint32_t u, int s) {
    const Unit w = unit(u);
    const uint32_t bar = smem_u32(bars + s);
    const uint32_t dst = smem_u32(smem + static_cast<size_t>(s) * stage);
    const uint32_t rows = w.rows + halo, bytes = w.cols * 4;
    const float* src = x + w.row0 * W + w.col0;
    if (tid == 0) mbar_expect_tx(bar, rows * bytes);
    if (n_ct == 1) {  // full rows: one contiguous window, one copy
      if (tid == 0) bulk_load(dst, src, rows * bytes, bar);
      return;
    }
    __syncwarp(lanes);
    for (uint32_t i = tid; i < rows; i += lane_count) bulk_load(dst + i * bytes, src + i * W, bytes, bar);
  };

  if (tid < 32) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(smem_u32(bars + s), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp(lanes);
    for (int s = 0; s < stages && blockIdx.x + s * step < n_units; ++s) issue(blockIdx.x + s * step, s);
  }
  __syncthreads();  // the barriers are initialised before anyone waits
  const uint32_t c = threadIdx.x;
  uint32_t phase = 0;
  int s = 0;
  for (uint32_t u = blockIdx.x; u < n_units; u += step) {
    const Unit w = unit(u);
    const uint32_t n = w.rows > R ? n_long : n_short;
    const uint32_t i0 = min(threadIdx.y * n, w.rows), i1 = min(i0 + n, w.rows);
    const uint32_t pitch = w.cols / 4, opitch = W / 4;
    while (!mbar_try_wait(smem_u32(bars + s), phase)) {
    }
    if (c < pitch && i0 < i1) {
      const float4* at = reinterpret_cast<const float4*>(smem + static_cast<size_t>(s) * stage) +
                         i0 * pitch + c;
      float4* o = out + (w.row0 + i0) * opitch + w.col0 / 4 + c;
      for (uint32_t i = i0; i < i1; ++i, at += pitch, o += opitch) *o = shifted_sum<PS>(at, pitch, P);
    }
    if (u + stages * step < n_units) {  // unit u + stages * step takes this stage next
      __syncthreads();  // every thread is done with it
      if (tid < 32) issue(u + stages * step, s);
    }
    if (++s == stages) s = 0, phase ^= 1;
  }
}

using ShiftSumKernel = void (*)(const float*, uint32_t, uint32_t, uint32_t, uint32_t, uint32_t,
                                uint32_t, uint32_t, uint32_t, uint32_t, uint32_t, uint32_t,
                                uint32_t, int, float4*);
// the probe's P as a template parameter, any other at run time
const ShiftSumKernel kShiftSum[2] = {shift_sum_kernel<kProbeTaps>, shift_sum_kernel<0>};

using StagedKernel = void (*)(const unsigned char*, uint32_t, uint32_t, uint32_t, uint32_t,
                              uint32_t, uint32_t, uint32_t, uint32_t, uint32_t, uint32_t,
                              uint32_t, int, int, float4*);

// n / d == (t + ((n - t) >> 1)) >> (shift - 1), t = umulhi(n, magic), for
// every 32-bit n and 2 <= d < 2^32 (division by a constant as compilers
// emit it): no division on the card before the first copy.
void div_magic(uint32_t d, uint32_t* magic, uint32_t* shift) {
  uint32_t s = 0;
  while ((uint64_t{1} << s) < d) ++s;
  *magic = static_cast<uint32_t>(((uint64_t{1} << 32) * ((uint64_t{1} << s) - d)) / d + 1);
  *shift = s;
}
const StagedKernel kStaged[2] = {staged_kernel<0>, staged_kernel<1>};

std::atomic<int> g_ready[kMaxDevices];  // the kernels' attribute is set on device d

// Once per device: let the kernels take as much dynamic shared memory as
// the device allows a block.  Needs `device` current.
int configure(int device) {
  if (g_ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  for (StagedKernel k : kStaged) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  for (ShiftSumKernel k : kShiftSum) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
  }
  g_ready[device].store(1, std::memory_order_release);
  return cudaSuccess;
}

int make_current(int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return err;
  return configure(device);
}

}  // namespace

// Dynamic shared memory of one K6 or K7 block, in bytes: the ring of
// pieces and one 8-byte mbarrier a stage.
extern "C" int64_t tpusdr_staging_smem(int piece, int stages) {
  return static_cast<int64_t>(stages) * piece + static_cast<int64_t>(stages) * 8;
}

// K6 (op 0) or K7 (op 1) by a plan (staging_probes.staging_plan).  x holds
// n_out bytes of output rows, then for K7 `halo` bytes more (P-1 rows),
// 16-byte aligned; out holds n_out bytes; blk is a probe block's output
// bytes (B rows; n_out for K6), n_win = ceil(n_out / blk) windows; x and
// S = n_out + n_win * halo are under 4 GB.  The plan gives unit and piece
// multiples of 16 (piece of unit), blocks <= max(1, S / unit), stages >= 1
// a multiple of groups (1, 2, 4 or 8).  Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int tpusdr_staging(int op, const void* x, int64_t n_out, int64_t blk, int64_t halo,
                              int64_t n_win, int unit, int blocks, int piece, int stages,
                              int groups, void* out, int device, void* stream) {
  if (n_out <= 0) return cudaSuccess;
  if (op < 0 || op > 1) return cudaErrorInvalidValue;
  if ((groups != 1 && groups != 2 && groups != 4 && groups != 8) || stages % groups) {
    return cudaErrorInvalidValue;
  }
  int err = make_current(device);
  if (err != cudaSuccess) return err;
  const uint32_t n_s = static_cast<uint32_t>(n_out + n_win * halo);
  const uint32_t n_units = n_s / unit;
  uint32_t magic, shift;
  div_magic(static_cast<uint32_t>(blk + halo), &magic, &shift);
  kStaged[op]<<<static_cast<unsigned>(blocks), kThreads,
                static_cast<size_t>(tpusdr_staging_smem(piece, stages)),
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), unit, n_units / blocks, n_units % blocks,
      n_s - n_units * unit, static_cast<uint32_t>(n_out), static_cast<uint32_t>(blk),
      static_cast<uint32_t>(halo), static_cast<uint32_t>(n_win), magic, shift, piece, stages,
      groups, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one K8 block, in bytes: `stages` stages, each
// the window of the longest run (ceil(rows_out / runs) + P-1 rows of `tile`
// floats) rounded up to 128 bytes, and one 8-byte mbarrier a stage.
extern "C" int64_t tpusdr_shift_sum_smem(int64_t rows_out, int P, int64_t runs, int tile,
                                         int stages) {
  const int64_t rows = (rows_out + runs - 1) / runs + P - 1;
  const int64_t stage = (rows * tile * 4 + 127) / 128 * 128;
  return static_cast<int64_t>(stages) * (stage + 8);
}

// K8 by a plan (staging_probes.shift_sum_plan).  x holds rows_out + P-1
// rows of W floats (W a multiple of 4, x 16-byte aligned, under 4 GB); out
// holds rows_out rows.  The plan gives 1 <= runs <= rows_out, `tile` a
// multiple of 4, blocks >= 1, stages >= 1, groups >= 1 with tile / 4 *
// groups <= 256 threads.  Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int tpusdr_shift_sum(const void* x, int64_t rows_out, int W, int P, int blocks,
                                int64_t runs, int tile, int stages, int groups, void* out,
                                int device, void* stream) {
  if (rows_out <= 0) return cudaSuccess;
  if (P < 1 || W < 4 || W % 4 || tile < 4 || tile % 4 || runs < 1 || runs > rows_out ||
      blocks < 1 || stages < 1 || groups < 1 || tile / 4 * groups > kThreads) {
    return cudaErrorInvalidValue;
  }
  int err = make_current(device);
  if (err != cudaSuccess) return err;
  const uint32_t R = static_cast<uint32_t>(rows_out / runs);
  const uint32_t extra = static_cast<uint32_t>(rows_out % runs);
  const uint32_t n_ct = static_cast<uint32_t>((W + tile - 1) / tile);
  uint32_t magic = 0, shift = 0;
  if (n_ct > 1) div_magic(n_ct, &magic, &shift);
  const int64_t smem = tpusdr_shift_sum_smem(rows_out, P, runs, tile, stages);
  const ShiftSumKernel k = kShiftSum[P == kProbeTaps ? 0 : 1];
  k<<<static_cast<unsigned>(blocks), dim3(static_cast<unsigned>(tile / 4), static_cast<unsigned>(groups)),
      static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint32_t>(W), static_cast<uint32_t>(P), R, extra,
      static_cast<uint32_t>(runs) * n_ct, n_ct, magic, shift, static_cast<uint32_t>(tile),
      (R + groups) / groups, (R + groups - 1) / groups, static_cast<uint32_t>(smem / stages - 8),
      stages, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
