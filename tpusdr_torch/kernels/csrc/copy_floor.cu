// Copy floor: pull a whole tick of complex64 samples through shared memory
// and write only the first 128 columns of each row.  No arithmetic.
//
//   x   : (n_rows, G) complex64, read whole, once
//   out : (n_rows, 128) complex64,  out[r, c] = x[r, c]
//
// Replaces the kernel of dma_once in benchmarks/kernel_floor_probe.py
// (kern, :280-331): on the TPU two float32 planes are copied in blocks of
// 160 rows (4 MB a plane) into VMEM by n_split concurrent DMAs a plane,
// double-buffered across the sequential grid.
//
// What bounds it: bytes.  n_rows*G*8 in, n_rows*1024 out, zero FLOP: its
// time is the least any FIR kernel that stages its input can take for the
// same tick, which is what the kernel is for.  A launch lasts as long as
// its busiest SM, so the design hands every SM the same bytes, in few and
// large copies (on an H100 the time at a 10 MB tick is the launch, the
// first byte's latency and the device memory's rate, not the issue of
// copies):
//
//  * The tick is one flat run of bytes, cut into one span a block of a
//    persistent grid (copy_floor_plan: one block an SM).  Spans are whole
//    units of `unit` bytes (128 * n_split where a piece holds it, so that
//    each of the n_split copies starts on a 128-byte line), the tail of
//    the tick that is no whole unit going with the last span; their
//    lengths differ by at most one unit and the tail, whatever G is: rows
//    play no part in the cut.
//  * A block walks its span in pieces of `piece` bytes (the plan cuts the
//    longest span into the fewest equal pieces of at most 96 KB; a span's
//    last piece may be shorter) through a ring of `stages` shared-memory
//    buffers, one mbarrier a stage.  One thread arms a stage's barrier
//    with the piece's bytes and issues n_split bulk copies (cp.async.bulk,
//    the Tensor Memory Accelerator's 1-D copy) that complete on it.  Every
//    thread waits on the barrier of every piece; the threads write the row
//    heads the piece holds (a head cut by a piece or span boundary is
//    written partly by each side); then the block synchronises and the
//    stage is refilled.  The copy is made by hardware, so the compiler
//    cannot drop it.
//
// The kernel attribute and the opt-in shared memory limit are set up once
// per device; a launch makes no query.
//
// Alignment rule of the copy: source, destination and size of every bulk
// copy are multiples of 16 bytes, so G must be a multiple of 2*n_split (the
// tick is then whole 16*n_split units), and `unit` and `piece` multiples
// of 16*n_split.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "tma_common.cuh"

namespace {

using namespace tpusdr_tma;

constexpr int kThreads = 128;
constexpr uint32_t kHeadBytes = 128 * 8;       // complex64 columns kept, in bytes
constexpr uint32_t kHeadVecs = kHeadBytes / 16;  // 16-byte vectors a row head
constexpr int kMaxDevices = 64;

// All offsets are 32-bit (the wrapper keeps a tick under 4 GB) and the
// ring's stage and phase advance by one a piece: no 64-bit or per-piece
// division stands between the launch and the first copies.
__global__ void __launch_bounds__(kThreads)
    copy_floor_kernel(const unsigned char* __restrict__ x, uint32_t row_bytes, uint32_t unit,
                      uint32_t units_per_block, uint32_t extra_units, uint32_t tail,
                      int n_split, uint32_t piece, int stages, float4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * piece);
  // this block's span [begin, begin + span): units_per_block units, one
  // more for the first extra_units blocks, and the tail for the last
  const uint32_t b = blockIdx.x;
  const uint32_t begin = (b * units_per_block + min(b, extra_units)) * unit;
  const uint32_t span =
      (units_per_block + (b < extra_units ? 1u : 0u)) * unit + (b + 1 == gridDim.x ? tail : 0u);
  // piece j is bytes [j * piece, min((j + 1) * piece, span)) of the span
  const uint32_t n_pieces = (span + piece - 1) / piece;
  const uint32_t part = piece / n_split;

  // one thread arms stage s's barrier with piece j's bytes, then issues
  // n_split bulk copies that complete on it
  auto issue = [&](uint32_t j, int s) {
    const uint32_t off = j * piece;
    const uint32_t len = span - off < piece ? span - off : piece;
    const uint32_t p = len == piece ? part : len / n_split;
    const uint32_t bar = smem_u32(bars + s);
    const uint32_t dst = smem_u32(smem + static_cast<size_t>(s) * piece);
    const unsigned char* src = x + begin + off;
    mbar_expect_tx(bar, len);
    for (int k = 0; k < n_split; ++k) bulk_load(dst + k * p, src + k * p, p, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < stages && static_cast<uint32_t>(s) < n_pieces; ++s) issue(s, s);
  }
  __syncthreads();  // the barriers are initialised before anyone waits

  uint32_t phase = 0;
  int s = 0;
  for (uint32_t j = 0; j < n_pieces; ++j) {
    while (!mbar_try_wait(smem_u32(bars + s), phase)) {
    }
    // the row heads [r * row_bytes, r * row_bytes + 1024) that meet the
    // piece [a, a + len): rows r0..r1, each vector written where it lies
    // inside the piece
    const uint32_t a = begin + j * piece;
    const uint32_t len = span - j * piece < piece ? span - j * piece : piece;
    const uint32_t r0 = a / row_bytes;
    const uint32_t in_row = a - r0 * row_bytes;
    if (in_row < kHeadBytes || in_row + len > row_bytes) {
      const unsigned char* buf = smem + static_cast<size_t>(s) * piece;
      const uint32_t n_vecs = ((a + len - 1) / row_bytes - r0 + 1) * kHeadVecs;
      for (uint32_t v = threadIdx.x; v < n_vecs; v += kThreads) {
        const uint32_t r = r0 + v / kHeadVecs;
        const uint32_t q = v % kHeadVecs;
        const uint32_t g = r * row_bytes + q * 16;
        if (g >= a && g - a < len) {
          out[r * kHeadVecs + q] = *reinterpret_cast<const float4*>(buf + (g - a));
        }
      }
    }
    __syncthreads();  // every thread is past this piece's wait: the stage may be refilled
    if (threadIdx.x == 0 && j + stages < n_pieces) issue(j + stages, s);
    if (++s == stages) s = 0, phase ^= 1;
  }
}

std::atomic<int> g_ready[kMaxDevices];  // the kernel's attribute is set on device d

// Once per device: let the kernel take as much dynamic shared memory as the
// device allows a block.  Needs `device` current.
int configure(int device) {
  if (g_ready[device].load(std::memory_order_acquire)) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(copy_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
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

// Dynamic shared memory one block needs, in bytes: the ring of pieces and
// one 8-byte mbarrier a stage.
extern "C" int64_t tpusdr_copy_floor_smem(int piece, int stages) {
  return static_cast<int64_t>(stages) * piece + static_cast<int64_t>(stages) * 8;
}

// Blocks of `smem` bytes of dynamic shared memory that the card keeps
// resident on one SM at once (a check of a plan, not called at launch);
// negative: a CUDA error.
extern "C" int tpusdr_copy_floor_resident(int64_t smem, int device) {
  int err = make_current(device);
  if (err != cudaSuccess) return -err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_floor_kernel, kThreads,
                                                      static_cast<size_t>(smem));
  return err != cudaSuccess ? -err : per_sm;
}

// x is (n_rows, G) complex64, 16-byte aligned; out is (n_rows, 128)
// complex64, n_rows * G * 8 < 2^32.  The wrapper has checked G >= 128 and
// G % (2 * n_split) == 0, and its plan (copy_floor_plan) gives unit a
// multiple of 16 * n_split, piece a multiple of unit, blocks <= max(1,
// n_rows * G * 8 / unit) and stages >= 1.  Launches on `stream`; returns
// the cudaError_t of the launch.
extern "C" int tpusdr_copy_floor(const void* x, int64_t n_rows, int G, int n_split,
                                 int unit, int blocks, int piece, int stages, void* out,
                                 int device, void* stream) {
  if (n_rows <= 0) return cudaSuccess;
  int err = make_current(device);
  if (err != cudaSuccess) return err;
  const uint32_t n_bytes = static_cast<uint32_t>(n_rows * G * 8);
  const uint32_t n_units = n_bytes / unit;
  copy_floor_kernel<<<static_cast<unsigned>(blocks), kThreads,
                      static_cast<size_t>(tpusdr_copy_floor_smem(piece, stages)),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<uint32_t>(G) * 8, unit,
      n_units / blocks, n_units % blocks, n_bytes - n_units * unit, n_split, piece, stages,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
