// The port's host runtime: an SPSC byte ring, a file reader thread that
// fills it, and float32 PCM -> int16.
//
// Counterpart of native/tpusdr_native.cpp:33-217, 250-257 (the JAX
// package's host library), with the same roles: the reference's
// BufferPool condvar handoff (BufferPool.cpp:38-99, HackrfSource.cpp:
// 175-201) and FileReader's chunked reads (FileReader.cpp:48-66), moved
// off the pipeline thread so a 20 Msps ingest loop does not run under the
// Python GIL.  Host code only: the blocks it yields go to the card as
// packed words and convert there.
//
// What differs from the JAX library's C++:
//   * every wait takes its predicate under the ring's mutex, and every
//     change that can make a predicate true is made under it, so no
//     wakeup is lost (tpusdr_native.cpp:103-114, 133-144 test outside it);
//   * a blocking write of more than the capacity returns at once, and the
//     file reader writes pieces of at most half the capacity, so every
//     ring size works (the JAX reader's 64 KiB pieces never fit a smaller
//     ring and it retries for ever);
//   * after close, a read returns what is left, fewer bytes than asked,
//     so a stream's tail is not lost;
//   * a read reports a timeout (-1) apart from the end of the stream (0).
//
// Single producer, single consumer: the producer alone advances head, the
// consumer alone advances tail, so each copies outside the mutex into or
// out of a region the other cannot touch, then publishes under it.
//
// Plain C interface for ctypes.  Built with the host C++ compiler, not
// nvcc, by tpusdr_torch/io/native.py.

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>

namespace {

struct Ring {
  uint8_t* data = nullptr;
  size_t capacity = 0;
  uint64_t head = 0;  // bytes written, under m
  uint64_t tail = 0;  // bytes read, under m
  uint64_t dropped = 0;
  bool closed = false;
  std::mutex m;
  std::condition_variable cv;
};

size_t free_bytes(const Ring* r) { return r->capacity - static_cast<size_t>(r->head - r->tail); }

size_t used_bytes(const Ring* r) { return static_cast<size_t>(r->head - r->tail); }

// Copy n bytes in at byte position pos (mod capacity) / out from it.
void copy_in(Ring* r, uint64_t pos, const uint8_t* src, size_t n) {
  size_t at = static_cast<size_t>(pos % r->capacity);
  size_t first = std::min(n, r->capacity - at);
  std::memcpy(r->data + at, src, first);
  std::memcpy(r->data, src + first, n - first);
}

void copy_out(const Ring* r, uint64_t pos, uint8_t* dst, size_t n) {
  size_t at = static_cast<size_t>(pos % r->capacity);
  size_t first = std::min(n, r->capacity - at);
  std::memcpy(dst, r->data + at, first);
  std::memcpy(dst + first, r->data, n - first);
}

// The producer's half of a write once room is known: copy, then publish.
size_t commit_write(Ring* r, std::unique_lock<std::mutex>& lk, const uint8_t* src, size_t n) {
  uint64_t head = r->head;
  lk.unlock();
  copy_in(r, head, src, n);
  lk.lock();
  r->head = head + n;
  r->cv.notify_all();
  return n;
}

struct FileReader {
  Ring* ring = nullptr;
  std::FILE* f = nullptr;
  size_t chunk = 0;
  bool loop = false;
  std::thread th;
};

bool closed(Ring* r) {
  std::lock_guard<std::mutex> lk(r->m);
  return r->closed;
}

}  // namespace

extern "C" {

void* tpusdr_host_ring_create(size_t capacity) {
  if (capacity == 0) return nullptr;
  auto* r = new Ring();
  r->data = static_cast<uint8_t*>(std::malloc(capacity));
  if (!r->data) {
    delete r;
    return nullptr;
  }
  r->capacity = capacity;
  return r;
}

void tpusdr_host_ring_destroy(void* h) {
  auto* r = static_cast<Ring*>(h);
  if (!r) return;
  std::free(r->data);
  delete r;
}

size_t tpusdr_host_ring_available(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->m);
  return used_bytes(r);
}

uint64_t tpusdr_host_ring_dropped(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->m);
  return r->dropped;
}

// No more writes; readers drain what is left, then see the end.
void tpusdr_host_ring_close(void* h) {
  auto* r = static_cast<Ring*>(h);
  std::lock_guard<std::mutex> lk(r->m);
  r->closed = true;
  r->cv.notify_all();
}

// Write all n bytes or none: a block that does not fit is dropped and
// counted (the live-source overrun policy, HackrfSource.cpp:184-187).
// Returns n, or 0 if dropped or the ring is closed (not counted).
size_t tpusdr_host_ring_write(void* h, const uint8_t* src, size_t n) {
  auto* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->m);
  if (r->closed) return 0;
  if (n > free_bytes(r)) {
    ++r->dropped;
    return 0;
  }
  return commit_write(r, lk, src, n);
}

// Blocking write for file playback: waits for room instead of dropping,
// and never counts a drop (a paused read loses nothing).  Returns n, or 0
// at once if n exceeds the capacity, on close, or at the timeout.
size_t tpusdr_host_ring_write_wait(void* h, const uint8_t* src, size_t n, int timeout_ms) {
  auto* r = static_cast<Ring*>(h);
  if (n > r->capacity) return 0;
  std::unique_lock<std::mutex> lk(r->m);
  auto deadline = std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  if (!r->cv.wait_until(lk, deadline, [r, n] { return r->closed || n <= free_bytes(r); })) return 0;
  if (r->closed) return 0;
  return commit_write(r, lk, src, n);
}

// Read n bytes, waiting up to timeout_ms for them.  Returns n; after
// close, what is left (fewer than n, 0 at the end); -1 at the timeout.
int64_t tpusdr_host_ring_read(void* h, uint8_t* dst, size_t n, int timeout_ms) {
  auto* r = static_cast<Ring*>(h);
  std::unique_lock<std::mutex> lk(r->m);
  auto deadline = std::chrono::steady_clock::now() + std::chrono::milliseconds(timeout_ms);
  if (!r->cv.wait_until(lk, deadline, [r, n] { return r->closed || used_bytes(r) >= n; })) return -1;
  size_t got = std::min(n, used_bytes(r));
  uint64_t tail = r->tail;
  lk.unlock();
  copy_out(r, tail, dst, got);
  lk.lock();
  r->tail = tail + got;
  r->cv.notify_all();  // a producer waiting for room
  return static_cast<int64_t>(got);
}

}  // extern "C"

namespace {

void file_reader_main(FileReader* fr) {
  uint8_t* buf = static_cast<uint8_t*>(std::malloc(fr->chunk));
  bool any = false;
  while (buf && !closed(fr->ring)) {
    size_t n = std::fread(buf, 1, fr->chunk, fr->f);
    if (n == 0) {
      if (!fr->loop || !any || std::ferror(fr->f)) break;
      std::rewind(fr->f);
      continue;
    }
    any = true;
    // backpressure: wait for room; a close (the stop) ends the wait
    while (tpusdr_host_ring_write_wait(fr->ring, buf, n, 100) == 0 && !closed(fr->ring)) {
    }
  }
  std::free(buf);
  tpusdr_host_ring_close(fr->ring);
}

}  // namespace

extern "C" {

// Stream the file at path into the ring on a thread of its own, in pieces
// of at most `chunk` bytes and at most half the ring, from the start again
// at the end with `loop`; the ring is closed at the end.  nullptr if the
// file does not open.
void* tpusdr_host_file_reader_start(const char* path, void* ring, size_t chunk, int loop) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = static_cast<Ring*>(ring);
  auto* fr = new FileReader();
  fr->ring = r;
  fr->f = f;
  fr->chunk = std::max<size_t>(1, std::min(chunk ? chunk : size_t(64) << 10, r->capacity / 2));
  fr->loop = loop != 0;
  fr->th = std::thread(file_reader_main, fr);
  return fr;
}

// Stop the thread by closing the ring, and wait for it; the ring stays
// allocated.
void tpusdr_host_file_reader_stop(void* h) {
  auto* fr = static_cast<FileReader*>(h);
  if (!fr) return;
  tpusdr_host_ring_close(fr->ring);
  if (fr->th.joinable()) fr->th.join();
  std::fclose(fr->f);
  delete fr;
}

// float32 PCM in [-1, 1] -> int16: scaled by 32767, clamped, rounded half
// away from zero, the JAX library's C arithmetic (tpusdr_native.cpp:
// 250-257) step for step.
void tpusdr_host_f32_to_i16(const float* src, int16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * 32767.0f;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = static_cast<int16_t>(v + (v >= 0 ? 0.5f : -0.5f));
  }
}

}  // extern "C"
