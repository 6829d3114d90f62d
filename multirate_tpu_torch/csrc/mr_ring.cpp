// multirate_tpu_torch native runtime: lock-free SPSC streaming ring buffer.
//
// A copy of the JAX package's native/mr_ring.cpp, kept here so that the port
// builds it from its own sources (with g++, into build/: ops/cuda/build.py).
//
// The device compute path runs fixed-size blocks; real streaming sources
// deliver arbitrary-sized chunks. This ring buffer sits between a producer
// thread (audio/SDR/network ingest) and the consumer that feeds the block
// step, providing:
//   - wait-free push/pop for a single producer + single consumer
//     (C++11 acquire/release atomics, cache-line-separated indices),
//   - fixed-block reassembly (pop_block) regardless of push chunking,
//   - a contiguous pop through a consumer-owned scratch buffer,
//   - int16 -> float32 ingest conversion (PCM/SDR sources).
//
// Block k+1 assembles here while the card filters block k.
//
// C ABI only (consumed via ctypes from multirate_tpu_torch.io.stream).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

constexpr size_t kCacheLine = 64;

struct Ring {
  float* buf;
  size_t capacity;  // power of two
  size_t mask;
  alignas(kCacheLine) std::atomic<uint64_t> head;  // next write position
  alignas(kCacheLine) std::atomic<uint64_t> tail;  // next read position
  float* scratch;   // unwrap buffer for straddling pops
};

inline size_t round_up_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

Ring* mr_ring_create(size_t min_capacity) {
  Ring* r = new (std::nothrow) Ring;
  if (!r) return nullptr;
  r->capacity = round_up_pow2(min_capacity < 64 ? 64 : min_capacity);
  r->mask = r->capacity - 1;
  r->buf = new (std::nothrow) float[r->capacity];
  r->scratch = new (std::nothrow) float[r->capacity];
  if (!r->buf || !r->scratch) {
    delete[] r->buf;
    delete[] r->scratch;
    delete r;
    return nullptr;
  }
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  return r;
}

void mr_ring_destroy(Ring* r) {
  if (!r) return;
  delete[] r->buf;
  delete[] r->scratch;
  delete r;
}

size_t mr_ring_capacity(const Ring* r) { return r->capacity; }

size_t mr_ring_size(const Ring* r) {
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

// Producer side: append n f32 samples. Returns n on success, 0 if the ring
// lacks space (caller decides: drop, block, or grow).
size_t mr_ring_push(Ring* r, const float* src, size_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (r->capacity - static_cast<size_t>(head - tail) < n) return 0;
  const size_t pos = static_cast<size_t>(head) & r->mask;
  const size_t first = r->capacity - pos < n ? r->capacity - pos : n;
  std::memcpy(r->buf + pos, src, first * sizeof(float));
  std::memcpy(r->buf, src + first, (n - first) * sizeof(float));
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Producer side: append n int16 PCM samples, converted to f32 in [-1, 1).
size_t mr_ring_push_i16(Ring* r, const int16_t* src, size_t n) {
  const uint64_t head = r->head.load(std::memory_order_relaxed);
  const uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (r->capacity - static_cast<size_t>(head - tail) < n) return 0;
  constexpr float kScale = 1.0f / 32768.0f;
  uint64_t h = head;
  for (size_t i = 0; i < n; ++i) {
    r->buf[static_cast<size_t>(h++) & r->mask] = src[i] * kScale;
  }
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// Consumer side: pop exactly `block` samples into a contiguous pointer.
// Returns a pointer into the consumer-owned scratch buffer (the copy happens
// BEFORE the space is released to the producer — returning an in-ring
// pointer after advancing tail would be a use-after-release race), or
// nullptr if fewer than `block` samples are available. Valid until the next
// pop/destroy.
const float* mr_ring_pop_block(Ring* r, size_t block) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  if (static_cast<size_t>(head - tail) < block || block > r->capacity)
    return nullptr;
  const size_t pos = static_cast<size_t>(tail) & r->mask;
  const size_t first =
      pos + block <= r->capacity ? block : r->capacity - pos;
  std::memcpy(r->scratch, r->buf + pos, first * sizeof(float));
  std::memcpy(r->scratch + first, r->buf, (block - first) * sizeof(float));
  r->tail.store(tail + block, std::memory_order_release);
  return r->scratch;
}

// Consumer side: drain whatever remains (< block) into dst; returns count.
size_t mr_ring_drain(Ring* r, float* dst, size_t max_n) {
  const uint64_t tail = r->tail.load(std::memory_order_relaxed);
  const uint64_t head = r->head.load(std::memory_order_acquire);
  size_t n = static_cast<size_t>(head - tail);
  if (n > max_n) n = max_n;
  for (size_t i = 0; i < n; ++i)
    dst[i] = r->buf[static_cast<size_t>(tail + i) & r->mask];
  r->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
