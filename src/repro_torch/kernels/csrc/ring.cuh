// The shared-memory ring's barriers and copies, shared by K2 and K3
// (table_build.cu, exact_rank.cu, through pack.cuh) and the step-1 ring
// kernel of K1/K6 and K4/K5/K7 (step1_ring.cuh).
//
// A ring stage is filled by asynchronous copies that complete on the
// stage's "full" mbarrier, and released by its consumers on its "empty"
// mbarrier. Two kinds of copy fill a stage:
//   - cp.async.bulk (the 1-D form of TMA): one instruction moves a
//     16-byte-aligned range; the bytes outside it go by ordinary loads
//     (copy_edges / copy_bulk), and each range lands at its global
//     address modulo 16;
//   - cp.async of 4 bytes a thread, which can scatter (transpose) what it
//     copies; a thread's copies arrive on an mbarrier when they complete
//     (cp_async_arrive).
// A wait on a barrier traps after 2^26 polls, so that a fault in a ring's
// protocol ends the launch with an error instead of holding the card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait takes at most a stage's work; one that outlasts 2^26 polls
// (seconds) traps, so that a fault in the ring ends the launch with an
// error rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Order this thread's generic-proxy accesses to shared memory before the
// bulk copies that follow
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes [src, src + len) of global memory land at region + (src & 15):
// the head and tail outside the 16-byte-aligned middle by the lanes'
// ordinary loads here; returns the middle's bytes, which copy_bulk moves
__device__ __forceinline__ unsigned copy_edges(unsigned char* region,
                                               const unsigned char* src,
                                               unsigned len, int lane) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  unsigned char* dst = region + (s & 15u);
  const uintptr_t lo = (s + 15u) & ~uintptr_t(15);
  const uintptr_t hi = (s + len) & ~uintptr_t(15);
  const bool bulk = hi > lo;
  const unsigned head = bulk ? (unsigned)(lo - s) : len;
  const unsigned tail = bulk ? (unsigned)(hi - s) : len;
  for (unsigned i = lane; i < head; i += 32) dst[i] = src[i];
  for (unsigned i = tail + lane; i < len; i += 32) dst[i] = src[i];
  return bulk ? (unsigned)(hi - lo) : 0u;
}

__device__ __forceinline__ void copy_bulk(unsigned char* region,
                                          const unsigned char* src,
                                          unsigned len, uint64_t* bar) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t lo = (s + 15u) & ~uintptr_t(15);
  const uintptr_t hi = (s + len) & ~uintptr_t(15);
  if (hi > lo)
    bulk_g2s(region + (s & 15u) + (lo - s),
             reinterpret_cast<const void*>(lo), (unsigned)(hi - lo), bar);
}

// Where the range copy_edges / copy_bulk moved from `src` begins in its
// region: at src's address modulo 16
__device__ __forceinline__ const unsigned char* landed_at(
    const unsigned char* region, const void* src) {
  return region + (reinterpret_cast<uintptr_t>(src) & 15u);
}

// One f32 from global to shared memory, asynchronously; src_bytes 0 writes
// +0.0f and reads nothing (a masked element)
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          unsigned src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Arrive on `bar` once every cp.async this thread issued so far has
// landed; the arrival counts against the barrier's initial count
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

}  // namespace
