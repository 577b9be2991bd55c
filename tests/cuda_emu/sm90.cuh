// CPU twin of the part of paddle_tpu_torch/csrc/sm90.cuh that the paged
// attention kernel uses: mbarriers and the 1-D bulk copy.  The emulated
// build finds this file before csrc/ (emulate.py compiles with -I on this
// folder), so the kernel's own code runs unchanged around it.
//
// A shared-memory address is an offset into the block's emulated dynamic
// shared memory.  An mbarrier is the 64 bits it occupies on the card,
// updated atomically: pending arrivals (bits 0-11), the count it was
// initialised with (12-23), the phase (24) and the signed transaction
// count (32-63).  A phase completes when the pending arrivals and the
// transaction count both reach 0, as on the card.  A bulk copy is a
// memcpy that then counts its bytes off the barrier; it checks the
// card's alignment rules first.
#pragma once

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

#include "cuda_runtime.h"

namespace sm90 {

inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) -
                               emu_dyn_smem);
}

inline std::atomic_ref<uint64_t> emu_bar(uint32_t bar) {
  if (bar % 8) std::abort();
  return std::atomic_ref<uint64_t>(
      *reinterpret_cast<uint64_t*>(emu_dyn_smem + bar));
}

inline void mbar_init(uint32_t bar, uint32_t count) {
  emu_bar(bar).store(static_cast<uint64_t>(count) | (uint64_t{count} << 12));
}

inline void mbar_init_fence() {}

inline void emu_update(uint32_t bar, uint32_t arrivals, int32_t tx) {
  auto a = emu_bar(bar);
  uint64_t old = a.load();
  for (;;) {
    const uint32_t lo = static_cast<uint32_t>(old);
    uint32_t pending = lo & 0xfffu;
    const uint32_t expected = (lo >> 12) & 0xfffu;
    uint32_t phase = (lo >> 24) & 1u;
    int32_t count = static_cast<int32_t>(old >> 32);
    if (pending < arrivals) {
      std::fprintf(stderr, "mbarrier: more arrivals than expected\n");
      std::abort();
    }
    pending -= arrivals;
    count += tx;
    if (pending == 0 && count == 0) {
      phase ^= 1u;
      pending = expected;
    }
    const uint64_t next =
        (static_cast<uint64_t>(static_cast<uint32_t>(count)) << 32) |
        pending | (expected << 12) | (phase << 24);
    if (a.compare_exchange_weak(old, next)) return;
  }
}

inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  emu_update(bar, 1, static_cast<int32_t>(bytes));
}

inline void mbar_arrive(uint32_t bar) { emu_update(bar, 1, 0); }

inline void mbar_wait(uint32_t bar, uint32_t parity) {
  const auto t0 = std::chrono::steady_clock::now();
  while (((emu_bar(bar).load() >> 24) & 1u) == parity) {
    std::this_thread::yield();
    if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(60)) {
      std::fprintf(stderr, "mbarrier: wait timed out\n");
      std::abort();
    }
  }
}

inline void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                         uint32_t bar) {
  if (dst % 16 || reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16 ||
      bytes == 0) {
    std::fprintf(stderr, "bulk copy: address or size not 16-byte aligned\n");
    std::abort();
  }
  std::memcpy(emu_dyn_smem + dst, src, bytes);
  emu_update(bar, 0, -static_cast<int32_t>(bytes));
}

}  // namespace sm90
