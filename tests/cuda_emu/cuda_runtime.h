// CPU emulation of the CUDA runtime subset that the port's kernels use,
// for tests on a machine without a card or nvcc.  A launch runs its
// blocks one after another; the threads of a block run as std::threads
// that meet at __syncthreads() on a std::barrier, and a warp's threads
// meet on their own barrier for each shuffle.  Dynamic shared memory is
// filled with NaN before each block, so a read of a value no thread
// wrote shows up in the result.  Only what the kernels call is here.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__ __restrict
#define __launch_bounds__(...)
using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> emu_warp_barriers;
inline float emu_shuffle[1024];
inline unsigned char* emu_dyn_smem = nullptr;
// each kernel's dynamic shared-memory limit, as cudaFuncSetAttribute set it
inline std::map<const void*, int> emu_smem_limits;

inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }

// A block's threads really run at once, so the add must be atomic.
inline float atomicAdd(float* address, float val) {
  return std::atomic_ref<float>(*address).fetch_add(val);
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  emu_warp_barriers[w]->arrive_and_wait();  // last shuffle's reads done
  emu_shuffle[t] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  return emu_shuffle[w * 32 + (lane ^ lane_mask)];
}

inline int emu_shuffle_int[1024];
inline int __shfl_sync(unsigned, int v, int src_lane) {
  const int t = threadIdx.x, w = t / 32;
  emu_warp_barriers[w]->arrive_and_wait();
  emu_shuffle_int[t] = v;
  emu_warp_barriers[w]->arrive_and_wait();
  return emu_shuffle_int[w * 32 + (src_lane & 31)];
}

// Every lane of the warp must call it, as on the card with a full mask.
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}

template <class T>
cudaError_t cudaFuncSetAttribute(T* fn, cudaFuncAttribute, int value) {
  emu_smem_limits[reinterpret_cast<const void*>(fn)] = value;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}

// kernel<<<grid, block, smem, stream>>>(args) is rewritten to
// emu_launch(&kernel, grid, block, smem, [&] { kernel(args); }).
inline void emu_launch(const void* kernel, dim3 grid, dim3 block, size_t smem,
                       const std::function<void()>& body) {
  const auto it = emu_smem_limits.find(kernel);
  const int limit = it == emu_smem_limits.end() ? 48 * 1024 : it->second;
  if (smem > static_cast<size_t>(limit) || smem > 232448) {
    std::fprintf(stderr, "launch asks %zu bytes of shared memory (limit "
                 "%d, card 232448)\n", smem, limit);
    std::abort();
  }
  gridDim = grid;
  blockDim = block;
  const int nt = block.x * block.y * block.z;
  if (nt > 1024) std::abort();
  std::vector<float> buf(smem / sizeof(float) + 4);
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::fill(buf.begin(), buf.end(), std::nanf(""));
        emu_dyn_smem = reinterpret_cast<unsigned char*>(buf.data());
        std::barrier<> bar(nt);
        emu_block_barrier = &bar;
        emu_warp_barriers.clear();
        for (int w = 0; w < (nt + 31) / 32; ++w)
          emu_warp_barriers.emplace_back(
              new std::barrier<>(std::min(32, nt - 32 * w)));
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t)
          threads.emplace_back([&, t, bx, by, bz] {
            threadIdx = dim3(t, 0, 0);
            blockIdx = dim3(bx, by, bz);
            body();
          });
        for (auto& th : threads) th.join();
      }
}
