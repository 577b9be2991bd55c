// PTX helpers shared by the port's Hopper tensor-core kernels (sm_90a):
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// wgmma forms the kernels use, for bf16 and fp16 operands with fp32
// accumulators, and the host-side tensor-map encoder.
//
// Used by flash_fwd_sm90.cu, flash_bwd_sm90.cu, lmce_sm90.cu and
// lmce_fwd_sm90.cu.
// _build.py hashes this header into every library's name, so an edit
// rebuilds them all.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace sm90 {

constexpr int kAtom = 64;       // 16-bit columns per 128-byte swizzle row
constexpr int kRowBytes = 128;
// An mbarrier wait that outlives this many cycles (~10 s) traps instead
// of hanging the card on a lost TMA completion.
constexpr long long kWaitCycles = 20000000000LL;

// ---------------------------------------------------------------------------
// element types: bf16 and fp16 share every kernel body
// ---------------------------------------------------------------------------
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // a pair rounded to nearest even, .x = lo (the lower address)
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Elem<__half> {
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One arrival (release: this thread's earlier shared-memory writes are
// seen by a thread whose wait observes the phase completing).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitCycles) __trap();
}

// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, uint64_t map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 4-D tensor map.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, uint64_t map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Add a shared-memory box into a 4-D tensor map's box in global memory
// (cp.reduce.async.bulk.tensor .add; the map's type, e.g. fp32), as a
// bulk async group of the issuing thread.  Out-of-range rows are clipped.
__device__ __forceinline__ void tma_reduce_add_4d(uint64_t map, uint32_t src,
                                                  int c0, int c1, int c2,
                                                  int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until this thread's bulk async groups have read their shared
// memory, or have completed.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (a later wgmma or TMA reading them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes to this point
// of the program, so the compiler moves no use across the wait.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SM90_F8(d, o)                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),              \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define SM90_F16(d, o) SM90_F8(d, o), SM90_F8(d, o + 8)
#define SM90_F32(d, o) SM90_F16(d, o), SM90_F16(d, o + 16)
#define SM90_R16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define SM90_R64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"  \
  " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31,"                                                              \
  " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47,"                                                              \
  " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, " \
  "%62, %63}"
#define SM90_TYPES_BF16 ".f32.bf16.bf16 "
#define SM90_TYPES_F16 ".f32.f16.f16 "

// D[64 x N] (+)= A[64 x 16] B[N x 16]^T, A and B K-major in shared
// memory; scale_d = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (Elem<T>::kMap == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16" SM90_TYPES_BF16
                 SM90_R16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : SM90_F16(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16" SM90_TYPES_F16
                 SM90_R16 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : SM90_F16(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  if constexpr (Elem<T>::kMap == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16" SM90_TYPES_BF16
                 SM90_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : SM90_F32(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16" SM90_TYPES_F16
                 SM90_R32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : SM90_F32(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (Elem<T>::kMap == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16" SM90_TYPES_BF16
                 SM90_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : SM90_F32(d, 0), SM90_F32(d, 32)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16" SM90_TYPES_F16
                 SM90_R64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"
                 : SM90_F32(d, 0), SM90_F32(d, 32)
                 : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss: N 32, 64, 128");
  if constexpr (N == 32)
    wgmma_ss_n32<T>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64<T>(d, da, db, scale_d);
  else
    wgmma_ss_n128<T>(d, da, db, scale_d);
}

// D[64 x N] (+)= A[64 x 16] B[N x 16]^T with A MN-major in shared memory
// (transpose flag set: the tile is 16 rows of K, each 64 M values in a
// 128-byte swizzled row) and B K-major; scale_d = 0 overwrites D.
template <typename T>
__device__ __forceinline__ void wgmma_ss_ta_n32(float (&d)[16], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (Elem<T>::kMap == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16" SM90_TYPES_BF16
                 SM90_R16 ", %16, %17, p, 1, 1, 1, 0;\n}\n"
                 : SM90_F16(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16" SM90_TYPES_F16
                 SM90_R16 ", %16, %17, p, 1, 1, 1, 0;\n}\n"
                 : SM90_F16(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_ta_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  if constexpr (Elem<T>::kMap == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16" SM90_TYPES_BF16
                 SM90_R32 ", %32, %33, p, 1, 1, 1, 0;\n}\n"
                 : SM90_F32(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16" SM90_TYPES_F16
                 SM90_R32 ", %32, %33, p, 1, 1, 1, 0;\n}\n"
                 : SM90_F32(d, 0)
                 : "l"(da), "l"(db), "r"(scale_d));
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss_ta(float (&d)[N / 2], uint64_t da,
                                            uint64_t db, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma_ss_ta: N 32, 64");
  if constexpr (N == 32)
    wgmma_ss_ta_n32<T>(d, da, db, scale_d);
  else
    wgmma_ss_ta_n64<T>(d, da, db, scale_d);
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A 16-bit pairs in registers (the
// m64k16 A fragment), B MN-major in shared memory (transpose flag set).
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db) {
  if constexpr (Elem<T>::kMap == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16" SM90_TYPES_BF16
                 SM90_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : SM90_F32(d, 0)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16" SM90_TYPES_F16
                 SM90_R32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : SM90_F32(d, 0)
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library already loaded in the
// process (dlopen of libcuda.so.1), so no library links -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Return codes beyond cudaError_t's: the driver entry point is missing,
// or the driver refused a tensor map (the wrappers check the rules first).
constexpr int kErrNoEncode = -1;
constexpr int kErrTensorMap = -2;

}  // namespace sm90
