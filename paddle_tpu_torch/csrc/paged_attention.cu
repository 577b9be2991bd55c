// Ragged paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/inference/serving/paged_attention_kernel.py::
// _paged_attn_kernel (the Pallas kernel behind paged_ragged_attention).
//
// What it computes: for every request b and head h, one query row
// q[b, h, :] attends the request's first len_b cached positions, which
// live in pages of a [NB, BS, H, Dh] K/V pool named by page_table[b, :].
// Online softmax with f32 statistics; positions >= len_b contribute
// exactly nothing; the result is divided by max(l, DENOM_TINY), so a
// row with len_b == 0 returns exact 0.0, never NaN.  Output in the
// input dtype (fp32, bf16 or fp16).
//
// What bounds it: device-memory bytes.  Each (b, h) reads its len_b
// K and V rows once -- at most sum_b ceil(len_b/BS)*BS*H*Dh*2*itemsize
// per layer counting whole pages, sum_b len_b*H*Dh*2*itemsize counting
// only the real rows, which is what this kernel touches -- and does
// 4 flops per element read, far below the card's ~20 flop/byte fp32
// ridge.  So the design reads only the real pages, straight through the
// page table, never the [B, MAXNB*BS, H, Dh] gather the plain version
// materialises, and keeps every intermediate in registers.
//
// Design: one CTA per (h, b), kWarps warps cut into groups of LANES
// lanes: a whole warp per row when Dh is a multiple of 32, half a warp
// otherwise (Dh = 16, gpt_tiny's head dim, and the other multiples of
// 16), so a warp then walks two token tiles at once.  Group g walks
// tokens g*kUnroll, g*kUnroll + groups*kUnroll, ... in tiles of kUnroll
// consecutive tokens, issuing the tile's K/V loads together and the
// next tile's page-table reads before this tile's arithmetic; each lane
// owns Dh/LANES consecutive features (a coalesced row read per group),
// the q.k dot is a butterfly reduction over the group (the warp's loop
// runs while its first group has tokens, so every shuffle has all 32
// lanes), and each group keeps its own (m, l, acc).  The groups'
// partial states are merged once through shared memory at the end.  The
// CTA reads the page table and the length itself, so the launch shape
// depends on (B, H) only.
// Lengths clamp to [0, MAXNB*BS] and page ids to [0, NB-1], so a stale
// or inactive row stays memory-safe.  cp.async double buffering of
// pages, split-K over long contexts and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kMaskValue = -1e30f;  // MASK_VALUE of ragged_attention.py
constexpr float kDenomTiny = 1e-30f;  // DENOM_TINY of ragged_attention.py
constexpr int kWarps = 16;
constexpr int kUnroll = 4;

template <int EPL>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&o)[EPL]) {
  if constexpr (EPL % 4 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      o[i] = v.x; o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] = p[i];
  }
}

template <int EPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p,
                                         float (&o)[EPL]) {
  if constexpr (EPL % 8 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h2[j]);
        o[i + 2 * j] = f.x; o[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 2) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p + i));
      o[i] = f.x; o[i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] = __bfloat162float(p[i]);
  }
}

template <int EPL>
__device__ __forceinline__ void load_row(const __half* __restrict__ p,
                                         float (&o)[EPL]) {
  if constexpr (EPL % 8 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + i);
      const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __half22float2(h2[j]);
        o[i + 2 * j] = f.x; o[i + 2 * j + 1] = f.y;
      }
    }
  } else if constexpr (EPL % 2 == 0) {
#pragma unroll
    for (int i = 0; i < EPL; i += 2) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(p + i));
      o[i] = f.x; o[i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < EPL; ++i) o[i] = __half2float(p[i]);
  }
}

// Page ids of tokens t0 .. t0+kUnroll-1 (0 past the length), clamped
// to the pool so a stale table entry stays memory-safe.
__device__ __forceinline__ void fetch_pages(const int32_t* __restrict__ trow,
                                            int t0, int len, int BS, int NB,
                                            int (&pages)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 + u;
    pages[u] = t < len ? min(max(trow[t / BS], 0), NB - 1) : 0;
  }
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch does
}
__device__ __forceinline__ void store_elem(__half* p, float v) {
  *p = __float2half_rn(v);
}

template <typename T, int EPL, int LANES>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                  const T* __restrict__ pool_v,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ lengths, T* __restrict__ out,
                  int H, int NB, int BS, int MAXNB, float scale) {
  constexpr int Dh = EPL * LANES;
  constexpr int kPerWarp = 32 / LANES;          // groups in a warp
  constexpr int kGroups = kWarps * kPerWarp;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int grp = threadIdx.x / LANES;
  const int gl = threadIdx.x % LANES;

  const int len = max(0, min(lengths[b], MAXNB * BS));
  const int32_t* trow = table + static_cast<size_t>(b) * MAXNB;

  float qv[EPL];
  load_row<EPL>(q + (static_cast<size_t>(b) * H + h) * Dh + gl * EPL, qv);

  float m = kMaskValue;
  float l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) acc[i] = 0.f;

  constexpr int kStride = kGroups * kUnroll;
  const int lead = (grp % kPerWarp) * kUnroll;  // this group's offset
  int pages[kUnroll];
  fetch_pages(trow, warp * kPerWarp * kUnroll + lead, len, BS, NB, pages);
  for (int tw0 = warp * kPerWarp * kUnroll; tw0 < len; tw0 += kStride) {
    const int t0 = tw0 + lead;
    float kr[kUnroll][EPL];
    float vr[kUnroll][EPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const size_t off =
            ((static_cast<size_t>(pages[u]) * BS + (t % BS)) * H + h) * Dh +
            gl * EPL;
        load_row<EPL>(pool_k + off, kr[u]);
        load_row<EPL>(pool_v + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < EPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
    // the next tile's page ids load while this tile computes, so a
    // page-table read never stands in series with the K/V reads
    fetch_pages(trow, t0 + kStride, len, BS, NB, pages);
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < EPL; ++i) d = fmaf(qv[i], kr[u][i], d);
      s[u] = d;
    }
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = (t0 + u < len) ? s[u] * scale : kMaskValue;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u < len) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[i] = fmaf(p, vr[u][i], acc[i]);
      }
    }
    m = m_new;
  }

  // merge the groups' partial softmax states
  __shared__ float sm_m[kGroups];
  __shared__ float sm_l[kGroups];
  __shared__ float sm_acc[kGroups][Dh];
  if (gl == 0) {
    sm_m[grp] = m;
    sm_l[grp] = l;
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i) sm_acc[grp][gl * EPL + i] = acc[i];
  __syncthreads();

  float m_all = kMaskValue;
#pragma unroll
  for (int w = 0; w < kGroups; ++w) m_all = fmaxf(m_all, sm_m[w]);
  float wscale[kGroups];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kGroups; ++w) {
    wscale[w] = expf(sm_m[w] - m_all);
    l_all += sm_l[w] * wscale[w];
  }
  const float denom = fmaxf(l_all, kDenomTiny);
  T* orow = out + (static_cast<size_t>(b) * H + h) * Dh;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) o = fmaf(sm_acc[w][d], wscale[w], o);
    store_elem(orow + d, o / denom);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const void* table, const void* lengths, void* out, int B,
                   int H, int Dh, int NB, int BS, int MAXNB, float scale,
                   cudaStream_t stream) {
  const dim3 grid(H, B);
  const dim3 block(kWarps * 32);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(pool_k);
  const T* vp = static_cast<const T*>(pool_v);
  const int32_t* tp = static_cast<const int32_t*>(table);
  const int32_t* lp = static_cast<const int32_t*>(lengths);
  T* op = static_cast<T*>(out);
#define PADDLE_PAGED_CASE(EPL, LANES)                                     \
  case EPL:                                                               \
    paged_attn_kernel<T, EPL, LANES><<<grid, block, 0, stream>>>(         \
        qp, kp, vp, tp, lp, op, H, NB, BS, MAXNB, scale);                 \
    break;
  if (Dh % 32 == 0) {   // a warp per row
    switch (Dh / 32) {
      PADDLE_PAGED_CASE(1, 32)
      PADDLE_PAGED_CASE(2, 32)
      PADDLE_PAGED_CASE(3, 32)
      PADDLE_PAGED_CASE(4, 32)
      PADDLE_PAGED_CASE(5, 32)
      PADDLE_PAGED_CASE(6, 32)
      PADDLE_PAGED_CASE(7, 32)
      PADDLE_PAGED_CASE(8, 32)
      default:
        return cudaErrorInvalidValue;
    }
  } else {              // half a warp per row: Dh / 16 is odd
    switch (Dh / 16) {
      PADDLE_PAGED_CASE(1, 16)
      PADDLE_PAGED_CASE(3, 16)
      PADDLE_PAGED_CASE(5, 16)
      PADDLE_PAGED_CASE(7, 16)
      PADDLE_PAGED_CASE(9, 16)
      PADDLE_PAGED_CASE(11, 16)
      PADDLE_PAGED_CASE(13, 16)
      PADDLE_PAGED_CASE(15, 16)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef PADDLE_PAGED_CASE
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  dtype: 0 = float32, 1 = bfloat16, 2 = float16;
// Dh a multiple of 16 up to 256.  All pointers
// are device pointers of contiguous tensors; the launch goes on
// `stream` and does not synchronise.  Returns a cudaError_t (0 = ok).
extern "C" int paddle_paged_attention(int dtype, const void* q,
                                      const void* pool_k, const void* pool_v,
                                      const void* table, const void* lengths,
                                      void* out, int B, int H, int Dh, int NB,
                                      int BS, int MAXNB, float scale,
                                      void* stream) {
  if (Dh <= 0 || Dh % 16 != 0 || Dh > 256 || B <= 0 || H <= 0 || NB <= 0 ||
      BS <= 0 || MAXNB <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch<float>(q, pool_k, pool_v, table, lengths, out, B, H, Dh, NB,
                        BS, MAXNB, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, pool_k, pool_v, table, lengths, out, B, H,
                                Dh, NB, BS, MAXNB, scale, s);
  else if (dtype == 2)
    err = launch<__half>(q, pool_k, pool_v, table, lengths, out, B, H, Dh, NB,
                         BS, MAXNB, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
