// Ragged paged decode attention for Hopper (sm_90a): split-K over the
// context, K/V tiles brought into shared memory by bulk asynchronous
// copies.
//
// Replaces paddle_tpu/inference/serving/paged_attention_kernel.py::
// _paged_attn_kernel (the Pallas kernel behind paged_ragged_attention).
// csrc/paged_attention.cu, the first port of it (one CTA per (head,
// request) walking the whole context), stays as the wrapper's comparison
// entry _cuda_core_paged.
//
// What it computes: for every request b and head h, one query row
// q[b, h, :] attends the request's first len_b cached positions, which
// live in pages of a [NB, BS, H, Dh] K/V pool named by page_table[b, :].
// Online softmax with f32 statistics; positions >= len_b contribute
// exactly nothing; the result is divided by max(l, DENOM_TINY), so a
// row with len_b == 0 returns exact 0.0.  Output in the input dtype
// (fp32, bf16 or fp16); Dh any multiple of 16 up to 256, any BS and H.
// Lengths clamp to [0, MAXNB*BS] and page ids to [0, NB-1], so a stale
// or inactive row stays memory-safe.
//
// What bounds it: device-memory bytes.  Each real position's K and V
// rows are read once: sum_b len_b * H*Dh*2*itemsize bytes, against 4
// flops per element (one q.k and one p.v multiply-add), i.e. 1 flop per
// byte in fp32 and 2 in bf16, far under the card's ridge.  With one
// query row per (b, h) a product has M = 1; wgmma needs 64 rows, so the
// tensor cores have nothing to do here and this kernel uses none.  What
// the card offers it is bytes in flight: many CTAs, each with several
// bulk copies outstanding, and no narrow scattered loads.
//
// Design.
// 1. Split-K.  The grid is (split, request, head group).  A CTA takes
//    the tokens [s*ST, (s+1)*ST) of request b, reading lengths[b] and
//    the page table itself; a CTA whose range starts at or past the
//    length exits when a combine follows, and with one split runs its
//    empty range, writing the row's exact 0.  The split count and
//    every other launch number come from the shapes only (the wrapper's
//    split_plan: B, H, Dh, BS, MAXNB, the dtype and the SM count), so
//    the launch never waits on the lengths.
// 2. Bulk copies.  One token's K (or V) row is H*Dh contiguous elements
//    and a run of tokens inside one page is contiguous too, so a tile of
//    up to TT tokens that does not cross a page is ONE
//    cp.async.bulk of tl*H*Dh*itemsize bytes (no tensor map, so no host
//    encode per call).  Where a head group is narrower than a row, each
//    token's slice is one copy (HG*Dh*itemsize >= 32 bytes, 16-byte
//    aligned).  Only the real tokens are copied.  The producer warp (the
//    CTA's last) reads 32 page ids at a time with one coalesced load,
//    and fills a ring of `stages` K+V tiles on full/empty mbarriers.
// 3. Consumers.  A group of G lanes (a power of two, <= 32) owns one
//    head of the group and a 16-byte chunk of its Dh per lane (two where
//    Dh*itemsize > 512); TS groups per head take every TS-th token of a
//    tile.  A group scores kBatch tokens from shared memory with 16-byte
//    reads and fp32 FMAs, reduces them over its lanes in one butterfly,
//    and updates its online softmax and fp32 accumulator in registers.
//    The TS groups of a head merge through shared memory at the end.
// 4. Combine in a fixed order.  With one split the CTA writes the output
//    itself.  Otherwise it writes its fp32 partial (m, l, acc[Dh]) to a
//    workspace the wrapper allocates, and a second launch over (request,
//    head x Dh) merges the splits s < ceil(len/ST) in split order, so
//    two runs give the same bits and an empty row stays exact 0.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"
#include "smem_limit.cuh"

namespace {

constexpr float kMaskValue = -1e30f;  // MASK_VALUE of ragged_attention.py
constexpr float kDenomTiny = 1e-30f;  // DENOM_TINY of ragged_attention.py
constexpr int kBatch = 4;             // tokens scored before one reduction
constexpr int kMaxThreads = 416;      // 384 consumers + the producer warp
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 128;        // 2 * kMaxStages mbarriers
constexpr int kCombineThreads = 256;  // at most; Dh threads a CTA

// 16 bytes of T as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      o[2 * j] = f.x; o[2 * j + 1] = f.y;
    }
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __half* p, float (&o)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h2 = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __half22float2(h2[j]);
      o[2 * j] = f.x; o[2 * j + 1] = f.y;
    }
  }
};

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch does
}
__device__ __forceinline__ void store_elem(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The launch's shape: everything but the pointers.
struct Geometry {
  int H, Dh, NB, BS, MAXNB;
  int HG;      // heads a CTA takes (a divisor of H)
  int TT;      // tokens a tile holds at most
  int TS;      // token groups per head
  int stages;  // tiles in the ring
  int ST;      // tokens a split takes
  int NS;      // splits: ceil(MAXNB*BS / ST)
  float scale;
};

// Tokens of the tile that starts at t0: at most TT, never across a page
// or past the split's end.
__device__ __forceinline__ int tile_len(const Geometry& g, int t0,
                                        int t_end) {
  return min(g.TT, min(g.BS - t0 % g.BS, t_end - t0));
}

template <typename T, int G, int CPL>
__global__ void __launch_bounds__(kMaxThreads, 2)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ pool_k,
                   const T* __restrict__ pool_v,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ lengths, T* __restrict__ out,
                   float* __restrict__ ws, Geometry g) {
  constexpr int V = Vec<T>::N;
  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int hg0 = blockIdx.z * g.HG;
  const int t_begin = s * g.ST;
  const int n_cw = static_cast<int>(blockDim.x >> 5) - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = threadIdx.x / G;  // a consumer's group
  const int gl = threadIdx.x % G;   // its lane in the group
  const bool real = warp < n_cw && gid < g.HG * g.TS;
  const int C = g.Dh / V;           // 16-byte chunks of one head's row
  const int32_t* trow = table + static_cast<size_t>(b) * g.MAXNB;

  // the first 32 page ids (producer) and q (consumers) load while the
  // length does
  int win = (t_begin / g.BS) & ~31;
  int mine = 0;
  float qv[CPL][V];
  if (warp == n_cw) {
    if (win + lane < g.MAXNB) mine = trow[win + lane];
  } else {
    const int h = real ? gid % g.HG : 0;
    const T* qrow = q + (static_cast<size_t>(b) * g.H + hg0 + h) * g.Dh;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = gl + j * G;
      if (real && c < C) {
        Vec<T>::load(qrow + c * V, qv[j]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) qv[j][i] = 0.f;
      }
    }
  }
  const int len = max(0, min(lengths[b], g.MAXNB * g.BS));
  // past the length the combine skips this split; with one split no
  // combine follows, so the CTA runs its empty range and writes the row
  // (len == 0) as 0 / DENOM_TINY = exact 0
  if (t_begin >= len && g.NS > 1) return;
  const int t_end = min(len, t_begin + g.ST);

  const int row = g.HG * g.Dh;          // elements of a token's slice
  const int tile_elems = g.TT * row;    // one tile of K (or of V)
  extern __shared__ uint4 smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_raw);
  const uint32_t bar0 = sm90::smem_u32(base);  // full[i] then empty[i]
  T* ring = reinterpret_cast<T*>(base + kBarBytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < g.stages; ++i) {
      sm90::mbar_init(bar0 + 8 * i, 1);
      sm90::mbar_init(bar0 + 8 * (kMaxStages + i), n_cw);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  float m = kMaskValue;
  float l = 0.f;
  float acc[CPL][V];
#pragma unroll
  for (int j = 0; j < CPL; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
  }

  if (warp == n_cw) {
    // producer: page ids 32 at a time, one bulk copy per tile (or per
    // token slice), as soon as the stage is free
    const size_t tok = static_cast<size_t>(g.H) * g.Dh;
    const uint32_t slice = static_cast<uint32_t>(row * sizeof(T));
    int k = 0;
    for (int t0 = t_begin; t0 < t_end; ++k) {
      const int tl = tile_len(g, t0, t_end);
      const int pidx = t0 / g.BS;
      if ((pidx & ~31) != win) {
        win = pidx & ~31;
        mine = win + lane < g.MAXNB ? trow[win + lane] : 0;
      }
      const int page =
          min(max(__shfl_sync(0xffffffffu, mine, pidx & 31), 0), g.NB - 1);
      const int st = k % g.stages;
      if (k >= g.stages)
        sm90::mbar_wait(bar0 + 8 * (kMaxStages + st),
                        ((k / g.stages) - 1) & 1);
      const uint32_t full = bar0 + 8 * st;
      if (lane == 0) sm90::mbar_expect_tx(full, 2u * tl * slice);
      __syncwarp();
      const size_t src =
          (static_cast<size_t>(page) * g.BS + (t0 - pidx * g.BS)) * tok +
          static_cast<size_t>(hg0) * g.Dh;
      T* kd = ring + static_cast<size_t>(st) * 2 * tile_elems;
      T* vd = kd + tile_elems;
      if (g.HG == g.H) {  // the tile's rows are contiguous in the pool
        if (lane == 0) {
          sm90::bulk_load_1d(sm90::smem_u32(kd), pool_k + src, tl * slice,
                             full);
          sm90::bulk_load_1d(sm90::smem_u32(vd), pool_v + src, tl * slice,
                             full);
        }
      } else {
        for (int r = lane; r < tl; r += 32) {
          sm90::bulk_load_1d(sm90::smem_u32(kd + r * row),
                             pool_k + src + r * tok, slice, full);
          sm90::bulk_load_1d(sm90::smem_u32(vd + r * row),
                             pool_v + src + r * tok, slice, full);
        }
      }
      t0 += tl;
    }
  } else {
    // consumers: group (h, ts) scores tokens ts, ts + TS, ... of a tile
    const int h = real ? gid % g.HG : 0;
    const int ts = real ? gid / g.HG : 0;
    const int upt = (g.TT + g.TS - 1) / g.TS;  // tokens a group takes
    int k = 0;
    for (int t0 = t_begin; t0 < t_end; ++k) {
      const int tl = tile_len(g, t0, t_end);
      const int st = k % g.stages;
      sm90::mbar_wait(bar0 + 8 * st, (k / g.stages) & 1);
      const T* ks = ring + static_cast<size_t>(st) * 2 * tile_elems +
                    h * g.Dh;
      const T* vs = ks + tile_elems;
      for (int u0 = 0; u0 < upt; u0 += kBatch) {
        float sc[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int uu = 0; uu < kBatch; ++uu) {
          const int r = ts + (u0 + uu) * g.TS;
          ok[uu] = real && u0 + uu < upt && r < tl;
          float d = 0.f;
          if (ok[uu]) {
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              const int c = gl + j * G;
              if (c < C) {
                float kv[V];
                Vec<T>::load(ks + r * row + c * V, kv);
#pragma unroll
                for (int i = 0; i < V; ++i) d = fmaf(qv[j][i], kv[i], d);
              }
            }
          }
          sc[uu] = d;
        }
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int uu = 0; uu < kBatch; ++uu)
            sc[uu] += __shfl_xor_sync(0xffffffffu, sc[uu], off);
        }
        float m_new = m;
#pragma unroll
        for (int uu = 0; uu < kBatch; ++uu) {
          sc[uu] = ok[uu] ? sc[uu] * g.scale : kMaskValue;
          m_new = fmaxf(m_new, sc[uu]);
        }
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
#pragma unroll
          for (int i = 0; i < V; ++i) acc[j][i] *= alpha;
        }
#pragma unroll
        for (int uu = 0; uu < kBatch; ++uu) {
          if (ok[uu]) {
            const int r = ts + (u0 + uu) * g.TS;
            const float p = expf(sc[uu] - m_new);
            l += p;
#pragma unroll
            for (int j = 0; j < CPL; ++j) {
              const int c = gl + j * G;
              if (c < C) {
                float vv[V];
                Vec<T>::load(vs + r * row + c * V, vv);
#pragma unroll
                for (int i = 0; i < V; ++i) acc[j][i] = fmaf(p, vv[i],
                                                             acc[j][i]);
              }
            }
          }
        }
        m = m_new;
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(bar0 + 8 * (kMaxStages + st));
      t0 += tl;
    }
  }

  // merge the TS groups of each head (the ring is free: every tile was
  // consumed), then write the split's partial or, with one split, out
  __syncthreads();
  const int groups = g.HG * g.TS;
  float* gm = reinterpret_cast<float*>(ring);
  float* gls = gm + groups;
  float* ga = gls + groups;
  if (real) {
    if (gl == 0) {
      gm[gid] = m;
      gls[gid] = l;
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = gl + j * G;
      if (c < C) {
#pragma unroll
        for (int i = 0; i < V; ++i) ga[gid * g.Dh + c * V + i] = acc[j][i];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < row; idx += blockDim.x) {
    const int hh = idx / g.Dh;
    const int d = idx - hh * g.Dh;
    float mx = kMaskValue;
    for (int t = 0; t < g.TS; ++t) mx = fmaxf(mx, gm[t * g.HG + hh]);
    float ls = 0.f;
    float a = 0.f;
    for (int t = 0; t < g.TS; ++t) {
      const int x = t * g.HG + hh;
      const float w = expf(gm[x] - mx);
      ls = fmaf(gls[x], w, ls);
      a = fmaf(ga[x * g.Dh + d], w, a);
    }
    const int head = hg0 + hh;
    if (g.NS == 1) {
      store_elem(out + (static_cast<size_t>(b) * g.H + head) * g.Dh + d,
                 a / fmaxf(ls, kDenomTiny));
    } else {
      float* part =
          ws + ((static_cast<size_t>(b) * g.NS + s) * g.H + head) *
                   (g.Dh + 2);
      part[2 + d] = a;
      if (d == 0) {
        part[0] = mx;
        part[1] = ls;
      }
    }
  }
}

// out[b, h, :] from the partials of splits 0 .. ceil(len_b/ST)-1, merged
// in split order: one CTA per (h, b).  The splits' m and l come in
// together and their weights exp(m - max) go to shared memory, then each
// thread sums its column of acc over the splits with the loads in
// flight together.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ ws,
                     const int32_t* __restrict__ lengths, T* __restrict__ out,
                     int H, int Dh, int BS, int MAXNB, int ST, int NS) {
  extern __shared__ uint4 smem_raw[];
  float* w = reinterpret_cast<float*>(smem_raw);  // [NS] m, then weights
  float* lw = w + NS;                              // [NS] l * weight
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int len = max(0, min(lengths[b], MAXNB * BS));
  const int n = (len + ST - 1) / ST;
  const size_t step = static_cast<size_t>(H) * (Dh + 2);
  const float* p = ws + (static_cast<size_t>(b) * NS * H + h) * (Dh + 2);
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    w[s] = p[s * step];
    lw[s] = p[s * step + 1];
  }
  __syncthreads();
  float mx = kMaskValue;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, w[s]);
  __syncthreads();
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    w[s] = expf(w[s] - mx);
    lw[s] *= w[s];
  }
  __syncthreads();
  float ls = 0.f;
  for (int s = 0; s < n; ++s) ls += lw[s];
  const float den = fmaxf(ls, kDenomTiny);
  T* orow = out + (static_cast<size_t>(b) * H + h) * Dh;
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n; ++s) a = fmaf(p[s * step + 2 + d], w[s], a);
    store_elem(orow + d, a / den);
  }
}

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int32_t* table;
  const int32_t* lengths;
  void* out;
  float* ws;
  int B;
};

template <typename T, int G, int CPL>
cudaError_t launch_split(const Args& a, const Geometry& g, int threads,
                         size_t smem, cudaStream_t stream) {
  // the shared-memory limit set so far for this kernel, per device
  // (cudaFuncSetAttribute would cost host time on every decode step)
  static int set[smem_limit::kMaxDevices] = {};
  const cudaError_t err =
      smem_limit::raise(paged_split_kernel<T, G, CPL>, smem, set);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.NS, a.B, g.H / g.HG);
  paged_split_kernel<T, G, CPL><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.pool_k),
      static_cast<const T*>(a.pool_v), a.table, a.lengths,
      static_cast<T*>(a.out), a.ws, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, const Geometry& g, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int chunks = g.Dh / V;
  int G = 1;
  while (G < chunks && G < 32) G *= 2;
  if (G < 2) G = 2;
  const int cpl = (chunks + G - 1) / G;
  const int consumers = (g.HG * g.TS * G + 31) / 32 * 32;
  const int threads = consumers + 32;
  const size_t ring = static_cast<size_t>(g.stages) * 2 * g.TT * g.HG *
                      g.Dh * sizeof(T);
  const size_t merge = static_cast<size_t>(g.HG) * g.TS * (g.Dh + 2) * 4;
  const size_t smem = kBarBytes + (ring > merge ? ring : merge);
  if (threads > kMaxThreads || smem > 232448 || cpl > 2)
    return cudaErrorInvalidValue;
  cudaError_t err;
#define PADDLE_SPLIT_CASE(GG, CC)                                     \
  if (G == GG && cpl == CC)                                           \
    err = launch_split<T, GG, CC>(a, g, threads, smem, stream);       \
  else
  PADDLE_SPLIT_CASE(2, 1)
  PADDLE_SPLIT_CASE(4, 1)
  PADDLE_SPLIT_CASE(8, 1)
  PADDLE_SPLIT_CASE(16, 1)
  PADDLE_SPLIT_CASE(32, 1)
  PADDLE_SPLIT_CASE(32, 2)
  return cudaErrorInvalidValue;
#undef PADDLE_SPLIT_CASE
  if (err != cudaSuccess || g.NS == 1) return err;
  const dim3 grid(g.H, a.B);
  const int combine_threads =
      g.Dh < kCombineThreads ? g.Dh : kCombineThreads;
  const size_t combine_smem = 2 * sizeof(float) * g.NS;
  if (combine_smem > 48 * 1024) return cudaErrorInvalidValue;
  paged_combine_kernel<T><<<grid, combine_threads, combine_smem, stream>>>(
      a.ws, a.lengths, static_cast<T*>(a.out), g.H, g.Dh, g.BS, g.MAXNB,
      g.ST, g.NS);
  return cudaGetLastError();
}

}  // namespace

// The launch's numbers, as the wrapper packs them once per shape (one
// host pointer instead of fourteen arguments through ctypes a call).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16; Dh a multiple of 16
// up to 256; heads .. splits the wrapper's split_plan.
struct Launch {
  int dtype, B, H, Dh, NB, BS, MAXNB;
  int heads, tile, token_groups, stages, split_tokens, splits;
  float scale;
};

// C entry for ctypes.  `ws` holds B*splits*H*(Dh+2) floats when splits >
// 1 (unused otherwise).  All other pointers are device pointers of
// contiguous tensors, q and the pools 16-byte aligned; the launches go on
// `stream` and do not synchronise.  Returns a cudaError_t (0 = ok).
extern "C" int paddle_paged_attention_sm90(const Launch* l, const void* q,
                                           const void* pool_k,
                                           const void* pool_v,
                                           const void* table,
                                           const void* lengths, void* out,
                                           void* ws, void* stream) {
  if (l->Dh <= 0 || l->Dh % 16 != 0 || l->Dh > 256 || l->B <= 0 ||
      l->H <= 0 || l->NB <= 0 || l->BS <= 0 || l->MAXNB <= 0 ||
      l->heads <= 0 || l->H % l->heads != 0 || l->tile <= 0 ||
      l->token_groups <= 0 || l->token_groups > l->tile || l->stages <= 0 ||
      l->stages > kMaxStages || l->split_tokens <= 0 ||
      l->splits !=
          (l->MAXNB * l->BS + l->split_tokens - 1) / l->split_tokens ||
      (l->splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, pool_k, pool_v, static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(lengths), out,
               static_cast<float*>(ws), l->B};
  const Geometry g{l->H, l->Dh, l->NB, l->BS, l->MAXNB, l->heads, l->tile,
                   l->token_groups, l->stages, l->split_tokens, l->splits,
                   l->scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (l->dtype == 0)
    err = launch<float>(a, g, s);
  else if (l->dtype == 1)
    err = launch<__nv_bfloat16>(a, g, s);
  else if (l->dtype == 2)
    err = launch<__half>(a, g, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
