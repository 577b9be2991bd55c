// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas flash-attention kernels of paddle_tpu/ops/pallas_ops.py:
//   flash_fwd     <- _flash_kernel (launched by _pallas_flash_bh) and
//                    _flash_packed_fwd_kernel (launched by _pallas_flash_packed)
//   flash_bwd_dq  <- _flash_bwd_dq_kernel and _flash_packed_bwd_dq_kernel
//                    (the split branch of _pallas_flash_bwd and
//                    _pallas_flash_packed_bwd)
//   flash_bwd_dkv <- _flash_bwd_dkv_kernel and _flash_packed_bwd_dkv_kernel
//   flash_fwd_hpack <- _flash_kernel_hpack (launched by
//                    _pallas_flash_bh_hpack), hp heads per program
//   flash_bwd_fused <- _flash_bwd_fused_kernel (the fused branch of
//                    _pallas_flash_bwd): dq, dk, dv in one sweep
// The TPU has one kernel per memory layout ([B*H, S, D], and heads packed
// in 128-lane groups of [B, S, H*D]).  Here every entry point takes the
// batch, sequence and head strides of each tensor (the head dim is
// contiguous), so one kernel reads [B, S, H, D] views of the fused qkv
// projection in place and also serves the [B*H, S, D] layout (H = 1).
//
// What they compute (scale = 1/sqrt(D), masks: causal k <= q, the ragged
// edge k < Sk, and q_seg[q] == k_seg[k] when segment ids are given):
//   forward:  S = scale*Q K^T masked to -inf; online softmax in fp32 with
//             the running max clamped at kLseFloor, so a fully-masked row
//             gives out = 0 and lse = kLseFloor, never NaN; out in the
//             input dtype, lse fp32 [B, H, Sq].
//   dq:       delta = rowsum(dO * O) (written to an fp32 [B, H, Sq]
//             buffer), P = exp(S - lse), dS = P * (dP - delta) * scale
//             with dP = dO V^T, dq = dS K.
//   dk, dv:   dv = P^T dO, dk = dS^T Q, reading delta from that buffer,
//             so it launches after flash_bwd_dq on the same stream.
// Every sum is an fp32 sum in a fixed order, so the results are the same
// from run to run, except flash_bwd_fused's dq, whose per-k-tile partial
// sums meet in an fp32 workspace through atomics (notes at the kernel).
//
// What bounds them: at GPT-2-small training shapes (B=8, S=1024, H=12,
// D=64, causal, bf16) the forward does ~1.3e10 flop on ~50 MB, ~260 flop
// per byte: below the card's bf16 tensor-core ridge but far above its
// fp32 ridge (~20 flop/byte).  This first version does its arithmetic in
// fp32 on the CUDA cores, so operations bound it: the design keeps every
// tile in shared memory, gives each thread a 4x4 block of scores and a
// 4 x D/16 block of the output so each shared-memory read feeds 2-4 FMAs,
// pads or transposes every tile so no warp access conflicts on a bank,
// skips the K/V tiles above the causal diagonal, and starts the heaviest
// causal tiles first.  Tensor cores (mma.sync / wgmma on bf16), TMA and
// a pipelined K/V ring are the next steps.
//
// Design: 256 threads as a 16 x 16 grid (ty, tx); tiles of 64 q rows by
// 64 k rows.  A thread owns rows ty + 16*i and columns tx + 16*j of the
// score tile, so a row's max and sum reduce over the 16 lanes of a half
// warp with four shuffles.  forward and dq: one CTA per (64-row q tile,
// head, batch) walking the K/V tiles; dkv: one CTA per (64-row k tile,
// head, batch) walking the q tiles.  Tiles are staged in shared memory
// as fp32 whatever the input dtype; rows past the sequence end load as
// zero and are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kLseFloor = -1e30f;   // _LSE_FLOOR of pallas_ops.py
constexpr float kDenomTiny = 1e-30f;  // the kernels' max(l, 1e-30)
constexpr int kBM = 64;               // q rows per tile
constexpr int kBN = 64;               // k rows per tile
constexpr int kThreads = 256;         // 16 x 16
constexpr int kTR = kBM / 16;         // score rows per thread
constexpr int kTC = kBN / 16;         // score columns per thread
// Leading dimension of the 64 x 64 score tiles: rows ty and ty + 1 of a
// warp land 16 banks apart.
constexpr int kLdP = kBN + 16;

struct Layout {  // element strides; the head dim has stride 1
  int64_t b, s, h;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch does
}

// max / sum over the 16 lanes that share a row (one half warp)
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage rows r0 .. r0+rows-1 of one (batch, head) slice into shared
// memory as fp32: row-major dst[r*ld + d], or transposed dst[d*ld + r].
// Rows at or past `seq` load as 0.
template <typename T, int D, bool kTrans>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ base,
                                          int64_t s_stride, int r0, int seq,
                                          int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float v = 0.f;
    if (r0 + r < seq) v = to_f(base[static_cast<int64_t>(r0 + r) * s_stride + d]);
    if (kTrans)
      dst[d * ld + r] = v;
    else
      dst[r * ld + d] = v;
  }
}

__device__ __forceinline__ void load_seg(int* dst, const int32_t* seg,
                                         int r0, int seq, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads)
    dst[r] = (seg != nullptr && r0 + r < seq) ? seg[r0 + r] : 0;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Sq, int Sk,
                                        bool causal, bool has_seg, int qs,
                                        int ks) {
  return qpos < Sq && kpos < Sk && (!causal || kpos <= qpos) &&
         (!has_seg || qs == ks);
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return kBM * (D + 1) + D * (kBN + 1) + kBN * D + kBM * kLdP + kBM + kBN;
}
template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * kBM * (D + 1) + 2 * D * (kBN + 1) + kBM * kLdP + 3 * kBM + kBN;
}
template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * kBN * (D + 1) + 2 * D * (kBM + 1) + 2 * kBN * kLdP + 3 * kBM +
         kBN;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------
// The causal tiles at the bottom walk the most K/V tiles: start them first.
__device__ __forceinline__ int q_tile(int Sq, int causal) {
  const int n_qt = (Sq + kBM - 1) / kBM;
  return causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                : static_cast<int>(blockIdx.x);
}

// One 64-row q tile of one (batch, head) slice: walks the K/V tiles with
// the online softmax and writes its rows of out and lse.  Shared by
// flash_fwd_kernel (one head per CTA) and flash_fwd_hpack_kernel (HP
// heads per CTA), so the two compute each head in the same order.
template <typename T, int D>
__device__ __forceinline__ void fwd_head(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    const int32_t* __restrict__ qseg, const int32_t* __restrict__ kseg,
    int b, int h, int H, int Sq, int Sk, int qt, Layout lq, Layout lk,
    Layout lv, Layout lo, int causal, float scale) {
  constexpr int kLdQ = D + 1;
  constexpr int kLdK = kBN + 1;
  constexpr int kCols = D / 16;  // output columns per thread
  float* Qs = smem;                       // [kBM][kLdQ]
  float* Kt = Qs + kBM * kLdQ;            // [D][kLdK]  (transposed)
  float* Vs = Kt + D * kLdK;              // [kBN][D]
  float* Ps = Vs + kBN * D;               // [kBM][kLdP]
  int* qsg = reinterpret_cast<int*>(Ps + kBM * kLdP);  // [kBM]
  int* ksg = qsg + kBM;                                // [kBN]

  const int q0 = qt * kBM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool has_seg = qseg != nullptr;

  const T* qb = q + b * lq.b + h * lq.h;
  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  load_tile<T, D, false>(Qs, kLdQ, qb, lq.s, q0, Sq, kBM);
  load_seg(qsg, has_seg ? qseg + static_cast<int64_t>(b) * Sq : nullptr, q0,
           Sq, kBM);

  float m[kTR], l[kTR], acc[kTR][kCols];
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? min(Sk, q0 + kBM) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, true>(Kt, kLdK, kb, lk.s, k0, Sk, kBN);
    load_tile<T, D, false>(Vs, D, vb, lv.s, k0, Sk, kBN);
    load_seg(ksg, has_seg ? kseg + static_cast<int64_t>(b) * Sk : nullptr, k0,
             Sk, kBN);
    __syncthreads();

    float s[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kTR], bk[kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) a[i] = Qs[(ty + 16 * i) * kLdQ + d];
#pragma unroll
      for (int j = 0; j < kTC; ++j) bk[j] = Kt[d * kLdK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, Sq, Sk, causal, has_seg,
                                qsg[r], ksg[c]);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = fmaxf(m_new, kLseFloor);
      const float alpha = expf(fmaxf(m[i], kLseFloor) - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const float p = expf(s[i][j] - m_safe);
        Ps[r * kLdP + tx + 16 * j] = p;
        ps += p;
      }
      ps = half_warp_sum(ps);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int jj = 0; jj < kBN; ++jj) {
      float p[kTR], vv[kCols];
#pragma unroll
      for (int i = 0; i < kTR; ++i) p[i] = Ps[(ty + 16 * i) * kLdP + jj];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[jj * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

  T* ob = o + b * lo.b + h * lo.h;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], kDenomTiny);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(ob + static_cast<int64_t>(r) * lo.s + tx + 16 * c, acc[i][c] / denom);
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + r] =
          fmaxf(m[i], kLseFloor) + logf(denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int32_t* __restrict__ qseg,
                 const int32_t* __restrict__ kseg, int H, int Sq, int Sk,
                 Layout lq, Layout lk, Layout lv, Layout lo, int causal,
                 float scale) {
  extern __shared__ float smem[];
  fwd_head<T, D>(smem, q, k, v, o, lse, qseg, kseg, blockIdx.z, blockIdx.y,
                 H, Sq, Sk, q_tile(Sq, causal), lq, lk, lv, lo, causal, scale);
}

// ---------------------------------------------------------------------------
// forward, HP heads per CTA (flash_fwd_hpack)
// ---------------------------------------------------------------------------
// Replaces _flash_kernel_hpack of pallas_ops.py (launched by
// _pallas_flash_bh_hpack under PADDLE_TPU_FLASH_HEADPACK): each program
// owns hp consecutive rows of [B*H, S, D], which on the TPU turns two
// 64-wide contractions into one full 128-lane MXU pass.  Here the CUDA
// cores have no lane width to fill, so the CTA walks its HP heads one
// after another, each with fwd_head, and the outputs equal flash_fwd's
// bit for bit.  Heads are consecutive along B*H (head h of batch b is
// row b*H + h), so a CTA's heads may straddle two batches when H is odd,
// as in the JAX grid.  What changes is the grid: BH/HP x q tiles CTAs,
// each HP times longer, the Q/K/V tiles and the score tile reused from
// one head to the next in the same shared memory.  It is bound as
// flash_fwd is (fp32 FMAs on the CUDA cores, far above the fp32 ridge);
// on tensor cores the HP heads would become one wider wgmma N tile.
template <typename T, int D, int HP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_hpack_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int H, int Sq, int Sk,
                       Layout lq, Layout lk, Layout lv, Layout lo,
                       int causal, float scale) {
  extern __shared__ float smem[];
  const int qt = q_tile(Sq, causal);
#pragma unroll 1
  for (int j = 0; j < HP; ++j) {
    const int bh = static_cast<int>(blockIdx.y) * HP + j;
    if (j > 0) __syncthreads();  // the previous head's tile readers are done
    fwd_head<T, D>(smem, q, k, v, o, lse, nullptr, nullptr, bh / H, bh % H,
                   H, Sq, Sk, qt, lq, lk, lv, lo, causal, scale);
  }
}

// ---------------------------------------------------------------------------
// backward: dq (and delta)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq,
                    const int32_t* __restrict__ qseg,
                    const int32_t* __restrict__ kseg, int H, int Sq, int Sk,
                    Layout lq, Layout lk, Layout lv, Layout lo, Layout ldo,
                    Layout ldq, int causal, float scale) {
  constexpr int kLdQ = D + 1;
  constexpr int kLdK = kBN + 1;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBM][kLdQ]
  float* dOs = Qs + kBM * kLdQ;      // [kBM][kLdQ]
  float* Kt = dOs + kBM * kLdQ;      // [D][kLdK]
  float* Vt = Kt + D * kLdK;         // [D][kLdK]
  float* dSs = Vt + D * kLdK;        // [kBM][kLdP]
  float* lse_s = dSs + kBM * kLdP;   // [kBM]
  float* delta_s = lse_s + kBM;      // [kBM]
  int* qsg = reinterpret_cast<int*>(delta_s + kBM);  // [kBM]
  int* ksg = qsg + kBM;                              // [kBN]

  const int n_qt = (Sq + kBM - 1) / kBM;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_seg = qseg != nullptr;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;

  const T* kb = k + b * lk.b + h * lk.h;
  const T* vb = v + b * lv.b + h * lv.h;
  const T* ob = o + b * lo.b + h * lo.h;
  load_tile<T, D, false>(Qs, kLdQ, q + b * lq.b + h * lq.h, lq.s, q0, Sq, kBM);
  load_tile<T, D, false>(dOs, kLdQ, dout + b * ldo.b + h * ldo.h, ldo.s, q0,
                         Sq, kBM);
  load_seg(qsg, has_seg ? qseg + static_cast<int64_t>(b) * Sq : nullptr, q0,
           Sq, kBM);
  for (int r = threadIdx.x; r < kBM; r += kThreads)
    lse_s[r] = (q0 + r < Sq) ? lse[row0 + q0 + r] : 0.f;
  __syncthreads();

  // delta = rowsum(dO * O): one warp per row, fp32
  for (int r = warp; r < kBM; r += kThreads / 32) {
    float part = 0.f;
    if (q0 + r < Sq) {
      const T* orow = ob + static_cast<int64_t>(q0 + r) * lo.s;
      for (int d = lane; d < D; d += 32)
        part = fmaf(dOs[r * kLdQ + d], to_f(orow[d]), part);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      delta_s[r] = part;
      if (q0 + r < Sq) delta[row0 + q0 + r] = part;
    }
  }

  float acc[kTR][kCols];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  const int k_end = causal ? min(Sk, q0 + kBM) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBN) {
    __syncthreads();
    load_tile<T, D, true>(Kt, kLdK, kb, lk.s, k0, Sk, kBN);
    load_tile<T, D, true>(Vt, kLdK, vb, lv.s, k0, Sk, kBN);
    load_seg(ksg, has_seg ? kseg + static_cast<int64_t>(b) * Sk : nullptr, k0,
             Sk, kBN);
    __syncthreads();

    float s[kTR][kTC], dp[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kTR], g[kTR], bk[kTC], bv[kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        a[i] = Qs[(ty + 16 * i) * kLdQ + d];
        g[i] = dOs[(ty + 16 * i) * kLdQ + d];
      }
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        bk[j] = Kt[d * kLdK + tx + 16 * j];
        bv[j] = Vt[d * kLdK + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, Sq, Sk, causal, has_seg,
                                qsg[r], ksg[c]);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * kLdP + c] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // dq += dS K, with K read from its transposed tile
#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float ds[kTR], kk[kCols];
#pragma unroll
      for (int i = 0; i < kTR; ++i) ds[i] = dSs[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) kk[cc] = Kt[(tx + 16 * cc) * kLdK + c];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(ds[i], kk[cc], acc[i][cc]);
    }
  }

  T* dqb = dq + b * ldq.b + h * ldq.h;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(dqb + static_cast<int64_t>(r) * ldq.s + tx + 16 * c, acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dk, dv (and, fused, dq)
// ---------------------------------------------------------------------------
// p and dS as the fused sweep rounds them before their products: to the
// input dtype, as _flash_bwd_fused_kernel casts them (a no-op in fp32).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 64-row k tile of one (batch, head) slice walking the q tiles that
// can see it.  kFused = false is flash_bwd_dkv; kFused = true is the
// sweep of flash_bwd_fused, which also adds each q tile's dS K into the
// fp32 dq workspace dq_ws (contiguous [B, Sq, H, D]).
template <typename T, int D, bool kFused>
__device__ __forceinline__ void dkv_sweep(
    float* smem, const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dq_ws,
    const int32_t* __restrict__ qseg, const int32_t* __restrict__ kseg,
    int H, int Sq, int Sk, Layout lq, Layout lk, Layout lv, Layout ldo,
    Layout ldk, Layout ldv, int causal, float scale) {
  constexpr int kLdK = D + 1;
  constexpr int kLdQ = kBM + 1;
  constexpr int kCols = D / 16;
  float* Ks = smem;                  // [kBN][kLdK]
  float* Vs = Ks + kBN * kLdK;       // [kBN][kLdK]
  float* Qt = Vs + kBN * kLdK;       // [D][kLdQ]   (transposed)
  float* dOt = Qt + D * kLdQ;        // [D][kLdQ]   (transposed)
  float* Ps = dOt + D * kLdQ;        // [kBN][kLdP] P^T
  float* dSs = Ps + kBN * kLdP;      // [kBN][kLdP] dS^T
  float* lse_s = dSs + kBN * kLdP;   // [kBM]
  float* delta_s = lse_s + kBM;      // [kBM]
  int* qsg = reinterpret_cast<int*>(delta_s + kBM);  // [kBM]
  int* ksg = qsg + kBM;                              // [kBN]

  const int k0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool has_seg = qseg != nullptr;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;

  const T* qb = q + b * lq.b + h * lq.h;
  const T* dob = dout + b * ldo.b + h * ldo.h;
  load_tile<T, D, false>(Ks, kLdK, k + b * lk.b + h * lk.h, lk.s, k0, Sk, kBN);
  load_tile<T, D, false>(Vs, kLdK, v + b * lv.b + h * lv.h, lv.s, k0, Sk, kBN);
  load_seg(ksg, has_seg ? kseg + static_cast<int64_t>(b) * Sk : nullptr, k0,
           Sk, kBN);

  float ak[kTR][kCols], av[kTR][kCols];
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) ak[i][c] = av[i][c] = 0.f;

  // q tiles that can see this k tile under the causal mask
  const int q_begin = causal ? (k0 / kBM) * kBM : 0;
  for (int q0 = q_begin; q0 < Sq; q0 += kBM) {
    __syncthreads();
    load_tile<T, D, true>(Qt, kLdQ, qb, lq.s, q0, Sq, kBM);
    load_tile<T, D, true>(dOt, kLdQ, dob, ldo.s, q0, Sq, kBM);
    load_seg(qsg, has_seg ? qseg + static_cast<int64_t>(b) * Sq : nullptr, q0,
             Sq, kBM);
    for (int r = threadIdx.x; r < kBM; r += kThreads) {
      const bool in = q0 + r < Sq;
      lse_s[r] = in ? lse[row0 + q0 + r] : 0.f;
      delta_s[r] = in ? delta[row0 + q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T: rows are k (ty + 16 i), columns are q (tx + 16 j)
    float st[kTR][kTC], dpt[kTR][kTC];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[kTR], w[kTR], bq[kTC], bg[kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        a[i] = Ks[(ty + 16 * i) * kLdK + d];
        w[i] = Vs[(ty + 16 * i) * kLdK + d];
      }
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        bq[j] = Qt[d * kLdQ + tx + 16 * j];
        bg[j] = dOt[d * kLdQ + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          st[i][j] = fmaf(a[i], bq[j], st[i][j]);
          dpt[i][j] = fmaf(w[i], bg[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kTR; ++i) {
      const int c = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        const int r = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, Sq, Sk, causal, has_seg,
                                qsg[r], ksg[c]);
        const float p = ok ? expf(st[i][j] * scale - lse_s[r]) : 0.f;
        const float ds = p * (dpt[i][j] - delta_s[r]) * scale;
        if constexpr (kFused) {
          Ps[c * kLdP + r] = round_as(p, q);
          dSs[c * kLdP + r] = round_as(ds, q);
        } else {
          Ps[c * kLdP + r] = p;
          dSs[c * kLdP + r] = ds;
        }
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T Q, reading dO and Q from their transposed tiles
#pragma unroll 4
    for (int r = 0; r < kBM; ++r) {
      float p[kTR], ds[kTR], g[kCols], qq[kCols];
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        p[i] = Ps[(ty + 16 * i) * kLdP + r];
        ds[i] = dSs[(ty + 16 * i) * kLdP + r];
      }
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        g[cc] = dOt[(tx + 16 * cc) * kLdQ + r];
        qq[cc] = Qt[(tx + 16 * cc) * kLdQ + r];
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          av[i][cc] = fmaf(p[i], g[cc], av[i][cc]);
          ak[i][cc] = fmaf(ds[i], qq[cc], ak[i][cc]);
        }
    }

    if constexpr (kFused) {
      // this k tile's share of dq rows q0 + ty + 16 i: dS K, read from
      // dS^T and the row-major K tile, then added into the workspace
      float aq[kTR][kCols];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) aq[i][cc] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kBN; ++c) {
        float ds[kTR], kk[kCols];
#pragma unroll
        for (int i = 0; i < kTR; ++i) ds[i] = dSs[c * kLdP + ty + 16 * i];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) kk[cc] = Ks[c * kLdK + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
#pragma unroll
          for (int cc = 0; cc < kCols; ++cc)
            aq[i][cc] = fmaf(ds[i], kk[cc], aq[i][cc]);
      }
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = q0 + ty + 16 * i;
        if (r >= Sq) continue;
        float* row = dq_ws + ((static_cast<int64_t>(b) * Sq + r) * H + h) * D;
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          atomicAdd(row + tx + 16 * cc, aq[i][cc]);
      }
    }
  }

  T* dkb = dk + b * ldk.b + h * ldk.h;
  T* dvb = dv + b * ldv.b + h * ldv.h;
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      store(dkb + static_cast<int64_t>(c) * ldk.s + tx + 16 * cc, ak[i][cc]);
      store(dvb + static_cast<int64_t>(c) * ldv.s + tx + 16 * cc, av[i][cc]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, const int32_t* __restrict__ qseg,
                     const int32_t* __restrict__ kseg, int H, int Sq, int Sk,
                     Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldk,
                     Layout ldv, int causal, float scale) {
  extern __shared__ float smem[];
  dkv_sweep<T, D, false>(smem, q, k, v, dout, lse, delta, dk, dv, nullptr,
                         qseg, kseg, H, Sq, Sk, lq, lk, lv, ldo, ldk, ldv,
                         causal, scale);
}

// ---------------------------------------------------------------------------
// backward in one sweep (flash_bwd_fused)
// ---------------------------------------------------------------------------
// Replaces _flash_bwd_fused_kernel of pallas_ops.py (the fused branch of
// _pallas_flash_bwd, PADDLE_TPU_FLASH_FUSED_BWD).  The TPU kernel walks
// (kv, q) block pairs in order on one core and keeps a whole-sequence dq
// in VMEM across the kv loop; on Hopper the kv tiles run in parallel
// CTAs, so three launches on one stream:
//   1. flash_bwd_fused_prep_kernel: delta = rowsum(dO * O), one warp per
//      row (the dq kernel's sum, same order), and zeroes the row's fp32
//      dq workspace.  delta comes from this pre-pass rather than from a
//      recompute on every visit of a q tile (as _flash_bwd_dkv_kernel
//      does): the workspace needs zeroing anyway, the pre-pass reads O
//      once instead of once per visiting k tile, and the sweep then
//      never reads O.
//   2. flash_bwd_fused_kernel: one CTA per (64-row k tile, head, batch)
//      walks the q tiles from the first the causal mask lets reach it;
//      the five products (S, dP, P^T dO, dS^T Q, dS K) of each pair are
//      computed once, dK and dV accumulate in registers and are written
//      once, and each q tile's dS K is added into the workspace with
//      atomicAdd.  p is rounded to the input dtype before P^T dO and dS
//      before dS^T Q and dS K, where the TPU kernel rounds them.
//   3. flash_bwd_fused_dq_cast_kernel (bf16 only): rounds the workspace
//      into dq.  For fp32 the workspace is dq itself.
// dk and dv have one summation order, the same bits on every run; the
// atomics make the order of dq's per-k-tile partial sums vary from run
// to run, which moves dq by a few fp32 ulps of its magnitude (|dq| x
// 2^-24 per k tile at most), far inside the checks' 1e-4 x max(|ref|, 1).
// Bound: ~3.2e10 flop on ~101 MB at GPT-2-small's [96, 1024, 64] causal
// shape, operations on bf16 tensor cores; here fp32 FMAs on the CUDA
// cores, so operations bound it, as in the split pair, which it replaces
// with one sweep that computes S and dP once instead of twice.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_prep_kernel(const T* __restrict__ o,
                            const T* __restrict__ dout,
                            float* __restrict__ delta,
                            float* __restrict__ dq_ws, int B, int H, int Sq,
                            Layout lo, Layout ldo) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      warp;  // (b, h, s) in delta's order
  if (row >= static_cast<int64_t>(B) * H * Sq) return;  // whole warps
  const int s = static_cast<int>(row % Sq);
  const int h = static_cast<int>((row / Sq) % H);
  const int b = static_cast<int>(row / (static_cast<int64_t>(Sq) * H));
  const T* orow = o + b * lo.b + h * lo.h + static_cast<int64_t>(s) * lo.s;
  const T* grow =
      dout + b * ldo.b + h * ldo.h + static_cast<int64_t>(s) * ldo.s;
  float part = 0.f;
  for (int d = lane; d < D; d += 32)
    part = fmaf(to_f(grow[d]), to_f(orow[d]), part);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) delta[row] = part;
  float* ws = dq_ws + ((static_cast<int64_t>(b) * Sq + s) * H + h) * D;
  for (int d = lane; d < D; d += 32) ws[d] = 0.f;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, float* __restrict__ dq_ws,
                       const int32_t* __restrict__ qseg,
                       const int32_t* __restrict__ kseg, int H, int Sq,
                       int Sk, Layout lq, Layout lk, Layout lv, Layout ldo,
                       Layout ldk, Layout ldv, int causal, float scale) {
  extern __shared__ float smem[];
  dkv_sweep<T, D, true>(smem, q, k, v, dout, lse, delta, dk, dv, dq_ws,
                        qseg, kseg, H, Sq, Sk, lq, lk, lv, ldo, ldk, ldv,
                        causal, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_fused_dq_cast_kernel(const float* __restrict__ dq_ws,
                               T* __restrict__ dq, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) store(dq + i, dq_ws[i]);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
Layout layout_at(const int64_t* strides, int i) {
  return Layout{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, const int32_t* qseg, const int32_t* kseg, int B,
                int H, int Sq, int Sk, int causal, float scale,
                const int64_t* st, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, qseg, kseg, H, Sq, Sk,
      layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), layout_at(st, 3),
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   const int32_t* qseg, const int32_t* kseg, int B, int H,
                   int Sq, int Sk, int causal, float scale, const int64_t* st,
                   cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), qseg, kseg,
      H, Sq, Sk, layout_at(st, 0), layout_at(st, 1), layout_at(st, 2),
      layout_at(st, 3), layout_at(st, 4), layout_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, const int32_t* qseg,
                    const int32_t* kseg, int B, int H, int Sq, int Sk,
                    int causal, float scale, const int64_t* st,
                    cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBN - 1) / kBN, H, B);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), qseg, kseg, H, Sq, Sk,
      layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), layout_at(st, 3),
      layout_at(st, 4), layout_at(st, 5), causal, scale);
  return cudaGetLastError();
}

template <typename T, int D, int HP>
cudaError_t fwd_hpack(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int Sq, int Sk, int causal,
                      float scale, const int64_t* st, cudaStream_t stream) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = prepare(flash_fwd_hpack_kernel<T, D, HP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBM - 1) / kBM, B * H / HP, 1);
  flash_fwd_hpack_kernel<T, D, HP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Sq, Sk,
      layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), layout_at(st, 3),
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_fused(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, float* dq_ws, void* dq, void* dk,
                      void* dv, const int32_t* qseg, const int32_t* kseg,
                      int B, int H, int Sq, int Sk, int causal, float scale,
                      const int64_t* st, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  const int rows_per_cta = kThreads / 32;
  flash_bwd_fused_prep_kernel<T, D><<<
      static_cast<unsigned>((rows + rows_per_cta - 1) / rows_per_cta),
      kThreads, 0, stream>>>(static_cast<const T*>(o),
                             static_cast<const T*>(dout), delta, dq_ws, B, H,
                             Sq, layout_at(st, 3), layout_at(st, 4));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  err = prepare(flash_bwd_fused_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + kBN - 1) / kBN, H, B);
  flash_bwd_fused_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dq_ws, qseg, kseg, H, Sq, Sk,
      layout_at(st, 0), layout_at(st, 1), layout_at(st, 2), layout_at(st, 4),
      layout_at(st, 5), layout_at(st, 6), causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || static_cast<void*>(dq_ws) == dq) return err;

  const int64_t n = rows * D;
  flash_bwd_fused_dq_cast_kernel<T><<<
      static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
      stream>>>(dq_ws, static_cast<T*>(dq), n);
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// C entries for ctypes.  dtype: 0 = float32, 1 = bfloat16; head_dim 64
// or 128.  Pointers are device pointers; qseg/kseg are int32 [B, Sq] /
// [B, Sk] or null; lse and delta are fp32 [B, H, Sq] contiguous.
// `strides` is a host array of (batch, seq, head) element strides, three
// per tensor, in the order the tensors appear in the signature (q, k, v,
// then the rest without lse/delta/seg).  The launch goes on `stream` and
// does not synchronise.  Returns a cudaError_t (0 = ok).
#define PADDLE_FLASH_DISPATCH(FN, ...)                                     \
  cudaError_t err = cudaErrorInvalidValue;                                 \
  if (dtype == 0 && head_dim == 64)                                        \
    err = FN<float, 64>(__VA_ARGS__);                                      \
  else if (dtype == 0 && head_dim == 128)                                  \
    err = FN<float, 128>(__VA_ARGS__);                                     \
  else if (dtype == 1 && head_dim == 64)                                   \
    err = FN<__nv_bfloat16, 64>(__VA_ARGS__);                              \
  else if (dtype == 1 && head_dim == 128)                                  \
    err = FN<__nv_bfloat16, 128>(__VA_ARGS__);                             \
  return static_cast<int>(err);

extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, void* o, void* lse,
                         const void* qseg, const void* kseg, int B, int H,
                         int Sq, int Sk, int causal, float scale,
                         const void* strides, void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  PADDLE_FLASH_DISPATCH(fwd, q, k, v, o, static_cast<float*>(lse),
                        static_cast<const int32_t*>(qseg),
                        static_cast<const int32_t*>(kseg), B, H, Sq, Sk,
                        causal, scale, static_cast<const int64_t*>(strides),
                        static_cast<cudaStream_t>(stream))
}

extern "C" int flash_bwd_dq(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* delta,
                            void* dq, const void* qseg, const void* kseg,
                            int B, int H, int Sq, int Sk, int causal,
                            float scale, const void* strides, void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  PADDLE_FLASH_DISPATCH(bwd_dq, q, k, v, o, dout,
                        static_cast<const float*>(lse),
                        static_cast<float*>(delta), dq,
                        static_cast<const int32_t*>(qseg),
                        static_cast<const int32_t*>(kseg), B, H, Sq, Sk,
                        causal, scale, static_cast<const int64_t*>(strides),
                        static_cast<cudaStream_t>(stream))
}

extern "C" int flash_bwd_dkv(int dtype, int head_dim, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, const void* qseg, const void* kseg,
                             int B, int H, int Sq, int Sk, int causal,
                             float scale, const void* strides, void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  PADDLE_FLASH_DISPATCH(bwd_dkv, q, k, v, dout,
                        static_cast<const float*>(lse),
                        static_cast<const float*>(delta), dk, dv,
                        static_cast<const int32_t*>(qseg),
                        static_cast<const int32_t*>(kseg), B, H, Sq, Sk,
                        causal, scale, static_cast<const int64_t*>(strides),
                        static_cast<cudaStream_t>(stream))
}

// hp heads per CTA: hp 2 or 4, head_dim 64 only, B * H divisible by hp;
// anything else returns cudaErrorInvalidValue.  strides: q, k, v, o.
extern "C" int flash_fwd_hpack(int dtype, int head_dim, int hp,
                               const void* q, const void* k, const void* v,
                               void* o, void* lse, int B, int H, int Sq,
                               int Sk, int causal, float scale,
                               const void* strides, void* stream) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  if (bad_shape(B, H, Sq, Sk) || head_dim != 64 || (hp != 2 && hp != 4) ||
      bh % hp != 0 || bh / hp > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int64_t*>(strides);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && hp == 2)
    err = fwd_hpack<float, 64, 2>(q, k, v, o, l, B, H, Sq, Sk, causal, scale,
                                  st, s);
  else if (dtype == 0 && hp == 4)
    err = fwd_hpack<float, 64, 4>(q, k, v, o, l, B, H, Sq, Sk, causal, scale,
                                  st, s);
  else if (dtype == 1 && hp == 2)
    err = fwd_hpack<__nv_bfloat16, 64, 2>(q, k, v, o, l, B, H, Sq, Sk, causal,
                                          scale, st, s);
  else if (dtype == 1 && hp == 4)
    err = fwd_hpack<__nv_bfloat16, 64, 4>(q, k, v, o, l, B, H, Sq, Sk, causal,
                                          scale, st, s);
  return static_cast<int>(err);
}

// The fused backward's three launches.  dq_ws is an fp32 workspace and dq
// the output, both contiguous [B, Sq, H, D]; for fp32 pass the same
// pointer for both (no cast launch).  delta is fp32 [B, H, Sq] scratch.
// strides: q, k, v, o, dout, dk, dv.
extern "C" int flash_bwd_fused(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta,
                               void* dq_ws, void* dq, void* dk, void* dv,
                               const void* qseg, const void* kseg, int B,
                               int H, int Sq, int Sk, int causal, float scale,
                               const void* strides, void* stream) {
  if (bad_shape(B, H, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  PADDLE_FLASH_DISPATCH(bwd_fused, q, k, v, o, dout,
                        static_cast<const float*>(lse),
                        static_cast<float*>(delta),
                        static_cast<float*>(dq_ws), dq, dk, dv,
                        static_cast<const int32_t*>(qseg),
                        static_cast<const int32_t*>(kseg), B, H, Sq, Sk,
                        causal, scale, static_cast<const int64_t*>(strides),
                        static_cast<cudaStream_t>(stream))
}

#undef PADDLE_FLASH_DISPATCH
