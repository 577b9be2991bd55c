// Fused lm-head matmul + softmax cross-entropy for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_lmce.py:
//   lmce_fwd    <- _fwd_kernel (launched by _call_fwd)
//   lmce_bwd_dh <- _dh_kernel  (launched by _call_bwd)
//   lmce_bwd_dw <- _dw_kernel  (launched by _call_bwd)
// h is [N, D], W is [V, D] (rows contiguous along D), labels int32 [N].
// The logits S = h W^T ([N, V], fp32 sums) are never written to memory:
//   forward: per row, an online max / sum-exp over the vocabulary and the
//            picked logit -> lse = m + log(max(l, 1e-30)) and
//            loss = lse - S[label] (0 where label < 0), both fp32 [N];
//   dh:      dh = dL W with dL = (exp(S - lse) - onehot(label)) * g,
//            g zeroed where label < 0, dL rounded to the operand dtype;
//   dW:      dW = dL^T h, the same dL.
// The running max starts at -1e30 (_NEG), vocabulary columns >= V score
// -1e30 in the forward and give p = 0 in the backward, a label outside
// [0, V) picks -1e30, and rows >= N are neither read nor written: the
// kernels mask both ragged edges themselves, so no padding is needed.
// dh comes out in h's dtype and dW in W's, both summed in fp32.
//
// What bounds them: at GPT-2-small training shapes (N = 8192, V = 50304,
// D = 768, bf16) the forward does 6.3e11 flop and the two backward
// kernels 1.3e12 each (S is recomputed) on under 170 MB: operations bound
// all three, on the tensor cores by far (~0.6-1.3 ms at 989 TFLOP/s)
// against ~0.03-0.05 ms of bytes.  This first version does its arithmetic
// in fp32 FMAs on the CUDA cores, as the flash kernels do; the design
// keeps every operand tile in shared memory, gives each thread a 4 x 4
// register block so a shared-memory read feeds 4 FMAs (the owner side is
// read as a broadcast float4), lays the tiles out so no warp access
// conflicts on a bank, and fetches the next D chunk of the score tile into
// registers while the current one is multiplied.  Tensor cores (mma.sync /
// wgmma on bf16) and TMA are the next steps.
//
// Design.  256 threads = 8 warps.  Every kernel works on score tiles of
// 32 "owner" rows by 128 "streamed" rows: warp w owns owner rows
// 4w .. 4w+3 and lane l the streamed rows l + 32 j (j < 4), so a row's
// max and sum reduce within one warp.  The Pallas grid's sequential axis
// becomes a loop inside the block:
//   forward: one CTA per 32 rows of h, walking all vocab tiles;
//   dh:      one CTA per (32 rows of h, slice of D), walking the vocab;
//   dW:      one CTA per (32 rows of W, slice of D), walking the rows of h.
// The backward CTAs keep their [32, slice] fp32 gradient in shared memory
// (slice <= 1024 columns; a wider D takes several slices, each of which
// recomputes S).  Per step they compute S, turn it into dL (stored
// transposed in shared memory), then add dL x (the streamed rows' slice),
// staged 128 columns at a time.  No atomics: every sum has one fixed
// order, so the results are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;         // _NEG of pallas_lmce.py
constexpr float kTiny = 1e-30f;        // the forward's max(l, 1e-30)
constexpr int kThreads = 256;
constexpr int kTA = 32;                // owner rows per CTA (8 warps x 4)
constexpr int kTB = 128;               // streamed rows per step (32 lanes x 4)
constexpr int kDK = 32;                // contraction chunk of the score tile
constexpr int kLdA = kTA + 4;          // owner chunk, stored transposed
constexpr int kLdB = kDK + 1;          // streamed chunk, row-major, padded
constexpr int kDC = 128;               // gradient columns per staged chunk
constexpr int kLdO = kDC + 4;          // staged streamed rows of that chunk
constexpr int kMaxSlice = 1024;        // gradient columns one CTA keeps
constexpr int kMaxD = 65536;           // keeps every slice non-empty

constexpr int kScoreFloats = kDK * kLdA + kTB * kLdB;
constexpr int kStageFloats = kTB * kLdO > kScoreFloats ? kTB * kLdO
                                                       : kScoreFloats;

// Eight consecutive elements, fetched as 16- or 32-byte loads.
template <typename T>
struct Vec8;
template <>
struct Vec8<float> {
  float4 lo, hi;
};
template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
};

__device__ __forceinline__ void fetch8(Vec8<float>& v, const float* p,
                                       bool ok) {
  if (ok) {
    v.lo = *reinterpret_cast<const float4*>(p);
    v.hi = *reinterpret_cast<const float4*>(p + 4);
  } else {
    v.lo = float4{0.f, 0.f, 0.f, 0.f};
    v.hi = float4{0.f, 0.f, 0.f, 0.f};
  }
}
__device__ __forceinline__ void fetch8(Vec8<__nv_bfloat16>& v,
                                       const __nv_bfloat16* p, bool ok) {
  v.raw = ok ? *reinterpret_cast<const uint4*>(p) : uint4{0u, 0u, 0u, 0u};
}
__device__ __forceinline__ void unpack8(const Vec8<float>& v, float f[8]) {
  f[0] = v.lo.x; f[1] = v.lo.y; f[2] = v.lo.z; f[3] = v.lo.w;
  f[4] = v.hi.x; f[5] = v.hi.y; f[6] = v.hi.z; f[7] = v.hi.w;
}
__device__ __forceinline__ void unpack8(const Vec8<__nv_bfloat16>& v,
                                        float f[8]) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v.raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h2[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch does
}
// dL rounded to the operand dtype before its product (pallas_lmce.py
// .astype(w.dtype) / .astype(h.dtype))
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// s[i][j] = sum_d A[a0 + 4 warp + i][d] * B[b0 + lane + 32 j][d], fp32.
// Rows at or past nA / nB read as 0.  At ([kDK][kLdA], transposed) and Bs
// ([kTB][kLdB]) are this CTA's shared staging; every thread calls this.
// Loader roles: threads 0..127 fetch the owner chunk (row = lane, 8-group
// = warp), all 256 fetch two 8-groups of the streamed chunk (row = idx/4,
// 8-group = idx%4), so both stores and reads are free of bank conflicts.
template <typename T>
__device__ __forceinline__ void score_tile(const T* __restrict__ A, int a0,
                                           int nA, const T* __restrict__ B,
                                           int b0, int nB, int D, float* At,
                                           float* Bs, float s[4][4]) {
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const bool a_loader = t < kTA * (kDK / 8);
  const int a_row = t % kTA;
  const int a_grp = t / kTA;
  const T* a_src = A + static_cast<int64_t>(a0 + a_row) * D + 8 * a_grp;
  const bool a_in = a_loader && a0 + a_row < nA;
  int b_row[2];
  bool b_in[2];
  const T* b_src[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int idx = t + kThreads * k;
    b_row[k] = idx / 4;
    b_in[k] = b0 + b_row[k] < nB;
    b_src[k] = B + static_cast<int64_t>(b0 + b_row[k]) * D + 8 * (idx % 4);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

  Vec8<T> ra, rb[2];
  fetch8(ra, a_src, a_in && 8 * a_grp < D);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    fetch8(rb[k], b_src[k], b_in[k] && 8 * (t % 4) < D);

  for (int d0 = 0; d0 < D; d0 += kDK) {
    __syncthreads();  // the previous chunk's readers are done
    float f[8];
    if (a_loader) {
      unpack8(ra, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) At[(8 * a_grp + e) * kLdA + a_row] = f[e];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      unpack8(rb[k], f);
      const int grp = (t + kThreads * k) % 4;
#pragma unroll
      for (int e = 0; e < 8; ++e) Bs[b_row[k] * kLdB + 8 * grp + e] = f[e];
    }
    __syncthreads();
    const int dn = d0 + kDK;  // the next chunk, fetched during this one
    if (dn < D) {
      fetch8(ra, a_src + dn, a_in && dn + 8 * a_grp < D);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        fetch8(rb[k], b_src[k] + dn, b_in[k] && dn + 8 * (t % 4) < D);
    }
#pragma unroll 8
    for (int dd = 0; dd < kDK; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(At + dd * kLdA +
                                                        4 * warp);
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(lane + 32 * j) * kLdB + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[0][j] = fmaf(a.x, b[j], s[0][j]);
        s[1][j] = fmaf(a.y, b[j], s[1][j]);
        s[2][j] = fmaf(a.z, b[j], s[2][j]);
        s[3][j] = fmaf(a.w, b[j], s[3][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward: loss and lse
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
lmce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const int32_t* __restrict__ labels, float* __restrict__ loss,
                float* __restrict__ lse, int N, int V, int D) {
  extern __shared__ float4 smem_v4[];
  float* At = reinterpret_cast<float*>(smem_v4);
  float* Bs = At + kDK * kLdA;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kTA;

  float m[4], l[4], pick[4];
  int lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = n0 + 4 * warp + i;
    lab[i] = r < N ? labels[r] : -1;
    m[i] = kNeg;
    l[i] = 0.f;
    pick[i] = kNeg;
  }

  for (int v0 = 0; v0 < V; v0 += kTB) {
    float s[4][4];
    score_tile(h, n0, N, w, v0, V, D, At, Bs, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v0 + lane + 32 * j >= V) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float ps = 0.f;
      float pk = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps += expf(s[i][j] - m_new);
        if (v0 + lane + 32 * j == lab[i]) pk = fmaxf(pk, s[i][j]);
      }
      l[i] = expf(m[i] - m_new) * l[i] + warp_sum(ps);
      m[i] = m_new;
      pick[i] = fmaxf(pick[i], warp_max(pk));
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = n0 + 4 * warp + i;
      if (r >= N) continue;
      const float z = m[i] + logf(fmaxf(l[i], kTiny));
      lse[r] = z;
      loss[r] = lab[i] >= 0 ? z - pick[i] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// backward: dh (kDW = false) and dW (kDW = true)
// ---------------------------------------------------------------------------
// Owner rows are rows of h for dh and rows of W for dW; the streamed rows
// are the other operand's.  `slice` gradient columns, starting at
// blockIdx.y * slice, are accumulated in shared memory.
template <typename T, bool kDW>
__global__ void __launch_bounds__(kThreads)
lmce_bwd_kernel(const T* __restrict__ h, const T* __restrict__ w,
                const int32_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ grad, int N, int V, int D, int slice) {
  extern __shared__ float4 smem_v4[];
  float* acc = reinterpret_cast<float*>(smem_v4);  // [kTA][slice]
  float* dlT = acc + kTA * slice;                   // [kTB][kLdA]
  float* stage = dlT + kTB * kLdA;                  // score chunks, or
  float* At = stage;                                // [kTB][kLdO] rows
  float* Bs = stage + kDK * kLdA;
  float* Os = stage;

  const T* A = kDW ? w : h;
  const T* B = kDW ? h : w;
  const int nA = kDW ? V : N;
  const int nB = kDW ? N : V;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int a0 = blockIdx.x * kTA;
  const int p0 = blockIdx.y * slice;
  const int pn = min(slice, D - p0);

  for (int k = t; k < kTA * slice; k += kThreads) acc[k] = 0.f;

  // per-row terms of the rows of h: the owner's for dh (loaded once), the
  // streamed side's for dW (loaded per step).  Rows past N get g = 0.
  float r_lse[4], r_g[4];
  int r_lab[4];
  auto row_terms = [&](int base, int stride) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = base + stride * k;
      const bool in = n < N;
      r_lab[k] = in ? labels[n] : -1;
      r_lse[k] = in ? lse[n] : 0.f;
      r_g[k] = (in && r_lab[k] >= 0) ? g[n] : 0.f;
    }
  };
  if (!kDW) row_terms(a0 + 4 * warp, 1);

  for (int b0 = 0; b0 < nB; b0 += kTB) {
    float s[4][4];
    score_tile(A, a0, nA, B, b0, nB, D, At, Bs, s);
    if (kDW) row_terms(b0 + lane, 32);

    // dL, transposed: dlT[streamed row][owner row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ri = kDW ? j : i;                       // row of h
        const int v = kDW ? a0 + 4 * warp + i : b0 + lane + 32 * j;
        const float p = v < V ? expf(s[i][j] - r_lse[ri]) : 0.f;
        const float hit = v == r_lab[ri] ? 1.f : 0.f;
        d[i] = round_to((p - hit) * r_g[ri], A);
      }
      *reinterpret_cast<float4*>(dlT + (lane + 32 * j) * kLdA + 4 * warp) =
          float4{d[0], d[1], d[2], d[3]};
    }

    // acc[owner row][c] += sum_jj dL[owner row][jj] * B[b0 + jj][p0 + c]
    for (int c0 = 0; c0 < pn; c0 += kDC) {
      __syncthreads();  // dlT is written; the stage's last readers are done
#pragma unroll
      for (int k = 0; k < kTB * kDC / 8 / kThreads; ++k) {
        const int idx = t + kThreads * k;
        const int row = (idx / 4) % kTB;
        const int grp = idx % 4 + 4 * (idx / (4 * kTB));
        const int c = c0 + 8 * grp;
        Vec8<T> v;
        fetch8(v, B + static_cast<int64_t>(b0 + row) * D + p0 + c,
               b0 + row < nB && c < pn);
        float f[8];
        unpack8(v, f);
        float* dst = Os + row * kLdO + 8 * grp;
        *reinterpret_cast<float4*>(dst) = float4{f[0], f[1], f[2], f[3]};
        *reinterpret_cast<float4*>(dst + 4) = float4{f[4], f[5], f[6], f[7]};
      }
      __syncthreads();
      float o[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[i][c] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < kTB; ++jj) {
        const float4 dl = *reinterpret_cast<const float4*>(dlT + jj * kLdA +
                                                           4 * warp);
        float bv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Os[jj * kLdO + lane + 32 * c];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[0][c] = fmaf(dl.x, bv[c], o[0][c]);
          o[1][c] = fmaf(dl.y, bv[c], o[1][c]);
          o[2][c] = fmaf(dl.z, bv[c], o[2][c]);
          o[3][c] = fmaf(dl.w, bv[c], o[3][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = c0 + lane + 32 * c;
          if (col < pn) acc[(4 * warp + i) * slice + col] += o[i][c];
        }
    }
  }

  __syncthreads();
  for (int k = t; k < kTA * pn; k += kThreads) {
    const int r = k / pn;
    const int c = k % pn;
    if (a0 + r < nA)
      store(grad + static_cast<int64_t>(a0 + r) * D + p0 + c,
            acc[r * slice + c]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem_bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes));
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t fwd(const void* h, const void* w, const int32_t* labels,
                float* loss, float* lse, int N, int V, int D,
                cudaStream_t stream) {
  const size_t smem = kScoreFloats * sizeof(float);
  cudaError_t err = prepare(lmce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int grid = cdiv(N, kTA);
  lmce_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, loss, lse,
      N, V, D);
  return cudaGetLastError();
}

template <typename T, bool kDW>
cudaError_t bwd(const void* h, const void* w, const int32_t* labels,
                const float* lse, const float* g, void* grad, int N, int V,
                int D, cudaStream_t stream) {
  // D split into the fewest slices of at most kMaxSlice columns, each a
  // multiple of 8 wide
  const int n_slices = cdiv(D, kMaxSlice);
  const int slice = cdiv(cdiv(D, n_slices), 8) * 8;
  const size_t smem =
      (static_cast<size_t>(kTA) * slice + kTB * kLdA + kStageFloats) *
      sizeof(float);
  cudaError_t err = prepare(lmce_bwd_kernel<T, kDW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(kDW ? V : N, kTA), n_slices);
  lmce_bwd_kernel<T, kDW><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, g,
      static_cast<T*>(grad), N, V, D, slice);
  return cudaGetLastError();
}

bool bad_shape(int N, int V, int D) {
  return N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || D > kMaxD;
}

}  // namespace

// C entries for ctypes.  dtype: 0 = float32, 1 = bfloat16.  Pointers are
// device pointers: h [N, D] and w [V, D] contiguous and 16-byte aligned,
// D a positive multiple of 8; labels int32 [N]; loss, lse and g fp32 [N];
// dh [N, D] and dw [V, D] in the operand dtype.  The launch goes on
// `stream` and does not synchronise.  Returns a cudaError_t (0 = ok).
#define PADDLE_LMCE_DISPATCH(FN, ...)                                      \
  cudaError_t err = cudaErrorInvalidValue;                                 \
  if (dtype == 0)                                                          \
    err = FN<float>(__VA_ARGS__);                                          \
  else if (dtype == 1)                                                     \
    err = FN<__nv_bfloat16>(__VA_ARGS__);                                  \
  return static_cast<int>(err);

extern "C" int lmce_fwd(int dtype, const void* h, const void* w,
                        const void* labels, void* loss, void* lse, int N,
                        int V, int D, void* stream) {
  if (bad_shape(N, V, D)) return static_cast<int>(cudaErrorInvalidValue);
  PADDLE_LMCE_DISPATCH(fwd, h, w, static_cast<const int32_t*>(labels),
                       static_cast<float*>(loss), static_cast<float*>(lse),
                       N, V, D, static_cast<cudaStream_t>(stream))
}

#define PADDLE_LMCE_BWD(NAME, DW)                                          \
  extern "C" int NAME(int dtype, const void* h, const void* w,             \
                      const void* labels, const void* lse, const void* g,  \
                      void* grad, int N, int V, int D, void* stream) {     \
    if (bad_shape(N, V, D)) return static_cast<int>(cudaErrorInvalidValue); \
    cudaError_t err = cudaErrorInvalidValue;                               \
    const int32_t* lab = static_cast<const int32_t*>(labels);              \
    const float* z = static_cast<const float*>(lse);                       \
    const float* gg = static_cast<const float*>(g);                        \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                   \
    if (dtype == 0)                                                        \
      err = bwd<float, DW>(h, w, lab, z, gg, grad, N, V, D, st);           \
    else if (dtype == 1)                                                   \
      err = bwd<__nv_bfloat16, DW>(h, w, lab, z, gg, grad, N, V, D, st);   \
    return static_cast<int>(err);                                          \
  }

PADDLE_LMCE_BWD(lmce_bwd_dh, false)
PADDLE_LMCE_BWD(lmce_bwd_dw, true)

#undef PADDLE_LMCE_BWD
#undef PADDLE_LMCE_DISPATCH
