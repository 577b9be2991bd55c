// The fused lm-head cross-entropy backward on Hopper's tensor cores
// (sm_90a): wgmma + TMA, bf16 and fp16 operands.
//
// Replaces, for 16-bit operands, the Pallas kernels of
// paddle_tpu/ops/pallas_lmce.py launched by _call_bwd:
//   lmce_bwd_dh_tc <- _dh_kernel (dh = dL W)
//   lmce_bwd_dw_tc <- _dw_kernel (dW = dL^T h)
// lmce.cu keeps the CUDA-core backward (fp32 FMAs) for fp32 operands.
// The semantics are lmce.cu's: h is [N, D], W is [V, D] (rows contiguous
// along D, D a multiple of 8), S = h W^T summed in fp32 and never
// written to memory, dL = (exp(S - lse) - onehot(label)) * g with g
// zeroed where label < 0 and p = 0 on vocabulary columns >= V, dL
// rounded to the operand dtype before its product, dh in h's dtype and
// dW in W's, every sum in fp32 in one fixed order (no atomics: two runs
// give the same bits).  TMA fills rows and columns past the tensors'
// ends with zeros, so the masks are explicit: p = 0 for v >= V, and the
// row terms (label, lse, g) read as (-1, 0, 0) past N, which makes dL 0
// on those rows; stores past N, V or D are skipped.
//
// What bounds them: at GPT-2-small training shapes (N = 8192, V = 50304,
// D = 768, bf16) each kernel needs 4NVD = 1.27e12 flop (S recomputed,
// then the product with dL) on ~0.1 GB: operations on the tensor cores
// (1.28 ms at 989 TFLOP/s).  The CUDA-core kernels run these in fp32 FMAs
// at 24-28 TFLOP/s.  Here both products are wgmma with fp32
// accumulators, and the design's work is keeping the tensor cores fed
// from L2: every CTA streams the whole of the other operand.
//
// Design (one kernel for both; dh: owner = h, streamed = W; dW: owner =
// W, streamed = h, which makes the tile S^T and the per-row terms
// per-column).  A CTA owns 64 rows of the owner operand and keeps them
// resident in shared memory for its whole life (D <= 768: 12 TMA boxes
// of 64 columns, 96 KB, 128-byte swizzle).  It walks the streamed
// operand in tiles of 32 rows, each the full depth of D (48 KB at
// D = 768), through a two-stage TMA ring completing on mbarriers.  Two
// warpgroups (256 threads) split the work by 64-column blocks of D:
//   S      each warpgroup computes the partial S over its half of the
//          contraction (wgmma m64n32k16, owner and streamed blocks both
//          K-major from shared memory); the two partials meet through
//          shared memory and each adds the other's (a + b == b + a in
//          IEEE, so both hold the same S bits);
//   dL     the epilogue on the accumulator fragments in registers: ex2
//          of S log2(e) - lse log2(e), the one-hot, g, the masks, packed
//          to 16-bit pairs, which are the A fragment of the next product;
//   grad   each warpgroup adds dL times its half of the streamed tile's
//          columns into its fp32 accumulators (wgmma m64n64k16 per
//          64-column block, A from registers, B the same streamed tile,
//          MN-major with the transpose flag): up to 6 blocks, 64 x 384
//          fp32 = 192 registers a thread.
// So S is computed once (4NVD flop, no recompute), the owner is read
// from memory once, and the streamed operand once per CTA (mostly from
// L2: the CTAs walk it in the same order).  Thread 0 refills a stage
// with the tile two ahead once both warpgroups are done with it.
// dh launches N/64 CTAs (128 at N = 8192: one wave on 132 SMs), dW
// V/64 (786).  D > 768 is cut into windows of at most 12 blocks: a
// CTA (grid.y = window) computes the whole S, one window at a time with
// the owner window reloaded per tile, its own window last, and keeps
// only that window's gradient columns (each window recomputes S; the
// windows' sums run in different orders, each fixed).

#include "sm90.cuh"
#include "smem_limit.cuh"

#include <cmath>
#include <cstdint>

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 64;          // owner rows per CTA
constexpr int kBN = 32;          // streamed rows per tile
constexpr int kThreads = 256;    // two warpgroups
constexpr int kStages = 2;       // streamed-tile ring depth
constexpr int kMaxBlocks = 12;   // 64-column blocks of D in one window
constexpr int kWgBlocks = kMaxBlocks / 2;  // gradient blocks a warpgroup
constexpr int kFrag = kBN / 2;   // S accumulator floats a thread

// Shared-memory plan of one CTA, in bytes from a 1024-aligned base.
struct Plan {
  static constexpr uint32_t kOwnerBlock = kBM * kRowBytes;   // 8 KB
  static constexpr uint32_t kStreamBlock = kBN * kRowBytes;  // 4 KB
  static constexpr uint32_t kOwner = 0;
  static constexpr uint32_t kStage = kOwner + kMaxBlocks * kOwnerBlock;
  static constexpr uint32_t kStageBytes = kMaxBlocks * kStreamBlock;
  // the two warpgroups' S partials: [warpgroup][element][thread] fp32
  static constexpr uint32_t kX = kStage + kStages * kStageBytes;
  static constexpr uint32_t kXBytes = 2 * kFrag * 128 * 4;
  // row terms of the h rows in play: label, lse log2(e), g
  static constexpr uint32_t kTerms = kX + kXBytes;
  static constexpr uint32_t kTermBytes = 3 * kBM * 4;
  static constexpr uint32_t kBar = kTerms + kTermBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (kStages + 1);
  static constexpr size_t kAlloc = kBytes + 1024;  // room to align the base
};

struct Windows {   // D's 64-column blocks cut into windows
  int nb;          // blocks in all
  int nw;          // windows
  int wb;          // blocks per window (the last may hold fewer)
};

__device__ __forceinline__ int window_start(const Windows& w, int k) {
  return k * w.wb;
}
__device__ __forceinline__ int window_count(const Windows& w, int k) {
  return min(w.wb, w.nb - k * w.wb);
}

// Accumulator fragments (m64nN, fp32): thread t of a warpgroup holds, for
// each 8-column block j, elements 4j..4j+3 at rows r = 16*(t/32) +
// (t%32)/4 and r + 8, columns 8j + 2*(t%4) and +1:
//   e -> row r + 8*((e >> 1) & 1), column 8*(e >> 2) + 2*(t%4) + (e & 1).
// Both warpgroups cover the same 64 owner rows.
template <typename T, bool kDW>
__global__ void __launch_bounds__(kThreads, 1)
lmce_bwd_tc_kernel(const __grid_constant__ CUtensorMap t_own,
                   const __grid_constant__ CUtensorMap t_str,
                   const int32_t* __restrict__ labels,
                   const float* __restrict__ lse,
                   const float* __restrict__ g, T* __restrict__ grad,
                   int N, int V, int D, Windows win) {
  using P = Plan;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* xs = reinterpret_cast<float*>(gbase + P::kX);
  int* lab_s = reinterpret_cast<int*>(gbase + P::kTerms);
  float* lse_s = reinterpret_cast<float*>(lab_s + kBM);
  float* g_s = lse_s + kBM;
  const uint32_t full_bar = base + P::kBar;          // kStages barriers
  const uint32_t own_bar = full_bar + 8 * kStages;
  const uint64_t map_own = reinterpret_cast<uint64_t>(&t_own);
  const uint64_t map_str = reinterpret_cast<uint64_t>(&t_str);

  const int nA = kDW ? V : N;   // owner rows
  const int nB = kDW ? N : V;   // streamed rows
  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int tw = tid % 128;
  const int lane = tid % 32;
  const int a0 = static_cast<int>(blockIdx.x) * kBM;
  const int y = static_cast<int>(blockIdx.y);   // this CTA's window
  const int n_tiles = (nB + kBN - 1) / kBN;
  const int n_items = n_tiles * win.nw;         // (tile, window) in order

  // item -> (tile, window): each tile walks the windows from y + 1 on,
  // so its last item is window y, whose blocks stay in the stage for the
  // gradient product
  auto item_window = [&](int item) { return (y + 1 + item % win.nw) % win.nw; };

  // thread 0: the owner window's blocks into the owner slot
  auto issue_owner = [&](int kw) {
    const int cnt = window_count(win, kw);
    const int b0 = window_start(win, kw);
    mbar_expect_tx(own_bar, cnt * P::kOwnerBlock);
    for (int b = 0; b < cnt; ++b)
      tma_load_2d(base + P::kOwner + b * P::kOwnerBlock, map_own, own_bar,
                  (b0 + b) * kAtom, a0);
  };
  // thread 0: item `item`'s streamed blocks into its stage
  auto issue_stream = [&](int item) {
    const int kw = item_window(item);
    const int cnt = window_count(win, kw);
    const int b0 = window_start(win, kw);
    const int stage = item % kStages;
    const uint32_t bar = full_bar + 8 * stage;
    const uint32_t dst = base + P::kStage + stage * P::kStageBytes;
    mbar_expect_tx(bar, cnt * P::kStreamBlock);
    for (int b = 0; b < cnt; ++b)
      tma_load_2d(dst + b * P::kStreamBlock, map_str, bar, (b0 + b) * kAtom,
                  (item / win.nw) * kBN);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full_bar + 8 * s, 1);
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    issue_owner(item_window(0));
    for (int i = 0; i < kStages && i < n_items; ++i) issue_stream(i);
  }

  // The row terms of h rows (the owner's for dh, once; the streamed
  // tile's for dW, per tile): fetched into registers, stored to shared
  // memory once the S product is issued, so no warp holds its
  // warpgroup's wgmma back while the loads are in flight.
  int f_lab = -1;
  float f_lse = 0.f, f_g = 0.f;
  auto fetch_terms = [&](int n0, int rows) {
    const int n = n0 + tid;
    if (tid < rows && n < N) {
      f_lab = labels[n];
      f_lse = lse[n];
      f_g = g[n];
    } else {
      f_lab = -1;
      f_lse = f_g = 0.f;
    }
  };
  auto store_terms = [&](int rows) {
    if (tid < rows) {
      lab_s[tid] = f_lab;
      lse_s[tid] = f_lse * kLog2e;
      g_s[tid] = f_lab >= 0 ? f_g : 0.f;
    }
  };
  if (!kDW) {
    fetch_terms(a0, kBM);
    store_terms(kBM);
  }

  const int r_lo = 16 * (tw / 32) + lane / 4;   // local owner rows
  const int cq = 2 * (lane % 4);
  // this warpgroup's share of a window's blocks: [wb0, wb1)
  auto wg_range = [&](int cnt, int& wb0, int& wb1) {
    const int half = (cnt + 1) / 2;
    wb0 = wg == 0 ? 0 : half;
    wb1 = wg == 0 ? half : cnt;
  };
  int own_b0, own_b1;   // gradient blocks, in window y
  wg_range(window_count(win, y), own_b0, own_b1);
  const int nob = own_b1 - own_b0;

  float acc[kWgBlocks][32];
#pragma unroll
  for (int j = 0; j < kWgBlocks; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  float s[kFrag];

#pragma unroll 1
  for (int item = 0; item < n_items; ++item) {
    const int tile = item / win.nw;
    const int kw = item_window(item);
    const bool first = item % win.nw == 0;
    const bool last = item % win.nw == win.nw - 1;
    const int b0 = tile * kBN;   // first streamed row
    const int stage = item % kStages;
    const uint32_t sa = base + P::kStage + stage * P::kStageBytes;

    if (kDW && first) fetch_terms(b0, kBN);   // read after the exchange
    mbar_wait(own_bar, win.nw == 1 ? 0 : (item & 1));
    mbar_wait(full_bar + 8 * stage, (item / kStages) & 1);

    // S (partial over this warpgroup's blocks of the window)
    if (first) {
#pragma unroll
      for (int e = 0; e < kFrag; ++e) s[e] = 0.f;
    }
    int sb0, sb1;
    wg_range(window_count(win, kw), sb0, sb1);
    wgmma_fence();
#pragma unroll 1
    for (int b = sb0; b < sb1; ++b)
#pragma unroll
      for (int kq = 0; kq < 4; ++kq) {
        const uint32_t koff = kq * 32;   // 16 columns = 32 bytes
        wgmma_ss<T, kBN>(
            s, sw128_desc(base + P::kOwner + b * P::kOwnerBlock + koff, 16,
                          1024),
            sw128_desc(sa + b * P::kStreamBlock + koff, 16, 1024), 1);
      }
    wgmma_commit();
    if (kDW && first) store_terms(kBN);
    wgmma_wait_all();
    reg_fence(s);

    if (last) {
      // the two partials meet: each warpgroup adds the other's
      float* mine = xs + wg * kFrag * 128;
      const float* other = xs + (1 - wg) * kFrag * 128;
#pragma unroll
      for (int e = 0; e < kFrag; ++e) mine[e * 128 + tw] = s[e];
      __syncthreads();
#pragma unroll
      for (int e = 0; e < kFrag; ++e) s[e] += other[e * 128 + tw];

      // dL on the fragments, packed to 16-bit pairs (the A fragment:
      // k step kk takes columns 16kk..16kk+15, pairs 4kk..4kk+3)
      uint32_t a[kFrag / 2];
#pragma unroll
      for (int e = 0; e < kFrag; e += 2) {
        float d[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = r_lo + 8 * ((e >> 1) & 1);   // local owner row
          const int col = 8 * (e >> 2) + cq + u;       // local streamed row
          const int v = kDW ? a0 + row : b0 + col;     // vocabulary id
          const int t = kDW ? col : row;               // h row's terms
          const float p =
              v < V ? ex2(fmaf(s[e + u], kLog2e, -lse_s[t])) : 0.f;
          d[u] = (p - (v == lab_s[t] ? 1.f : 0.f)) * g_s[t];
        }
        a[e / 2] = Elem<T>::pack(d[0], d[1]);
      }

      // grad[:, own blocks] += dL (streamed tile's own blocks)
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kWgBlocks; ++j) {
        if (j < nob) {
          const uint32_t blk = sa + (own_b0 + j) * P::kStreamBlock;
#pragma unroll
          for (int kk = 0; kk < kBN / 16; ++kk)
            wgmma_rs_n64_tb<T>(acc[j], a[4 * kk], a[4 * kk + 1],
                               a[4 * kk + 2], a[4 * kk + 3],
                               sw128_desc(blk + kk * 16 * kRowBytes, 1024,
                                          1024));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < kWgBlocks; ++j) reg_fence(acc[j]);
      reg_fence(a);
    }

    __syncthreads();   // both warpgroups are done with the stage and xs
    if (tid == 0) {
      if (win.nw > 1 && item + 1 < n_items) issue_owner(item_window(item + 1));
      if (item + kStages < n_items) issue_stream(item + kStages);
    }
  }

  // store this warpgroup's gradient blocks of window y
  const int c_base = window_start(win, y) * kAtom;
#pragma unroll
  for (int j = 0; j < kWgBlocks; ++j) {
    if (j >= nob) continue;
    const int c_blk = c_base + (own_b0 + j) * kAtom;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = a0 + r_lo + 8 * i;
      if (r >= nA) continue;
      T* row = grad + static_cast<int64_t>(r) * D;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = c_blk + 8 * jj + cq;   // D is even: c < D covers c+1
        if (c < D)
          *reinterpret_cast<uint32_t*>(row + c) = Elem<T>::pack(
              acc[j][4 * jj + 2 * i], acc[j][4 * jj + 2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// A 16-bit [rows, D] row-major tensor as a 2-D map (D, rows) whose box is
// 64 columns of `box_rows` rows, 128-byte swizzled; past the ends reads
// zero.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, int rows, int D,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kAtom, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, Elem<T>::kMap, 2, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <typename T, bool kDW>
int launch(const void* h, const void* w, const int32_t* labels,
           const float* lse, const float* g, void* grad, int N, int V, int D,
           cudaStream_t stream) {
  const int nA = kDW ? V : N;
  const int nB = kDW ? N : V;
  CUtensorMap m_own, m_str;
  int err = make_map<T>(&m_own, kDW ? w : h, nA, D, kBM);
  if (err == 0) err = make_map<T>(&m_str, kDW ? h : w, nB, D, kBN);
  if (err != 0) return err;
  Windows win;
  win.nb = (D + kAtom - 1) / kAtom;
  win.nw = (win.nb + kMaxBlocks - 1) / kMaxBlocks;
  win.wb = (win.nb + win.nw - 1) / win.nw;
  auto kernel = lmce_bwd_tc_kernel<T, kDW>;
  static int set[smem_limit::kMaxDevices] = {};
  const cudaError_t cerr = smem_limit::raise(kernel, Plan::kAlloc, set);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(static_cast<unsigned>((nA + kBM - 1) / kBM),
                  static_cast<unsigned>(win.nw));
  kernel<<<grid, kThreads, Plan::kAlloc, stream>>>(
      m_own, m_str, labels, lse, g, static_cast<T*>(grad), N, V, D, win);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDW>
int launch_as(int dtype, const void* h, const void* w, const void* labels,
              const void* lse, const void* g, void* grad, int N, int V,
              int D, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || D > 65536)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* lab = static_cast<const int32_t*>(labels);
  const auto* z = static_cast<const float*>(lse);
  const auto* gg = static_cast<const float*>(g);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, kDW>(h, w, lab, z, gg, grad, N, V, D, st);
  if (dtype == 2)
    return launch<__half, kDW>(h, w, lab, z, gg, grad, N, V, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entries for ctypes.  dtype 1 = bfloat16, 2 = float16.  Pointers are
// device pointers: h [N, D] and w [V, D] contiguous with 16-byte-aligned
// bases and D a positive multiple of 8 up to 65536 (TMA's rule: rows a
// multiple of 16 bytes apart); labels int32 [N]; lse and g fp32 [N]; dh
// [N, D] and dw [V, D] in the operand dtype.  The launch goes on
// `stream` and does not synchronise.  Returns 0, a cudaError_t, -1 (no
// cuTensorMapEncodeTiled in the driver) or -2 (the driver refused a
// tensor map).
extern "C" int lmce_bwd_dh_tc(int dtype, const void* h, const void* w,
                              const void* labels, const void* lse,
                              const void* g, void* dh, int N, int V, int D,
                              void* stream) {
  return launch_as<false>(dtype, h, w, labels, lse, g, dh, N, V, D, stream);
}

extern "C" int lmce_bwd_dw_tc(int dtype, const void* h, const void* w,
                              const void* labels, const void* lse,
                              const void* g, void* dw, int N, int V, int D,
                              void* stream) {
  return launch_as<true>(dtype, h, w, labels, lse, g, dw, N, V, D, stream);
}
