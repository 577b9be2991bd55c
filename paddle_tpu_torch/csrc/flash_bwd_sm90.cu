// The flash-attention backward on Hopper's tensor cores (sm_90a): wgmma +
// TMA, bf16 and fp16 operands.
//
// Replaces, for 16-bit inputs at head dims 64 and 128, the Pallas kernels
// of paddle_tpu/ops/pallas_ops.py's backward:
//   flash_bwd_dq_tc    <- _flash_bwd_dq_kernel (the split branch of
//                         _pallas_flash_bwd) and _flash_packed_bwd_dq_kernel
//                         (_pallas_flash_packed_bwd)
//   flash_bwd_dkv_tc   <- _flash_bwd_dkv_kernel and
//                         _flash_packed_bwd_dkv_kernel
//   flash_bwd_fused_tc <- _flash_bwd_fused_kernel (the fused branch of
//                         _pallas_flash_bwd, dq, dk, dv in one sweep)
// flash_attention.cu keeps the CUDA-core kernels (fp32 FMAs) for fp32
// inputs and for head dims 16 and 32.  The semantics are that pair's and the TPU
// kernels': S = Q K^T a 16-bit product summed in fp32, times scale;
// P = exp(S - lse) on the visible pairs (causal k <= q, the ragged Sq/Sk
// edge, q_seg == k_seg), 0 elsewhere; dP = dO V^T; dS = P (dP - delta)
// scale rounded to the input dtype; dq = dS K, dv = round(P)^T dO,
// dk = dS^T Q, summed in fp32 and stored in the input dtype.  dq writes
// delta = rowsum(dO * O) (fp32 [B, H, Sq]), which dkv reads, so dkv
// launches after dq on the same stream.  A row that sees no key
// (lse = kLseFloor) gets dq = 0 exactly and adds nothing to dk, dv.
// Every sum of dq, dkv and the fused sweep's dk and dv has one fixed
// order (no atomics): two runs give the same bits.  The fused sweep's dq
// is summed through fp32 atomics and varies by a few fp32 ulps from run
// to run.
//
// What bounds them: at GPT-2-small's training shape (B=8, S=1024, H=12,
// D=64, causal, bf16) dq does 6 D pairs = 1.93e10 flop on ~63 MB and dkv
// 8 D pairs = 2.58e10 flop on ~51 MB, 300-500 flop per byte: above the
// card's bf16 ridge, so the tensor cores (0.020 and 0.026 ms at
// 989 TFLOP/s) bound them, and between the products the element work on
// each score (ex2, the masks, dS, the 16-bit packing) runs on the CUDA
// cores.  The design keeps the tensor cores fed while that runs.
//
// Design (one kernel for both, as lmce_sm90.cu): a CTA owns 128 rows of
// one (batch, head) -- dq: 128 q rows, with Q and dO resident; dkv: 128
// kv rows, with K and V resident -- and streams the other side in tiles
// of BN rows (dq: K and V; dkv: Q and dO, with the tile's lse, delta and
// q segment ids) through a ring of kStages stages.  288 threads: two
// consumer warpgroups of 64 owner rows each and one producer warp.  The
// producer warp fills a stage as soon as both warpgroups have released it
// (an "empty" mbarrier each stage, 256 arrivals), so no __syncthreads
// sits in the loop and the two warpgroups run apart: one's element work
// overlaps the other's products.  Per streamed tile each warpgroup runs
//   X = A1 B1^T, Y = A2 B2^T   wgmma m64nBNk16, both operands K-major in
//                              shared memory (dq: S = Q K^T, dP = dO V^T;
//                              dkv: S^T = K Q^T, dP^T = V dO^T, so lse and
//                              delta index the accumulator's columns);
//   P, dS on the accumulator fragments in registers, packed to 16-bit
//                              pairs, which are the next product's A
//                              operand (the accumulator layout of m64nBN
//                              is the A-fragment layout of m64kBN);
//   acc1 += dS B1             wgmma m64n64k16 per 64 output columns, A
//                              from registers, B MN-major (transpose flag):
//                              dq += dS K, or dk += dS^T Q;
//   acc2 += P B2              (dkv) dv += P^T dO.
// BN is 64, and 32 at D = 128.  A thread may hold 168 registers (ptxas
// kept the consumers there under setmaxnreg too), too few for dkv's dk
// and dv at D = 128 (64 x 128 fp32 each, 128 registers): there two CTAs
// share the kv rows, each accumulating one 64-column half of dk and dv
// and computing S^T and dP^T in full (kOutCols).  Causal CTAs skip the
// tiles beyond the diagonal and launch the heaviest first (dq: the last q
// tiles; dkv: the first kv tiles); a warpgroup whose rows see nothing of
// a tile skips its products.  TMA fills rows past Sq or Sk with zeros,
// and S = 0 there would give P = exp(-lse) != 0, so P is masked by
// predicate on rows and columns and lse/delta are read only for rows
// < Sq.
//
// The fused sweep (kMode 2) is dkv's CTA computing S^T and dP^T once per
// (kv tile, q tile) pair, as the TPU kernel does: five products where the
// split pair does seven.  Beside dk += dS^T Q and dv += P^T dO it adds
// dq's partial over its kv rows into an fp32 workspace.  The fragment
// holds dS^T with kv rows in M, so each warpgroup writes its rounded dS^T
// fragment transposed into a shared-memory tile ([BN q rows][64 kv], the
// K-major B operand; 2-byte stores, a proxy fence and a named barrier
// over the warpgroup) and runs dq^T[64 D cols, BN q] = K^T dS^T with A
// the resident K box read MN-major (transpose flag), issued with dk's and
// dv's products.  Each warpgroup stages its fp32 partial as [BN q][64 d]
// and adds it into the workspace with one TMA reduce-add
// (cp.reduce.async.bulk.tensor .add.f32) a tile: two adds per dq element
// per CTA, no barrier between the warpgroups, so one's element work still
// overlaps the other's products.  The order of the adds varies from run
// to run, so dq moves by a few fp32 ulps; dk and dv do not.  The sweep
// takes 32-row q tiles at every head dim: a thread may hold 168
// registers, and with 64-row tiles at D = 64 ptxas spills 72 bytes (40
// with dq's product issued after dk's and dv's wait).  Device time of
// one call at GPT-2-small's [96, 1024, 64] causal on an H100 at 700 W
// (chip_fused_variants.py): 0.218 ms as kept; 0.210 with 64-row tiles,
// 0.205 with dq late too; 0.263 with red.global.add.f32 per element in
// place of the reduce-add.  At D = 128 each of the two
// CTAs of a kv tile adds dq's half of its dk/dv columns (dS K[:, half]).
// Three launches: a pre-pass (delta = rowsum(dO * O), the workspace
// zeroed), the sweep, and the 16-bit cast of the workspace into dq.
//
// Host side: the tensor maps are encoded per call (sm90::encode_tiled) as
// in flash_fwd_sm90.cu; a [B, S, H, D] view is a 4-D map (D, H, S, B).
// TMA needs 16-byte-aligned bases and strides, and dq reads O and dO rows
// with 16-byte loads for delta, which the Python wrappers check first.

#include "sm90.cuh"
#include "smem_limit.cuh"

#include <cstdint>

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 128;                      // owner rows per CTA
constexpr int kConsumers = 256;               // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kStages = 4;                    // streamed-tile ring depth

struct Layout {  // element strides; the head dim has stride 1
  int64_t b, s, h;
};

// The two 16-bit values of a 32-bit word as floats, the lower address
// first.
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half) {
  return make_float2(
      __half2float(__ushort_as_half(static_cast<unsigned short>(w & 0xffffu))),
      __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}

// A thread of the 288 may hold 168 registers.  At D = 128 the streamed
// tiles take 32 rows, which halves X, Y and the packed dS and P; and dkv's
// dk and dv (64 x 128 fp32 each, 128 registers) would still not fit, so
// there two CTAs share the kv rows, each accumulating one 64-column half
// of dk and dv and computing S^T and dP^T in full.
// The fused sweep (kMode 2) holds dq's partial too, and at D = 64 takes
// 32-row tiles as well: with 64, ptxas spilled 72 bytes.
template <int D, int kMode = 0>
constexpr int kBN = D == 128 || kMode == 2 ? 32 : 64;  // streamed rows
template <int D, bool kDKV>
constexpr int kOutCols = kDKV && D == 128 ? 64 : D;

// kMode: 0 = dq, 1 = dkv, 2 = the fused sweep (dkv, and each streamed q
// tile's dq partial added into an fp32 workspace).
constexpr int kModeDq = 0, kModeDkv = 1, kModeFused = 2;

// Shared-memory plan of one CTA, in bytes from a 1024-aligned base.  Each
// tile is D / 64 boxes of 64 columns, 128-byte swizzled.
template <int D, int BN, bool kFused = false>
struct Plan {
  static constexpr uint32_t kOwnBytes = kBM * D * 2;   // one owner tile
  static constexpr uint32_t kStrBytes = BN * D * 2;    // one streamed tile
  static constexpr uint32_t kOwn1 = 0;
  static constexpr uint32_t kOwn2 = kOwnBytes;
  // stage s: streamed tile 1, then streamed tile 2
  static constexpr uint32_t kStage = 2 * kOwnBytes;
  static constexpr uint32_t kStageBytes = 2 * kStrBytes;
  // the fused sweep's dS^T tiles, one a warpgroup: [BN q rows][64 kv
  // columns], 128 bytes a row, 128-byte swizzled (1024-aligned)
  static constexpr uint32_t kDs = kStage + kStages * kStageBytes;
  static constexpr uint32_t kDsBytes = kFused ? 2 * BN * kRowBytes : 0;
  // the fused sweep's fp32 dq partials, one a warpgroup: [BN q][64 d]
  static constexpr uint32_t kDqs = kDs + kDsBytes;
  static constexpr uint32_t kDqsBytes =
      kFused ? 2 * BN * kAtom * 4 : 0;
  // stage s's column terms: lse log2(e) [BN], delta [BN], segment [BN]
  static constexpr uint32_t kTerms = kDqs + kDqsBytes;
  static constexpr uint32_t kTermBytes = 3 * BN * 4;
  static constexpr uint32_t kBar = kTerms + kStages * kTermBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (2 * kStages + 1);
  static constexpr size_t kAlloc = kBytes + 1024;  // room to align the base
};

// Accumulator fragments (m64nN, fp32): thread t of a warpgroup holds, for
// each 8-column block j, elements 4j..4j+3 at rows r = 16*(t/32) +
// (t%32)/4 and r + 8, columns 8j + 2*(t%4) and +1:
//   e -> row r + 8*((e >> 1) & 1), column 8*(e >> 2) + 2*(t%4) + (e & 1).
// kMode 0 is dq (owner: Q, dO; streamed: K, V; out1 = dq); 1 is dkv
// (owner: K, V; streamed: Q, dO; out1 = dk, out2 = dv); 2 is dkv that
// also adds dS K (its 128 kv rows) into the workspace dq_ws (through
// t_ws, its tensor map) for each streamed q tile.
template <typename T, int D, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap t_own1,
                    const __grid_constant__ CUtensorMap t_own2,
                    const __grid_constant__ CUtensorMap t_str1,
                    const __grid_constant__ CUtensorMap t_str2,
                    const __grid_constant__ CUtensorMap t_ws,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    const int32_t* __restrict__ qseg,
                    const int32_t* __restrict__ kseg, T* __restrict__ out1,
                    T* __restrict__ out2, float* __restrict__ dq_ws, int H,
                    int Sq, int Sk, Layout lo,
                    Layout ldo, Layout l1, Layout l2, int causal,
                    float scale) {
  constexpr bool kDKV = kMode != kModeDq;
  constexpr bool kFused = kMode == kModeFused;
  constexpr int BN = kBN<D, kMode>;
  using P = Plan<D, BN, kFused>;
  constexpr int kHalves = D / kAtom;           // 64-column boxes of a tile
  constexpr int kOut = kOutCols<D, kDKV> / kAtom;   // output boxes
  const int out0 = static_cast<int>(blockIdx.z) * kOut;  // the first one
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t full_bar = base + P::kBar;          // kStages barriers
  const uint32_t empty_bar = full_bar + 8 * kStages;  // kStages barriers
  const uint32_t own_bar = empty_bar + 8 * kStages;

  const int tid = threadIdx.x;
  const int bh = static_cast<int>(blockIdx.x);
  const int b = bh / H;
  const int h = bh - b * H;
  const int nA = kDKV ? Sk : Sq;   // owner extent
  const int nB = kDKV ? Sq : Sk;   // streamed extent
  const int y = static_cast<int>(blockIdx.y);
  const int n_own = (nA + kBM - 1) / kBM;
  // heaviest first: dq's last q tiles and dkv's first kv tiles see the
  // most of the other side under the causal mask
  const int a0 = (!kDKV && causal ? n_own - 1 - y : y) * kBM;
  const int s_begin = kDKV && causal ? a0 : 0;
  const int s_end = !kDKV && causal ? min(Sk, a0 + kBM) : nB;
  const int n_items = s_end > s_begin ? (s_end - s_begin + BN - 1) / BN : 0;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Sq;
  const bool has_seg = qseg != nullptr;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 32);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // -------------------------------------------------------------------
  // producer warp: the owner tiles once, then each streamed tile and its
  // column terms into the next free stage
  // -------------------------------------------------------------------
  if (tid >= kConsumers) {
    const int lane = tid - kConsumers;
    const uint64_t map_s1 = reinterpret_cast<uint64_t>(&t_str1);
    const uint64_t map_s2 = reinterpret_cast<uint64_t>(&t_str2);
    if (lane == 0) {
      const uint64_t map_o1 = reinterpret_cast<uint64_t>(&t_own1);
      const uint64_t map_o2 = reinterpret_cast<uint64_t>(&t_own2);
      mbar_expect_tx(own_bar, 2 * P::kOwnBytes);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) {
        tma_load_4d(base + P::kOwn1 + hf * kBM * kRowBytes, map_o1, own_bar,
                    hf * kAtom, h, a0, b);
        tma_load_4d(base + P::kOwn2 + hf * kBM * kRowBytes, map_o2, own_bar,
                    hf * kAtom, h, a0, b);
      }
    }
#pragma unroll 1
    for (int item = 0; item < n_items; ++item) {
      const int stage = item % kStages;
      if (item >= kStages)
        mbar_wait(empty_bar + 8 * stage, ((item / kStages) - 1) & 1);
      const int s0 = s_begin + item * BN;
      float* lse_t = reinterpret_cast<float*>(gbase + P::kTerms +
                                              stage * P::kTermBytes);
      float* del_t = lse_t + BN;
      int* seg_t = reinterpret_cast<int*>(del_t + BN);
      for (int j = lane; j < BN; j += 32) {
        const int pos = s0 + j;
        const bool in = pos < nB;
        if (kDKV) {
          lse_t[j] = in ? lse[row0 + pos] * kLog2e : 0.f;
          del_t[j] = in ? delta[row0 + pos] : 0.f;
        }
        if (has_seg)
          seg_t[j] = !in ? 0
                     : kDKV ? qseg[static_cast<int64_t>(b) * Sq + pos]
                            : kseg[static_cast<int64_t>(b) * Sk + pos];
      }
      const uint32_t bar = full_bar + 8 * stage;
      if (lane == 0) {   // its arrival is the expect_tx
        const uint32_t dst = base + P::kStage + stage * P::kStageBytes;
        mbar_expect_tx(bar, P::kStageBytes);
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf) {
          tma_load_4d(dst + hf * BN * kRowBytes, map_s1, bar, hf * kAtom, h,
                      s0, b);
          tma_load_4d(dst + P::kStrBytes + hf * BN * kRowBytes, map_s2, bar,
                      hf * kAtom, h, s0, b);
        }
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // -------------------------------------------------------------------
  // consumer warpgroups
  // -------------------------------------------------------------------
  const int wg = tid / 128;
  const int tw = tid % 128;
  const int lane = tid % 32;
  const int wrow0 = a0 + 64 * wg;   // the warpgroup's first owner row
  const int r_lo = wrow0 + 16 * (tw / 32) + lane / 4;
  const int rows[2] = {r_lo, r_lo + 8};
  const bool row_in[2] = {rows[0] < nA, rows[1] < nA};
  const int cq = 2 * (lane % 4);

  // owner-row terms: dq's lse, delta and q segment ids; dkv's k segment ids
  float lse_r[2] = {0.f, 0.f}, del_r[2] = {0.f, 0.f};
  int seg_r[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (has_seg && row_in[i])
      seg_r[i] = kDKV ? kseg[static_cast<int64_t>(b) * Sk + rows[i]]
                      : qseg[static_cast<int64_t>(b) * Sq + rows[i]];
    if (!kDKV) {
      // delta = rowsum(dO * O): lane j of the row's quad sums columns
      // [j D/4, (j+1) D/4) in order, then the quad adds its four parts
      float part = 0.f;
      if (row_in[i]) {
        lse_r[i] = lse[row0 + rows[i]] * kLog2e;
        const int c0 = (lane % 4) * (D / 4);
        const T* orow = o + b * lo.b + h * lo.h +
                        static_cast<int64_t>(rows[i]) * lo.s + c0;
        const T* grow = dout + b * ldo.b + h * ldo.h +
                        static_cast<int64_t>(rows[i]) * ldo.s + c0;
#pragma unroll
        for (int c = 0; c < D / 4; c += 8) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
          const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
          const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
          const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 of = unpack2(ow[u], T());
            const float2 gf = unpack2(gw[u], T());
            part = fmaf(gf.x, of.x, part);
            part = fmaf(gf.y, of.y, part);
          }
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      del_r[i] = part;
      if (row_in[i] && lane % 4 == 0) delta[row0 + rows[i]] = part;
    }
  }

  constexpr int kAcc2 = kDKV ? kOut : 1;
  float acc1[kOut][32];      // dq, or dk
  float acc2[kAcc2][32];     // dv (dkv only)
#pragma unroll
  for (int hf = 0; hf < kOut; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc1[hf][e] = 0.f;
#pragma unroll
  for (int hf = 0; hf < kAcc2; ++hf)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc2[hf][e] = 0.f;

  const uint32_t a1 = base + P::kOwn1 + wg * 64 * kRowBytes;
  const uint32_t a2 = base + P::kOwn2 + wg * 64 * kRowBytes;
  const float scale_log2 = scale * kLog2e;
  mbar_wait(own_bar, 0);

#pragma unroll 1
  for (int item = 0; item < n_items; ++item) {
    const int stage = item % kStages;
    const int s0 = s_begin + item * BN;
    mbar_wait(full_bar + 8 * stage, (item / kStages) & 1);

    // does any of this warpgroup's rows see a column of this tile?
    const bool active =
        !causal || (kDKV ? s0 + BN - 1 >= wrow0 : s0 <= wrow0 + 63);
    if (active) {
      const uint32_t b1 = base + P::kStage + stage * P::kStageBytes;
      const uint32_t b2 = b1 + P::kStrBytes;
      const float* lse_t = reinterpret_cast<const float*>(
          gbase + P::kTerms + stage * P::kTermBytes);
      const float* del_t = lse_t + BN;
      const int* seg_t = reinterpret_cast<const int*>(del_t + BN);

      // X = A1 B1^T and Y = A2 B2^T
      float x[BN / 2], yv[BN / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss<T, BN>(x,
                        sw128_desc(a1 + (kk / 4) * kBM * kRowBytes + koff, 16,
                                   1024),
                        sw128_desc(b1 + (kk / 4) * BN * kRowBytes + koff, 16,
                                   1024),
                        kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;
        wgmma_ss<T, BN>(yv,
                        sw128_desc(a2 + (kk / 4) * kBM * kRowBytes + koff, 16,
                                   1024),
                        sw128_desc(b2 + (kk / 4) * BN * kRowBytes + koff, 16,
                                   1024),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(x);
      reg_fence(yv);

      // P and dS on the fragments, packed to 16-bit pairs (the A
      // fragment: k step kk takes columns 16kk..16kk+15, pairs 4kk..4kk+3)
      const bool need_mask =
          s0 + BN > nB || wrow0 + 64 > nA || has_seg ||
          (causal && (kDKV ? s0 < wrow0 + 63 : s0 + BN - 1 > wrow0));
      uint32_t ds[BN / 4];
      uint32_t pp[kDKV ? BN / 4 : 1];
#pragma unroll
      for (int e = 0; e < BN / 2; e += 2) {
        const int i = (e >> 1) & 1;                  // row r_lo or r_lo + 8
        float pv[2], dv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * (e >> 2) + cq + u;     // local streamed row
          const float lse_c = kDKV ? lse_t[col] : lse_r[i];
          const float del_c = kDKV ? del_t[col] : del_r[i];
          bool ok = true;
          if (need_mask) {
            const int spos = s0 + col;
            const int qpos = kDKV ? spos : rows[i];
            const int kpos = kDKV ? rows[i] : spos;
            ok = row_in[i] && spos < nB && (!causal || kpos <= qpos);
            if (has_seg && ok) ok = seg_r[i] == seg_t[col];
          }
          const float p = ok ? ex2(fmaf(x[e + u], scale_log2, -lse_c)) : 0.f;
          pv[u] = p;
          dv[u] = p * (yv[e + u] - del_c) * scale;
        }
        ds[e / 2] = Elem<T>::pack(dv[0], dv[1]);
        if constexpr (kDKV) pp[e / 2] = Elem<T>::pack(pv[0], pv[1]);
      }

      // fused: the rounded dS^T fragment, transposed, into this
      // warpgroup's tile [BN q rows][64 kv columns] (the K-major B of dq's
      // product); 128-byte swizzle: byte o of row q lands at o ^ (q%8)*16
      const uint32_t ds_tile = base + P::kDs + wg * BN * kRowBytes;
      if constexpr (kFused) {
        uint8_t* tile = gbase + P::kDs + wg * BN * kRowBytes;
        const int kv = 16 * (tw / 32) + lane / 4;   // local kv row
#pragma unroll
        for (int e = 0; e < BN / 2; e += 2) {
          const int kr = kv + 8 * ((e >> 1) & 1);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qc = 8 * (e >> 2) + cq + u;     // local q row
            const uint32_t off =
                (static_cast<uint32_t>(qc * kRowBytes + 2 * kr)) ^
                ((qc & 7) << 4);
            *reinterpret_cast<uint16_t*>(tile + off) =
                static_cast<uint16_t>(u == 0 ? ds[e / 2] & 0xffffu
                                             : ds[e / 2] >> 16);
          }
        }
        fence_proxy_async();
        // the previous tile's reduce has read its staging tile
        if (tw == 0) bulk_wait_read();
        named_bar_sync(1 + wg, 128);
      }
      float dqt[kFused ? BN / 2 : 1];   // dq^T partial: [64 D cols x BN q]

      // acc1 += dS B1 (dq += dS K, dk += dS^T Q); dkv: acc2 += P B2
      // (dv += P^T dO); B1, B2 MN-major from the stage, this CTA's
      // output boxes
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < kOut; ++hf) {
          const uint32_t off = (out0 + hf) * BN * kRowBytes +
                               kk * 16 * kRowBytes;
          wgmma_rs_n64_tb<T>(acc1[hf], ds[4 * kk], ds[4 * kk + 1],
                             ds[4 * kk + 2], ds[4 * kk + 3],
                             sw128_desc(b1 + off, 1024, 1024));
          if constexpr (kDKV)
            wgmma_rs_n64_tb<T>(acc2[hf], pp[4 * kk], pp[4 * kk + 1],
                               pp[4 * kk + 2], pp[4 * kk + 3],
                               sw128_desc(b2 + off, 1024, 1024));
        }
      if constexpr (kFused) {
        // dq^T[out box cols, q] = K^T dS^T over this warpgroup's 64 kv
        // rows: A = the resident K box, MN-major (transpose flag); B =
        // the dS^T tile, K-major
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_ta<T, BN>(
              dqt,
              sw128_desc(base + P::kOwn1 + out0 * kBM * kRowBytes +
                             (wg * 64 + kk * 16) * kRowBytes,
                         1024, 1024),
              sw128_desc(ds_tile + kk * 32, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kOut; ++hf) reg_fence(acc1[hf]);
      reg_fence(ds);
      if constexpr (kDKV) {
#pragma unroll
        for (int hf = 0; hf < kOut; ++hf) reg_fence(acc2[hf]);
        reg_fence(pp);
      }
      if constexpr (kFused) {
        // stage the partial as [BN q][64 d] fp32 and add it into the
        // workspace with one TMA reduce-add (cp.reduce.async.bulk.tensor
        // .add.f32) per warpgroup; rows past Sq are clipped by TMA
        reg_fence(dqt);
        const int dcol = 16 * (tw / 32) + lane / 4;
        float* stg = reinterpret_cast<float*>(gbase + P::kDqs) +
                     wg * BN * kAtom;
#pragma unroll
        for (int e = 0; e < BN / 2; ++e)
          stg[(8 * (e >> 2) + cq + (e & 1)) * kAtom + dcol +
              8 * ((e >> 1) & 1)] = dqt[e];
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (tw == 0)
          tma_reduce_add_4d(reinterpret_cast<uint64_t>(&t_ws),
                            base + P::kDqs + wg * BN * kAtom * 4,
                            out0 * kAtom, h, s0, b);
      }
    }
    mbar_arrive(empty_bar + 8 * stage);   // this thread is done with it
  }
  if (kFused && tw == 0) bulk_wait_all();   // the last reduce is done

  // store this thread's rows: dq, or dk and dv
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_in[i]) continue;
    T* r1 = out1 + b * l1.b + h * l1.h + static_cast<int64_t>(rows[i]) * l1.s +
            out0 * kAtom + cq;
#pragma unroll
    for (int hf = 0; hf < kOut; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(r1 + hf * kAtom + 8 * j) =
            Elem<T>::pack(acc1[hf][4 * j + 2 * i], acc1[hf][4 * j + 2 * i + 1]);
    if constexpr (kDKV) {
      T* r2 = out2 + b * l2.b + h * l2.h +
              static_cast<int64_t>(rows[i]) * l2.s + out0 * kAtom + cq;
#pragma unroll
      for (int hf = 0; hf < kOut; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(r2 + hf * kAtom + 8 * j) =
              Elem<T>::pack(acc2[hf][4 * j + 2 * i],
                            acc2[hf][4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// A 16-bit [B, S, H, D] tensor at `ptr` with element strides st = (b, s,
// h) as a 4-D map (D, H, S, B) whose box is 64 columns of `rows` rows of
// one (b, h), 128-byte swizzled; rows past S read as zero.
template <typename T>
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             const int64_t* st, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, Elem<T>::kMap, 4, const_cast<void*>(ptr), dims, strides, box,
      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// The fused sweep's fp32 dq workspace, contiguous [B, Sq, H, D], as a
// 4-D map (D, H, Sq, B) whose box is 64 columns of `rows` rows of one
// (b, h), unswizzled (the reduce-add's destination).
int make_ws_map(CUtensorMap* map, const float* ws, int B, int Sq, int H,
                int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(Sq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(D) * 4, static_cast<cuuint64_t>(H) * D * 4,
      static_cast<cuuint64_t>(Sq) * H * D * 4};
  const cuuint32_t box[4] = {kAtom, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(ws), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

Layout layout_at(const int64_t* st, int i) {
  return Layout{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// The fused sweep's two helpers (one launch each on the same stream):
// delta = rowsum(dO * O), D / 8 lanes per row, each summing its 8
// products (one 16-byte load of each row) in order before a butterfly,
// with the row's fp32 dq workspace zeroed; and the workspace rounded into
// the 16-bit dq, 4 elements a thread.
constexpr int kHelperThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kHelperThreads)
fused_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ delta, float* __restrict__ dq_ws,
                  int B, int H, int Sq, Layout lo, Layout ldo) {
  constexpr int kLanes = D / 8;                 // lanes per row
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kHelperThreads +
                    threadIdx.x;
  const int64_t row = t / kLanes;               // (b, h, s) in delta's order
  const int part_idx = static_cast<int>(t % kLanes);
  const bool in = row < static_cast<int64_t>(B) * H * Sq;
  float part = 0.f;
  int64_t s = 0, h = 0, b = 0;
  if (in) {
    s = row % Sq;
    h = (row / Sq) % H;
    b = row / (static_cast<int64_t>(Sq) * H);
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + b * lo.b + h * lo.h + s * lo.s + 8 * part_idx);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * ldo.b + h * ldo.h + s * ldo.s + 8 * part_idx);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 of = unpack2(ow[u], T());
      const float2 gf = unpack2(gw[u], T());
      part = fmaf(gf.x, of.x, part);
      part = fmaf(gf.y, of.y, part);
    }
  }
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1)   // rows are whole lane runs
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (!in) return;
  if (part_idx == 0) delta[row] = part;
  float4* ws = reinterpret_cast<float4*>(
      dq_ws + ((b * Sq + s) * H + h) * D + 8 * part_idx);
  ws[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  ws[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kHelperThreads)
fused_dq_cast_kernel(const float* __restrict__ dq_ws, T* __restrict__ dq,
                     int64_t n_quads) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kHelperThreads + threadIdx.x;
  if (i < n_quads) {   // D is a multiple of 4: quads never straddle a row
    const float4 x = reinterpret_cast<const float4*>(dq_ws)[i];
    reinterpret_cast<uint2*>(dq)[i] =
        make_uint2(Elem<T>::pack(x.x, x.y), Elem<T>::pack(x.z, x.w));
  }
}

// dq: tensors (q, k, v, o, dout, dq) at strides 0..5; dkv and the fused
// sweep: (q, k, v, dout, dk, dv).
template <typename T, int D, int kMode>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* out1,
           void* out2, float* dq_ws, const int32_t* qseg,
           const int32_t* kseg, int B, int H, int Sq, int Sk, int causal,
           float scale, const int64_t* st, cudaStream_t stream) {
  constexpr bool kDKV = kMode != kModeDq;
  constexpr int BN = kBN<D, kMode>;
  using P = Plan<D, BN, kMode == kModeFused>;
  CUtensorMap m_o1, m_o2, m_s1, m_s2, m_ws{};
  const int64_t* st_do = st + (kDKV ? 9 : 12);
  int err = 0;
  if (kMode == kModeFused)
    err = make_ws_map(&m_ws, dq_ws, B, Sq, H, D, BN);
  if (err != 0) return err;
  if (kDKV) {   // owner K, V; streamed Q, dO
    err = make_map<T>(&m_o1, k, B, Sk, H, D, st + 3, kBM);
    if (err == 0) err = make_map<T>(&m_o2, v, B, Sk, H, D, st + 6, kBM);
    if (err == 0) err = make_map<T>(&m_s1, q, B, Sq, H, D, st, BN);
    if (err == 0) err = make_map<T>(&m_s2, dout, B, Sq, H, D, st_do, BN);
  } else {      // owner Q, dO; streamed K, V
    err = make_map<T>(&m_o1, q, B, Sq, H, D, st, kBM);
    if (err == 0) err = make_map<T>(&m_o2, dout, B, Sq, H, D, st_do, kBM);
    if (err == 0) err = make_map<T>(&m_s1, k, B, Sk, H, D, st + 3, BN);
    if (err == 0) err = make_map<T>(&m_s2, v, B, Sk, H, D, st + 6, BN);
  }
  if (err != 0) return err;
  auto kernel = flash_bwd_tc_kernel<T, D, kMode>;
  static int set[smem_limit::kMaxDevices] = {};
  const cudaError_t cerr = smem_limit::raise(kernel, P::kAlloc, set);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_own = ((kDKV ? Sk : Sq) + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * H),
                  static_cast<unsigned>(n_own),
                  static_cast<unsigned>(D / kOutCols<D, kDKV>));
  const Layout lo = kDKV ? Layout{0, 0, 0} : layout_at(st, 3);
  const Layout ldo = layout_at(st_do, 0);
  const Layout l1 = layout_at(st, kDKV ? 4 : 5);
  const Layout l2 = kDKV ? layout_at(st, 5) : l1;
  kernel<<<grid, kThreads, P::kAlloc, stream>>>(
      m_o1, m_o2, m_s1, m_s2, m_ws, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, qseg, kseg,
      static_cast<T*>(out1), static_cast<T*>(out2), dq_ws, H, Sq, Sk, lo,
      ldo, l1, l2, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The fused backward's three launches; strides (q, k, v, o, dout, dk, dv).
template <typename T, int D>
int launch_fused(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta,
                 float* dq_ws, void* dq, void* dk, void* dv,
                 const int32_t* qseg, const int32_t* kseg, int B, int H,
                 int Sq, int Sk, int causal, float scale, const int64_t* st,
                 cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * H * Sq;
  const int64_t lanes = rows * (D / 8);
  fused_prep_kernel<T, D><<<
      static_cast<unsigned>((lanes + kHelperThreads - 1) / kHelperThreads),
      kHelperThreads, 0, stream>>>(static_cast<const T*>(o),
                                   static_cast<const T*>(dout), delta, dq_ws,
                                   B, H, Sq, layout_at(st, 3),
                                   layout_at(st, 4));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // the sweep reads (q, k, v, dout, dk, dv) as dkv does
  int64_t sw[18];
  const int pick[6] = {0, 1, 2, 4, 5, 6};
  for (int t = 0; t < 6; ++t)
    for (int j = 0; j < 3; ++j) sw[3 * t + j] = st[3 * pick[t] + j];
  err = launch<T, D, kModeFused>(q, k, v, nullptr, dout, lse, delta, dk, dv,
                                 dq_ws, qseg, kseg, B, H, Sq, Sk, causal,
                                 scale, sw, stream);
  if (err != 0) return err;
  const int64_t n_quads = rows * D / 4;
  fused_dq_cast_kernel<T><<<
      static_cast<unsigned>((n_quads + kHelperThreads - 1) / kHelperThreads),
      kHelperThreads, 0, stream>>>(dq_ws, static_cast<T*>(dq), n_quads);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (dtype, head_dim): dtype 1 = bf16, 2 = fp16.
template <int kMode>
int launch_as(int dtype, int head_dim, const void* q, const void* k,
              const void* v, const void* o, const void* dout, const void* lse,
              void* delta, void* dq_ws, void* out0, void* out1, void* out2,
              const void* qseg, const void* kseg, int B, int H, int Sq,
              int Sk, int causal, float scale, const void* strides,
              void* stream) {
  const int n_own = ((kMode != kModeDq ? Sk : Sq) + kBM - 1) / kBM;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || n_own > 65535 ||
      (head_dim != 64 && head_dim != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int64_t*>(strides);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* ws = static_cast<float*>(dq_ws);
  const auto* qs = static_cast<const int32_t*>(qseg);
  const auto* ks = static_cast<const int32_t*>(kseg);
  auto s = static_cast<cudaStream_t>(stream);
#define PADDLE_FLASH_BWD_TC(T, D)                                          \
  if constexpr (kMode == kModeFused)                                       \
    return launch_fused<T, D>(q, k, v, o, dout, l, dl, ws, out0, out1,     \
                              out2, qs, ks, B, H, Sq, Sk, causal, scale,   \
                              st, s);                                      \
  else                                                                     \
    return launch<T, D, kMode>(q, k, v, o, dout, l, dl, out1, out2,        \
                               nullptr, qs, ks, B, H, Sq, Sk, causal,      \
                               scale, st, s);
  if (dtype == 1 && head_dim == 64) { PADDLE_FLASH_BWD_TC(__nv_bfloat16, 64) }
  if (dtype == 1 && head_dim == 128) { PADDLE_FLASH_BWD_TC(__nv_bfloat16, 128) }
  if (dtype == 2 && head_dim == 64) { PADDLE_FLASH_BWD_TC(__half, 64) }
  if (dtype == 2 && head_dim == 128) { PADDLE_FLASH_BWD_TC(__half, 128) }
#undef PADDLE_FLASH_BWD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entries for ctypes, with the signatures of flash_attention.cu's
// flash_bwd_dq, flash_bwd_dkv and flash_bwd_fused.  dtype 1 = bfloat16,
// 2 = float16; head_dim 64 or 128.  Pointers are device pointers;
// qseg/kseg are int32 [B, Sq] / [B, Sk] or null; lse and delta are fp32
// [B, H, Sq] contiguous.  `strides` is a host array of (batch, seq, head)
// element strides, three per tensor, in the order the tensors appear in
// the signature (dq: q, k, v, o, dout, dq; dkv: q, k, v, dout, dk, dv;
// fused: q, k, v, o, dout, dk, dv).  Every base address and stride of q,
// k, v and dout (and, for dq, o) must be a multiple of 16 bytes (TMA's
// rule).  The launches go on `stream` and do not synchronise.  Returns
// 0, a cudaError_t, -1 (no cuTensorMapEncodeTiled in the driver) or -2
// (the driver refused a tensor map).
extern "C" int flash_bwd_dq_tc(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta,
                               void* dq, const void* qseg, const void* kseg,
                               int B, int H, int Sq, int Sk, int causal,
                               float scale, const void* strides,
                               void* stream) {
  return launch_as<kModeDq>(dtype, head_dim, q, k, v, o, dout, lse, delta,
                            nullptr, nullptr, dq, nullptr, qseg, kseg, B, H,
                            Sq, Sk, causal, scale, strides, stream);
}

extern "C" int flash_bwd_dkv_tc(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* qseg, const void* kseg, int B,
                                int H, int Sq, int Sk, int causal,
                                float scale, const void* strides,
                                void* stream) {
  return launch_as<kModeDkv>(dtype, head_dim, q, k, v, nullptr, dout, lse,
                             const_cast<void*>(delta), nullptr, nullptr, dk,
                             dv, qseg, kseg, B, H, Sq, Sk, causal, scale,
                             strides, stream);
}

// The fused backward: the pre-pass (delta, zeroed workspace), the sweep
// and the dq cast.  dq_ws is an fp32 workspace and dq the output, both
// contiguous [B, Sq, H, D]; delta is fp32 [B, H, Sq] scratch.
extern "C" int flash_bwd_fused_tc(int dtype, int head_dim, const void* q,
                                  const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq_ws,
                                  void* dq, void* dk, void* dv,
                                  const void* qseg, const void* kseg, int B,
                                  int H, int Sq, int Sk, int causal,
                                  float scale, const void* strides,
                                  void* stream) {
  return launch_as<kModeFused>(dtype, head_dim, q, k, v, o, dout, lse, delta,
                               dq_ws, dq, dk, dv, qseg, kseg, B, H, Sq, Sk,
                               causal, scale, strides, stream);
}
