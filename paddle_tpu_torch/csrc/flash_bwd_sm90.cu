// The split flash-attention backward on Hopper's tensor cores (sm_90a):
// wgmma + TMA, bf16 and fp16 operands.
//
// Replaces, for 16-bit inputs at head dims 64 and 128, the Pallas kernels
// of paddle_tpu/ops/pallas_ops.py's split backward:
//   flash_bwd_dq_tc  <- _flash_bwd_dq_kernel (the split branch of
//                       _pallas_flash_bwd) and _flash_packed_bwd_dq_kernel
//                       (_pallas_flash_packed_bwd)
//   flash_bwd_dkv_tc <- _flash_bwd_dkv_kernel and
//                       _flash_packed_bwd_dkv_kernel
// flash_attention.cu keeps the CUDA-core pair (fp32 FMAs) for fp32 inputs
// and for head dims 16 and 32.  The semantics are that pair's and the TPU
// kernels': S = Q K^T a 16-bit product summed in fp32, times scale;
// P = exp(S - lse) on the visible pairs (causal k <= q, the ragged Sq/Sk
// edge, q_seg == k_seg), 0 elsewhere; dP = dO V^T; dS = P (dP - delta)
// scale rounded to the input dtype; dq = dS K, dv = round(P)^T dO,
// dk = dS^T Q, summed in fp32 and stored in the input dtype.  dq writes
// delta = rowsum(dO * O) (fp32 [B, H, Sq]), which dkv reads, so dkv
// launches after dq on the same stream.  A row that sees no key
// (lse = kLseFloor) gets dq = 0 exactly and adds nothing to dk, dv.
// Every sum has one fixed order (no atomics): two runs give the same bits.
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
// Host side: the tensor maps are encoded per call (sm90::encode_tiled) as
// in flash_fwd_sm90.cu; a [B, S, H, D] view is a 4-D map (D, H, S, B).
// TMA needs 16-byte-aligned bases and strides, and dq reads O and dO rows
// with 16-byte loads for delta, which the Python wrappers check first.

#include "sm90.cuh"

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
template <int D>
constexpr int kBN = D == 128 ? 32 : 64;       // streamed rows per tile
template <int D, bool kDKV>
constexpr int kOutCols = kDKV && D == 128 ? 64 : D;

// Shared-memory plan of one CTA, in bytes from a 1024-aligned base.  Each
// tile is D / 64 boxes of 64 columns, 128-byte swizzled.
template <int D, int BN>
struct Plan {
  static constexpr uint32_t kOwnBytes = kBM * D * 2;   // one owner tile
  static constexpr uint32_t kStrBytes = BN * D * 2;    // one streamed tile
  static constexpr uint32_t kOwn1 = 0;
  static constexpr uint32_t kOwn2 = kOwnBytes;
  // stage s: streamed tile 1, then streamed tile 2
  static constexpr uint32_t kStage = 2 * kOwnBytes;
  static constexpr uint32_t kStageBytes = 2 * kStrBytes;
  // stage s's column terms: lse log2(e) [BN], delta [BN], segment [BN]
  static constexpr uint32_t kTerms = kStage + kStages * kStageBytes;
  static constexpr uint32_t kTermBytes = 3 * BN * 4;
  static constexpr uint32_t kBar = kTerms + kStages * kTermBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (2 * kStages + 1);
  static constexpr size_t kAlloc = kBytes + 1024;  // room to align the base
};

// Accumulator fragments (m64nN, fp32): thread t of a warpgroup holds, for
// each 8-column block j, elements 4j..4j+3 at rows r = 16*(t/32) +
// (t%32)/4 and r + 8, columns 8j + 2*(t%4) and +1:
//   e -> row r + 8*((e >> 1) & 1), column 8*(e >> 2) + 2*(t%4) + (e & 1).
// kDKV = false is dq (owner: Q, dO; streamed: K, V; out1 = dq);
// kDKV = true is dkv (owner: K, V; streamed: Q, dO; out1 = dk, out2 = dv).
template <typename T, int D, bool kDKV>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_kernel(const __grid_constant__ CUtensorMap t_own1,
                    const __grid_constant__ CUtensorMap t_own2,
                    const __grid_constant__ CUtensorMap t_str1,
                    const __grid_constant__ CUtensorMap t_str2,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    const int32_t* __restrict__ qseg,
                    const int32_t* __restrict__ kseg, T* __restrict__ out1,
                    T* __restrict__ out2, int H, int Sq, int Sk, Layout lo,
                    Layout ldo, Layout l1, Layout l2, int causal,
                    float scale) {
  constexpr int BN = kBN<D>;
  using P = Plan<D, BN>;
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
    }
    mbar_arrive(empty_bar + 8 * stage);   // this thread is done with it
  }

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

Layout layout_at(const int64_t* st, int i) {
  return Layout{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// dq: tensors (q, k, v, o, dout, dq) at strides 0..5; dkv: (q, k, v,
// dout, dk, dv).
template <typename T, int D, bool kDKV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* out1,
           void* out2, const int32_t* qseg, const int32_t* kseg, int B, int H,
           int Sq, int Sk, int causal, float scale, const int64_t* st,
           cudaStream_t stream) {
  constexpr int BN = kBN<D>;
  using P = Plan<D, BN>;
  CUtensorMap m_o1, m_o2, m_s1, m_s2;
  const int64_t* st_do = st + (kDKV ? 9 : 12);
  int err;
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
  auto kernel = flash_bwd_tc_kernel<T, D, kDKV>;
  const cudaError_t cerr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::kAlloc));
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
      m_o1, m_o2, m_s1, m_s2, static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, qseg, kseg,
      static_cast<T*>(out1), static_cast<T*>(out2), H, Sq, Sk, lo, ldo, l1,
      l2, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (dtype, head_dim): dtype 1 = bf16, 2 = fp16.
template <bool kDKV>
int launch_as(int dtype, int head_dim, const void* q, const void* k,
              const void* v, const void* o, const void* dout, const void* lse,
              void* delta, void* out1, void* out2, const void* qseg,
              const void* kseg, int B, int H, int Sq, int Sk, int causal,
              float scale, const void* strides, void* stream) {
  const int n_own = ((kDKV ? Sk : Sq) + kBM - 1) / kBM;
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || n_own > 65535 ||
      (head_dim != 64 && head_dim != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int64_t*>(strides);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  const auto* qs = static_cast<const int32_t*>(qseg);
  const auto* ks = static_cast<const int32_t*>(kseg);
  auto s = static_cast<cudaStream_t>(stream);
#define PADDLE_FLASH_BWD_TC(T, D)                                          \
  return launch<T, D, kDKV>(q, k, v, o, dout, l, dl, out1, out2, qs, ks, B, \
                            H, Sq, Sk, causal, scale, st, s);
  if (dtype == 1 && head_dim == 64) PADDLE_FLASH_BWD_TC(__nv_bfloat16, 64)
  if (dtype == 1 && head_dim == 128) PADDLE_FLASH_BWD_TC(__nv_bfloat16, 128)
  if (dtype == 2 && head_dim == 64) PADDLE_FLASH_BWD_TC(__half, 64)
  if (dtype == 2 && head_dim == 128) PADDLE_FLASH_BWD_TC(__half, 128)
#undef PADDLE_FLASH_BWD_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C entries for ctypes, with the signatures of flash_attention.cu's
// flash_bwd_dq and flash_bwd_dkv.  dtype 1 = bfloat16, 2 = float16;
// head_dim 64 or 128.  Pointers are device pointers; qseg/kseg are int32
// [B, Sq] / [B, Sk] or null; lse and delta are fp32 [B, H, Sq]
// contiguous.  `strides` is a host array of (batch, seq, head) element
// strides, three per tensor, in the order the tensors appear in the
// signature (dq: q, k, v, o, dout, dq; dkv: q, k, v, dout, dk, dv).
// Every base address and stride of q, k, v, o and dout must be a
// multiple of 16 bytes (TMA's rule).  The launch goes on `stream` and
// does not synchronise.  Returns 0, a cudaError_t, -1 (no
// cuTensorMapEncodeTiled in the driver) or -2 (the driver refused a
// tensor map).
extern "C" int flash_bwd_dq_tc(int dtype, int head_dim, const void* q,
                               const void* k, const void* v, const void* o,
                               const void* dout, const void* lse, void* delta,
                               void* dq, const void* qseg, const void* kseg,
                               int B, int H, int Sq, int Sk, int causal,
                               float scale, const void* strides,
                               void* stream) {
  return launch_as<false>(dtype, head_dim, q, k, v, o, dout, lse, delta, dq,
                          nullptr, qseg, kseg, B, H, Sq, Sk, causal, scale,
                          strides, stream);
}

extern "C" int flash_bwd_dkv_tc(int dtype, int head_dim, const void* q,
                                const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const void* qseg, const void* kseg, int B,
                                int H, int Sq, int Sk, int causal,
                                float scale, const void* strides,
                                void* stream) {
  return launch_as<true>(dtype, head_dim, q, k, v, nullptr, dout, lse,
                         const_cast<void*>(delta), dk, dv, qseg, kseg, B, H,
                         Sq, Sk, causal, scale, strides, stream);
}
