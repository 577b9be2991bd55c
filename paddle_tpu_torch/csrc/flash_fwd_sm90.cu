// Flash attention forward on Hopper's tensor cores (sm_90a): wgmma + TMA.
//
// Replaces, for bf16 and fp16 inputs, the Pallas forward kernels of
// paddle_tpu/ops/pallas_ops.py:
//   flash_fwd_tc       <- _flash_kernel (launched by _pallas_flash_bh) and
//                         _flash_packed_fwd_kernel (_pallas_flash_packed)
//   flash_fwd_hpack_tc <- _flash_kernel_hpack (_pallas_flash_bh_hpack),
//                         hp consecutive rows of B*H per CTA
// flash_attention.cu keeps the CUDA-core forward (fp32 FMAs) for fp32
// inputs and for head dims below 64.  Semantics are that kernel's:
// scale, causal (k <= q), the ragged Sq/Sk edge masked here, segment
// ids; the running max clamped at kLseFloor, so a fully-masked row gives
// out = 0 and lse = kLseFloor, never NaN; the max(l, 1e-30) denominator;
// out in the input dtype [B, Sq, H, D] and lse fp32 [B, H, Sq]; D 64 or
// 128; q, k, v any strided [B, S, H, D] view with a contiguous head dim
// (the [B*H, S, 1, D] layout included).
// Rounding follows the TPU kernel (pallas_ops.py:136-166): S = Q K^T is
// a 16-bit product summed in fp32, p = exp(S - m) is rounded to the
// input dtype for the P V product while l sums the unrounded fp32 p.
// bf16 and fp16 share one body (the element type is a template
// parameter: the .bf16 or .f16 wgmma form, the tensor-map data type, the
// pair packing); the PTX helpers live in sm90.cuh.
//
// What bounds it: at GPT-2-small's training shape (B=8, S=1024, H=12,
// D=64, causal) the forward does ~1.29e10 flop on ~50 MB, ~260 flop per
// byte, far above the CUDA cores' fp32 ridge, so flash_attention.cu's
// forward is bound by its FMAs.  Here both products run on the tensor
// cores in bf16 with fp32 accumulation (989 TFLOP/s dense); the least
// time is then the bytes (0.0151 ms at 3.35 TB/s), so the design's work
// is keeping the tensor cores fed.
//
// Design: one CTA takes 128 q rows of one head (HP heads in turn for
// the head-packed entry) with 256 threads, two warpgroups of 64 rows.
// Thread 0 issues TMA loads: Q once per head, K and V tiles of BN keys
// (64 at D = 64, 128 at D = 128) into a ring of two stages, each
// completing on an mbarrier.  Tiles land
// with the 128-byte swizzle (D = 128 as two 64-column halves), the
// layout wgmma reads.  Per K/V tile each warpgroup runs
//   S = Q K^T   wgmma m64nBNk16, Q and K from shared memory (both
//               K-major: d contiguous);
//   the online softmax on the accumulator fragments in registers (a row
//               lives on the 4 lanes of a quad: two shuffles);
//   O += P V    wgmma m64n64k16 per 64 output columns, P rounded to bf16
//               (or fp16) in registers as the A operand (the fp32
//               accumulator layout of S is the A-operand layout after
//               packing pairs),
//               V from shared memory MN-major (transpose flag).
// After both warpgroups are done with a stage, thread 0 refills it with
// the tile two ahead, so one tile loads while the next computes; in the
// head-packed entry the ring runs on across head boundaries (the next
// head's Q and first K/V tiles load while the current head finishes), and
// each head has its own Q slot.  Every head runs the same instructions, so
// flash_fwd_hpack_tc equals flash_fwd_tc bit for bit.  Causal CTAs skip
// the K/V tiles above the diagonal and the heaviest q tiles launch first.
//
// Host side: the tensor maps are encoded per call with
// cuTensorMapEncodeTiled, taken from the driver library already loaded in
// the process (sm90::encode_tiled), so the library links no -lcuda.
// A [B, S, H, D] view is a 4-D map (D, H, S, B) with byte strides; TMA
// needs a 16-byte-aligned base and strides that are multiples of 16
// bytes, which the Python wrapper checks before it calls.

#include "sm90.cuh"
#include "smem_limit.cuh"

#include <cmath>
#include <cstdint>

namespace {

constexpr float kLseFloor = -1e30f;   // _LSE_FLOOR of pallas_ops.py
constexpr float kDenomTiny = 1e-30f;  // the kernels' max(l, 1e-30)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;              // q rows per CTA
constexpr int kThreads = 256;         // two warpgroups of 64 rows
constexpr int kStages = 2;            // K/V ring depth
using namespace sm90;

struct Layout {  // element strides; the head dim has stride 1
  int64_t b, s, h;
};

// Shared-memory plan of one CTA, in bytes from a 1024-aligned base.
template <int D, int BN, int HP>
struct Plan {
  static constexpr int kHalves = D / kAtom;
  static constexpr uint32_t kQBytes = kBM * D * 2;
  static constexpr uint32_t kKVBytes = BN * D * 2;  // one K (or V) tile
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + HP * kQBytes;   // a Q slot per head
  static constexpr uint32_t kV = kK + kStages * kKVBytes;
  static constexpr uint32_t kBar = kV + kStages * kKVBytes;
  static constexpr uint32_t kBytes = kBar + 8 * (kStages + HP);
  static constexpr size_t kAlloc = kBytes + 1024;  // room to align the base
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// Accumulator fragments (m64nN, fp32): thread t of a warpgroup holds, for
// each 8-column block j, elements 4j..4j+3 at rows r = 16*(t/32) +
// (t%32)/4 and r + 8, columns 8j + 2*(t%4) and +1:
//   e -> row r + 8*((e >> 1) & 1), column 8*(e >> 2) + 2*(t%4) + (e & 1).
template <typename T, int D, int BN, int HP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    T* __restrict__ o, float* __restrict__ lse,
                    const int32_t* __restrict__ qseg,
                    const int32_t* __restrict__ kseg, int H, int Sq, int Sk,
                    Layout lo, int causal, float scale) {
  using P = Plan<D, BN, HP>;
  constexpr int kHalves = P::kHalves;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + P::kBar;        // kStages barriers
  const uint32_t q_bar = full_bar + 8 * kStages;   // HP barriers
  const uint64_t map_q = reinterpret_cast<uint64_t>(&tq);
  const uint64_t map_k = reinterpret_cast<uint64_t>(&tk);
  const uint64_t map_v = reinterpret_cast<uint64_t>(&tv);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int n_qt = (Sq + kBM - 1) / kBM;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBM;
  const int bh0 = static_cast<int>(blockIdx.x) * HP;
  const int k_end = causal ? min(Sk, q0 + kBM) : Sk;
  const int nkt = (k_end + BN - 1) / BN;   // K/V tiles per head
  const int n_items = HP * nkt;            // (head, K/V tile) in order

  // Thread 0 loads item `item`'s K and V tiles into its stage, and the
  // head's Q into its slot when the item is the head's first tile.
  auto issue = [&](int item) {
    const int jh = item / nkt;
    const int kt = item - jh * nkt;
    const int bh = bh0 + jh;
    const int b = bh / H;
    const int h = bh - b * H;
    if (kt == 0) {
      const uint32_t bar = q_bar + 8 * jh;
      const uint32_t dst = base + P::kQ + jh * P::kQBytes;
      mbar_expect_tx(bar, P::kQBytes);
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load_4d(dst + hf * kBM * kRowBytes, map_q, bar, hf * kAtom, h,
                    q0, b);
    }
    const int stage = item % kStages;
    const uint32_t bar = full_bar + 8 * stage;
    const uint32_t kdst = base + P::kK + stage * P::kKVBytes;
    const uint32_t vdst = base + P::kV + stage * P::kKVBytes;
    mbar_expect_tx(bar, 2 * P::kKVBytes);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) {
      tma_load_4d(kdst + hf * BN * kRowBytes, map_k, bar, hf * kAtom, h,
                  kt * BN, b);
      tma_load_4d(vdst + hf * BN * kRowBytes, map_v, bar, hf * kAtom, h,
                  kt * BN, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full_bar + 8 * s, 1);
    for (int s = 0; s < HP; ++s) mbar_init(q_bar + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < kStages && i < n_items; ++i) issue(i);

  // This thread's two rows and the first of its columns in each 8-block.
  const int wrow0 = q0 + 64 * wg;   // the warpgroup's first row
  const int r_lo = wrow0 + 16 * ((tid % 128) / 32) + lane / 4;
  const int r_hi = r_lo + 8;
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const bool has_seg = qseg != nullptr;

  float acc[kHalves][32];
  float m[2], l[2];   // running max (log2 units) and sum, rows r_lo / r_hi
  int qs[2] = {0, 0};
  int b = 0, h = 0;

#pragma unroll 1
  for (int item = 0; item < n_items; ++item) {
    const int jh = item / nkt;
    const int kt = item - jh * nkt;
    if (kt == 0) {
      const int bh = bh0 + jh;
      b = bh / H;
      h = bh - b * H;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
      }
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[hf][e] = 0.f;
      if (has_seg) {
        const int32_t* qsb = qseg + static_cast<int64_t>(b) * Sq;
        qs[0] = r_lo < Sq ? qsb[r_lo] : 0;
        qs[1] = r_hi < Sq ? qsb[r_hi] : 0;
      }
      mbar_wait(q_bar + 8 * jh, 0);   // each slot fills once
    }
    const int stage = item % kStages;
    mbar_wait(full_bar + 8 * stage, (item / kStages) & 1);
    const int k0 = kt * BN;

    // A warpgroup whose rows see no key of this tile skips it: its
    // softmax state would not change.
    if (!causal || k0 <= wrow0 + 63) {
      const uint32_t qa = base + P::kQ + jh * P::kQBytes +
                          wg * 64 * kRowBytes;
      const uint32_t ka = base + P::kK + stage * P::kKVBytes;
      const uint32_t va = base + P::kV + stage * P::kKVBytes;

      float s[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) s[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;   // 16 columns = 32 bytes
        wgmma_ss<T, BN>(s,
                     sw128_desc(qa + (kk / 4) * kBM * kRowBytes + koff, 16,
                                1024),
                     sw128_desc(ka + (kk / 4) * BN * kRowBytes + koff, 16,
                                1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(s);

      // scale (to log2 units) and mask
      const bool need_mask = k0 + BN > Sk || has_seg ||
                             (causal && k0 + BN - 1 > wrow0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i = (e >> 1) & 1;
        float x = s[e] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + 8 * (e >> 2) + cq + (e & 1);
          const int qpos = i ? r_hi : r_lo;
          bool ok = kpos < Sk && (!causal || kpos <= qpos);
          if (has_seg && ok)
            ok = qs[i] == kseg[static_cast<int64_t>(b) * Sk + kpos];
          if (!ok) x = -INFINITY;
        }
        s[e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      float m_safe[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        m_safe[i] = fmaxf(m_new, kLseFloor);
        alpha[i] = ex2(fmaxf(m[i], kLseFloor) - m_safe[i]);
        m[i] = m_new;
      }
      // p in fp32 for the sums, rounded to 16-bit pairs for P V
      uint32_t p[BN / 4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < BN / 2; e += 2) {
        const int i = (e >> 1) & 1;
        const float p0 = ex2(s[e] - m_safe[i]);
        const float p1 = ex2(s[e + 1] - m_safe[i]);
        ps[i] += p0 + p1;
        p[e / 2] = Elem<T>::pack(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
        ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
        l[i] = alpha[i] * l[i] + ps[i];
      }
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[hf][e] *= alpha[(e >> 1) & 1];

      // O += P V: k step kk takes P's keys 16kk..16kk+15, which are
      // p[4kk .. 4kk+3] in the A-fragment order.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
          wgmma_rs_n64_tb<T>(acc[hf], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                          p[4 * kk + 3],
                          sw128_desc(va + hf * BN * kRowBytes +
                                         kk * 16 * kRowBytes,
                                     1024, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int hf = 0; hf < kHalves; ++hf) reg_fence(acc[hf]);
      reg_fence(p);
    }

    __syncthreads();   // both warpgroups are done with this stage
    if (tid == 0 && item + kStages < n_items) issue(item + kStages);

    if (kt == nkt - 1) {   // the head's last tile: normalise and store
      T* ob = o + b * lo.b + h * lo.h;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = i ? r_hi : r_lo;
        if (r >= Sq) continue;
        const float denom = fmaxf(l[i], kDenomTiny);
        const float inv = 1.f / denom;
        T* orow = ob + static_cast<int64_t>(r) * lo.s + cq;
#pragma unroll
        for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<uint32_t*>(orow + hf * kAtom + 8 * j) =
                Elem<T>::pack(acc[hf][4 * j + 2 * i] * inv,
                              acc[hf][4 * j + 2 * i + 1] * inv);
          }
        if (lane % 4 == 0)
          lse[(static_cast<int64_t>(b) * H + h) * Sq + r] =
              fmaxf(m[i] * kLn2, kLseFloor) + logf(denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 16-bit [B, S, H, D] tensor of element type T at `ptr` with element
// strides st = (b, s, h) as a 4-D map (D, H, S, B) whose box is 64
// columns of `rows` rows of one (b, h), 128-byte swizzled; rows past S
// read as zero.
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
      map, Elem<T>::kMap, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

// K/V tile rows by head dim.  At D = 64, 64-key tiles keep a thread near
// 108 registers, so two CTAs share an SM and one's softmax overlaps the
// other's products; 128-key tiles (~157 registers, one CTA per SM) ran
// slower on the card.
template <int D>
constexpr int kBN = D == 64 ? 64 : 128;

template <typename T, int D, int HP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int32_t* qseg, const int32_t* kseg, int B, int H, int Sq,
           int Sk, int causal, float scale, const int64_t* st,
           cudaStream_t stream) {
  constexpr int BN = kBN<D>;
  using P = Plan<D, BN, HP>;
  CUtensorMap mq, mk, mv;
  int err = make_map<T>(&mq, q, B, Sq, H, D, st, kBM);
  if (err == 0) err = make_map<T>(&mk, k, B, Sk, H, D, st + 3, BN);
  if (err == 0) err = make_map<T>(&mv, v, B, Sk, H, D, st + 6, BN);
  if (err != 0) return err;
  auto kernel = flash_fwd_tc_kernel<T, D, BN, HP>;
  static int set[smem_limit::kMaxDevices] = {};
  const cudaError_t cerr = smem_limit::raise(kernel, P::kAlloc, set);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(B) * H / HP),
                  static_cast<unsigned>((Sq + kBM - 1) / kBM));
  const Layout lo{st[9], st[10], st[11]};
  kernel<<<grid, kThreads, P::kAlloc, stream>>>(
      mq, mk, mv, static_cast<T*>(o), lse, qseg, kseg, H, Sq, Sk, lo, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for (dtype, head_dim, hp): dtype 1 = bf16, 2 = fp16.
template <int D, int HP>
int launch_as(int dtype, const void* q, const void* k, const void* v,
              void* o, float* lse, const int32_t* qseg, const int32_t* kseg,
              int B, int H, int Sq, int Sk, int causal, float scale,
              const int64_t* st, cudaStream_t stream) {
  if (dtype == 1)
    return launch<__nv_bfloat16, D, HP>(q, k, v, o, lse, qseg, kseg, B, H,
                                        Sq, Sk, causal, scale, st, stream);
  if (dtype == 2)
    return launch<__half, D, HP>(q, k, v, o, lse, qseg, kseg, B, H, Sq, Sk,
                                 causal, scale, st, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool bad_shape(int B, int H, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 ||
         (static_cast<int64_t>(Sq) + kBM - 1) / kBM > 65535;
}

}  // namespace

// C entries for ctypes.  dtype 1 = bfloat16, 2 = float16; head_dim 64
// or 128; pointers are device pointers; qseg/kseg are int32 [B, Sq] /
// [B, Sk] or null; lse is fp32 [B, H, Sq] contiguous.  `strides` is a
// host array of (batch, seq, head) element strides of q, k, v and out,
// in that order; every base address and every stride of q, k and v must
// be a multiple of 16 bytes (TMA's rule).  The launch goes on `stream`
// and does not synchronise.  Returns 0, a cudaError_t, -1 (no
// cuTensorMapEncodeTiled in the driver) or -2 (the driver refused a
// tensor map).
extern "C" int flash_fwd_tc(int dtype, int head_dim, const void* q,
                            const void* k, const void* v, void* o, void* lse,
                            const void* qseg, const void* kseg, int B, int H,
                            int Sq, int Sk, int causal, float scale,
                            const void* strides, void* stream) {
  if (bad_shape(B, H, Sq, Sk) || (head_dim != 64 && head_dim != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int64_t*>(strides);
  auto* l = static_cast<float*>(lse);
  const auto* qs = static_cast<const int32_t*>(qseg);
  const auto* ks = static_cast<const int32_t*>(kseg);
  auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch_as<64, 1>(dtype, q, k, v, o, l, qs, ks, B, H, Sq, Sk,
                            causal, scale, st, s);
  return launch_as<128, 1>(dtype, q, k, v, o, l, qs, ks, B, H, Sq, Sk, causal,
                           scale, st, s);
}

// hp consecutive rows of B*H per CTA: hp 2 or 4, head_dim 64, B * H
// divisible by hp, no segment ids; anything else returns
// cudaErrorInvalidValue.  Same dtypes, strides and return codes as
// flash_fwd_tc.
extern "C" int flash_fwd_hpack_tc(int dtype, int head_dim, int hp,
                                  const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int H, int Sq,
                                  int Sk, int causal, float scale,
                                  const void* strides, void* stream) {
  const int64_t bh = static_cast<int64_t>(B) * H;
  if (bad_shape(B, H, Sq, Sk) || head_dim != 64 || (hp != 2 && hp != 4) ||
      bh % hp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* st = static_cast<const int64_t*>(strides);
  auto* l = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  if (hp == 2)
    return launch_as<64, 2>(dtype, q, k, v, o, l, nullptr, nullptr, B, H, Sq,
                            Sk, causal, scale, st, s);
  return launch_as<64, 4>(dtype, q, k, v, o, l, nullptr, nullptr, B, H, Sq,
                          Sk, causal, scale, st, s);
}
