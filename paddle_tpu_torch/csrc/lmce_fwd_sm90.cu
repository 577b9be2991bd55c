// The fused lm-head cross-entropy forward on Hopper's tensor cores
// (sm_90a): wgmma + TMA, bf16 and fp16 operands.
//
// Replaces, for 16-bit operands, the Pallas kernel of
// paddle_tpu/ops/pallas_lmce.py launched by _call_fwd:
//   lmce_fwd_tc <- _fwd_kernel (loss and lse of softmax(h W^T))
// lmce.cu keeps the CUDA-core forward (fp32 FMAs) for fp32 operands and
// for the comparison on the card.  The semantics are lmce.cu's: h is
// [N, D], W is [V, D] (rows contiguous along D, D a multiple of 8),
// S = h W^T summed in fp32 and never written to memory; per row an
// online max / sum-exp over the vocabulary starting at -1e30, vocabulary
// columns >= V left out (the TPU kernel scores them -1e30, which adds
// nothing), the picked logit S[label] (-1e30 for a label outside
// [0, V)), lse = m + log(max(l, 1e-30)) and loss = lse - S[label], 0
// where label < 0.
//
// What bounds it: at GPT-2-small training shapes (N = 8192, V = 50304,
// D = 768, bf16) it needs 2NVD = 6.3e11 flop on ~90 MB: operations on
// the tensor cores (0.64 ms at 989 TFLOP/s).  W (77 MB) is larger than
// L2 (50 MB) and every CTA streams all of its vocabulary slice, so what
// the design works against is the traffic through L2: about BM flop per
// byte of W, with BM the owner rows a CTA holds.
//
// Design.  A CTA owns 128 rows of h (two consumer warpgroups of 64 rows)
// and one slice of the vocabulary, and walks the slice's 64-row W tiles,
// each as D / 64 items of one 64-column box, through a 4-stage TMA ring
// filled by a producer warp (288 threads; "full" and "empty" mbarriers
// per stage, no __syncthreads in the loop).  For D <= 768 the CTA's h
// rows stay resident in shared memory (12 boxes of 128 x 64, 192 KB,
// loaded once); a wider D streams the h box with each W box instead (the
// h rows are then read from L2 once per W tile).  Each item is 4 wgmma
// m64n64k16 per warpgroup (both operands K-major, 128-byte swizzled)
// accumulating S in 32 fp32 registers; a warpgroup keeps at most one
// item's group in flight (wgmma.wait_group 1) and releases the stage of
// the item before.  After a tile's last box the online max / sum-exp and
// the label pick run on the accumulator fragments: each thread keeps
// its own (m, l, pick) for its two rows over the columns it holds (ex2
// of S log2(e) - m log2(e)), and the four threads of a row merge theirs
// at the end.  So S is computed once, h is read once (resident), and W
// once per row block, which at 128 rows is 4.9 GB through L2 at the
// main shape (64 row blocks x 77 MB).
//
// The vocabulary is split into `slices` consecutive runs of tiles
// (grid.y) so the grid fills the card's SMs: the wrapper picks them
// (64 row blocks x 2 slices = 128 CTAs at the main shape, one wave).
// Each (row block, slice) CTA writes a partial (m, l, pick) per row into
// an fp32 workspace [3, slices, N]; lmce_fwd_combine_kernel merges the
// slices of a row in slice order (expf, logf) into lse and loss.  Every
// sum has one fixed order, so two runs give the same bits.
//
// Edges: TMA fills rows past N or V and columns past D with zeros, so
// the masks are explicit: columns v >= V are left out of the statistics
// and the pick, rows >= N are never stored.

#include "sm90.cuh"
#include "smem_limit.cuh"

#include <cmath>
#include <cstdint>

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg = -1e30f;    // _NEG of pallas_lmce.py
constexpr float kTiny = 1e-30f;   // the max(l, 1e-30) of the lse
constexpr int kBM = 128;          // h rows per CTA
constexpr int kBV = 64;           // vocabulary rows per W tile
constexpr int kConsumers = 256;   // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;   // and the producer warp
constexpr int kStages = 4;        // ring depth
constexpr int kMaxResident = 12;  // 64-column h boxes kept resident

// Shared-memory plan, in bytes from a 1024-aligned base.  Resident: the
// h boxes, then the stages (a W box each).  Streamed: the stages (an h
// box, then a W box).
constexpr uint32_t kHBox = kBM * kRowBytes;   // 16 KB
constexpr uint32_t kWBox = kBV * kRowBytes;   // 8 KB
constexpr uint32_t kResidentBytes = kMaxResident * kHBox + kStages * kWBox;
constexpr uint32_t kStreamedBytes = kStages * (kHBox + kWBox);
constexpr uint32_t kBarOff =
    kResidentBytes > kStreamedBytes ? kResidentBytes : kStreamedBytes;
constexpr size_t kAlloc = kBarOff + 8 * (2 * kStages + 1) + 1024;
static_assert(kAlloc <= 232448, "lmce_fwd_tc: shared memory");

struct Shape {
  int N, V;
  int nb;       // 64-column boxes of D
  int n_vt;     // W tiles of kBV rows
  int tps;      // W tiles per slice
  int slices;
  int resident;
};

// Accumulator fragment (m64n64, fp32): thread t of a warpgroup holds, for
// each 8-column block j, elements 4j..4j+3 at rows r = 16*(t/32) +
// (t%32)/4 and r + 8, columns 8j + 2*(t%4) and +1:
//   e -> row r + 8*((e >> 1) & 1), column 8*(e >> 2) + 2*(t%4) + (e & 1).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
lmce_fwd_tc_kernel(const __grid_constant__ CUtensorMap t_h,
                   const __grid_constant__ CUtensorMap t_w,
                   const int32_t* __restrict__ labels,
                   float* __restrict__ part, Shape sh) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + kBarOff;           // kStages barriers
  const uint32_t empty_bar = full_bar + 8 * kStages;  // kStages barriers
  const uint32_t own_bar = empty_bar + 8 * kStages;

  const int tid = threadIdx.x;
  const int n0 = static_cast<int>(blockIdx.x) * kBM;
  const int slice = static_cast<int>(blockIdx.y);
  const int vt0 = slice * sh.tps;
  const int n_tiles = max(0, min(sh.n_vt, vt0 + sh.tps) - vt0);
  const int n_items = n_tiles * sh.nb;
  const bool resident = sh.resident != 0;
  const uint32_t stage0 = resident ? sh.nb * kHBox : 0u;
  const uint32_t stage_bytes = resident ? kWBox : kHBox + kWBox;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers);
    }
    mbar_init(own_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // -------------------------------------------------------------------
  // producer: lane 0 loads the resident h boxes once, then each item's
  // box(es) into the next free stage
  // -------------------------------------------------------------------
  if (tid >= kConsumers) {
    if (tid != kConsumers) return;
    const uint64_t map_h = reinterpret_cast<uint64_t>(&t_h);
    const uint64_t map_w = reinterpret_cast<uint64_t>(&t_w);
    if (resident && n_items > 0) {
      mbar_expect_tx(own_bar, sh.nb * kHBox);
      for (int kb = 0; kb < sh.nb; ++kb)
        tma_load_2d(base + kb * kHBox, map_h, own_bar, kb * kAtom, n0);
    }
#pragma unroll 1
    for (int item = 0; item < n_items; ++item) {
      const int stage = item % kStages;
      if (item >= kStages)
        mbar_wait(empty_bar + 8 * stage, ((item / kStages) - 1) & 1);
      const int kb = item % sh.nb;
      const int v0 = (vt0 + item / sh.nb) * kBV;
      const uint32_t bar = full_bar + 8 * stage;
      const uint32_t dst = base + stage0 + stage * stage_bytes;
      mbar_expect_tx(bar, stage_bytes);
      if (resident) {
        tma_load_2d(dst, map_w, bar, kb * kAtom, v0);
      } else {
        tma_load_2d(dst, map_h, bar, kb * kAtom, n0);
        tma_load_2d(dst + kHBox, map_w, bar, kb * kAtom, v0);
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
  const int r_lo = n0 + 64 * wg + 16 * (tw / 32) + lane / 4;
  const int rows[2] = {r_lo, r_lo + 8};
  const int cq = 2 * (lane % 4);
  int lab[2];
  float m[2], l[2], pick[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lab[i] = rows[i] < sh.N ? labels[rows[i]] : -1;
    m[i] = kNeg;
    l[i] = 0.f;
    pick[i] = kNeg;
  }
  if (resident && n_items > 0) mbar_wait(own_bar, 0);

  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  int held = -1;   // the stage whose wgmma group may still be in flight
#pragma unroll 1
  for (int item = 0; item < n_items; ++item) {
    const int stage = item % kStages;
    const int kb = item % sh.nb;
    mbar_wait(full_bar + 8 * stage, (item / kStages) & 1);
    const uint32_t st = base + stage0 + stage * stage_bytes;
    const uint32_t a =
        (resident ? base + kb * kHBox : st) + wg * 64 * kRowBytes;
    const uint32_t bw = resident ? st : st + kHBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // 16 columns = 32 bytes a step
      wgmma_ss<T, 64>(s, sw128_desc(a + kk * 32, 16, 1024),
                      sw128_desc(bw + kk * 32, 16, 1024), kb > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait_one();   // the previous item's group is done
    if (held >= 0) mbar_arrive(empty_bar + 8 * held);
    held = stage;
    if (kb != sh.nb - 1) continue;

    // the tile's S is complete: statistics and pick on the fragments
    wgmma_wait_all();
    reg_fence(s);
    mbar_arrive(empty_bar + 8 * stage);
    held = -1;
    const int v0 = (vt0 + item / sh.nb) * kBV;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = v0 + 8 * j + cq + u;
          const float x = s[4 * j + 2 * i + u];
          if (v < sh.V) mx = fmaxf(mx, x);
          if (v == lab[i]) pick[i] = x;
        }
      const float m_new = fmaxf(m[i], mx);
      const float off = -m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = v0 + 8 * j + cq + u;
          if (v < sh.V) sum += ex2(fmaf(s[4 * j + 2 * i + u], kLog2e, off));
        }
      l[i] = l[i] * ex2(fmaf(m[i], kLog2e, off)) + sum;
      m[i] = m_new;
    }
  }

  // the four threads of a row merge their statistics, then store them
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], x);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], x);
      const float po = __shfl_xor_sync(0xffffffffu, pick[i], x);
      const float mn = fmaxf(m[i], mo);
      const float off = -mn * kLog2e;
      l[i] = l[i] * ex2(fmaf(m[i], kLog2e, off)) +
             lo * ex2(fmaf(mo, kLog2e, off));
      m[i] = mn;
      pick[i] = fmaxf(pick[i], po);
    }
    if (lane % 4 == 0 && rows[i] < sh.N) {
      const int64_t at = static_cast<int64_t>(slice) * sh.N + rows[i];
      const int64_t plane = static_cast<int64_t>(sh.slices) * sh.N;
      part[at] = m[i];
      part[plane + at] = l[i];
      part[2 * plane + at] = pick[i];
    }
  }
}

// One thread per row: the slices' partials merged in slice order.
__global__ void __launch_bounds__(256)
lmce_fwd_combine_kernel(const float* __restrict__ part,
                        const int32_t* __restrict__ labels,
                        float* __restrict__ loss, float* __restrict__ lse,
                        int N, int slices) {
  const int r = static_cast<int>(blockIdx.x) * 256 + threadIdx.x;
  if (r >= N) return;
  const int64_t plane = static_cast<int64_t>(slices) * N;
  float m = kNeg;
  for (int k = 0; k < slices; ++k) m = fmaxf(m, part[int64_t(k) * N + r]);
  float l = 0.f, pick = kNeg;
  for (int k = 0; k < slices; ++k) {
    const int64_t at = static_cast<int64_t>(k) * N + r;
    l += part[plane + at] * expf(part[at] - m);
    pick = fmaxf(pick, part[2 * plane + at]);
  }
  const float z = m + logf(fmaxf(l, kTiny));
  lse[r] = z;
  loss[r] = labels[r] >= 0 ? z - pick : 0.f;
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

template <typename T>
int launch(const void* h, const void* w, const int32_t* labels, float* loss,
           float* lse, float* part, int slices, int N, int V, int D,
           cudaStream_t stream) {
  CUtensorMap m_h, m_w;
  int err = make_map<T>(&m_h, h, N, D, kBM);
  if (err == 0) err = make_map<T>(&m_w, w, V, D, kBV);
  if (err != 0) return err;
  Shape sh;
  sh.N = N;
  sh.V = V;
  sh.nb = (D + kAtom - 1) / kAtom;
  sh.n_vt = (V + kBV - 1) / kBV;
  sh.slices = slices;
  sh.tps = (sh.n_vt + slices - 1) / slices;
  sh.resident = sh.nb <= kMaxResident;
  auto kernel = lmce_fwd_tc_kernel<T>;
  static int set[smem_limit::kMaxDevices] = {};
  const cudaError_t cerr = smem_limit::raise(kernel, kAlloc, set);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid(static_cast<unsigned>((N + kBM - 1) / kBM),
                  static_cast<unsigned>(slices));
  kernel<<<grid, kThreads, kAlloc, stream>>>(m_h, m_w, labels, part, sh);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  lmce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, stream>>>(
      part, labels, loss, lse, N, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes: lmce_fwd's signature with the partials' workspace
// and the number of vocabulary slices (1 to 65535, at most the number of
// 64-row W tiles) after lse.  dtype 1 = bfloat16, 2 = float16.  Pointers
// are device pointers: h [N, D] and w [V, D] contiguous with 16-byte-
// aligned bases and D a positive multiple of 8 up to 65536 (TMA's rule:
// rows a multiple of 16 bytes apart); labels int32 [N]; loss and lse fp32
// [N]; part fp32 [3, slices, N] scratch.  Two launches (the sweep, the
// combine) go on `stream` and do not synchronise.  Returns 0, a
// cudaError_t, -1 (no cuTensorMapEncodeTiled in the driver) or -2 (the
// driver refused a tensor map).
extern "C" int lmce_fwd_tc(int dtype, const void* h, const void* w,
                           const void* labels, void* loss, void* lse,
                           void* part, int slices, int N, int V, int D,
                           void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 8 != 0 || D > 65536 ||
      slices <= 0 || slices > 65535 || slices > (V + kBV - 1) / kBV)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* lab = static_cast<const int32_t*>(labels);
  auto* lo = static_cast<float*>(loss);
  auto* z = static_cast<float*>(lse);
  auto* p = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w, lab, lo, z, p, slices, N, V, D, st);
  if (dtype == 2)
    return launch<__half>(h, w, lab, lo, z, p, slices, N, V, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
