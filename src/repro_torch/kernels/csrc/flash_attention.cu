// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (launched by `flash_attention`
// there).  It computes the same function: attention with an online
// softmax whose running max m, sum l and accumulator are kept in f32,
// scale 1/sqrt(hd), causal mask q_pos >= k_pos on absolute positions
// filled with -1e30, output acc / max(l, 1e-30) cast to q's dtype.
// Inputs are taken in model layout (B, S, H, hd) with arbitrary batch,
// sequence and head strides, so the caller makes no transposed copies.
//
// Bound at the qwen2_05b prefill shape (B=4, S=T=2048, H=14, hd=64,
// bf16, causal): 30.1 GFLOP per call (two products over the lower half
// of the score matrix) -> about 30 us at 989 TFLOP/s, against 58.7 MB of
// q/k/v/o -> about 17.5 us at 3.35 TB/s.  The call is compute-bound: the
// products belong on wgmma, the only instruction that reaches the
// tensor cores' full rate, and the loads must run behind them.
//
// Design.  The TPU kernel walks a sequential (b, h, q-block, kv-block)
// grid and carries m/l/acc in VMEM scratch across the kv axis.  Here one
// thread block owns one (q-tile of kBlockQ rows, head, batch), and the kv
// axis becomes a loop inside the block.  Under the causal mask the block
// stops at the last key its last row can see, so tiles wholly above the
// diagonal (which contribute exactly 0 under the -1e30 fill) are
// skipped; blocks are launched longest first, so the short ones fill
// the last wave.
//
// - bf16: warp-specialised.  One producer warp issues TMA copies: the
//   block's Q tile once, then K and V tiles through a ring of kStages
//   shared-memory stages, each stage guarded by a "full" mbarrier (the
//   copy's bytes have landed) and an "empty" one (both consumers are done
//   with it).  Two consumer warpgroups own 64 query rows each.  The head
//   dim is held as 64-column panels in the 128-byte swizzle (head dims
//   below 64, or between 64 and 128, are zero-filled by TMA up to the
//   panel).  S = Q K^T is a wgmma with both operands read from shared
//   memory (K-major); the S accumulators are scaled by scale * log2(e),
//   masked only on tiles that cross the diagonal or the T edge, and
//   turned into P = exp2(S - m) (ex2.approx) in registers; P, rounded to
//   bf16, is the register A operand of O += P V, whose B operand is the
//   V tile read MN-major (the transpose flag), so V is never transposed
//   by hand.  Inside a warpgroup the products of two tiles are in flight
//   together: S_j = Q K_j^T and O += P_{j-1} V_{j-1} are issued at once,
//   and the softmax of S_j runs while the PV product holds the tensor
//   cores.  The row max and sum are reduced over the four lanes that
//   share a row.  O is normalised, written swizzled into the
//   warpgroup's own Q panel and stored by TMA, which clips rows >= S and
//   columns >= hd.  TMA needs 16-byte aligned tensors and strides in
//   multiples of 16 bytes; the wrapper checks that.
// - f32: scalar FMA, to keep f32 accuracy.  Each query row is split over
//   1, 2 or 4 adjacent threads (head dims 16-32, 48-64, 80-128) holding q
//   and the accumulator in registers; 32-key tiles are staged as f32 and
//   read back as float4 broadcasts.
//
// Measured on the card and not kept (PERF.md): ping-pong scheduling of
// the two consumer warpgroups, folding the scale into the exponent's
// FFMA, four partial max / sum chains per row, and a persistent grid
// with a double-buffered Q tile.  None gained more than a few percent at
// the slice shape, and the persistent grid lost at longer sequences.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"  // mbarriers, tensor-map encoder

namespace {

constexpr int kBlockQ = 128;  // query rows per bf16 block (registry.BLOCK_Q)
constexpr float kMaskFill = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, T;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: TMA ring, warp-specialised, wgmma products with f32 sums
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;                      // warpgroups, 64 rows each
constexpr int kThreads = 32 * (4 * kConsumers + 1);  // + one producer warp
constexpr int kPanel = 64;        // head-dim columns per 128-byte panel
constexpr int kRowBytes = 128;    // one swizzled panel row

// Tiles of the instantiation for head dims up to 64 * NP.
template <int NP>
struct Tile {
  static constexpr int kHeadDim = kPanel * NP;       // padded head dim
  static constexpr int kBlockK = NP == 1 ? 128 : 64;  // keys per stage
  static constexpr int kStages = 4;
  static constexpr int kQPanel = kBlockQ * kRowBytes;
  static constexpr int kKvPanel = kBlockK * kRowBytes;
  static constexpr int kKvBytes = NP * kKvPanel;      // one K or V tile
  static constexpr int kBarriers = NP * kQPanel + 2 * kStages * kKvBytes;
  // + 1024 bytes of slack to align the base to the swizzle atom
  static constexpr int kSmem = kBarriers + 8 * (2 * kStages + 1) + 1024;
};

// box at coordinates (c0 = head-dim column, c1 = position, c2 = head,
// c3 = batch) of the map's tensor -> shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3, %4}], [%5];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(src)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of wgmma operands
// (accumulators, register A fragments) across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e]) :: "memory");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, f32) += A (64 x 16) B (16 x N), bf16; `ss`: A and B from
// shared memory (both K-major); `rs`: A from registers, B MN-major.
// scale_d = 0 ignores the old D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32],
                                             uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                              uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    wgmma_ss_n128(d, a, b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, scale_d);
  } else {
    wgmma_rs_n128(d, a, b, scale_d);
  }
}

// S (64 x BK) = Q K^T for one warpgroup: 16 head-dim columns per step,
// 4 steps per 128-byte panel; both operands K-major in shared memory
template <int NP>
__device__ __forceinline__ void issue_qk(float (&s)[Tile<NP>::kBlockK / 2],
                                         uint32_t q_wg, uint32_t k_tile) {
  using C = Tile<NP>;
#pragma unroll
  for (int kk = 0; kk < C::kHeadDim / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss<C::kBlockK>(
        s, sw128_desc(q_wg + (kk / 4) * C::kQPanel + col, 16, 1024),
        sw128_desc(k_tile + (kk / 4) * C::kKvPanel + col, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O += P V; V is the MN-major B operand: 16 keys (2 KB) per step, the
// next 64 head dims one panel on (LBO), 8 keys per swizzle atom (SBO)
template <int NP>
__device__ __forceinline__ void issue_pv(
    float (&o)[Tile<NP>::kHeadDim / 2],
    const uint32_t (&pa)[Tile<NP>::kBlockK / 16][4], uint32_t v_tile) {
  using C = Tile<NP>;
#pragma unroll
  for (int kk = 0; kk < C::kBlockK / 16; ++kk) {
    wgmma_rs<C::kHeadDim>(
        o, pa[kk], sw128_desc(v_tile + kk * 16 * kRowBytes, C::kKvPanel, 1024),
        1);
  }
  wgmma_commit();
}

// Online softmax of one score tile, rows a and b of this lane: scores
// are scaled into log2 units and masked (only when `edge`: the tile
// crosses the diagonal or the T edge), the running max m is raised, the
// sum l rescaled and grown, and s becomes P = exp2(s - m).  Returns the
// factors by which the accumulator rows must be rescaled.
template <int BK>
__device__ __forceinline__ float2 online_softmax(
    float (&s)[BK / 2], float& m_a, float& m_b, float& l_a, float& l_b,
    float scale_log2, bool edge, bool causal, int k0, int t4, int row_a,
    int row_b, int T) {
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const bool rb = (i & 2) != 0;
    float x = s[i] * scale_log2;
    if (edge) {
      const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
      if (causal && key > (rb ? row_b : row_a)) x = kMaskFill;
      if (key >= T) x = -INFINITY;   // not a key: contributes nothing
    }
    s[i] = x;
    if (rb) {
      mx_b = fmaxf(mx_b, x);
    } else {
      mx_a = fmaxf(mx_a, x);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float2 alpha = make_float2(ex2(m_a - mx_a), ex2(m_b - mx_b));
  m_a = mx_a;
  m_b = mx_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const bool rb = (i & 2) != 0;
    s[i] = ex2(s[i] - (rb ? m_b : m_a));
    if (rb) {
      sum_b += s[i];
    } else {
      sum_a += s[i];
    }
  }
  l_a = l_a * alpha.x + sum_a;
  l_b = l_b * alpha.y + sum_b;
  return alpha;
}

// P (f32 accumulator layout) -> bf16 A fragments of PV, 16 keys each:
// the S slices 2kk and 2kk+1 are exactly the A fragment of step kk
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    }
  }
}

template <int N>
__device__ __forceinline__ void scale_rows(float (&o)[N], float2 alpha) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
}

// q, k, v, o: (B, S|T, H, hd) bf16 through their tensor maps (boxes of
// kPanel columns x 64 rows for q and o, x kBlockK rows for k and v)
template <int NP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       int S, int T, int H, int B, int causal,
                       float scale_log2) {
  using C = Tile<NP>;
  constexpr int BK = C::kBlockK;
  constexpr int ST = C::kStages;
  constexpr int HDP = C::kHeadDim;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;     // swizzle atoms: 1024 B
  const uint32_t q_s = base;                       // NP panels x kBlockQ rows
  const uint32_t kv_s = base + NP * C::kQPanel;    // per stage: K tile, V tile
  const uint32_t bars = base + C::kBarriers;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (ST + st); };
  const uint32_t q_bar = bars + 16 * ST;

  // the q-tiles with the most key tiles are launched first
  const int HB = H * B;
  const int n_qt = (S + kBlockQ - 1) / kBlockQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / HB;
  const int h = static_cast<int>(blockIdx.x) % HB % H;
  const int b = static_cast<int>(blockIdx.x) % HB / H;
  const int q0 = qt * kBlockQ;
  const int n_k = ((causal ? min(T, q0 + kBlockQ) : T) + BK - 1) / BK;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * kConsumers);   // one arrival per warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // producer: Q once, then K/V through the ring
    if (lane == 0) {
      mbar_expect_tx(q_bar, NP * C::kQPanel);
      for (int w = 0; w < kConsumers; ++w) {
        for (int p = 0; p < NP; ++p) {
          tma_load(q_s + p * C::kQPanel + w * 64 * kRowBytes, &tq, q_bar,
                   p * kPanel, q0 + 64 * w, h, b);
        }
      }
      for (int j = 0; j < n_k; ++j) {
        const int st = j % ST;
        if (j >= ST) mbar_wait(empty(st), (j / ST - 1) & 1);
        const uint32_t k_dst = kv_s + st * 2 * C::kKvBytes;
        mbar_expect_tx(full(st), 2 * C::kKvBytes);
        for (int p = 0; p < NP; ++p) {
          tma_load(k_dst + p * C::kKvPanel, &tk, full(st), p * kPanel,
                   j * BK, h, b);
          tma_load(k_dst + C::kKvBytes + p * C::kKvPanel, &tv, full(st),
                   p * kPanel, j * BK, h, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows r0 .. r0 + 63; this lane holds rows
  // row_a and row_b = row_a + 8, columns 8 n + 2 t4 + {0, 1} of each
  // 8-column slice n of an accumulator
  const int wg = warp / 4;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int r0 = q0 + 64 * wg;
  const int row_a = r0 + 16 * (warp % 4) + g;
  const int row_b = row_a + 8;
  // tiles past this warpgroup's last causal key are consumed, not computed
  const int n_k_wg = ((causal ? min(T, r0 + 64) : T) + BK - 1) / BK;
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;

  float o[HDP / 2];
  float s[BK / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  // running max (log2 units, scale folded in) and this lane's share of
  // the sum, for rows a and b
  float m_a = kMaskFill, m_b = kMaskFill;
  float l_a = 0.f, l_b = 0.f;

  const bool causal_b = causal != 0;
  uint32_t pa[BK / 16][4];
  auto k_tile = [&](int j) { return kv_s + (j % ST) * 2 * C::kKvBytes; };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(j % ST));
  };

  mbar_wait(q_bar, 0);
  // tile 0: S, softmax, P
  mbar_wait(full(0), 0);
  fence_regs(s);
  wgmma_fence();
  issue_qk<NP>(s, q_wg, k_tile(0));
  wgmma_wait<0>();
  fence_regs(s);
  online_softmax<BK>(s, m_a, m_b, l_a, l_b, scale_log2,
                     (causal_b && BK - 1 > r0) || BK > T, causal_b, 0, t4,
                     row_a, row_b, T);
  pack_p<BK>(pa, s);
  // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} in flight together;
  // the softmax of S_j runs while the PV product is on the tensor cores
  for (int j = 1; j < n_k_wg; ++j) {
    const int k0 = j * BK;
    mbar_wait(full(j % ST), (j / ST) & 1);
    fence_regs(s);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_qk<NP>(s, q_wg, k_tile(j));
    issue_pv<NP>(o, pa, k_tile(j - 1) + C::kKvBytes);
    wgmma_wait<1>();
    fence_regs(s);
    const float2 alpha = online_softmax<BK>(
        s, m_a, m_b, l_a, l_b, scale_log2,
        (causal_b && k0 + BK - 1 > r0) || k0 + BK > T, causal_b, k0, t4,
        row_a, row_b, T);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(j - 1);
    scale_rows(o, alpha);
    pack_p<BK>(pa, s);
  }
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  issue_pv<NP>(o, pa, k_tile(n_k_wg - 1) + C::kKvBytes);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);
  release(n_k_wg - 1);
  // tiles past this warpgroup's last causal key: consumed, not computed
  for (int j = n_k_wg; j < n_k; ++j) {
    mbar_wait(full(j % ST), (j / ST) & 1);
    release(j);
  }

  // normalise; write O into this warpgroup's own (consumed) Q panels in
  // the swizzled layout of the store's map; TMA clips rows >= S and
  // columns >= hd
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  uint8_t* const q_gen = smem_raw + (q_wg - raw);
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * (warp % 4) + g + 8 * half;
      const int off = (n / 8) * C::kQPanel + r * kRowBytes +
                      ((n % 8) ^ (r % 8)) * 16 + 4 * t4;
      const float inv = half ? inv_b : inv_a;
      *reinterpret_cast<uint32_t*>(q_gen + off) =
          pack_bf16(o[4 * n + 2 * half] * inv, o[4 * n + 2 * half + 1] * inv);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int p = 0; p < NP; ++p) {
      tma_store(&to, q_wg + p * C::kQPanel, p * kPanel, r0, h, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMA
// ---------------------------------------------------------------------------

constexpr int kScalarBlockQ = 64;  // query rows per f32 block
constexpr int kScalarBlockK = 32;  // keys per shared-memory tile

// threads that share one query row
template <int HD>
struct RowSplit {
  static constexpr int kThreads = HD > 64 ? 4 : (HD > 32 ? 2 : 1);
  static constexpr int kChunks = HD / (4 * kThreads);  // float4s per thread
};

template <int HD>
__global__ void __launch_bounds__(kScalarBlockQ * RowSplit<HD>::kThreads)
flash_fwd_f32_kernel(Args a) {
  constexpr int TPR = RowSplit<HD>::kThreads;
  constexpr int NC = RowSplit<HD>::kChunks;
  constexpr int NT = kScalarBlockQ * TPR;
  static_assert(HD % (4 * TPR) == 0, "head dim must split into float4s");

  __shared__ float4 k_tile[kScalarBlockK][HD / 4];
  __shared__ float4 v_tile[kScalarBlockK][HD / 4];

  const int tid = threadIdx.x;
  const int row = tid / TPR;       // query row within the tile
  const int part = tid % TPR;      // this thread's share of the head dims
  const int q0 = blockIdx.x * kScalarBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int sq = q0 + row;         // absolute query position
  const bool live = sq < a.S;

  const float* Q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* K = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* V = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;
  float* O = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  // chunk c of this thread holds head dims 4 * (c * TPR + part) + [0, 4):
  // the TPR threads of a row read neighbouring float4s of a key
  float q[NC][4];
  float acc[NC][4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d0 = 4 * (c * TPR + part);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      q[c][e] = live ? Q[sq * a.q_ss + d0 + e] : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = kMaskFill;
  float l = 0.f;

  // under the causal mask no row of this tile sees a key past its last row
  const int k_end = a.causal ? min(a.T, q0 + kScalarBlockQ) : a.T;
  for (int k0 = 0; k0 < k_end; k0 += kScalarBlockK) {
    __syncthreads();             // the previous tile is fully consumed
    float* kt = reinterpret_cast<float*>(k_tile);
    float* vt = reinterpret_cast<float*>(v_tile);
    for (int i = tid; i < kScalarBlockK * HD; i += NT) {
      const int r = i / HD;
      const int d = i - r * HD;
      const int t = k0 + r;
      kt[i] = t < a.T ? K[t * a.k_st + d] : 0.f;
      vt[i] = t < a.T ? V[t * a.v_st + d] : 0.f;
    }
    __syncthreads();

    float s[kScalarBlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kScalarBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = k_tile[j][c * TPR + part];
        dot = fmaf(q[c][0], kk.x, dot);
        dot = fmaf(q[c][1], kk.y, dot);
        dot = fmaf(q[c][2], kk.z, dot);
        dot = fmaf(q[c][3], kk.w, dot);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const int t = k0 + j;
      float sj = dot * a.scale;
      if (a.causal && t > sq) sj = kMaskFill;
      if (t >= a.T) sj = -INFINITY;   // not a key: contributes nothing
      s[j] = sj;
      m_new = fmaxf(m_new, sj);
    }

    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kScalarBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = v_tile[j][c * TPR + part];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
    m = m_new;
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d0 = 4 * (c * TPR + part);
#pragma unroll
      for (int e = 0; e < 4; ++e) O[sq * a.o_ss + d0 + e] = acc[c][e] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// map of a (B, n, H, hd) bf16 tensor with element strides s_n, s_h, s_b,
// as dims (hd, n, H, B), in boxes of kPanel columns x `rows`, 128-byte
// swizzled; reads outside the tensor are zero-filled
bool tensor_map(CUtensorMap* map, const void* ptr, int hd, int n, int H,
                int B, long long s_n, long long s_h, long long s_b,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_n) * 2,
                                 static_cast<cuuint64_t>(s_h) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {kPanel, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP>
cudaError_t launch_bf16(const Args& a, int B, int H, int hd,
                        cudaStream_t stream) {
  using C = Tile<NP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<NP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv, to;
  if (!tensor_map(&tq, a.q, hd, a.S, H, B, a.q_ss, a.q_sh, a.q_sb, 64) ||
      !tensor_map(&tk, a.k, hd, a.T, H, B, a.k_st, a.k_sh, a.k_sb,
                  C::kBlockK) ||
      !tensor_map(&tv, a.v, hd, a.T, H, B, a.v_st, a.v_sh, a.v_sb,
                  C::kBlockK) ||
      !tensor_map(&to, a.o, hd, a.S, H, B, a.o_ss, a.o_sh, a.o_sb, 64)) {
    return cudaErrorInvalidValue;
  }
  const long long blocks =
      static_cast<long long>((a.S + kBlockQ - 1) / kBlockQ) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<NP><<<static_cast<unsigned>(blocks),
                                     kThreads, C::kSmem, stream>>>(
      tq, tk, tv, to, a.S, a.T, H, B, a.causal,
      a.scale * 1.4426950408889634f);
  return cudaSuccess;
}

template <int HD>
void launch_f32(const Args& a, int B, int H, cudaStream_t stream) {
  const dim3 grid((a.S + kScalarBlockQ - 1) / kScalarBlockQ, H, B);
  const dim3 block(kScalarBlockQ * RowSplit<HD>::kThreads);
  flash_fwd_f32_kernel<HD><<<grid, block, 0, stream>>>(a);
}

bool launch_f32_hd(const Args& a, int B, int H, int hd,
                   cudaStream_t stream) {
  switch (hd) {
    case 16: launch_f32<16>(a, B, H, stream); return true;
    case 32: launch_f32<32>(a, B, H, stream); return true;
    case 48: launch_f32<48>(a, B, H, stream); return true;
    case 64: launch_f32<64>(a, B, H, stream); return true;
    case 80: launch_f32<80>(a, B, H, stream); return true;
    case 96: launch_f32<96>(a, B, H, stream); return true;
    case 112: launch_f32<112>(a, B, H, stream); return true;
    case 128: launch_f32<128>(a, B, H, stream); return true;
    default: return false;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, T, H, hd); strides in elements, the
// head-dim stride must be 1.  For bf16 every pointer must be 16-byte
// aligned and every other stride a multiple of 8 elements (TMA).
// dtype: 0 = float32, 1 = bfloat16.  The kernel is launched on `stream`
// and nothing is allocated.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a head dim or dtype without an
// instantiation, or strides TMA cannot describe).
extern "C" int toast_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int S, int T, int H, int hd, int dtype,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, float scale, void* stream) {
  Args a{q, k, v, o, S, T,
         q_sb, q_ss, q_sh, k_sb, k_st, k_sh,
         v_sb, v_st, v_sh, o_sb, o_ss, o_sh,
         causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (!launch_f32_hd(a, B, H, hd, st)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 1 && hd % 16 == 0 && hd >= 16 && hd <= 128) {
    const cudaError_t err = hd <= kPanel ? launch_bf16<1>(a, B, H, hd, st)
                                         : launch_bf16<2>(a, B, H, hd, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

