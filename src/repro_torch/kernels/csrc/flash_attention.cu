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
// q/k/v/o -> about 17.5 us at 3.35 TB/s.  The call is compute-bound, so
// the bf16 path runs its two products on the tensor cores.
//
// Design.  The TPU kernel walks a sequential (b, h, q-block, kv-block)
// grid and carries m/l/acc in VMEM scratch across the kv axis.  Here one
// thread block owns one (q-tile of 64 rows, head, batch), and the kv
// axis becomes a loop inside the block over key tiles staged in shared
// memory.  Under the causal mask the block stops at the last key its
// last row can see, so tiles wholly above the diagonal (which contribute
// exactly 0 under the -1e30 fill) are skipped and the work follows the
// data, about half the full matrix.  Ragged tiles at the S and T edges
// are masked in the kernel, so every S and T is taken.
//
// - bf16: four warps of 16 query rows each.  Q stays in registers as
//   mma.sync A fragments; each 64-key tile of K (row-major) and V
//   (transposed, so PV's B fragments are contiguous pairs) is staged in
//   padded shared memory (the padding spreads a warp's fragment reads
//   over all 32 banks).  S = QK^T and O += PV are mma.sync m16n8k16 bf16
//   products with f32 sums; the S accumulators are re-packed in registers
//   as the A fragments of PV, so scores never leave the registers, and
//   the row max / sum are reduced over each quad of lanes with shuffles.
// - f32: scalar FMA, to keep f32 accuracy.  Each query row is split over
//   1, 2 or 4 adjacent threads (head dims 16-32, 48-64, 80-128) holding q
//   and the accumulator in registers; 32-key tiles are staged as f32 and
//   read back as float4 broadcasts.
//
// Not yet done (later work): TMA / cp.async pipelining of the tile
// loads against the products, wgmma, and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block (registry.BLOCK_Q)
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
// bf16: tensor-core products (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;          // 16 query rows per warp
constexpr int kMmaBlockK = 64;     // keys per shared-memory tile

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(32 * kWarps)
flash_fwd_mma_kernel(Args a) {
  constexpr int KS = HD / 16;          // k-steps of QK^T over the head dim
  constexpr int ND = HD / 8;           // n-tiles of PV over the head dim
  constexpr int NT = kMmaBlockK / 8;   // n-tiles of QK^T over the keys
  constexpr int KP = kMmaBlockK / 16;  // k-steps of PV over the keys
  constexpr int K_STRIDE = HD + 8;     // padded rows: conflict-free reads
  constexpr int V_STRIDE = kMmaBlockK + 8;
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");

  __shared__ __align__(16) __nv_bfloat16 k_s[kMmaBlockK * K_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 v_t[HD * V_STRIDE];  // [d][key]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;           // fragment row group
  const int t4 = lane & 3;           // lane within the quad
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row_a = q0 + warp * 16 + g;   // this lane's two query rows
  const int row_b = row_a + 8;

  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;
  __nv_bfloat16* O =
      static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  // Q as A fragments (16x16, row-major) for every k-step, in registers
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + 2 * t4;
    const bool va = row_a < a.S, vb = row_b < a.S;
    qa[ks][0] = va ? load_pair(Q + row_a * a.q_ss + c) : 0u;
    qa[ks][1] = vb ? load_pair(Q + row_b * a.q_ss + c) : 0u;
    qa[ks][2] = va ? load_pair(Q + row_a * a.q_ss + c + 8) : 0u;
    qa[ks][3] = vb ? load_pair(Q + row_b * a.q_ss + c + 8) : 0u;
  }

  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  }
  float m_a = kMaskFill, m_b = kMaskFill;  // running max of rows a, b
  float l_a = 0.f, l_b = 0.f;              // this lane's share of the sums

  const int k_end = a.causal ? min(a.T, q0 + kBlockQ) : a.T;
  for (int k0 = 0; k0 < k_end; k0 += kMmaBlockK) {
    __syncthreads();             // the previous tile is fully consumed
    for (int i = tid; i < kMmaBlockK * HD / 2; i += 32 * kWarps) {
      const int r = (2 * i) / HD;
      const int d = 2 * i - r * HD;
      const int t = k0 + r;
      uint32_t kk = 0u, vv = 0u;
      if (t < a.T) {
        kk = load_pair(K + t * a.k_st + d);
        vv = load_pair(V + t * a.v_st + d);
      }
      *reinterpret_cast<uint32_t*>(k_s + r * K_STRIDE + d) = kk;
      v_t[d * V_STRIDE + r] =
          __ushort_as_bfloat16(static_cast<unsigned short>(vv & 0xffffu));
      v_t[(d + 1) * V_STRIDE + r] =
          __ushort_as_bfloat16(static_cast<unsigned short>(vv >> 16));
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kp =
            k_s + (nt * 8 + g) * K_STRIDE + ks * 16 + 2 * t4;
        mma_16816(s[nt], qa[ks], load_pair(kp), load_pair(kp + 8));
      }
    }

    // scale, mask, and the running max of both rows over the quad
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int row = e < 2 ? row_a : row_b;
        float v = s[nt][e] * a.scale;
        if (a.causal && key > row) v = kMaskFill;
        if (key >= a.T) v = -INFINITY;   // not a key: contributes nothing
        s[nt][e] = v;
        if (e < 2) {
          mx_a = fmaxf(mx_a, v);
        } else {
          mx_b = fmaxf(mx_b, v);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = expf(m_a - mx_a);
    const float alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alpha_a;
      o[nd][1] *= alpha_a;
      o[nd][2] *= alpha_b;
      o[nd][3] *= alpha_b;
    }

    // P = exp(S - m), re-packed as the bf16 A fragments of PV
    uint32_t pa[KP][4];
#pragma unroll
    for (int kp = 0; kp < KP; ++kp) {
      float p[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nt = 2 * kp + j;
        p[j][0] = expf(s[nt][0] - m_a);
        p[j][1] = expf(s[nt][1] - m_a);
        p[j][2] = expf(s[nt][2] - m_b);
        p[j][3] = expf(s[nt][3] - m_b);
        l_a += p[j][0] + p[j][1];
        l_b += p[j][2] + p[j][3];
      }
      pa[kp][0] = pack_bf16(p[0][0], p[0][1]);
      pa[kp][1] = pack_bf16(p[0][2], p[0][3]);
      pa[kp][2] = pack_bf16(p[1][0], p[1][1]);
      pa[kp][3] = pack_bf16(p[1][2], p[1][3]);
    }

    // O += P V
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
      for (int kp = 0; kp < KP; ++kp) {
        const __nv_bfloat16* vp =
            v_t + (nd * 8 + g) * V_STRIDE + kp * 16 + 2 * t4;
        mma_16816(o[nd], pa[kp], load_pair(vp), load_pair(vp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t4;
    if (row_a < a.S) {
      *reinterpret_cast<uint32_t*>(O + row_a * a.o_ss + c) =
          pack_bf16(o[nd][0] * inv_a, o[nd][1] * inv_a);
    }
    if (row_b < a.S) {
      *reinterpret_cast<uint32_t*>(O + row_b * a.o_ss + c) =
          pack_bf16(o[nd][2] * inv_b, o[nd][3] * inv_b);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMA
// ---------------------------------------------------------------------------

constexpr int kScalarBlockK = 32;  // keys per shared-memory tile

// threads that share one query row
template <int HD>
struct RowSplit {
  static constexpr int kThreads = HD > 64 ? 4 : (HD > 32 ? 2 : 1);
  static constexpr int kChunks = HD / (4 * kThreads);  // float4s per thread
};

template <int HD>
__global__ void __launch_bounds__(kBlockQ * RowSplit<HD>::kThreads)
flash_fwd_f32_kernel(Args a) {
  constexpr int TPR = RowSplit<HD>::kThreads;
  constexpr int NC = RowSplit<HD>::kChunks;
  constexpr int NT = kBlockQ * TPR;
  static_assert(HD % (4 * TPR) == 0, "head dim must split into float4s");

  __shared__ float4 k_tile[kScalarBlockK][HD / 4];
  __shared__ float4 v_tile[kScalarBlockK][HD / 4];

  const int tid = threadIdx.x;
  const int row = tid / TPR;       // query row within the tile
  const int part = tid % TPR;      // this thread's share of the head dims
  const int q0 = blockIdx.x * kBlockQ;
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
  const int k_end = a.causal ? min(a.T, q0 + kBlockQ) : a.T;
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

template <int HD>
void launch(const Args& a, int B, int H, int dtype, cudaStream_t stream) {
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, H, B);
  if (dtype == 1) {
    const dim3 block(32 * kWarps);
    flash_fwd_mma_kernel<HD><<<grid, block, 0, stream>>>(a);
  } else {
    const dim3 block(kBlockQ * RowSplit<HD>::kThreads);
    flash_fwd_f32_kernel<HD><<<grid, block, 0, stream>>>(a);
  }
}

bool launch_hd(const Args& a, int B, int H, int hd, int dtype,
               cudaStream_t stream) {
  switch (hd) {
    case 16: launch<16>(a, B, H, dtype, stream); return true;
    case 32: launch<32>(a, B, H, dtype, stream); return true;
    case 48: launch<48>(a, B, H, dtype, stream); return true;
    case 64: launch<64>(a, B, H, dtype, stream); return true;
    case 80: launch<80>(a, B, H, dtype, stream); return true;
    case 96: launch<96>(a, B, H, dtype, stream); return true;
    case 112: launch<112>(a, B, H, dtype, stream); return true;
    case 128: launch<128>(a, B, H, dtype, stream); return true;
    default: return false;
  }
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, T, H, hd); strides in elements, the
// head-dim stride must be 1 (and, for bf16, every other stride even and
// every pointer 4-byte aligned).  dtype: 0 = float32, 1 = bfloat16.  The
// kernel is launched on `stream` and nothing is allocated.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a head
// dim or dtype without an instantiation).
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
  if (dtype != 0 && dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!launch_hd(a, B, H, hd, dtype, static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
