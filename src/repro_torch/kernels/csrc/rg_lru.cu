// RG-LRU linear recurrence for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` in
// src/repro/kernels/rg_lru.py (launched by `rg_lru_scan` there).  It
// computes the same function: h_t = a_t * h_{t-1} + b_t over (B, S, R),
// starting from h = 0, with h carried in f32 and written in a's dtype
// (f32 or bf16; a, b and h share one dtype).  Inputs are taken with any
// batch and sequence strides and a contiguous channel dim.
//
// Bound at the recurrentgemma_2b prefill shape (B=4, S=4096, R=3840,
// f32 gates): each call must read a and b and write h once, 3 x 251.66
// MB = 754.97 MB -> 0.2254 ms at 3.35 TB/s (bf16: 0.1127 ms), against
// 2*B*S*R = 126 MFLOP (1.9 us at 67 TFLOP/s f32).  Bytes bound it, and
// every byte is moved once: both routes below make one pass.
//
// The TPU kernel tiles R by 128 lanes and walks S in chunks of 256 along
// a sequential grid axis, carrying h in VMEM scratch across chunks.
// Here the sequential S axis is a loop inside the block, and one thread
// owns one (batch, channel) pair and keeps h in a register.
//
// What held the first design back (the generic route below): each
// thread loaded its own next 16 steps ahead of its 16 dependent FMAs.
// At the slice shape that is B*R = 15360 threads, at most 4 warps per
// SM, and 2 x 16 x 4 B = 128 B in flight per thread: about 15 KB per SM,
// draining while the FMA chain and the stores run.  Keeping 3.35 TB/s
// busy across ~0.7 us of loaded latency needs 15-20 KB per SM at all
// times (Little's law), so the kernel was bound by latency and reached
// 46% of its bound.  Wider loads do not help (a warp's load is already a
// full 128-byte line), and the recurrence has no product for the tensor
// cores.
//
// The ring route.  A block owns one batch row and kTileBytes of channels
// (64 f32 or 128 bf16).  One producer warp streams a and b by TMA into a
// ring of kStages shared-memory stages, one (channels x kBoxS steps) box
// of each per stage, each stage guarded by a "full" mbarrier (the boxes'
// bytes have landed) and an "empty" one (every consumer thread holds its
// column in registers).  Parities come from the box index, and a wait of
// seconds traps.  The bytes in flight are set by the ring's depth, not
// by thread count and registers: up to 96 KB per block.  One consumer
// thread per channel reads its column of a stage (consecutive channels,
// consecutive banks), runs the dependent f32 FMA chain in registers,
// releases the stage, writes its h column into one of kOutBoxes staging
// boxes, and one thread stores the box by TMA.  The maps cover (R, S, B)
// with the tensors' own strides, so strided views are read in place;
// TMA zero-fills reads past R or S and drops writes there.
//
// Timed on the card (PERF.md, kernels/tune_rg_lru.py): with direct
// stores from the consumers the ring reached 76% of the bound at the
// slice shape and 37% at B = 1; the TMA store lifted both to about 85%.
// At 4 stages, rows of 256 channel bytes beat 128-byte ones by 13
// points in f32; depth and box length moved the slice shape by ~1%.
//
// Route rule (kernels/rg_lru.py, `route`): TMA needs a, b and h 16-byte
// aligned and their batch and sequence strides in multiples of 16 bytes
// (a dim of size 1 is given its packed stride; h is allocated packed).
// Inputs that meet it take the ring; the others (R = 131, or bf16 with
// R = 300, or a view that starts off the 16-byte grid) take the generic
// route, the first design, which takes any strides.  The wrapper
// chooses; this entry point launches the route it is told to, and
// refuses the ring for inputs TMA cannot take.

#include <cuda_bf16.h>

#include "hopper.cuh"  // mbarriers, tensor-map encoder

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// ring route: TMA producer warp, kStages-deep ring, one thread per channel
// ---------------------------------------------------------------------------

// channel bytes per block: 64 f32 or 128 bf16 channels (rg_lru.TILE_BYTES)
constexpr int kTileBytes = 256;
constexpr int kBoxS = 64;    // sequence steps per TMA box (rg_lru.BOX_S)
constexpr int kStages = 3;   // a and b ring depth (rg_lru.STAGES)
constexpr int kOutBoxes = 2;  // h staging boxes (rg_lru.OUT_BOXES)

template <typename T>
struct Ring {
  static constexpr int kTileR = kTileBytes / sizeof(T);  // channels
  static constexpr int kThreads = kTileR + 32;  // + one producer warp
  static constexpr int kBox = kTileBytes * kBoxS;           // one box
  static constexpr int kStageBytes = 2 * kBox;              // a box, b box
  static constexpr int kOut = kStages * kStageBytes;        // h boxes
  static constexpr int kBarriers = kOut + kOutBoxes * kBox;
  // + 128 bytes of slack to align the base for TMA
  static constexpr int kSmem = kBarriers + 8 * 2 * kStages + 128;
};

// box at (c0 = channel, c1 = step, c2 = batch row) -> shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

// shared memory -> box at (c0, c1, c2) of the map's tensor; TMA clips
// what lies outside the tensor
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(src)
      : "memory");
}

// a, b and h through their tensor maps (dims R, S, B)
template <typename T>
__global__ void __launch_bounds__(Ring<T>::kThreads)
rg_lru_ring_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap th, int S) {
  using C = Ring<T>;
  constexpr int kTileR = C::kTileR;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + C::kBarriers;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  const int r0 = blockIdx.x * kTileR;
  const int bi = blockIdx.y;
  const int n_box = (S + kBoxS - 1) / kBoxS;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kTileR);   // one arrival per consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTileR) {
    // producer: box j of a and b into stage j % kStages
    if (threadIdx.x == kTileR) {
      for (int j = 0; j < n_box; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty(st), (j / kStages - 1) & 1);
        const uint32_t dst = base + st * C::kStageBytes;
        mbar_expect_tx(full(st), C::kStageBytes);
        tma_load(dst, &ta, full(st), r0, j * kBoxS, bi);
        tma_load(dst + C::kBox, &tb, full(st), r0, j * kBoxS, bi);
      }
    }
    return;
  }

  // consumer: channel r0 + c, h box j staged in box j % kOutBoxes
  const int c = threadIdx.x;
  float hv = 0.f;
  for (int j = 0; j < n_box; ++j) {
    const int st = j % kStages;
    const int ob = j % kOutBoxes;
    mbar_wait(full(st), (j / kStages) & 1);
    const T* sa = reinterpret_cast<const T*>(smem + st * C::kStageBytes) + c;
    const T* sb = sa + kTileR * kBoxS;
    // the chain runs in registers first: a store to shared memory
    // between the steps would keep the compiler from loading ahead
    float hs[kBoxS];
#pragma unroll
    for (int i = 0; i < kBoxS; ++i) {
      hv = fmaf(load_f32(sa + i * kTileR), hv, load_f32(sb + i * kTileR));
      hs[i] = hv;
    }
    mbar_arrive(empty(st));
    T* so = reinterpret_cast<T*>(smem + C::kOut + ob * C::kBox) + c;
#pragma unroll
    for (int i = 0; i < kBoxS; ++i) store(so + i * kTileR, hs[i]);
    // h box j is written; before the barrier, thread 0 makes sure the
    // store of box j + 1 - kOutBoxes has read the box that j + 1 fills
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (c == 0) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n"
                   :: "n"(kOutBoxes - 2) : "memory");
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(kTileR) : "memory");
    if (c == 0) {
      tma_store(&th, base + C::kOut + ob * C::kBox, r0, j * kBoxS, bi);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (c == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// generic route: any strides; one thread per channel loads ahead
// ---------------------------------------------------------------------------

constexpr int kThreads = 64;   // channels per block
constexpr int kUnroll = 16;    // sequence steps per chunk

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           long long a_ss, long long b_ss,
                                           int s0, int S, float ca[kUnroll],
                                           float cb[kUnroll]) {
#pragma unroll
  for (int i = 0; i < kUnroll; ++i) {
    const int s = s0 + i;
    if (s < S) {
      ca[i] = load_f32(a + s * a_ss);
      cb[i] = load_f32(b + s * b_ss);
    } else {
      ca[i] = 0.f;
      cb[i] = 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rg_lru_generic_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ h, int S, int R, long long a_sb,
                      long long a_ss, long long b_sb, long long b_ss,
                      long long h_sb, long long h_ss) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  const long long bi = blockIdx.y;
  const T* ap = a + bi * a_sb + r;
  const T* bp = b + bi * b_sb + r;
  T* hp = h + bi * h_sb + r;

  float ca[kUnroll], cb[kUnroll], na[kUnroll], nb[kUnroll];
  load_chunk(ap, bp, a_ss, b_ss, 0, S, ca, cb);
  float hv = 0.f;
  for (int s0 = 0; s0 < S; s0 += kUnroll) {
    // issue the next chunk's loads before this chunk's dependent FMAs
    load_chunk(ap, bp, a_ss, b_ss, s0 + kUnroll, S, na, nb);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      hv = fmaf(ca[i], hv, cb[i]);
      if (s0 + i < S) store(hp + (s0 + i) * h_ss, hv);
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      ca[i] = na[i];
      cb[i] = nb[i];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void* a;
  const void* b;
  void* h;
  int B, S, R;
  long long a_sb, a_ss, b_sb, b_ss, h_sb, h_ss;
};

// TMA's rule for a (B, S, R) operand with unit channel stride
bool tma_ok(const void* p, long long s_b, long long s_s, int esize) {
  const long long lim = 1ll << 40;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s_b >= 0 && s_s >= 0 &&
         s_b * esize % 16 == 0 && s_s * esize % 16 == 0 &&
         s_b * esize < lim && s_s * esize < lim;
}

// map of a (B, S, R) operand as dims (R, S, B), in boxes of kTileR
// channels x kBoxS steps; reads outside the tensor are zero-filled and
// writes outside it are dropped
bool ring_map(CUtensorMap* map, const void* ptr, const Args& a, long long s_b,
              long long s_s, int esize, CUtensorMapDataType type) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(a.R),
                              static_cast<cuuint64_t>(a.S),
                              static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s_s * esize),
                                 static_cast<cuuint64_t>(s_b * esize)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kTileBytes / esize),
                             kBoxS, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_ring(const Args& a, CUtensorMapDataType type,
                        cudaStream_t stream) {
  using C = Ring<T>;
  constexpr int es = sizeof(T);
  if (!tma_ok(a.a, a.a_sb, a.a_ss, es) || !tma_ok(a.b, a.b_sb, a.b_ss, es) ||
      !tma_ok(a.h, a.h_sb, a.h_ss, es)) {
    return cudaErrorInvalidValue;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      rg_lru_ring_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap ta, tb, th;
  if (!ring_map(&ta, a.a, a, a.a_sb, a.a_ss, es, type) ||
      !ring_map(&tb, a.b, a, a.b_sb, a.b_ss, es, type) ||
      !ring_map(&th, a.h, a, a.h_sb, a.h_ss, es, type)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((a.R + C::kTileR - 1) / C::kTileR, a.B);
  rg_lru_ring_kernel<T><<<grid, C::kThreads, C::kSmem, stream>>>(
      ta, tb, th, a.S);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_generic(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.R + kThreads - 1) / kThreads, a.B);
  rg_lru_generic_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.a), static_cast<const T*>(a.b),
      static_cast<T*>(a.h), a.S, a.R, a.a_sb, a.a_ss, a.b_sb, a.b_ss,
      a.h_sb, a.h_ss);
  return cudaSuccess;
}

}  // namespace

// a, b, h: (B, S, R) with unit channel stride, strides in elements;
// dtype 0 = f32, 1 = bf16; route 0 = generic (any strides), 1 = ring
// (TMA: a, b and h 16-byte aligned, batch and sequence strides multiples
// of 16 bytes).  The kernel is launched on `stream` and nothing is
// allocated.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a bad size, dtype or route, or for the ring
// asked to take inputs TMA cannot describe.
extern "C" int toast_rg_lru_fwd(const void* a, const void* b, void* h,
                                int B, int S, int R, int dtype, int route,
                                long long a_sb, long long a_ss,
                                long long b_sb, long long b_ss,
                                long long h_sb, long long h_ss,
                                void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{a, b, h, B, S, R, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == 0 && dtype == 0) {
    err = launch_generic<float>(args, st);
  } else if (route == 0 && dtype == 1) {
    err = launch_generic<__nv_bfloat16>(args, st);
  } else if (route == 1 && dtype == 0) {
    err = launch_ring<float>(args, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, st);
  } else if (route == 1 && dtype == 1) {
    err = launch_ring<__nv_bfloat16>(args, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
