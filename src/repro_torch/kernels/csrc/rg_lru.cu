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
// MB = 754.97 MB -> 0.2254 ms at 3.35 TB/s, against 2*B*S*R = 126 MFLOP
// (negligible).  The call is bound by bytes.
//
// Design.  The TPU kernel tiles R by 128 lanes and walks S in chunks of
// 256 along a sequential grid axis, carrying h in VMEM scratch across
// chunks.  Here the sequential S axis becomes a loop inside the thread:
// one thread owns one (batch, channel) pair and keeps h in a register,
// neighbouring threads own neighbouring channels, so every load and
// store of a warp is one coalesced row segment.  The S loop runs in
// chunks of kUnroll steps, and the next chunk's a and b are loaded
// before the current chunk's dependent FMAs, so 2*kUnroll loads of each
// thread are in flight while it computes.  Ragged R is masked (threads
// past R return) and ragged S is masked in the last chunk, so every
// shape is taken.
//
// This is the simple kernel.  At the slice shape it has only B*R = 15360
// threads (about 4 warps per SM), each walking 4096 dependent steps, so
// it is expected to be bound by memory latency well above its bound.
// Options for a later PR: a chunked two-level scan (per-chunk (prod a,
// h) in a first pass, carries combined across chunks, then a second
// pass) to give many more threads than B*R; and wider vector loads
// (several channels per thread, 16 bytes per load).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels per block
constexpr int kUnroll = 16;    // sequence steps per chunk

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b,
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

template <typename T>
void launch(const void* a, const void* b, void* h, int B, int S, int R,
            long long a_sb, long long a_ss, long long b_sb, long long b_ss,
            long long h_sb, long long h_ss, cudaStream_t stream) {
  dim3 grid((R + kThreads - 1) / kThreads, B);
  rg_lru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(h), S, R, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss);
}

}  // namespace

// a, b, h: (B, S, R) with unit channel stride; dtype 0 = f32, 1 = bf16.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int toast_rg_lru_fwd(const void* a, const void* b, void* h,
                                int B, int S, int R, int dtype,
                                long long a_sb, long long a_ss,
                                long long b_sb, long long b_ss,
                                long long h_sb, long long h_ss,
                                void* stream) {
  if (B <= 0 || S <= 0 || R <= 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(a, b, h, B, S, R, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(a, b, h, B, S, R, a_sb, a_ss, b_sb, b_ss, h_sb,
                          h_ss, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
