// K3: y = silu(x * a[b, c] + b[b, c]), the GroupNorm-apply + SiLU pass.
//
// Replaces the TPU kernel `_affine_silu_kernel` of
// fast_cwdm_tpu/ops/elementwise_pallas.py (pallas_call at :90). The TPU
// version viewed the buffer as (rows, 128) lanes and tiled a lcm(C, 128)
// lane pattern of the per-channel parameters, and took batch 1 only; both
// are TPU layout devices and are not carried over. Any batch is taken here.
//
// Bound on the H100: memory. Every element is read once and written once
// (bf16: 4 bytes per element; the UNet's level-0 site, 1x64x112x112x80, moves
// 257 MB, about 77 us at 3.35 TB/s). The arithmetic (one fma, one exp, one
// divide, one multiply per element) is far below the fp32 rate.
//
// Design: a grid-stride loop over 16-byte vectors (8 bf16 or 4 fp32 values
// per load and per store). The per-(batch, channel) parameters a and b are
// a few KB and stay in L1/L2. Both memory formats of a logical NCDHW tensor
// are taken: contiguous (channel constant along a vector when the spatial
// size is a multiple of the vector) and channels_last_3d (channels
// consecutive along a vector when C is a multiple of it), so the channel
// index is one 64-bit division per vector, not per element. Shapes that fit
// neither run the same loop one element at a time. The math is fp32 and the
// result is rounded once to x's type (round to nearest even), as the TPU
// kernel does (elementwise_pallas.py:72-73); x*a and +b are rounded apart
// and SiLU is u * (1 / (1 + exp(-u))) with IEEE expf and division, the
// operations of the plain torch version (x.float() * a + b, then u *
// torch.sigmoid(u)), so the two should agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void affine_silu_kernel(const T* __restrict__ x,
                                   const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   T* __restrict__ y, long long n_vec, int C,
                                   long long S, int channels_last) {
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* yv = reinterpret_cast<Pack<T, VEC>*>(y);
  for (long long v = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       v < n_vec; v += (long long)gridDim.x * blockDim.x) {
    const long long i0 = v * VEC;
    // index of (batch, channel) of the vector's first element; the vector
    // never crosses a channel (contiguous) or a voxel (channels_last)
    const long long bc0 = channels_last ? (i0 / (S * C)) * C + i0 % C
                                        : i0 / S;
    const Pack<T, VEC> in = xv[v];
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const long long bc = channels_last ? bc0 + e : bc0;
      // product and sum rounded apart (no fma contraction), as the plain
      // version and the TPU kernel compute them
      const float u = __fadd_rn(__fmul_rn(to_float(in.v[e]), a[bc]), b[bc]);
      out.v[e] = from_float<T>(u * (1.0f / (1.0f + expf(-u))));
    }
    yv[v] = out;
  }
}

template <typename T>
int launch(const void* x, const float* a, const float* b, void* y,
           long long numel, int C, long long S, int channels_last,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const bool vec_ok = aligned && numel % VEC == 0 &&
                      (channels_last ? C % VEC == 0 : S % VEC == 0);
  const long long n_vec = vec_ok ? numel / VEC : numel;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks;
  if (numel > 0) {
    if (vec_ok)
      affine_silu_kernel<T, VEC><<<(int)blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), a, b, static_cast<T*>(y), n_vec, C, S,
          channels_last);
    else
      affine_silu_kernel<T, 1><<<(int)blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(x), a, b, static_cast<T*>(y), n_vec, C, S,
          channels_last);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: logical (B, C, *spatial) with S spatial elements, contiguous
// (channels_last = 0) or channels_last_3d (channels_last = 1).
// a, b: (B, C) fp32 contiguous. dtype: 0 = fp32, 1 = bf16.
extern "C" int affine_silu(const void* x, const float* a, const float* b,
                           void* y, long long numel, int C, long long S,
                           int channels_last, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, a, b, y, numel, C, S, channels_last, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, y, numel, C, S, channels_last, s);
  return (int)cudaErrorInvalidValue;
}
