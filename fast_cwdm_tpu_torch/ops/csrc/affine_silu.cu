// K3: y = silu(x * a[b, c] + b[b, c]), the GroupNorm-apply + SiLU pass,
// and its VJP (affine_silu_bwd, at the end of this file).
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

// ---------------------------------------------------------------------------
// K3 VJP: from the saved x, a, b and the cotangent g,
//   u = x a + b, s = sigmoid(u), du = g (s (1 + u (1 - s))),
//   gx = du a (rounded once to x's type), ga = sum du x, gb = sum du over
//   the voxels of each (batch, channel), fp32.
//
// Replaces `_affine_silu_bwd` of fast_cwdm_tpu/ops/elementwise_pallas.py
// (:155-167), the custom VJP registered on the Pallas kernel; on the TPU it
// is plain XLA (no pallas_call).
//
// Bound on the H100: memory. x and g are read once and gx written once (bf16:
// 6 bytes per element; at the UNet's level-0 site, 1x64x112x112x80, 385 MB,
// about 0.115 ms at 3.35 TB/s); the partial sums are a few hundred KB.
//
// Design: one pass over 16-byte vectors, as the forward, in CTAs that each
// own one (batch, channel) row range (contiguous) or one (batch, channel
// group) voxel range (channels_last_3d), so a CTA's sums belong to fixed
// (batch, channel) pairs. Each thread sums its own elements in a fixed
// order, the CTA reduces its threads in a fixed order and writes its sums to
// a partials buffer [2][chunks][B*C]; a second kernel sums the chunks of each
// (batch, channel) with one warp, in a fixed order. No atomics: two launches
// agree bit for bit. x a and + b, and every step of du, are rounded apart (__fmul_rn,
// __fadd_rn, __fsub_rn), as the plain torch version computes them one
// operation at a time, so gx matches it bit for bit; ga and gb differ from
// its sums by summation order only.

constexpr int kBwdThreads = 256;

__device__ __forceinline__ float silu_vjp(float xf, float gf, float a,
                                          float b) {
  const float u = __fadd_rn(__fmul_rn(xf, a), b);
  const float s = 1.0f / (1.0f + expf(-u));  // torch.sigmoid's operations
  return __fmul_rn(
      gf, __fmul_rn(s, __fadd_rn(1.0f, __fmul_rn(u, __fsub_rn(1.0f, s)))));
}

// Contiguous x: B*C rows of S elements, a row per (batch, channel). CTA
// (row, chunk) takes vectors [chunk * chunk_vec, (chunk + 1) * chunk_vec) of
// its row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
    affine_silu_bwd_rows(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ a,
                         const float* __restrict__ b, T* __restrict__ gx,
                         float* __restrict__ partials, long long S, int rows,
                         int chunks, long long chunk_vec) {
  const int chunk = blockIdx.x % chunks;
  const int row = blockIdx.x / chunks;
  const long long n_vec = S / VEC;
  const long long v0 = (long long)chunk * chunk_vec;
  const long long v1 = v0 + chunk_vec < n_vec ? v0 + chunk_vec : n_vec;
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x + row * S);
  const Pack<T, VEC>* gv = reinterpret_cast<const Pack<T, VEC>*>(g + row * S);
  Pack<T, VEC>* ov = reinterpret_cast<Pack<T, VEC>*>(gx + row * S);
  const float ar = a[row], br = b[row];
  float sx = 0.0f, s1 = 0.0f;
  for (long long v = v0 + threadIdx.x; v < v1; v += kBwdThreads) {
    const Pack<T, VEC> xi = xv[v], gi = gv[v];
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float xf = to_float(xi.v[e]);
      const float du = silu_vjp(xf, to_float(gi.v[e]), ar, br);
      out.v[e] = from_float<T>(__fmul_rn(du, ar));
      sx = fmaf(du, xf, sx);
      s1 += du;
    }
    ov[v] = out;
  }
  // fixed-order CTA reduction: butterfly within each warp, then the warps
  // in order
  __shared__ float red[2][kBwdThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[0][warp] = sx;
    red[1][warp] = s1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tx = 0.0f, t1 = 0.0f;
    for (int w = 0; w < kBwdThreads / 32; ++w) {
      tx += red[0][w];
      t1 += red[1][w];
    }
    partials[(long long)chunk * rows + row] = tx;
    partials[((long long)chunks + chunk) * rows + row] = t1;
  }
}

// channels_last_3d x: B blocks of S voxels of C channels. Thread (tx, ty)
// of CTA (batch, channel group, chunk) takes channel vector cg * bdx + tx of
// voxels chunk_vox * chunk + ty, + bdy, ...; the CTA then sums its rows ty
// in row order, a channel per thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
    affine_silu_bwd_cl(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ a,
                       const float* __restrict__ b, T* __restrict__ gx,
                       float* __restrict__ partials, long long S, int C,
                       int n_bc, int chunks, long long chunk_vox,
                       int cgroups) {
  const int cv = C / VEC;  // vectors per voxel
  const int chunk = blockIdx.x % chunks;
  const int cg = (blockIdx.x / chunks) % cgroups;
  const int bb = blockIdx.x / (chunks * cgroups);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bdx = blockDim.x, bdy = blockDim.y;
  const int cvi = cg * bdx + tx;
  const bool active = cvi < cv;
  const long long s0 = (long long)chunk * chunk_vox;
  const long long s1 = s0 + chunk_vox < S ? s0 + chunk_vox : S;
  float av[VEC], bv[VEC], sx[VEC], so[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int bc = bb * C + (active ? cvi * VEC + e : 0);
    av[e] = a[bc];
    bv[e] = b[bc];
    sx[e] = 0.0f;
    so[e] = 0.0f;
  }
  if (active) {
    const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
    const Pack<T, VEC>* gv = reinterpret_cast<const Pack<T, VEC>*>(g);
    Pack<T, VEC>* ov = reinterpret_cast<Pack<T, VEC>*>(gx);
    for (long long s = s0 + ty; s < s1; s += bdy) {
      const long long v = ((long long)bb * S + s) * cv + cvi;
      const Pack<T, VEC> xi = xv[v], gi = gv[v];
      Pack<T, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xf = to_float(xi.v[e]);
        const float du = silu_vjp(xf, to_float(gi.v[e]), av[e], bv[e]);
        out.v[e] = from_float<T>(__fmul_rn(du, av[e]));
        sx[e] = fmaf(du, xf, sx[e]);
        so[e] += du;
      }
      ov[v] = out;
    }
  }
  // bdx * bdy <= 256 threads, VEC <= 8 sums each: a [bdy][bdx * VEC] table
  // per sum, its columns summed over the rows in row order, one column per
  // thread (in turns where there are more columns than threads)
  __shared__ float red[2][kBwdThreads * 8];
  const int w = bdx * VEC;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[0][ty * w + tx * VEC + e] = sx[e];
    red[1][ty * w + tx * VEC + e] = so[e];
  }
  __syncthreads();
  for (int j = ty * bdx + tx; j < 2 * w; j += bdx * bdy) {
    const int k = j / w, col = j % w;
    const int c = (cg * bdx + col / VEC) * VEC + col % VEC;
    if (c >= C) continue;
    float t = 0.0f;
    for (int r = 0; r < bdy; ++r) t += red[k][r * w + col];
    partials[((long long)k * chunks + chunk) * n_bc + bb * C + c] = t;
  }
}

// ga[i] = sum over chunks of partials[0][k][i], gb[i] of partials[1][k][i]:
// one warp per i, lane l summing chunks l, l + 32, ... in order, then a
// butterfly over the lanes, a fixed order (a thread per i would wait on up
// to ~1000 loads in a row).
__global__ void affine_silu_bwd_reduce(const float* __restrict__ partials,
                                       float* __restrict__ ga,
                                       float* __restrict__ gb, int chunks,
                                       int n_bc) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n_bc) return;  // whole warps: blockDim.x is a multiple of 32
  float sx = 0.0f, s1 = 0.0f;
  for (int k = lane; k < chunks; k += 32) {
    sx += partials[(long long)k * n_bc + i];
    s1 += partials[((long long)chunks + k) * n_bc + i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  if (lane == 0) {
    ga[i] = sx;
    gb[i] = s1;
  }
}

template <typename T, int VEC>
void launch_bwd_main(const void* x, const void* g, const float* a,
                     const float* b, void* gx, float* partials, int B, int C,
                     long long S, int channels_last, int chunks,
                     cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(gx);
  if (channels_last) {
    const int cv = C / VEC;
    const int bdx = cv < kBwdThreads ? cv : kBwdThreads;
    const int bdy = kBwdThreads / bdx;
    const int cgroups = (cv + bdx - 1) / bdx;
    const long long chunk_vox = (S + chunks - 1) / chunks;
    affine_silu_bwd_cl<T, VEC>
        <<<chunks * cgroups * B, dim3(bdx, bdy), 0, stream>>>(
            xt, gt, a, b, ot, partials, S, C, B * C, chunks, chunk_vox,
            cgroups);
  } else {
    const long long chunk_vec = (S / VEC + chunks - 1) / chunks;
    affine_silu_bwd_rows<T, VEC><<<chunks * B * C, kBwdThreads, 0, stream>>>(
        xt, gt, a, b, ot, partials, S, B * C, chunks, chunk_vec);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* g, const float* a, const float* b,
               void* gx, float* ga, float* gb, float* partials, int B, int C,
               long long S, int channels_last, int vec, int chunks,
               cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B <= 0 || C <= 0 || S <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  if (vec == VEC) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(gx) % 16 == 0);
    if (!aligned || (channels_last ? C % VEC : S % VEC))
      return (int)cudaErrorInvalidValue;
    launch_bwd_main<T, VEC>(x, g, a, b, gx, partials, B, C, S, channels_last,
                            chunks, stream);
  } else if (vec == 1) {
    launch_bwd_main<T, 1>(x, g, a, b, gx, partials, B, C, S, channels_last,
                          chunks, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int n_bc = B * C;
  affine_silu_bwd_reduce<<<(n_bc + 7) / 8, 256, 0, stream>>>(partials, ga, gb,
                                                            chunks, n_bc);
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

// K3 VJP. x, g, gx: logical (B, C, *spatial) with S spatial elements, all
// three in one memory format, contiguous (channels_last = 0) or
// channels_last_3d (channels_last = 1). a, b, ga, gb: (B, C) fp32
// contiguous. partials: 2 * chunks * B * C fp32 of scratch. vec: elements per
// 16-byte vector (8 bf16, 4 fp32), or 1 for the scalar loop. dtype: 0 = fp32,
// 1 = bf16. Two launches, both on `stream`.
extern "C" int affine_silu_bwd(const void* x, const void* g, const float* a,
                               const float* b, void* gx, float* ga, float* gb,
                               float* partials, int B, int C, long long S,
                               int channels_last, int vec, int chunks,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_bwd<float>(x, g, a, b, gx, ga, gb, partials, B, C, S,
                             channels_last, vec, chunks, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g, a, b, gx, ga, gb, partials, B, C,
                                     S, channels_last, vec, chunks, s);
  return (int)cudaErrorInvalidValue;
}
