// GroupNorm statistics in one pass: for each (batch, channel) the fp32 mean
// and inverse standard deviation of the channel's group, from one read of x
// in its own dtype.
//
// Replaces no TPU kernel. The JAX package leaves these statistics to XLA
// (fast_cwdm_tpu/models/nn.py:76-84, GroupNorm32; fast_cwdm_tpu/ops/
// conv3d_pallas.py:311, group_stats), which fuses the cast, the square and
// both means into its reductions. Eager PyTorch ran them as an fp32 copy of
// x, a square of the copy and two reductions over it: about 30 bytes moved
// an element of a bf16 x, where one read is 2.
//
// Bound on the H100: memory. x is read once (bf16: 2 bytes an element; the
// UNet's largest site, 1x192x112x112x80, 385 MB, 0.115 ms at 3.35 TB/s; the
// 71 GroupNorms of a forward read 2.90 GB, 0.87 ms). The arithmetic, an add
// and an fma an element, is far below the fp32 rate.
//
// Design: one launch. Phase 1: each CTA streams one contiguous slab with
// 16-byte vector loads (four in flight a thread) and keeps fp32 sums of x
// and x^2 for the channels each thread owns: channels_last_3d x is B blocks
// of S voxels of C channels, a thread owning one vector of channels of every
// bdy-th voxel of its CTA's voxel range; contiguous x is B*C rows of S
// elements, a CTA owning a range of one row. The CTA sums its threads in a
// fixed order through shared memory and writes its per-channel sums to a
// workspace, [2][chunks][B*C] (Σx, then Σx²). Phase 2: the last CTA to
// finish, found by a ticket counter (atomicInc, which returns the counter to
// 0 at the last arrival, so it is ready for the next launch), sums each
// (batch, channel)'s partials in chunk order and forms the group's
// statistics by the caller's formula: 0, one mean over the voxels and the
// group's channels (group_stats); 1, the mean of the channel means
// (GroupNorm32). Then var = max(E[x^2] - E[x]^2, 0) and inv =
// rsqrt(var + 1e-5), written per (batch, channel). No float atomics: two
// launches agree bit for bit. The launch allocates nothing and does not
// synchronise, so it can be captured in a CUDA graph; launches on one device
// share one ticket and must run one after another (stream order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxVec = 8;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& p, float* sx,
                                           float* sq) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float f = to_float(p.v[e]);
    sx[e] += f;
    sq[e] = fmaf(f, f, sq[e]);
  }
}

// Phase 2, in the last CTA: chan = the partials summed over the chunks in
// chunk order ([2][B*C]), then the group statistics. Where a tile of
// (batch, channel) pairs leaves threads over, the chunks are cut into
// `parts` contiguous ranges summed side by side, then the parts in order.
__device__ void finish(const float* __restrict__ partials,
                       float* __restrict__ chan, float* __restrict__ mean_pc,
                       float* __restrict__ inv_pc, float* red, int n_bc, int C,
                       int groups, long long S, int chunks, int formula) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int base = 0; base < n_bc; base += nt) {
    const int tile = min(nt, n_bc - base);
    const int parts = max(1, min(nt / tile, chunks));
    const int j = tid % tile, part = tid / tile;
    if (part < parts) {
      const int k0 = (int)((long long)part * chunks / parts);
      const int k1 = (int)((long long)(part + 1) * chunks / parts);
      const float* px = partials + base + j;
      const float* pq = px + (long long)chunks * n_bc;
      float sx = 0.0f, sq = 0.0f;
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        // L2, not L1: written by other CTAs of this launch
        sx += __ldcg(px + (long long)k * n_bc);
        sq += __ldcg(pq + (long long)k * n_bc);
      }
      red[part * tile + j] = sx;
      red[nt + part * tile + j] = sq;
    }
    __syncthreads();
    if (tid < tile) {
      float sx = 0.0f, sq = 0.0f;
      for (int p = 0; p < parts; ++p) {
        sx += red[p * tile + tid];
        sq += red[nt + p * tile + tid];
      }
      chan[base + tid] = sx;
      chan[n_bc + base + tid] = sq;
    }
    __syncthreads();
  }
  const int cpg = C / groups;
  const float s = (float)S;
  for (int i = tid; i < n_bc; i += nt) {
    const int c0 = i - i % cpg;  // the group's first (batch, channel)
    float mean = 0.0f, mean_sq = 0.0f;
    if (formula == 0) {
      for (int c = c0; c < c0 + cpg; ++c) {
        mean += chan[c];
        mean_sq += chan[n_bc + c];
      }
      const float n = (float)(S * cpg);
      mean = mean / n;
      mean_sq = mean_sq / n;
    } else {
      for (int c = c0; c < c0 + cpg; ++c) {
        mean += chan[c] / s;
        mean_sq += chan[n_bc + c] / s;
      }
      mean = mean / (float)cpg;
      mean_sq = mean_sq / (float)cpg;
    }
    // rounded apart, as the plain version's operations; a NaN stays NaN,
    // as under torch.clamp
    const float d = __fsub_rn(mean_sq, __fmul_rn(mean, mean));
    mean_pc[i] = mean;
    inv_pc[i] = rsqrtf(__fadd_rn(d < 0.0f ? 0.0f : d, 1e-5f));
  }
}

// CL: CTA (batch bb, channel group cg, chunk) of a channels_last_3d x, a
// (bdx, bdy) block: thread (tx, ty) owns channel vector cg * bdx + tx of
// voxels s0 + ty, s0 + ty + bdy, ... below s1. Rows: CTA (row, chunk) of a
// contiguous x, 512 threads over the vectors [v0, v1) of one row.
template <typename T, int VEC, bool CL>
__global__ void __launch_bounds__(kThreads, 2)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                    float* __restrict__ chan, float* __restrict__ mean_pc,
                    float* __restrict__ inv_pc, unsigned int* __restrict__ ticket,
                    int C, long long S, int groups, int n_bc, int chunks,
                    long long chunk_len, int cgroups, int formula) {
  __shared__ float red[2 * kThreads * kMaxVec];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bdx = blockDim.x, bdy = blockDim.y;
  const int chunk = blockIdx.x % chunks;
  if constexpr (CL) {
    const int cv = C / VEC;  // vectors a voxel
    const int cg = (blockIdx.x / chunks) % cgroups;
    const int bb = blockIdx.x / (chunks * cgroups);
    const int cvi = cg * bdx + tx;
    const long long s0 = (long long)chunk * chunk_len;
    const long long s1 = s0 + chunk_len < S ? s0 + chunk_len : S;
    float sx[VEC], sq[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) sx[e] = sq[e] = 0.0f;
    if (cvi < cv) {
      const Pack<T, VEC>* xv =
          reinterpret_cast<const Pack<T, VEC>*>(x) + (long long)bb * S * cv + cvi;
      long long s = s0 + ty;
      for (; s + 3 * bdy < s1; s += 4 * bdy) {
        Pack<T, VEC> p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) p[u] = xv[(s + u * bdy) * cv];
#pragma unroll
        for (int u = 0; u < 4; ++u) accumulate(p[u], sx, sq);
      }
      for (; s < s1; s += bdy) accumulate(xv[s * cv], sx, sq);
    }
    // a [bdy][bdx * VEC] table a sum; each column summed over the rows in
    // row order, one column a thread (in turns where columns outnumber
    // threads)
    const int w = bdx * VEC, half = bdx * bdy * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[ty * w + tx * VEC + e] = sx[e];
      red[half + ty * w + tx * VEC + e] = sq[e];
    }
    __syncthreads();
    for (int j = ty * bdx + tx; j < 2 * w; j += bdx * bdy) {
      const int k = j / w, col = j % w;
      const int c = cg * w + col;
      if (c >= C) continue;
      float t = 0.0f;
      for (int r = 0; r < bdy; ++r) t += red[k * half + r * w + col];
      partials[((long long)k * chunks + chunk) * n_bc + (long long)bb * C + c] = t;
    }
  } else {
    const int row = blockIdx.x / chunks;
    const long long n_vec = S / VEC;
    const long long v0 = (long long)chunk * chunk_len;
    const long long v1 = v0 + chunk_len < n_vec ? v0 + chunk_len : n_vec;
    const Pack<T, VEC>* xv =
        reinterpret_cast<const Pack<T, VEC>*>(x) + (long long)row * n_vec;
    float sx[VEC], sq[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) sx[e] = sq[e] = 0.0f;
    long long v = v0 + tx;
    for (; v + 3 * bdx < v1; v += 4 * bdx) {
      Pack<T, VEC> p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = xv[v + u * bdx];
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate(p[u], sx, sq);
    }
    for (; v < v1; v += bdx) accumulate(xv[v], sx, sq);
    float tx_sum = 0.0f, tq_sum = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      tx_sum += sx[e];
      tq_sum += sq[e];
    }
    // fixed order: a butterfly within each warp, then the warps in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tx_sum += __shfl_xor_sync(0xffffffffu, tx_sum, off);
      tq_sum += __shfl_xor_sync(0xffffffffu, tq_sum, off);
    }
    const int warp = tx / 32;
    if (tx % 32 == 0) {
      red[warp] = tx_sum;
      red[kThreads / 32 + warp] = tq_sum;
    }
    __syncthreads();
    if (tx == 0) {
      float a = 0.0f, b = 0.0f;
      for (int w = 0; w < bdx / 32; ++w) {
        a += red[w];
        b += red[kThreads / 32 + w];
      }
      partials[(long long)chunk * n_bc + row] = a;
      partials[((long long)chunks + chunk) * n_bc + row] = b;
    }
  }
  // every writer's partials visible to the device before the CTA arrives
  __threadfence();
  __syncthreads();
  if (tx == 0 && ty == 0)
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish(partials, chan, mean_pc, inv_pc, red, n_bc, C, groups, S, chunks,
         formula);
}

template <typename T, int VEC>
void launch_layout(const void* x, float* partials, float* chan, float* mean_pc,
                   float* inv_pc, unsigned int* ticket, int B, int C,
                   long long S, int groups, int channels_last, int bdx, int bdy,
                   int chunks, long long chunk_len, int formula,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int n_bc = B * C;
  if (channels_last) {
    const int cv = C / VEC;
    const int cgroups = (cv + bdx - 1) / bdx;
    gn_stats_kernel<T, VEC, true>
        <<<B * cgroups * chunks, dim3(bdx, bdy), 0, stream>>>(
            xt, partials, chan, mean_pc, inv_pc, ticket, C, S, groups, n_bc,
            chunks, chunk_len, cgroups, formula);
  } else {
    gn_stats_kernel<T, VEC, false><<<n_bc * chunks, kThreads, 0, stream>>>(
        xt, partials, chan, mean_pc, inv_pc, ticket, C, S, groups, n_bc,
        chunks, chunk_len, 1, formula);
  }
}

template <typename T>
int launch(const void* x, float* mean_pc, float* inv_pc, float* workspace,
           unsigned int* ticket, int B, int C, long long S, int groups,
           int channels_last, int vec, int bdx, int bdy, int chunks,
           long long chunk_len, int formula, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (B <= 0 || C <= 0 || S <= 0 || groups <= 0 || C % groups || chunks <= 0 ||
      chunk_len <= 0 || (formula != 0 && formula != 1))
    return (int)cudaErrorInvalidValue;
  if (channels_last ? (bdx <= 0 || bdy <= 0 || bdx * bdy > kThreads)
                    : (bdx != kThreads || bdy != 1))
    return (int)cudaErrorInvalidValue;
  if (vec != VEC && vec != 1) return (int)cudaErrorInvalidValue;
  if (vec == VEC && (reinterpret_cast<uintptr_t>(x) % 16 ||
                     (channels_last ? C % VEC : S % VEC)))
    return (int)cudaErrorInvalidValue;
  float* partials = workspace;
  float* chan = workspace + 2LL * chunks * B * C;
  if (vec == VEC)
    launch_layout<T, VEC>(x, partials, chan, mean_pc, inv_pc, ticket, B, C, S,
                          groups, channels_last, bdx, bdy, chunks, chunk_len,
                          formula, stream);
  else
    launch_layout<T, 1>(x, partials, chan, mean_pc, inv_pc, ticket, B, C, S,
                        groups, channels_last, bdx, bdy, chunks, chunk_len,
                        formula, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// x: logical (B, C, *spatial) with S spatial elements, contiguous
// (channels_last = 0) or channels_last_3d (channels_last = 1); dtype 0 =
// fp32, 1 = bf16. mean_pc, inv_pc: (B, C) fp32 contiguous. workspace:
// 2 * (chunks + 1) * B * C fp32 of scratch. ticket: one unsigned int, 0
// before the launch and 0 again after it. vec: elements a 16-byte vector
// (8 bf16, 4 fp32), or 1 for scalar loads. The plan (bdx, bdy, chunks,
// chunk_len: voxels (channels_last) or vectors (contiguous) a chunk) is
// elementwise_cuda.gn_stats_plan's. formula: 0 = one mean over the voxels
// and the group's channels, 1 = the mean of the channel means. One launch
// on `stream`.
extern "C" int gn_stats(const void* x, float* mean_pc, float* inv_pc,
                        float* workspace, unsigned int* ticket, int B, int C,
                        long long S, int groups, int channels_last, int vec,
                        int bdx, int bdy, int chunks, long long chunk_len,
                        int formula, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, mean_pc, inv_pc, workspace, ticket, B, C, S,
                         groups, channels_last, vec, bdx, bdy, chunks,
                         chunk_len, formula, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, mean_pc, inv_pc, workspace, ticket, B, C,
                                 S, groups, channels_last, vec, bdx, bdy,
                                 chunks, chunk_len, formula, s);
  return (int)cudaErrorInvalidValue;
}
