// K4a / K4b / K5 in bf16 at the UNet's small deep levels, split over K:
// [GN-apply + SiLU prologue] -> 3x3x3 SAME conv -> [+ bias + temb + skip
// epilogue].
//
// Replaces, for bf16 at the deep levels (14x14x10, 7x7x5), the same TPU
// kernels as conv3d.cu (fast_cwdm_tpu/ops/conv3d_pallas.py `_kernel` :36,
// `_blocked_kernel` :154, `_v4_make_kernel` :341) and computes exactly what
// conv3d.cu and conv3d_wgmma.cu compute:
//   prologue (fp32): xn = (x - mean) * inv; u = xn * scale + bias;
//                    act = u * (1 / (1 + expf(-u))), products and sums
//                    rounded apart, IEEE quotient, rounded once to bf16;
//   zero padding AFTER the prologue;
//   bf16 products, fp32 accumulation;
//   epilogue (fp32): acc + (b + temb) + skip, rounded once to bf16.
//
// Bound on the H100: at 14x14x10 operations (256 -> 256: 6.9 GFLOP, 0.007
// ms at the bf16 dense rate), at 7x7x5 bytes (256 -> 256: the 3.5 MB
// weight, 0.001 ms). Either way a few microseconds, against a grid of 4-112
// output blocks: the time goes to filling the card and to latency, not to
// the MMA rate. What the design does about it:
//   - split K: the K dimension (Ci/16 chunks x 3 dx-planes = "units" of
//     16 channels x 9 taps) is cut into S contiguous ranges, one per CTA,
//     so that (M tiles) x (Co/64) x S x B CTAs fill at least one wave of
//     SMs (the plan, conv3d_cuda.splitk_plan, picks S on the host);
//   - M tiles are BM = 128 or 256 consecutive voxels in (x, y, z) order
//     (at 7x7x5 the whole 245-voxel volume is one tile; 4.3% of the rows
//     pad at either deep level), and each tile's halo is the box of input
//     voxels its rows read: one x-plane range, with whole y-lines and
//     z-lines where the tile spans them (the route sends only volumes
//     whose boxes fit the shared memory);
//   - each CTA streams its weight slice: the 9 taps of one dx-plane of one
//     16-channel chunk are 18,432 contiguous bytes of the packed weight
//     (conv3d_cuda.pack_wgmma_weights), so a chunk's dx range is one
//     cp.async.bulk completing on an mbarrier;
//   - producer warps stage chunk c+1 (the weight by bulk copy, the halo
//     through registers with the prologue applied, eight loads in flight
//     per thread) into a two-stage ring while eight consumer warps run
//     chunk c. The prologue, not the MMAs, limits a chunk, so there are
//     two producer warpgroups where the consumers' registers leave room;
//   - the tap offset into the halo is per row (rows are tap-shifted voxels
//     of irregular z-lines at Z = 5 or 10), which no wgmma descriptor can
//     address: A is gathered by ldmatrix with per-row addresses, and the
//     MMAs are mma.sync m16n8k16, fp32 accumulators (the MMA rate is not
//     the limit at these shapes);
//   - deterministic reduction: each split writes its fp32 partial tile once
//     into a workspace [S][B * Mpad][Co]; a second kernel of the same C
//     entry sums the S partials of every output in split order, adds the
//     epilogue and rounds once. No float atomics: two launches on the same
//     inputs give bit-identical outputs.
//
// Shared memory of one stage: halo [2][hv_cap][8] bf16 (one 16-byte row of
// 8 channels per box voxel, for each half of the 16-channel chunk), then
// the chunk's weight [27][2][64][8] bf16 (tap, channel half, output
// channel, 8 channels), of which the split's dx range is filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int BN = 64;                         // output channels per CTA
constexpr int BK = 16;                         // input channels per chunk
constexpr int UNIT_BYTES = 9 * BK * BN * 2;    // one dx-plane: 18,432
constexpr int W_BYTES = 3 * UNIT_BYTES;        // one chunk: 55,296
constexpr int kConsumers = 256;
// producer warpgroups: two where a consumer warp holds 32 rows (MI = 2,
// registers to spare), one at 64 rows (MI = 4)
template <int MI>
__host__ __device__ constexpr int producers() { return MI == 2 ? 256 : 128; }
constexpr int STAGES = 2;                      // the staging ring
constexpr int HEAD_BYTES = 128;                // the mbarriers
constexpr int SMEM_LIMIT = 232448;             // per block on the H100

struct Args {
  const bf16* x;        // (B, X, Y, Z, Ci)
  const bf16* w;        // packed: (Co/64, Ci/16, 27, 2, 64, 8)
  const float* mean;    // (B, Ci) or null
  const float* inv;
  const float* scale;
  const float* bias;
  float* ws;            // partials: (S, B, mpad, Co)
  int X, Y, Z, Ci, Co;
  int M, mpad;          // voxels; rows of the partials (tiles x BM)
  int nnb, units, S;    // Co blocks; K units (Ci/16 x 3); splits
  int hv_cap, stage_bytes;
};

struct RArgs {
  const float* ws;
  const float* b;       // (Co,)
  const float* temb;    // (B, Co) or null
  const bf16* skip;     // (B, X, Y, Z, Co) or null
  bf16* out;
  int B, M, mpad, Co, S;
};

// The halo box of the tile of voxels [v0, v_end): output x-planes [xl, xl +
// nx); the box's origin is input voxel (xl - 1, yl - 1, zl - 1) and its
// extent (nx + 2) x hy x hz. Whole y- and z-lines where the tile spans more
// than one plane or line. Mirrored by conv3d_cuda.splitk_box.
struct Box {
  int xl, yl, zl, nx, hy, hz;
};

__host__ __device__ inline Box tile_box(int v0, int v_end, int Y, int Z) {
  const int v1 = v_end - 1;
  const int x0 = v0 / (Y * Z), x1 = v1 / (Y * Z);
  const int y0 = (v0 / Z) % Y, y1 = (v1 / Z) % Y;
  Box b{x0, 0, 0, x1 - x0 + 1, Y + 2, Z + 2};
  if (x1 == x0) {
    b.yl = y0;
    b.hy = y1 - y0 + 3;
    if (y1 == y0) {
      b.zl = v0 % Z;
      b.hz = v1 % Z - v0 % Z + 3;
    }
  }
  return b;
}

// The K units [u0, u1) of split s: units * s / S onwards, as the plan.
__device__ __forceinline__ void split_units(const Args& p, int s, int& u0,
                                            int& u1) {
  u0 = (int)((long long)p.units * s / p.S);
  u1 = (int)((long long)p.units * (s + 1) / p.S);
}

// ------------------------------------------------------------ producer --

template <int NP, bool PRO>
__device__ __forceinline__ void produce(const Args& p, unsigned char* stages,
                                        uint64_t* full, uint64_t* empty,
                                        const Box& box, int bidx, int nb,
                                        int u0, int u1) {
  const int pt = threadIdx.x - kConsumers;  // 0 .. NP - 1
  const int half = pt & 1;                  // this thread's 8 channels
  const bf16* wsrc = p.w + (long long)nb * (p.Ci / BK) * (W_BYTES / 2);
  const int plane = box.hy * box.hz;
  // every thread's loads of a batch are in flight before any prologue
  constexpr int kBatch = 8, kStep = NP / 2;
  for (int c = u0 / 3, k = 0; 3 * c < u1; ++c, ++k) {
    const int s = k % STAGES;
    if (k >= STAGES) mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
    const int d0 = u0 > 3 * c ? u0 - 3 * c : 0;
    const int d1 = u1 - 1 - 3 * c < 2 ? u1 - 1 - 3 * c : 2;
    unsigned char* st = stages + s * p.stage_bytes;
    if (pt == 0) {
      const uint32_t bytes = (d1 - d0 + 1) * UNIT_BYTES;
      mbar_arrive_expect_tx(&full[s], bytes);
      bulk_g2s(st + 2 * p.hv_cap * 16 + d0 * UNIT_BYTES,
               wsrc + (long long)c * (W_BYTES / 2) + d0 * (UNIT_BYTES / 2),
               bytes, &full[s]);
    }
    const int cb = c * BK + half * 8;
    float mean[8], inv[8], scale[8], bias[8];
    if (PRO) {
      const long long o = (long long)bidx * p.Ci + cb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mean[e] = p.mean[o + e];
        inv[e] = p.inv[o + e];
        scale[e] = p.scale[o + e];
        bias[e] = p.bias[o + e];
      }
    }
    // the box planes that the dx range reads: [d0, d1 + nx - 1]
    uint4* dst = reinterpret_cast<uint4*>(st + half * p.hv_cap * 16);
    const int hv_end = (d1 + box.nx) * plane;
    for (int v0 = d0 * plane + (pt >> 1); v0 < hv_end; v0 += kStep * kBatch) {
      uint4 in[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int hv = v0 + kStep * j;
        const int hz = hv % box.hz, hy = (hv / box.hz) % box.hy, hx = hv / plane;
        const int gx = box.xl - 1 + hx, gy = box.yl - 1 + hy, gz = box.zl - 1 + hz;
        ok[j] = hv < hv_end && gx >= 0 && gx < p.X && gy >= 0 && gy < p.Y &&
                gz >= 0 && gz < p.Z;
        in[j] = make_uint4(0, 0, 0, 0);
        if (ok[j]) {
          const long long vox =
              (((long long)bidx * p.X + gx) * p.Y + gy) * p.Z + gz;
          in[j] = __ldg(reinterpret_cast<const uint4*>(p.x + vox * p.Ci + cb));
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int hv = v0 + kStep * j;
        if (hv < hv_end)
          dst[hv] = ok[j] ? prologue<PRO>(in[j], mean, inv, scale, bias)
                          : make_uint4(0, 0, 0, 0);
      }
    }
    mbar_arrive(&full[s]);
  }
}

// ------------------------------------------------------------ consumer --

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Eight warps of (MI * 16) rows x 32 output channels: warp w takes rows
// (w % 4) * MI * 16 and channels (w / 4) * 32 of the BM x 64 tile.
template <int MI>
__device__ __forceinline__ void consume(const Args& p, unsigned char* stages,
                                        uint64_t* full, uint64_t* empty,
                                        const Box& box, int bidx, int nb,
                                        int tile, int v0, int v_end, int split,
                                        int u0, int u1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * (MI * 16), wn = (warp >> 2) * 32;
  // ldmatrix row of this lane in each of the warp's MI 16-row tiles: the
  // box voxel of its output row at tap (0, 0, 0); padding rows read row 0
  int abase[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    int v = v0 + wm + i * 16 + (lane & 15);
    if (v >= v_end) v = v0;
    const int gz = v % p.Z, gy = (v / p.Z) % p.Y, gx = v / (p.Y * p.Z);
    abase[i] = ((gx - box.xl) * box.hy + (gy - box.yl)) * box.hz + (gz - box.zl);
  }
  // lanes 16-31 read the second 8 channels; B: matrix lane / 8 is (channel
  // half, n-tile) = (mat % 2, mat / 2), row lane % 8
  const int mat = lane >> 3;
  const uint32_t a_lane = (lane >> 4) * p.hv_cap * 16;
  const uint32_t b_lane =
      2 * p.hv_cap * 16 + ((mat & 1) * BN + wn + (mat >> 1) * 8 + (lane & 7)) * 16;
  const uint32_t base = smem_addr(stages);

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int c = u0 / 3, k = 0; 3 * c < u1; ++c, ++k) {
    const int s = k % STAGES;
    mbar_wait(&full[s], (k / STAGES) & 1);
    const int d0 = u0 > 3 * c ? u0 - 3 * c : 0;
    const int d1 = u1 - 1 - 3 * c < 2 ? u1 - 1 - 3 * c : 2;
    const uint32_t st = base + s * p.stage_bytes;
    for (int dx = d0; dx <= d1; ++dx) {
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9) {
        const int toff = (dx * box.hy + t9 / 3) * box.hz + t9 % 3;
        const uint32_t wt = st + b_lane + (dx * 9 + t9) * (2 * BN * 16);
        uint32_t a[MI][4], b[2][4];
#pragma unroll
        for (int i = 0; i < MI; ++i) ldsm_x4(a[i], st + a_lane + (abase[i] + toff) * 16);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) ldsm_x4(b[jp], wt + jp * 16 * 16);
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                     b[j >> 1][(j & 1) * 2 + 1]);
      }
    }
    __syncwarp();
    mbar_arrive_if(&empty[s], lane == 0);
  }

  // this split's fp32 partial tile, every row (padding rows included)
  const int g = lane >> 2, t = lane & 3;
  float* ws = p.ws + ((long long)(split * gridDim.z + bidx) * p.mpad + tile * (MI * 64)) * p.Co +
              nb * BN + wn + 2 * t;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long m = wm + i * 16 + g;
      *reinterpret_cast<float2*>(ws + m * p.Co + j * 8) =
          make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(ws + (m + 8) * p.Co + j * 8) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
}

template <int MI, bool PRO>
__global__ void __launch_bounds__(kConsumers + producers<MI>(), 1)
    conv3d_splitk_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  unsigned char* stages = smem + HEAD_BYTES;
  constexpr int BM = MI * 64;
  const int nb = blockIdx.x % p.nnb, t = blockIdx.x / p.nnb;
  const int split = blockIdx.y, bidx = blockIdx.z;
  // tile t: voxels [t * BM, t * BM + BM), cut at the end of the volume
  const int v0 = t * BM, v_end = v0 + BM < p.M ? v0 + BM : p.M;
  const Box box = tile_box(v0, v_end, p.Y, p.Z);
  int u0, u1;
  split_units(p, split, u0, u1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], producers<MI>() + 1);  // producer threads + the weight copy
      mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the role through a shuffle: warp-uniform to the compiler
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / kConsumers, 0);
  if (role)
    produce<producers<MI>(), PRO>(p, stages, full, empty, box, bidx, nb, u0, u1);
  else
    consume<MI>(p, stages, full, empty, box, bidx, nb, t, v0, v_end, split, u0, u1);
}

// ------------------------------------------------------------- reduce --

// out[b, v, co..co+3] = round(sum_s ws[s, b, v, co..co+3] + (b + temb) +
// skip), the partials summed in split order.
template <bool TEMB, bool SKIP>
__global__ void __launch_bounds__(256) conv3d_splitk_reduce(const RArgs p) {
  const int nq = p.Co / 4;
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)p.B * p.M * nq) return;
  const int co = (int)(i % nq) * 4;
  const long long bv = i / nq;  // b * M + v
  const int b = (int)(bv / p.M), v = (int)(bv % p.M);
  const long long stride = (long long)p.B * p.mpad * p.Co;
  const float* src = p.ws + ((long long)b * p.mpad + v) * p.Co + co;
  float4 acc = __ldcg(reinterpret_cast<const float4*>(src));
#pragma unroll 4
  for (int s = 1; s < p.S; ++s) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(src + s * stride));
    acc.x = __fadd_rn(acc.x, t.x);
    acc.y = __fadd_rn(acc.y, t.y);
    acc.z = __fadd_rn(acc.z, t.z);
    acc.w = __fadd_rn(acc.w, t.w);
  }
  const float a[4] = {acc.x, acc.y, acc.z, acc.w};
  const long long off = bv * p.Co + co;
  uint2 sk = make_uint2(0, 0);
  if (SKIP) sk = *reinterpret_cast<const uint2*>(p.skip + off);
  const bf16* s = reinterpret_cast<const bf16*>(&sk);
  uint2 res;
  bf16* r = reinterpret_cast<bf16*>(&res);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float ex = p.b[co + e];
    if (TEMB) ex = __fadd_rn(ex, p.temb[(long long)b * p.Co + co + e]);
    float o = __fadd_rn(a[e], ex);
    if (SKIP) o = __fadd_rn(o, __bfloat162float(s[e]));
    r[e] = __float2bfloat16_rn(o);
  }
  *reinterpret_cast<uint2*>(p.out + off) = res;
}

template <int MI, bool PRO>
int launch_main(const Args& p, int B, int smem, cudaStream_t stream) {
  auto kernel = conv3d_splitk_kernel<MI, PRO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int mtiles = p.mpad / (MI * 64);
  kernel<<<dim3((unsigned)(mtiles * p.nnb), (unsigned)p.S, (unsigned)B),
           kConsumers + producers<MI>(), smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool TEMB, bool SKIP>
int launch_reduce(const RArgs& r, cudaStream_t stream) {
  const long long n = (long long)r.B * r.M * (r.Co / 4);
  conv3d_splitk_reduce<TEMB, SKIP><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, X, Y, Z, Ci) bf16; w: the packed weight (Co/64, Ci/16, 27, 2, 64,
// 8) bf16; out and skip: (B, X, Y, Z, Co) bf16; b (Co,), temb (B, Co) and
// mean/inv/scale/bias (B, Ci) fp32; ws: fp32 workspace of S * B * mpad * Co
// elements, mpad = bm * the number of tiles; all contiguous. mean == null:
// no prologue; temb/skip == null: no such add. bm (128 or 256) and S (1 <=
// S <= 3 * Ci / 16) come from conv3d_cuda.splitk_plan. Needs Ci % 16 == 0,
// Co % 64 == 0, 16-byte aligned x, w and ws, and halo boxes that fit the
// shared memory. Launches the split kernel, then the reduction, on
// `stream`.
extern "C" int conv3d_splitk(const void* x, const void* w, const float* b,
                             const float* mean, const float* inv,
                             const float* scale, const float* bias,
                             const float* temb, const void* skip, void* out,
                             float* ws, int B, int X, int Y, int Z, int Ci,
                             int Co, int bm, int S, void* stream) {
  const int units = 3 * (Ci / BK);
  if (Ci % BK || Co % BN || (bm != 128 && bm != 256) || S < 1 || S > units ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(ws)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)X * Y * Z;
  if (B == 0 || M == 0 || Co == 0) return 0;
  if (M > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int mtiles = (int)((M + bm - 1) / bm);
  int hv = 0;
  for (int t = 0; t < mtiles; ++t) {
    const int v0 = t * bm, v_end = v0 + bm < M ? v0 + bm : (int)M;
    const Box bx = tile_box(v0, v_end, Y, Z);
    const int n = (bx.nx + 2) * bx.hy * bx.hz;
    hv = n > hv ? n : hv;
  }
  const int hv_cap = (hv + 7) / 8 * 8;
  const long long stage = 32LL * hv_cap + W_BYTES;
  const long long smem = HEAD_BYTES + STAGES * stage;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  Args p{static_cast<const bf16*>(x), static_cast<const bf16*>(w), mean, inv, scale, bias,
         ws, X, Y, Z, Ci, Co, (int)M, mtiles * bm, Co / BN, units, S, hv_cap, (int)stage};
  cudaStream_t s = (cudaStream_t)stream;
  int status;
  if (bm == 256)
    status = mean ? launch_main<4, true>(p, B, (int)smem, s)
                  : launch_main<4, false>(p, B, (int)smem, s);
  else
    status = mean ? launch_main<2, true>(p, B, (int)smem, s)
                  : launch_main<2, false>(p, B, (int)smem, s);
  if (status) return status;
  RArgs r{ws, b, temb, static_cast<const bf16*>(skip), static_cast<bf16*>(out), B, (int)M,
          mtiles * bm, Co, S};
  const int code = (temb ? 2 : 0) | (skip ? 1 : 0);
  switch (code) {
    case 0: return launch_reduce<false, false>(r, s);
    case 1: return launch_reduce<false, true>(r, s);
    case 2: return launch_reduce<true, false>(r, s);
    default: return launch_reduce<true, true>(r, s);
  }
}
