// K4a / K4b / K5 in bf16 on Hopper's warpgroup MMA: [GN-apply + SiLU
// prologue] -> 3x3x3 SAME conv -> [+ bias + temb + skip epilogue].
//
// Replaces, for bf16 and the large levels of the UNet, the same TPU kernels
// as conv3d.cu (fast_cwdm_tpu/ops/conv3d_pallas.py `_kernel` :36,
// `_blocked_kernel` :154, `_v4_make_kernel` :341) and computes exactly what
// conv3d.cu computes:
//   prologue (fp32): xn = (x - mean) * inv; u = xn * scale + bias;
//                    act = u * (1 / (1 + expf(-u))), products and sums
//                    rounded apart, IEEE division, rounded once to bf16;
//   zero padding AFTER the prologue;
//   bf16 products, fp32 accumulation;
//   epilogue (fp32): acc + (b + temb) + skip, rounded once to bf16.
//
// Bound on the H100: operations (level 0, 64 -> 64: 222 GFLOP, 0.224 ms at
// the bf16 dense rate). conv3d.cu reached 16% of it; what held it back and
// what this design does about each:
//   - mma.sync: here wgmma.mma_async m64nBNk16 with A and B read from
//     shared memory by descriptor;
//   - every 128-voxel CTA re-read all weights from L2: here a CTA owns an
//     8x8x8 output block (M = 512), so each staged weight byte serves 4x
//     more voxels;
//   - staging and the prologue did not overlap the MMAs inside a CTA: here
//     a producer warpgroup fills a ring of two (halo + weight) stages
//     while two consumer warpgroups run wgmma on the other.
//
// Shared-memory layout of one stage (no swizzle, "interleave" K-major
// operands, core matrices of 8 rows x 16 bytes):
//   halo  [2][HV][8] bf16: for each 8-channel half of the 16-channel chunk,
//         one 16-byte row per halo voxel, voxels in (hx, hy, hz) order,
//         HX x HY x HZ = 10 x 10 x 10. The 8 z-consecutive voxels of one
//         y-line are one 8x16 B core matrix; the next y-line sits HZ * 16 B
//         further (the descriptor's stride byte offset); the other channel
//         half HV * 16 B further (its leading byte offset). One m64 wgmma
//         covers the 8 (y) x 8 (z) patch of one x-plane, and tap (dx, dy,
//         dz) is the same descriptor moved by ((dx*HY + dy)*HZ + dz) * 16 B.
//   wts   [27][2][BN][8] bf16: per tap, per 8-channel half, the BN output
//         channels' 16-byte rows (B K-major: LBO BN * 16 B, SBO 128 B),
//         repacked once on the host (conv3d_cuda.pack_wgmma_weights) so
//         that a chunk's slice is one contiguous cp.async.bulk.
//
// Threads: warpgroups 0 and 1 consume (each owns TX/2 x-planes: TX/2 m64
// x nBN fp32 accumulators), warpgroup 2 produces (halo through registers
// with the prologue applied, fence.proxy.async, mbarrier arrive; the weight
// slice by one bulk copy completing on the same mbarrier).
//
// BN, the block's output channels, is 64 (conv3d_wgmma, m64n64k16) or 32
// (conv3d_wgmma_n32, m64n32k16: Co a multiple of 32 only, as the tp axis's
// Co/2 convs, and twice the blocks of a grid that is short of SMs at 64).
// At 32 a stage's weight slice is 27,648 B instead of 55,296 and a thread
// holds 16 accumulators per plane instead of 32; the halo staging and the
// prologue per block stay the same, so it does half the MMAs of a 64-wide
// block for the same producer work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TX = 8, TY = 8, TZ = 8;                  // output block
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;   // halo block
constexpr int HV = HX * HY * HZ;                       // 1000 halo voxels
constexpr int BK = 16;                                 // input channels/chunk
constexpr int PLANES = TX / 2;                         // x-planes per consumer
constexpr int kConsumers = 256, kThreads = 384;
constexpr int HALO_BYTES = 2 * HV * 16;                // 32,000
constexpr int STAGES = 2;                              // the staging ring
constexpr int HEAD_BYTES = 128;                        // the mbarriers
static_assert(HALO_BYTES % 128 == 0, "alignment");

// What the block's output channels BN (64 or 32) set.
template <int BN>
struct Width {
  static constexpr int W_BYTES = 27 * BK * BN * 2;     // 55,296 or 27,648
  static constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;
  static constexpr int SMEM_BYTES =                    // 174,720 or 119,424
      HEAD_BYTES + STAGES * STAGE_BYTES;
  static constexpr int ACC = BN / 2;                   // fp32 per plane a thread
  static_assert(W_BYTES % 128 == 0, "alignment");
};

using bf16 = __nv_bfloat16;

struct Args {
  const bf16* x;        // (B, X, Y, Z, Ci)
  const bf16* w;        // packed: (Co/BN, Ci/16, 27, 2, BN, 8)
  const float* b;       // (Co,)
  const float* mean;    // (B, Ci) or null
  const float* inv;
  const float* scale;
  const float* bias;
  const float* temb;    // (B, Co) or null
  const bf16* skip;     // (B, X, Y, Z, Co) or null
  bf16* out;
  int X, Y, Z, Ci, Co;
  int nnb, nty, ntz;    // blocks along Co, Y and Z
};

// --------------------------------------------------------------- wgmma --

// d (64 x 64, fp32) += A (64 x 16, bf16) * B (16 x 64, bf16), both K-major
// in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, fp32) += A (64 x 16, bf16) * B (16 x 32, bf16), both K-major
// in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (BN == 64)
    wgmma_m64n64k16(d, da, db);
  else
    wgmma_m64n32k16(d, da, db);
}

// ------------------------------------------------------------ producer --

template <int BN, bool PRO>
__device__ __forceinline__ void produce(const Args& p, unsigned char* stages,
                                        uint64_t* full, uint64_t* empty,
                                        int bidx, int nb, int x0, int y0,
                                        int z0) {
  constexpr int W_BYTES = Width<BN>::W_BYTES;
  constexpr int STAGE_BYTES = Width<BN>::STAGE_BYTES;
  const int pt = threadIdx.x - kConsumers;  // 0..127
  const int half = pt & 1;                  // this thread's 8 channels
  const int nchunks = p.Ci / BK;
  const bf16* wsrc = p.w + (long long)nb * nchunks * (W_BYTES / 2);
  // all of this thread's halo vectors of a chunk are loaded before any is
  // computed on: one memory latency per chunk, not one per vector
  constexpr int kBatch = (HV + 63) / 64;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % STAGES;
    if (c >= STAGES) mbar_wait(&empty[s], ((c / STAGES) - 1) & 1);
    unsigned char* st = stages + s * STAGE_BYTES;
    if (pt == 0) {
      mbar_arrive_expect_tx(&full[s], W_BYTES);
      bulk_g2s(st + HALO_BYTES, wsrc + (long long)c * (W_BYTES / 2), W_BYTES,
               &full[s]);
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
    uint4* dst = reinterpret_cast<uint4*>(st + half * HV * 16);
    for (int v0 = pt >> 1; v0 < HV; v0 += 64 * kBatch) {
      uint4 in[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int hv = v0 + 64 * k;
        const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
        const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
        ok[k] = hv < HV && gx >= 0 && gx < p.X && gy >= 0 && gy < p.Y &&
                gz >= 0 && gz < p.Z;
        in[k] = make_uint4(0, 0, 0, 0);
        if (ok[k]) {
          const long long vox =
              (((long long)bidx * p.X + gx) * p.Y + gy) * p.Z + gz;
          in[k] = __ldg(reinterpret_cast<const uint4*>(p.x + vox * p.Ci + cb));
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int hv = v0 + 64 * k;
        if (hv < HV)
          dst[hv] = ok[k] ? prologue<PRO>(in[k], mean, inv, scale, bias)
                          : make_uint4(0, 0, 0, 0);
      }
    }
    // plain stores, read next by the tensor cores' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&full[s]);
  }
}

// ------------------------------------------------------------ consumer --

template <bool TEMB, bool SKIP>
__device__ __forceinline__ void store2(const Args& p, int bidx, int gx, int gy,
                                       int gz, int co, float a0, float a1) {
  if (gx >= p.X || gy >= p.Y || gz >= p.Z) return;
  float e0 = p.b[co], e1 = p.b[co + 1];
  if (TEMB) {
    e0 = __fadd_rn(e0, p.temb[(long long)bidx * p.Co + co]);
    e1 = __fadd_rn(e1, p.temb[(long long)bidx * p.Co + co + 1]);
  }
  float o0 = __fadd_rn(a0, e0), o1 = __fadd_rn(a1, e1);
  const long long off =
      ((((long long)bidx * p.X + gx) * p.Y + gy) * p.Z + gz) * p.Co + co;
  if (SKIP) {
    const __nv_bfloat162 s = *reinterpret_cast<const __nv_bfloat162*>(p.skip + off);
    o0 = __fadd_rn(o0, __bfloat162float(s.x));
    o1 = __fadd_rn(o1, __bfloat162float(s.y));
  }
  __nv_bfloat162 r;
  r.x = __float2bfloat16_rn(o0);
  r.y = __float2bfloat16_rn(o1);
  *reinterpret_cast<__nv_bfloat162*>(p.out + off) = r;
}

template <int BN, bool TEMB, bool SKIP>
__device__ __forceinline__ void consume(const Args& p, unsigned char* stages,
                                        uint64_t* full, uint64_t* empty,
                                        int wg, int bidx, int nb, int x0,
                                        int y0, int z0) {
  // wg (0 or 1): this warpgroup's planes are wg * PLANES ...
  constexpr int STAGE_BYTES = Width<BN>::STAGE_BYTES;
  const int nchunks = p.Ci / BK;
  float acc[PLANES][Width<BN>::ACC];
#pragma unroll
  for (int q = 0; q < PLANES; ++q) {
#pragma unroll
    for (int i = 0; i < Width<BN>::ACC; ++i) acc[q][i] = 0.0f;
    fence_acc(acc[q]);
  }
  const uint32_t base = smem_addr(stages);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES;
    const uint64_t da = make_desc(a, HV * 16, HZ * 16);
    const uint64_t db = make_desc(a + HALO_BYTES, BN * 16, 8 * 16);
    wgmma_fence();
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9) {
        const int dy = t9 / 3, dz = t9 % 3, tap = dx * 9 + t9;
#pragma unroll
        for (int q = 0; q < PLANES; ++q) {
          const int hv = ((wg * PLANES + q + dx) * HY + dy) * HZ + dz;
          wgmma_m64k16<BN>(acc[q], da + hv, db + tap * (2 * BN));
        }
      }
    }
    wgmma_commit();
    // release the stage whose MMAs are known complete
    wgmma_wait<STAGES - 1>();
    const int done = c - (STAGES - 1);
    if (done >= 0) mbar_arrive_if(&empty[done % STAGES], (threadIdx.x & 127) == 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < PLANES; ++q) fence_acc(acc[q]);

  // accumulator fragment: warp w of the warpgroup holds rows 16w..16w+15;
  // row = 16w + lane/4 (+8), column = 8i + 2 (lane % 4) (+1); row m of a
  // plane is voxel (y, z) = (m / 8, m % 8)
  const int lane = threadIdx.x & 31, w = (threadIdx.x & 127) >> 5;
  const int gz = z0 + (lane >> 2);
#pragma unroll
  for (int q = 0; q < PLANES; ++q) {
    const int gx = x0 + wg * PLANES + q;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gy = y0 + 2 * w + j;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int co = nb * BN + 8 * i + 2 * (lane & 3);
        store2<TEMB, SKIP>(p, bidx, gx, gy, gz, co, acc[q][4 * i + 2 * j],
                           acc[q][4 * i + 2 * j + 1]);
      }
    }
  }
}

template <int BN, bool PRO, bool TEMB, bool SKIP>
__global__ void __launch_bounds__(kThreads, 1) conv3d_wgmma_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  unsigned char* stages = smem + HEAD_BYTES;
  int t = blockIdx.x;  // Co blocks fastest: they share the halo in L2
  const int nb = t % p.nnb;
  t /= p.nnb;
  const int z0 = (t % p.ntz) * TZ;
  t /= p.ntz;
  const int y0 = (t % p.nty) * TY;
  const int x0 = (t / p.nty) * TX;
  const int bidx = blockIdx.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // producer threads + the weight copy
      mbar_init(&empty[s], 2);       // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup index through a shuffle: warp-uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers / 128)
    produce<BN, PRO>(p, stages, full, empty, bidx, nb, x0, y0, z0);
  else
    consume<BN, TEMB, SKIP>(p, stages, full, empty, wg, bidx, nb, x0, y0,
                            z0);
}

template <int BN, bool PRO, bool TEMB, bool SKIP>
int launch(const Args& p, int B, cudaStream_t stream) {
  constexpr int SMEM_BYTES = Width<BN>::SMEM_BYTES;
  auto kernel = conv3d_wgmma_kernel<BN, PRO, TEMB, SKIP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((p.X + TX - 1) / TX) * p.nty * p.ntz * p.nnb;
  kernel<<<dim3((unsigned)blocks, (unsigned)B), kThreads, SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

__global__ void recip_check_kernel(unsigned long long* bad) {
  const uint32_t lo = 0x3f800000u, hi = 0x7e800000u;  // [1, 2^126)
  unsigned long long n = 0;
  for (uint32_t u = lo + blockIdx.x * blockDim.x + threadIdx.x; u < hi;
       u += gridDim.x * blockDim.x) {
    const float d = __uint_as_float(u);
    n += __float_as_uint(recip_normal(d)) != __float_as_uint(__fdiv_rn(1.0f, d));
  }
  if (n) atomicAdd(bad, n);
}

// x: (B, X, Y, Z, Ci) bf16; w: the packed weight (Co/BN, Ci/16, 27, 2, BN,
// 8) bf16; out and skip: (B, X, Y, Z, Co) bf16; b (Co,), temb (B, Co) and
// mean/inv/scale/bias (B, Ci) fp32; all contiguous. mean == null: no
// prologue; temb/skip == null: no such add. Needs Ci % 16 == 0, Co % BN ==
// 0 and 16-byte aligned x and w.
template <int BN>
int conv3d_wgmma_bn(const void* x, const void* w, const float* b,
                    const float* mean, const float* inv, const float* scale,
                    const float* bias, const float* temb, const void* skip,
                    void* out, int B, int X, int Y, int Z, int Ci, int Co,
                    void* stream) {
  if (Ci % BK || Co % BN ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * X * Y * Z == 0 || Co == 0) return 0;
  Args p{static_cast<const bf16*>(x), static_cast<const bf16*>(w), b, mean,
         inv, scale, bias, temb, static_cast<const bf16*>(skip),
         static_cast<bf16*>(out), X, Y, Z, Ci, Co, Co / BN, (Y + TY - 1) / TY,
         (Z + TZ - 1) / TZ};
  cudaStream_t s = (cudaStream_t)stream;
  const int code = (mean ? 4 : 0) | (temb ? 2 : 0) | (skip ? 1 : 0);
  switch (code) {
    case 0: return launch<BN, false, false, false>(p, B, s);
    case 1: return launch<BN, false, false, true>(p, B, s);
    case 2: return launch<BN, false, true, false>(p, B, s);
    case 3: return launch<BN, false, true, true>(p, B, s);
    case 4: return launch<BN, true, false, false>(p, B, s);
    case 5: return launch<BN, true, false, true>(p, B, s);
    case 6: return launch<BN, true, true, false>(p, B, s);
    default: return launch<BN, true, true, true>(p, B, s);
  }
}

}  // namespace

// Count the floats d in [1, 2^126) where recip_normal(d) differs from the
// IEEE quotient 1.0f / d (the prologue relies on 0) into *bad, a zeroed
// device counter.
extern "C" int recip_normal_mismatches(unsigned long long* bad, void* stream) {
  recip_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(bad);
  return (int)cudaGetLastError();
}

// The conv with 64-wide output blocks (Co % 64 == 0; conv3d_wgmma_bn).
extern "C" int conv3d_wgmma(const void* x, const void* w, const float* b,
                            const float* mean, const float* inv,
                            const float* scale, const float* bias,
                            const float* temb, const void* skip, void* out,
                            int B, int X, int Y, int Z, int Ci, int Co,
                            void* stream) {
  return conv3d_wgmma_bn<64>(x, w, b, mean, inv, scale, bias, temb, skip, out,
                             B, X, Y, Z, Ci, Co, stream);
}

// The conv with 32-wide output blocks (Co % 32 == 0), the same arguments
// with w packed at BN 32.
extern "C" int conv3d_wgmma_n32(const void* x, const void* w, const float* b,
                                const float* mean, const float* inv,
                                const float* scale, const float* bias,
                                const float* temb, const void* skip, void* out,
                                int B, int X, int Y, int Z, int Ci, int Co,
                                void* stream) {
  return conv3d_wgmma_bn<32>(x, w, b, mean, inv, scale, bias, temb, skip, out,
                             B, X, Y, Z, Ci, Co, stream);
}
