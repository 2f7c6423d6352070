// K4a / K4b / K5 in fp32 on Hopper's warpgroup MMA, as three TF32 products
// a term ("3xTF32"): [GN-apply + SiLU prologue] -> 3x3x3 SAME conv ->
// [+ bias + temb + skip epilogue].
//
// Replaces, for fp32 (every conv of the production UNet), the TPU kernels that
// conv3d.cu replaces (fast_cwdm_tpu/ops/conv3d_pallas.py `_kernel` :36,
// `_blocked_kernel` :154, `_v4_make_kernel` :341) when they run in fp32:
// the JAX package's FusableConv3d runs them in the input's dtype
// (fast_cwdm_tpu/models/unet.py:190-217, out_shape at conv3d_pallas.py:142),
// so fuse_conv with dtype float32 reaches them. It computes what conv3d.cu's
// fp32 path computes, within conv3d_cuda.tol_ratio:
//   prologue (fp32): xn = (x - mean) * inv; u = xn * scale + bias;
//                    act = u * (1 / (1 + expf(-u))), products and sums
//                    rounded apart, IEEE division (no rounding after it);
//   zero padding AFTER the prologue;
//   each product act * w as hi(act) hi(w) + hi(act) lo(w) + lo(act) hi(w) on
//   the TF32 tensor cores, fp32 accumulation;
//   epilogue (fp32): acc + (b + temb) + skip, rounded apart.
//
// The split: hi = cvt.rna.tf32.f32(v) (10 mantissa bits, low 13 bits zero),
// lo = v - hi, exact in fp32. The weights are split once on the host
// (conv3d_cuda.pack_tf32_weights, the same rounding: tf32_rna_mismatches
// counts the floats where the two differ), the activations here after the
// prologue. The tensor cores read lo truncated to TF32 (tf32_read_probe
// shows how they read an operand). Per term the dropped lo*lo (< 2^-22
// |act w|) and that truncation (< 2^-21 |act w| for each of the two lo
// products) stay far inside tol_ratio's 2^-16 conv(|act|, |w|); one TF32
// product alone (~2^-11 |act w|) does not, so no route takes it.
//
// Bound on the H100: operations. Level 1 (1x128x56x56x40, 128 -> 128) is
// 111.0 GFLOP: 1.656 ms at the fp32 FFMA rate (67 TFLOP/s), the most
// conv3d.cu's scalar fmaf can reach; 3 x 111.0 GFLOP of TF32 is 0.673 ms at
// 495 TFLOP/s. The MMAs are six times the bf16 kernel's for the same conv
// (three products at half the bf16 rate) while the producer's bytes only
// double, so this kernel is bound by its MMAs where conv3d_wgmma.cu is
// bound by its producer.
//
// The tensor cores' fp32 accumulation is the other design problem. They sum a
// wgmma's products into the accumulator with truncation, not rounding to
// nearest, so the error of a long chain of wgmma into one accumulator grows
// with its length, one sign: accumulating all 3 x 27 x Ci / 8 products of a
// term in the tensor cores (an 8x8x8 block of two 4-plane warpgroups, measured
// in PERF.md, Findings) came to 0.20-0.50 of tol_ratio where conv3d.cu's FFMA
// stays below 0.03, and put a 10-step fp32 volume 8.6e-4 from cuDNN's where
// the bar is 1e-4 (FFMA: 7.7e-5). So the card holds this kernel to
// conv3d_cuda.TF32_TOL_RATIO (0.1), and each unit (below) starts a fresh
// tensor-core sum (scale-d 0), 27 wgmma long, and adds it into an fp32
// accumulator of its own with one IEEE add (__fadd_rn) once the unit's MMAs
// are complete (a fresh sum every dy-row, 9 wgmma, was measured too: the
// volume's error no smaller, 2 % slower; PERF.md, Findings). The two
// accumulators of 32 fp32 a plane leave room for 2 planes a warpgroup, so the
// block is 4x8x8 (M = 256) by BN = 64 output channels: warpgroups 0 and 1
// consume (2 x-planes each, a m64n64 accumulator and its fp32 sum a plane),
// warpgroup 2 produces: its warps 0-2 stage the halo through registers
// (prologue, split, fence.proxy.async, mbarrier arrive), one thread of warp 3
// issues the weight copies.
//
// Shared memory: a chunk is 8 input channels (one k8 step); with hi and
// lo, its halo is 2 x 600 voxels x 32 B = 38,400 B and its 27 taps of
// weights 110,592 B at BN 64. The weights move per dx-plane (9 taps, hi +
// lo: 36,864 B) in a ring of two slots of their own, beside a ring of two
// halo stages:
//   head 128 + halo 2 x 38,400 + weights 2 x 36,864 = 150,656 B.
// The consumers walk units u = 3 * chunk + dx; a weight slot is released
// when its unit's MMAs are complete, a halo stage after its chunk's third
// unit. Layouts (no swizzle, K-major core matrices of 8 rows x 16 B,
// one 16-byte row holding 4 fp32 channels, so a k8 step spans two core
// matrices LBO apart):
//   halo  [hi, lo][2][HV][4] fp32: per 4-channel half one 16-byte row per
//         halo voxel, voxels in (hx, hy, hz) order; A of x-plane q and tap
//         (dx, dy, dz) starts ((q + dx) * HY + dy) * HZ + dz rows in, SBO
//         HZ * 16 (the next y-line), LBO HV * 16 (the other channel half);
//   wts   [hi, lo][9][2][BN][4] fp32 per (chunk, dx-plane), B K-major: LBO
//         BN * 16, SBO 128; one contiguous cp.async.bulk a unit.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TX = 4, TY = 8, TZ = 8;                  // output block
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;   // halo block
constexpr int HV = HX * HY * HZ;                       // 600 halo voxels
constexpr int BK = 8;                                  // input channels/chunk
constexpr int BN = 64;                                 // output channels/block
constexpr int PLANES = TX / 2;                         // x-planes per consumer
constexpr int ACC = BN / 2;                            // fp32 per plane a thread
constexpr int kConsumers = 256, kThreads = 384;
constexpr int kHaloThreads = 96;                       // producer warps 0-2
constexpr int HALO_PART = 2 * HV * 16;                 // 19,200: hi or lo
constexpr int HALO_STAGE = 2 * HALO_PART;              // 38,400
constexpr int W_TAP = 2 * BN * 16;                     // 2,048: a tap, hi or lo
constexpr int W_PART = 9 * W_TAP;                      // 18,432
constexpr int W_SLOT = 2 * W_PART;                     // 36,864: a dx-plane
constexpr int HALO_STAGES = 2, W_SLOTS = 2;
constexpr int HEAD_BYTES = 128;                        // the mbarriers
constexpr int SMEM_BYTES =                             // 150,656
    HEAD_BYTES + HALO_STAGES * HALO_STAGE + W_SLOTS * W_SLOT;
static_assert(SMEM_BYTES <= 232448, "one block's shared memory on the H100");
static_assert(HALO_STAGE % 128 == 0 && W_SLOT % 128 == 0, "alignment");

struct Args {
  const float* x;       // (B, X, Y, Z, Ci)
  const float* w;       // packed: (Co/BN, Ci/8, 3, 2, 9, 2, BN, 4)
  const float* b;       // (Co,)
  const float* mean;    // (B, Ci) or null
  const float* inv;
  const float* scale;
  const float* bias;
  const float* temb;    // (B, Co) or null
  const float* skip;    // (B, X, Y, Z, Co) or null
  float* out;
  int X, Y, Z, Ci, Co;
  int nnb, nty, ntz;    // blocks along Co, Y and Z
};

// d (64 x 64, fp32) = A (64 x 8, tf32) * B (8 x 64, tf32) + (acc ? d : 0),
// both K-major in shared memory (TF32 has no transposed form).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t da,
                                                    uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// v rounded to TF32, to nearest with ties away from zero, the low 13 bits
// zero (as conv3d_cuda.pack_tf32_weights rounds on the host).
__device__ __forceinline__ float tf32_hi(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

// The fp32 prologue of one 4-channel vector, as conv3d.cu's fp32 path and
// the plain version: xn = (x - mean) * inv; u = xn * scale + bias (products
// and sums rounded apart); u * (1 / (1 + expf(-u))) with the IEEE quotient.
template <bool PRO>
__device__ __forceinline__ float4 prologue4(float4 in, const float (&mean)[4],
                                            const float (&inv)[4],
                                            const float (&scale)[4],
                                            const float (&bias)[4]) {
  if (!PRO) return in;
  const float v[4] = {in.x, in.y, in.z, in.w};
  float u[4], d[4];
  bool normal = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float xn = __fmul_rn(__fsub_rn(v[e], mean[e]), inv[e]);
    u[e] = __fadd_rn(__fmul_rn(xn, scale[e]), bias[e]);
    d[e] = 1.0f + expf(-u[e]);
    normal = normal && d[e] < 0x1p126f;
  }
  float o[4];
  if (normal) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(u[e], recip_normal(d[e]));
  } else {  // some u < -87: the quotient leaves the normal range
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(u[e], 1.0f / d[e]);
  }
  return make_float4(o[0], o[1], o[2], o[3]);
}

// ------------------------------------------------------------ producer --

// Warps 0-2 of the producer warpgroup: each chunk's halo, the prologue
// applied, split into hi and lo.
template <bool PRO>
__device__ __forceinline__ void produce_halo(const Args& p, unsigned char* halo,
                                             uint64_t* full, uint64_t* empty,
                                             int bidx, int x0, int y0, int z0) {
  const int pt = threadIdx.x - kConsumers;  // 0..95
  const int half = pt & 1;                  // this thread's 4 channels
  const int nchunks = p.Ci / BK;
  constexpr int kLanes = kHaloThreads / 2;  // voxels in flight a pass
  // all of this thread's halo vectors of a pass are loaded before any is
  // computed on: one memory latency per pass, two passes a chunk
  constexpr int kBatch = (HV + 2 * kLanes - 1) / (2 * kLanes);
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % HALO_STAGES;
    if (c >= HALO_STAGES) mbar_wait(&empty[s], ((c / HALO_STAGES) - 1) & 1);
    const int cb = c * BK + half * 4;
    float mean[4], inv[4], scale[4], bias[4];
    if (PRO) {
      const long long o = (long long)bidx * p.Ci + cb;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mean[e] = p.mean[o + e];
        inv[e] = p.inv[o + e];
        scale[e] = p.scale[o + e];
        bias[e] = p.bias[o + e];
      }
    }
    unsigned char* st = halo + s * HALO_STAGE + half * HV * 16;
    float4* hi = reinterpret_cast<float4*>(st);
    float4* lo = reinterpret_cast<float4*>(st + HALO_PART);
    for (int v0 = pt >> 1; v0 < HV; v0 += kLanes * kBatch) {
      float4 in[kBatch];
      bool ok[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int hv = v0 + kLanes * k;
        const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
        const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
        ok[k] = hv < HV && gx >= 0 && gx < p.X && gy >= 0 && gy < p.Y &&
                gz >= 0 && gz < p.Z;
        in[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ok[k]) {
          const long long vox =
              (((long long)bidx * p.X + gx) * p.Y + gy) * p.Z + gz;
          in[k] = __ldg(reinterpret_cast<const float4*>(p.x + vox * p.Ci + cb));
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int hv = v0 + kLanes * k;
        if (hv < HV) {
          const float4 a = ok[k] ? prologue4<PRO>(in[k], mean, inv, scale, bias)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          const float4 h = make_float4(tf32_hi(a.x), tf32_hi(a.y), tf32_hi(a.z),
                                       tf32_hi(a.w));
          hi[hv] = h;
          lo[hv] = make_float4(__fsub_rn(a.x, h.x), __fsub_rn(a.y, h.y),
                               __fsub_rn(a.z, h.z), __fsub_rn(a.w, h.w));
        }
      }
    }
    // plain stores, read next by the tensor cores' async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&full[s]);
  }
}

// One thread of warp 3: unit u's weight slice (chunk u / 3, dx-plane u % 3,
// hi and lo) by one bulk copy into slot u % 2, once its last reader is done.
__device__ __forceinline__ void produce_weights(const Args& p, unsigned char* wring,
                                                uint64_t* full, uint64_t* empty,
                                                int nb) {
  const int units = 3 * (p.Ci / BK);
  const float* src = p.w + (long long)nb * units * (W_SLOT / 4);
  for (int u = 0; u < units; ++u) {
    const int s = u % W_SLOTS;
    if (u >= W_SLOTS) mbar_wait(&empty[s], ((u / W_SLOTS) - 1) & 1);
    mbar_arrive_expect_tx(&full[s], W_SLOT);
    bulk_g2s(wring + s * W_SLOT, src + (long long)u * (W_SLOT / 4), W_SLOT, &full[s]);
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
    const float2 s = *reinterpret_cast<const float2*>(p.skip + off);
    o0 = __fadd_rn(o0, s.x);
    o1 = __fadd_rn(o1, s.y);
  }
  *reinterpret_cast<float2*>(p.out + off) = make_float2(o0, o1);
}

template <bool TEMB, bool SKIP>
__device__ __forceinline__ void consume(const Args& p, unsigned char* halo,
                                        unsigned char* wring, uint64_t* full_h,
                                        uint64_t* empty_h, uint64_t* full_w,
                                        uint64_t* empty_w, int wg, int bidx,
                                        int nb, int x0, int y0, int z0) {
  // wg (0 or 1): this warpgroup's planes are wg * PLANES ...
  const int nchunks = p.Ci / BK;
  float acc[PLANES][ACC];  // one unit's tensor-core sum
  float sum[PLANES][ACC];  // the units' sums, IEEE adds
#pragma unroll
  for (int q = 0; q < PLANES; ++q) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[q][i] = sum[q][i] = 0.0f;
    fence_acc(acc[q]);
  }
  const uint32_t hbase = smem_addr(halo), wbase = smem_addr(wring);
  const bool leader = (threadIdx.x & 127) == 0;
  for (int c = 0; c < nchunks; ++c) {
    const int hs = c % HALO_STAGES;
    mbar_wait(&full_h[hs], (c / HALO_STAGES) & 1);
    const uint32_t a = hbase + hs * HALO_STAGE;
    const uint64_t da_hi = make_desc(a, HV * 16, HZ * 16);
    const uint64_t da_lo = make_desc(a + HALO_PART, HV * 16, HZ * 16);
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
      const int u = 3 * c + dx, ws = u % W_SLOTS;
      mbar_wait(&full_w[ws], (u / W_SLOTS) & 1);
      const uint32_t bw = wbase + ws * W_SLOT;
      const uint64_t db_hi = make_desc(bw, BN * 16, 8 * 16);
      const uint64_t db_lo = make_desc(bw + W_PART, BN * 16, 8 * 16);
      wgmma_fence();
#pragma unroll
      for (int t9 = 0; t9 < 9; ++t9) {
        const int dy = t9 / 3, dz = t9 % 3;
#pragma unroll
        for (int q = 0; q < PLANES; ++q) {
          const int hv = ((wg * PLANES + q + dx) * HY + dy) * HZ + dz;
          const int tb = t9 * (W_TAP / 16);
          // the unit's first product starts its sum afresh
          wgmma_m64n64k8_tf32(acc[q], da_hi + hv, db_hi + tb, t9 > 0);
          wgmma_m64n64k8_tf32(acc[q], da_hi + hv, db_lo + tb);
          wgmma_m64n64k8_tf32(acc[q], da_lo + hv, db_hi + tb);
        }
      }
      wgmma_commit();
      // the unit's MMAs are complete: release its weight slot, and after a
      // chunk's third unit the chunk's halo stage (predicated arrives: no
      // branch on the wgmma path); then add its sum, rounded to nearest
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < PLANES; ++q) fence_acc(acc[q]);
      mbar_arrive_if(&empty_w[ws], leader);
      mbar_arrive_if(&empty_h[hs], leader && dx == 2);
#pragma unroll
      for (int q = 0; q < PLANES; ++q)
#pragma unroll
        for (int i = 0; i < ACC; ++i) sum[q][i] = __fadd_rn(sum[q][i], acc[q][i]);
    }
  }

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
        store2<TEMB, SKIP>(p, bidx, gx, gy, gz, co, sum[q][4 * i + 2 * j],
                           sum[q][4 * i + 2 * j + 1]);
      }
    }
  }
}

template <bool PRO, bool TEMB, bool SKIP>
__global__ void __launch_bounds__(kThreads, 1) conv3d_tf32_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full_h = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty_h = full_h + HALO_STAGES;
  uint64_t* full_w = empty_h + HALO_STAGES;
  uint64_t* empty_w = full_w + W_SLOTS;
  unsigned char* halo = smem + HEAD_BYTES;
  unsigned char* wring = halo + HALO_STAGES * HALO_STAGE;
  int t = blockIdx.x;  // Co blocks fastest: they share the halo in L2
  const int nb = t % p.nnb;
  t /= p.nnb;
  const int z0 = (t % p.ntz) * TZ;
  t /= p.ntz;
  const int y0 = (t % p.nty) * TY;
  const int x0 = (t / p.nty) * TX;
  const int bidx = blockIdx.y;
  if (threadIdx.x == 0) {
    for (int s = 0; s < HALO_STAGES; ++s) {
      mbar_init(&full_h[s], kHaloThreads);  // the halo threads
      mbar_init(&empty_h[s], 2);            // one arrival per consumer warpgroup
    }
    for (int s = 0; s < W_SLOTS; ++s) {
      mbar_init(&full_w[s], 1);             // the copy's thread, + its bytes
      mbar_init(&empty_w[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warpgroup and warp indices through a shuffle: warp-uniform to the
  // compiler
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  if (warp >= kConsumers / 32) {
    if (warp < (kConsumers + kHaloThreads) / 32)
      produce_halo<PRO>(p, halo, full_h, empty_h, bidx, x0, y0, z0);
    else if ((threadIdx.x & 31) == 0)
      produce_weights(p, wring, full_w, empty_w, nb);
  } else {
    consume<TEMB, SKIP>(p, halo, wring, full_h, empty_h, full_w, empty_w,
                        warp / 4, bidx, nb, x0, y0, z0);
  }
}

template <bool PRO, bool TEMB, bool SKIP>
int launch(const Args& p, int B, cudaStream_t stream) {
  auto kernel = conv3d_tf32_kernel<PRO, TEMB, SKIP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const long long blocks =
      (long long)((p.X + TX - 1) / TX) * p.nty * p.ntz * p.nnb;
  kernel<<<dim3((unsigned)blocks, (unsigned)B), kThreads, SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- card checks --

// Floats whose cvt.rna.tf32.f32 (low 13 bits cleared) differs from the
// host's integer rounding (bits + 0x1000) & ~0x1fff, every finite pattern:
// bad[0] normal, bad[1] zero and subnormal.
__global__ void rna_check_kernel(unsigned long long* bad) {
  unsigned long long n[2] = {0, 0};
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += (unsigned long long)gridDim.x * blockDim.x) {
    const uint32_t u = (uint32_t)i;
    if ((u & 0x7f800000u) == 0x7f800000u) continue;  // inf, nan
    const uint32_t dev = __float_as_uint(tf32_hi(__uint_as_float(u)));
    n[(u & 0x7f800000u) == 0] += dev != ((u + 0x1000u) & 0xffffe000u);
  }
  if (n[0]) atomicAdd(&bad[0], n[0]);
  if (n[1]) atomicAdd(&bad[1], n[1]);
}

// One m64n64k8 TF32 wgmma with A[m][0] = a[m], B[0][0] = 1 and zeros
// elsewhere: out[m] = D[m][0] is a[m] as the tensor cores read an fp32
// operand (its low 13 bits truncated, rounded, or kept).
__global__ void tf32_read_kernel(const float* a, float* out) {
  __shared__ __align__(128) float sa[64 * 8];
  __shared__ __align__(128) float sb[64 * 8];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 8; i += 128) sa[i] = sb[i] = 0.0f;
  __syncthreads();
  // core matrix (m / 8, k / 4) at (m / 8) * 128 + (k / 4) * 1024 bytes, row
  // m % 8 16 bytes further
  if (t < 64) sa[(t / 8) * 32 + (t % 8) * 4] = a[t];
  if (t == 0) sb[0] = 1.0f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  fence_acc(d);
  wgmma_fence();
  wgmma_m64n64k8_tf32(d, make_desc(smem_addr(sa), 1024, 128),
                      make_desc(smem_addr(sb), 1024, 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(d);
  const int lane = t & 31, w = t >> 5;
  if ((lane & 3) == 0) {
    out[16 * w + lane / 4] = d[0];
    out[16 * w + lane / 4 + 8] = d[2];
  }
}

}  // namespace

// x: (B, X, Y, Z, Ci) fp32; w: the packed weight (Co/64, Ci/8, 3, 2, 9, 2,
// 64, 4) fp32 (conv3d_cuda.pack_tf32_weights); out and skip: (B, X, Y, Z,
// Co) fp32; b (Co,), temb (B, Co) and mean/inv/scale/bias (B, Ci) fp32; all
// contiguous. mean == null: no prologue; temb/skip == null: no such add.
// Needs Ci % 8 == 0, Co % 64 == 0 and 16-byte aligned x and w.
extern "C" int conv3d_wgmma_tf32(const void* x, const void* w, const float* b,
                                 const float* mean, const float* inv,
                                 const float* scale, const float* bias,
                                 const float* temb, const void* skip, void* out,
                                 int B, int X, int Y, int Z, int Ci, int Co,
                                 void* stream) {
  if (Ci % BK || Co % BN ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * X * Y * Z == 0 || Co == 0) return 0;
  Args p{static_cast<const float*>(x), static_cast<const float*>(w), b, mean,
         inv, scale, bias, temb, static_cast<const float*>(skip),
         static_cast<float*>(out), X, Y, Z, Ci, Co, Co / BN, (Y + TY - 1) / TY,
         (Z + TZ - 1) / TZ};
  cudaStream_t s = (cudaStream_t)stream;
  const int code = (mean ? 4 : 0) | (temb ? 2 : 0) | (skip ? 1 : 0);
  switch (code) {
    case 0: return launch<false, false, false>(p, B, s);
    case 1: return launch<false, false, true>(p, B, s);
    case 2: return launch<false, true, false>(p, B, s);
    case 3: return launch<false, true, true>(p, B, s);
    case 4: return launch<true, false, false>(p, B, s);
    case 5: return launch<true, false, true>(p, B, s);
    case 6: return launch<true, true, false>(p, B, s);
    default: return launch<true, true, true>(p, B, s);
  }
}

// Count into bad[0] (normal) and bad[1] (zero, subnormal), zeroed device
// counters, the finite floats where the kernel's TF32 rounding differs from
// pack_tf32_weights' (0 keeps the weights' and the activations' split one
// function).
extern "C" int tf32_rna_mismatches(unsigned long long* bad, void* stream) {
  rna_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(bad);
  return (int)cudaGetLastError();
}

// out[m] = a[m] (64 floats) as one TF32 wgmma reads an fp32 operand.
extern "C" int tf32_read_probe(const float* a, float* out, void* stream) {
  tf32_read_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}
