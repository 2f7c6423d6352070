// K4a / K4b / K5: [GN-apply + SiLU prologue] -> 3x3x3 SAME conv ->
// [+ bias + temb + skip epilogue], one kernel for all three.
//
// Replaces the TPU kernels of fast_cwdm_tpu/ops/conv3d_pallas.py:
//   K4a `_kernel`          (:36, pallas_call :115, one X row per program)
//   K4b `_blocked_kernel`  (:154, pallas_call :219, TX-row slab + halo rows)
//   K5  `_v4_make_kernel`  (:341, pallas_call :522, + temb + skip epilogue)
// Every difference between those three is a TPU layout device (row or slab
// programs, fold_taps, pack_n stacking the X taps on N for the 128-lane
// MXU, algo, unroll, VMEM limits); they compute one function, served here
// by one kernel whose prologue and epilogue are compile-time flags.
//
// Math, at each point as the Pallas kernels and the plain torch version:
//   prologue (fp32): xn = (x - mean) * inv; u = xn * scale + bias;
//                    act = u * sigmoid(u), rounded once to the input type;
//   zero padding AFTER the prologue: halo voxels outside the volume are 0
//                    in conv-input space (pro(0) != 0);
//   products of input-type values, fp32 accumulation;
//   epilogue (fp32): acc + (b + temb) + skip, rounded once to the output.
// The prologue's products and sums are rounded apart (__fmul_rn,
// __fadd_rn) and SiLU is u * (1 / (1 + expf(-u))) with IEEE division: the
// operations of the plain version, so both round the activation alike.
//
// Layout: x (B, X, Y, Z, Ci) channels-last (a logical NCDHW tensor in
// channels_last_3d memory), w (27, Ci, Co) = DHWIO, out/skip (B, X, Y, Z,
// Co). An implicit GEMM: M = voxels, N = Co, K = 27 * Ci.
//
// Bound on the H100: operations. At level 0 (1x64x112x112x80, 64 -> 64)
// the conv is 222 GFLOP against 257 MB moved: 0.224 ms at the bf16 dense
// tensor-core rate, 0.077 ms at 3.35 TB/s.
//
// Design (simple first; no TMA, no wgmma yet): a CTA owns a 2x4x16 block of
// output voxels (M = 128) by 64 output channels (N). For each chunk of BK
// input channels it stages into shared memory
//   - the 4x6x18 halo block of the input with the prologue applied on load
//     (each input element's prologue runs 3.4 times, not 27), zero outside
//     the volume, and
//   - all 27 taps of the weight slice (cp.async, overlapping the prologue);
// then runs the 27 taps from shared memory. bf16: mma.sync m16n8k16 with
// fp32 accumulators, A gathered per tap by ldmatrix (any row address), B by
// ldmatrix.trans; 8 warps of 32x32. fp32: scalar fmaf (no TF32), an 8x4
// register tile per thread. Both use about 80 KB of shared memory, so two
// CTAs share an SM and one stages while the other computes.
//
// The UNet's convs go elsewhere (conv3d_cuda.route): in bf16 to
// conv3d_wgmma.cu (large levels; with 32-wide output blocks where Co is a
// multiple of 32 only, or where 64-wide blocks are too few, as the tp
// axis's Co/2 convs) and conv3d_splitk.cu (small deep levels), in fp32 to
// conv3d_tf32.cu (three TF32 tensor-core products a term, every level).
// This kernel keeps bf16 with Ci not a multiple of 16, Co not a multiple of
// 32, or a grid too small for both wgmma widths where the split-K halo does
// not fit, and fp32 with Co not a multiple of 64: no conv of the production
// UNet, unsharded or on the sp or tp axis, in either dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TX = 2, TY = 4, TZ = 16;                 // output block
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;   // halo block
constexpr int HV = HX * HY * HZ;                       // 432 halo voxels
constexpr int BM = TX * TY * TZ;                       // 128
constexpr int BN = 64;
constexpr int kThreads = 256;

template <typename T>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int BK = 2 * VEC;          // input channels per chunk
  static constexpr int ASTR = BK + VEC;       // halo row stride (48 bytes)
  static constexpr int WSTR = BN + VEC;       // weight row stride
  static constexpr int A_ELEMS = HV * ASTR;
  static constexpr int W_ELEMS = 27 * BK * WSTR;
  static constexpr size_t SMEM = sizeof(T) * (A_ELEMS + W_ELEMS);
};

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
struct alignas(16) Pack {
  T v[VEC];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

struct Args {
  const void* x;
  const void* w;
  const float* b;      // (Co,)
  const float* mean;   // (B, Ci) or null
  const float* inv;
  const float* scale;
  const float* bias;
  const float* temb;   // (B, Co) or null
  const void* skip;    // (B, X, Y, Z, Co) or null
  void* out;
  int X, Y, Z, Ci, Co;
  int nty, ntz;        // output blocks along Y and Z
};

// Stage one chunk: the weight slice by cp.async (zero beyond Ci and Co),
// then the halo block through registers with the prologue applied.
template <typename T, bool PRO>
__device__ __forceinline__ void stage(const Args& p, T* As, T* Ws, int bidx,
                                      int x0, int y0, int z0, int n0,
                                      int c0) {
  using C = Cfg<T>;
  constexpr int VEC = C::VEC;
  const T* w = static_cast<const T*>(p.w);
  constexpr int WV = 27 * C::BK * (BN / VEC);
  for (int v = threadIdx.x; v < WV; v += kThreads) {
    const int col = (v % (BN / VEC)) * VEC;
    const int row = v / (BN / VEC);  // tap * BK + k
    const int tap = row / C::BK, ci = c0 + row % C::BK, co = n0 + col;
    const bool ok = ci < p.Ci && co < p.Co;
    const T* src = ok ? w + ((long long)tap * p.Ci + ci) * p.Co + co : w;
    cp_async16(Ws + row * C::WSTR + col, src, ok ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  // this thread's half of the chunk is fixed (kThreads is even)
  const int half = threadIdx.x & 1;
  const int cbase = c0 + half * VEC;
  const bool cok = cbase < p.Ci;  // Ci % VEC == 0: a vector is all in or out
  float mean[VEC], inv[VEC], scale[VEC], bias[VEC];
  if (PRO && cok) {
    const long long o = (long long)bidx * p.Ci + cbase;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      mean[e] = p.mean[o + e];
      inv[e] = p.inv[o + e];
      scale[e] = p.scale[o + e];
      bias[e] = p.bias[o + e];
    }
  }
  const T* x = static_cast<const T*>(p.x);
  for (int v = threadIdx.x; v < HV * 2; v += kThreads) {
    const int hv = v >> 1;
    const int hz = hv % HZ, hy = (hv / HZ) % HY, hx = hv / (HZ * HY);
    const int gx = x0 + hx - 1, gy = y0 + hy - 1, gz = z0 + hz - 1;
    Pack<T, VEC> out;
    if (cok && gx >= 0 && gx < p.X && gy >= 0 && gy < p.Y && gz >= 0 &&
        gz < p.Z) {
      const long long vox =
          (((long long)bidx * p.X + gx) * p.Y + gy) * p.Z + gz;
      const Pack<T, VEC> in =
          *reinterpret_cast<const Pack<T, VEC>*>(x + vox * p.Ci + cbase);
      if (PRO) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xn = __fmul_rn(__fsub_rn(to_float(in.v[e]), mean[e]),
                                     inv[e]);
          const float u = __fadd_rn(__fmul_rn(xn, scale[e]), bias[e]);
          out.v[e] = from_float<T>(__fmul_rn(u, 1.0f / (1.0f + expf(-u))));
        }
      } else {
        out = in;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out.v[e] = from_float<T>(0.0f);
    }
    *reinterpret_cast<Pack<T, VEC>*>(As + hv * C::ASTR + half * VEC) = out;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Output row m of the block -> its halo voxel index at tap (0, 0, 0).
__device__ __forceinline__ int halo_base(int m) {
  const int iz = m % TZ, iy = (m / TZ) % TY, ix = m / (TZ * TY);
  return (ix * HY + iy) * HZ + iz;
}

__device__ __forceinline__ int tap_offset(int tap) {
  return ((tap / 9) * HY + (tap / 3) % 3) * HZ + tap % 3;
}

// Epilogue of one output element pair (co, co + 1) of block row m.
template <typename T, bool TEMB, bool SKIP>
__device__ __forceinline__ void store2(const Args& p, int bidx, int x0,
                                       int y0, int z0, int m, int co,
                                       float a0, float a1) {
  const int iz = m % TZ, iy = (m / TZ) % TY, ix = m / (TZ * TY);
  const int gx = x0 + ix, gy = y0 + iy, gz = z0 + iz;
  if (gx >= p.X || gy >= p.Y || gz >= p.Z || co >= p.Co) return;
  float e0 = p.b[co], e1 = p.b[co + 1];
  if (TEMB) {
    e0 = __fadd_rn(e0, p.temb[(long long)bidx * p.Co + co]);
    e1 = __fadd_rn(e1, p.temb[(long long)bidx * p.Co + co + 1]);
  }
  float o0 = __fadd_rn(a0, e0), o1 = __fadd_rn(a1, e1);
  const long long off =
      ((((long long)bidx * p.X + gx) * p.Y + gy) * p.Z + gz) * p.Co + co;
  if (SKIP) {
    const T* s = static_cast<const T*>(p.skip) + off;
    o0 = __fadd_rn(o0, to_float(s[0]));
    o1 = __fadd_rn(o1, to_float(s[1]));
  }
  T* o = static_cast<T*>(p.out) + off;
  o[0] = from_float<T>(o0);
  o[1] = from_float<T>(o1);
}

__device__ __forceinline__ void block_coords(const Args& p, int& x0, int& y0,
                                             int& z0) {
  const int t = blockIdx.x;
  z0 = (t % p.ntz) * TZ;
  y0 = ((t / p.ntz) % p.nty) * TY;
  x0 = (t / (p.ntz * p.nty)) * TX;
}

// ---------------------------------------------------------------- bf16 --

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

template <bool PRO, bool TEMB, bool SKIP>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_bf16_kernel(const Args p) {
  using T = __nv_bfloat16;
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Ws = As + C::A_ELEMS;
  int x0, y0, z0;
  block_coords(p, x0, y0, z0);
  const int n0 = blockIdx.y * BN, bidx = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;

  // ldmatrix row of this lane in each of the warp's two 16-row tiles
  int abase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) abase[i] = halo_base(wm + i * 16 + (lane & 15));
  const uint32_t a_s = smem_addr(As) + (lane >> 4) * 16;
  const uint32_t w_s =
      smem_addr(Ws) + ((lane & 15) * C::WSTR + wn + (lane >> 4) * 8) * 2;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int c0 = 0; c0 < p.Ci; c0 += C::BK) {
    __syncthreads();  // the previous chunk's reads are done
    stage<T, PRO>(p, As, Ws, bidx, x0, y0, z0, n0, c0);
    __syncthreads();
#pragma unroll 3
    for (int tap = 0; tap < 27; ++tap) {
      const int toff = tap_offset(tap);
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], a_s + (abase[i] + toff) * (C::ASTR * 2));
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4_t(b[j], w_s + (tap * C::BK * C::WSTR + j * 16) * 2);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                   b[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = wm + i * 16 + g, co = n0 + wn + j * 8 + 2 * t;
      store2<T, TEMB, SKIP>(p, bidx, x0, y0, z0, m, co, acc[i][j][0],
                            acc[i][j][1]);
      store2<T, TEMB, SKIP>(p, bidx, x0, y0, z0, m + 8, co, acc[i][j][2],
                            acc[i][j][3]);
    }
}

// ---------------------------------------------------------------- fp32 --

template <bool PRO, bool TEMB, bool SKIP>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_f32_kernel(const Args p) {
  using T = float;
  using C = Cfg<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Ws = As + C::A_ELEMS;
  int x0, y0, z0;
  block_coords(p, x0, y0, z0);
  const int n0 = blockIdx.y * BN, bidx = blockIdx.z;
  // 16 x 16 threads; each owns 8 consecutive rows (one half of a z line)
  // and 4 consecutive output channels
  const int tn = threadIdx.x & 15, tm = threadIdx.x >> 4;
  const int abase = halo_base(tm * 8);

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int c0 = 0; c0 < p.Ci; c0 += C::BK) {
    __syncthreads();
    stage<T, PRO>(p, As, Ws, bidx, x0, y0, z0, n0, c0);
    __syncthreads();
    for (int tap = 0; tap < 27; ++tap) {
      const T* arow = As + (abase + tap_offset(tap)) * C::ASTR;
      const T* wrow = Ws + tap * C::BK * C::WSTR + tn * 4;
#pragma unroll
      for (int k = 0; k < C::BK; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(wrow + k * C::WSTR);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = arow[r * C::ASTR + k];
          acc[r][0] = fmaf(a, wv.x, acc[r][0]);
          acc[r][1] = fmaf(a, wv.y, acc[r][1]);
          acc[r][2] = fmaf(a, wv.z, acc[r][2]);
          acc[r][3] = fmaf(a, wv.w, acc[r][3]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = tm * 8 + r, co = n0 + tn * 4;
    store2<T, TEMB, SKIP>(p, bidx, x0, y0, z0, m, co, acc[r][0], acc[r][1]);
    store2<T, TEMB, SKIP>(p, bidx, x0, y0, z0, m, co + 2, acc[r][2],
                          acc[r][3]);
  }
}

template <typename Kernel>
int launch_one(Kernel kernel, size_t smem, const Args& p, int B,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((p.X + TX - 1) / TX) * p.nty * p.ntz;
  dim3 grid((unsigned)tiles, (unsigned)((p.Co + BN - 1) / BN), (unsigned)B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool PRO, bool TEMB, bool SKIP>
int dispatch(int dtype, const Args& p, int B, cudaStream_t s) {
  if (dtype == 0)
    return launch_one(conv3d_f32_kernel<PRO, TEMB, SKIP>, Cfg<float>::SMEM,
                      p, B, s);
  return launch_one(conv3d_bf16_kernel<PRO, TEMB, SKIP>,
                    Cfg<__nv_bfloat16>::SMEM, p, B, s);
}

}  // namespace

// x: (B, X, Y, Z, Ci), w: (27, Ci, Co), out and skip: (B, X, Y, Z, Co), all
// contiguous in that order and of one type (dtype 0 = fp32, 1 = bf16);
// b (Co,), temb (B, Co) and mean/inv/scale/bias (B, Ci) fp32 contiguous.
// mean == null: no prologue; temb/skip == null: no such add. Needs Ci and
// Co multiples of 8 and 16-byte aligned x and w.
extern "C" int conv3d_fused(const void* x, const void* w, const float* b,
                            const float* mean, const float* inv,
                            const float* scale, const float* bias,
                            const float* temb, const void* skip, void* out,
                            int B, int X, int Y, int Z, int Ci, int Co,
                            int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || Ci % 8 || Co % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * X * Y * Z == 0 || Co == 0) return 0;
  Args p{x, w, b, mean, inv, scale, bias, temb, skip, out, X, Y, Z, Ci, Co,
         (Y + TY - 1) / TY, (Z + TZ - 1) / TZ};
  cudaStream_t s = (cudaStream_t)stream;
  const int code = (mean ? 4 : 0) | (temb ? 2 : 0) | (skip ? 1 : 0);
  switch (code) {
    case 0: return dispatch<false, false, false>(dtype, p, B, s);
    case 1: return dispatch<false, false, true>(dtype, p, B, s);
    case 2: return dispatch<false, true, false>(dtype, p, B, s);
    case 3: return dispatch<false, true, true>(dtype, p, B, s);
    case 4: return dispatch<true, false, false>(dtype, p, B, s);
    case 5: return dispatch<true, false, true>(dtype, p, B, s);
    case 6: return dispatch<true, true, false>(dtype, p, B, s);
    default: return dispatch<true, true, true>(dtype, p, B, s);
  }
}
