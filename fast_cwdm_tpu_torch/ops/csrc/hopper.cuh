// Hopper building blocks shared by the fused-conv kernels (conv3d_wgmma.cu,
// conv3d_splitk.cu, conv3d_tf32.cu): shared-memory mbarriers, the bulk
// global -> shared copy that completes on one, the warpgroup-MMA
// descriptor and fences, and the fp32 GN-apply + SiLU prologue of one
// 8-channel bf16 vector with its branch-free reciprocal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarrier --

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive from the threads where `pred` holds, predicated inside the
// instruction: no branch around it, so ptxas keeps the warpgroup's wgmma
// path convergent.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_addr(bar)),
      "r"((int)pred)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed:
// the loop is in PTX (a loop in C around try_wait is divergent control flow
// to ptxas, which then serialises the wgmma that follow), and the thread
// sleeps in try_wait (suspend-time hint, 20 us) instead of spinning. A wait
// that never ends (a fault in the ring's bookkeeping) traps once 2^32 ns
// (4.3 s) have passed on the global timer since its first failed poll, so
// the launch fails instead of hanging the card; a legitimate wait is one
// chunk's staging or MMAs, microseconds. The timer is read only after a
// failed poll.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, %2;\n"
      "@p bra DONE;\n"
      "mov.u64 t0, %%globaltimer;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, %2;\n"
      "@p bra DONE;\n"
      "mov.u64 t, %%globaltimer;\n"
      "sub.u64 t, t, t0;\n"
      "setp.lt.u64 p, t, 4294967296;\n"
      "@p bra LAB_WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity), "r"(20000)
      : "memory");
}

// One contiguous global -> shared copy, completing on `bar` (no tensor map).
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// --------------------------------------------------------------- wgmma --

// Shared-memory matrix descriptor, no swizzle: start, leading and stride
// byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// ------------------------------------------------------------ prologue --

// 1/d rounded to nearest for 1 <= d < 2^126: the approximate reciprocal
// and one fma correction, bit for bit IEEE 1.0f / d on that range (every
// float in it is checked against __fdiv_rn by recip_normal_mismatches in
// conv3d_wgmma.cu). Unlike 1.0f / d it has no slow-path branch, so the
// eight elements of a vector interleave.
__device__ __forceinline__ float recip_normal(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
}

// The prologue of one 8-channel bf16 vector, as conv3d.cu and the plain
// version: xn = (x - mean) * inv; u = xn * scale + bias (products and sums
// rounded apart); u * (1 / (1 + expf(-u))) with the IEEE quotient; one
// rounding to bf16.
template <bool PRO>
__device__ __forceinline__ uint4 prologue(uint4 in, const float (&mean)[8],
                                          const float (&inv)[8],
                                          const float (&scale)[8],
                                          const float (&bias)[8]) {
  if (!PRO) return in;
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&in);
  float u[8], d[8];
  bool normal = true;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float xn = __fmul_rn(__fsub_rn(__bfloat162float(v[e]), mean[e]), inv[e]);
    u[e] = __fadd_rn(__fmul_rn(xn, scale[e]), bias[e]);
    d[e] = 1.0f + expf(-u[e]);
    normal = normal && d[e] < 0x1p126f;
  }
  uint4 out;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
  if (normal) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16_rn(__fmul_rn(u[e], recip_normal(d[e])));
  } else {  // some u < -87: the quotient leaves the normal range
#pragma unroll
    for (int e = 0; e < 8; ++e)
      o[e] = __float2bfloat16_rn(__fmul_rn(u[e], 1.0f / d[e]));
  }
  return out;
}

}  // namespace hopper
