// K1 and K2: one-level orthonormal 3-D Haar DWT and its exact inverse.
//
// Replaces the TPU kernels `_dwt3_kernel` and `_idwt3_kernel` of
// fast_cwdm_tpu/ops/wavelet_pallas.py (pallas_call at :125 and :161).
// On the TPU the Y and Z axes ran as banded matmuls on the MXU over one
// X-pair per grid step, with a band-major (8, X/2, Y/2, Z/2) output. The
// transform is block-local: each of the 8 bands at a latent voxel is
// +-(sum of one 2x2x2 input block)/(2*sqrt 2), so here one thread owns one
// latent voxel.
//
// Bound on the H100: memory. Each input byte is read once and each output
// byte written once (224x224x160 fp32 in, the same count out: 64.2 MB, about
// 19 us at 3.35 TB/s); the arithmetic is 6 flops per element.
//
// Design: the DWT thread reads its 2x2x2 block as four 8-byte float2 loads
// (neighbouring threads read neighbouring Z pairs, so each warp reads
// contiguous 256-byte rows) and writes its 8 bands as two 16-byte stores in
// the flat band-last (..., X/2, Y/2, Z/2, 8) layout that `dwt3_flat` returns,
// so no transpose pass follows. The IDWT thread does the reverse. The
// butterflies run in the order of the plain torch path (X, then Y, then Z
// for the DWT; Z, Y, X for the inverse), each a sum or difference times
// 1/sqrt 2, so the kernel and the plain path round identically.
//
// Leading dimensions are a batch. fp32 only, the type on the synthesis path.

#include <cuda_runtime.h>

namespace {

constexpr float kR = 0.70710678118654752440f;  // 1/sqrt(2), as fp32
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__global__ void haar_dwt3_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, long long n_out,
                                 int Yh, int Zh) {
  const long long Y = 2LL * Yh, Z = 2LL * Zh;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n_out; idx += (long long)gridDim.x * blockDim.x) {
    const long long k = idx % Zh;
    long long r = idx / Zh;
    const long long j = r % Yh;
    r /= Yh;  // r = batch * X/2 + i: the block's first input X row is 2r
    const float* p = x + ((2 * r) * Y + 2 * j) * Z + 2 * k;
    float v[2][2][2];  // [x parity][y parity][z parity]
    const float2 v00 = *reinterpret_cast<const float2*>(p);
    const float2 v01 = *reinterpret_cast<const float2*>(p + Z);
    const float2 v10 = *reinterpret_cast<const float2*>(p + Y * Z);
    const float2 v11 = *reinterpret_cast<const float2*>(p + Y * Z + Z);
    v[0][0][0] = v00.x; v[0][0][1] = v00.y;
    v[0][1][0] = v01.x; v[0][1][1] = v01.y;
    v[1][0][0] = v10.x; v[1][0][1] = v10.y;
    v[1][1][0] = v11.x; v[1][1][1] = v11.y;

    float sx[2][2][2];  // [hx][y parity][z parity]
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sx[0][b][c] = (v[0][b][c] + v[1][b][c]) * kR;
        sx[1][b][c] = (v[0][b][c] - v[1][b][c]) * kR;
      }
    float sy[2][2][2];  // [hx][hy][z parity]
#pragma unroll
    for (int hx = 0; hx < 2; ++hx)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sy[hx][0][c] = (sx[hx][0][c] + sx[hx][1][c]) * kR;
        sy[hx][1][c] = (sx[hx][0][c] - sx[hx][1][c]) * kR;
      }
    float o[8];  // band = 4*hx + 2*hy + hz
#pragma unroll
    for (int hx = 0; hx < 2; ++hx)
#pragma unroll
      for (int hy = 0; hy < 2; ++hy) {
        o[4 * hx + 2 * hy] = (sy[hx][hy][0] + sy[hx][hy][1]) * kR;
        o[4 * hx + 2 * hy + 1] = (sy[hx][hy][0] - sy[hx][hy][1]) * kR;
      }
    float4* q = reinterpret_cast<float4*>(y + idx * 8);
    q[0] = make_float4(o[0], o[1], o[2], o[3]);
    q[1] = make_float4(o[4], o[5], o[6], o[7]);
  }
}

__global__ void haar_idwt3_kernel(const float* __restrict__ y,
                                  float* __restrict__ x, long long n_in,
                                  int Yh, int Zh) {
  const long long Y = 2LL * Yh, Z = 2LL * Zh;
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < n_in; idx += (long long)gridDim.x * blockDim.x) {
    const float4* q = reinterpret_cast<const float4*>(y + idx * 8);
    const float4 lo = q[0], hi = q[1];
    const float band[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};

    float sz[2][2][2];  // [hx][hy][z parity]
#pragma unroll
    for (int hx = 0; hx < 2; ++hx)
#pragma unroll
      for (int hy = 0; hy < 2; ++hy) {
        const float l = band[4 * hx + 2 * hy], h = band[4 * hx + 2 * hy + 1];
        sz[hx][hy][0] = (l + h) * kR;
        sz[hx][hy][1] = (l - h) * kR;
      }
    float syv[2][2][2];  // [hx][y parity][z parity]
#pragma unroll
    for (int hx = 0; hx < 2; ++hx)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        syv[hx][0][c] = (sz[hx][0][c] + sz[hx][1][c]) * kR;
        syv[hx][1][c] = (sz[hx][0][c] - sz[hx][1][c]) * kR;
      }
    float v[2][2][2];  // [x parity][y parity][z parity]
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        v[0][b][c] = (syv[0][b][c] + syv[1][b][c]) * kR;
        v[1][b][c] = (syv[0][b][c] - syv[1][b][c]) * kR;
      }

    const long long k = idx % Zh;
    long long r = idx / Zh;
    const long long j = r % Yh;
    r /= Yh;
    float* p = x + ((2 * r) * Y + 2 * j) * Z + 2 * k;
    *reinterpret_cast<float2*>(p) = make_float2(v[0][0][0], v[0][0][1]);
    *reinterpret_cast<float2*>(p + Z) = make_float2(v[0][1][0], v[0][1][1]);
    *reinterpret_cast<float2*>(p + Y * Z) = make_float2(v[1][0][0], v[1][0][1]);
    *reinterpret_cast<float2*>(p + Y * Z + Z) =
        make_float2(v[1][1][0], v[1][1][1]);
  }
}

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

// x: (batch, 2*Xh, 2*Yh, 2*Zh) fp32 contiguous, 8-byte aligned.
// y: (batch, Xh, Yh, Zh, 8) fp32 contiguous, 16-byte aligned.
extern "C" int haar_dwt3_f32(const float* x, float* y, long long batch,
                             int Xh, int Yh, int Zh, void* stream) {
  const long long n = batch * Xh * (long long)Yh * Zh;
  if (n > 0)
    haar_dwt3_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, n, Yh, Zh);
  return (int)cudaGetLastError();
}

extern "C" int haar_idwt3_f32(const float* y, float* x, long long batch,
                              int Xh, int Yh, int Zh, void* stream) {
  const long long n = batch * Xh * (long long)Yh * Zh;
  if (n > 0)
    haar_idwt3_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        y, x, n, Yh, Zh);
  return (int)cudaGetLastError();
}
