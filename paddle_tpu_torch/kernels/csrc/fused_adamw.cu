// Fused AdamW over one packed bucket for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `_adamw_kernel`
// (paddle_tpu/kernels/fused_optimizer.py, driven by `fused_adamw_bucket`):
// one elementwise pass over a flat bucket that reads the gradient, the
// fp32 weights (the master copy, or the fp32 parameters themselves) and
// both moments once, and writes the weights, both moments and — with a
// master — the narrow parameters once. The nine fp32 scalars (lr,
// decoupled-decay factor, b1, 1-b1, b2, 1-b2, both bias corrections, eps)
// are read from device memory, so a changing step needs no host sync
// (the TPU kernel's scalar prefetch).
//
// Bound on this card: bytes. ~13 flops per element against 20 bytes
// (bf16 grad and params, fp32 master, bf16 moments), so the design only
// streams: 16-byte-or-wider vector loads, four elements per thread per
// iteration, a grid-stride loop. Indices are 64-bit: one bucket of an
// 8-layer Llama-3-8B holds ~2.8e9 elements, more than INT_MAX.
//
// Rounding is pinned to the plain version's (`_adamw_math`, a chain of
// separate PyTorch elementwise ops): every operation is an explicit
// round-to-nearest intrinsic, so nvcc cannot contract `b1*m + omb1*g`
// into an FMA, and the result is bitwise the plain version's for fp32
// and bf16 storage. The weights, m and v are updated in place.
//
// The kernel launches on the caller's stream, allocates nothing, and the
// C entry returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float (&x)[kVec]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[kVec]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float (&x)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&x)[kVec]) {
  uint2 v;
  v.x = bf16_bits(x[0]) | (bf16_bits(x[1]) << 16);
  v.y = bf16_bits(x[2]) | (bf16_bits(x[3]) << 16);
  *reinterpret_cast<uint2*>(p) = v;
}

// G: gradient (= parameter) type; M: moment storage type; kMaster: the
// parameters are bf16 with an fp32 master (p_out gets the rounded copy).
template <typename G, typename M, bool kMaster>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const G* __restrict__ g, float* __restrict__ w,
             M* __restrict__ m, M* __restrict__ v,
             __nv_bfloat16* __restrict__ p_out,
             const float* __restrict__ sc, size_t n) {
  const float lr = sc[0], wdf = sc[1], b1 = sc[2], omb1 = sc[3], b2 = sc[4],
              omb2 = sc[5], bc1 = sc[6], bc2 = sc[7], eps = sc[8];
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads * kVec;
  for (size_t i = (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) *
                  kVec;
       i < n; i += stride) {
    float gx[kVec], wx[kVec], mx[kVec], vx[kVec];
    load4(g + i, gx);
    load4(w + i, wx);
    load4(m + i, mx);
    load4(v + i, vx);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      // _adamw_math, token for token:
      //   w = w * wdf
      //   m = b1 * m + omb1 * g
      //   v = b2 * v + omb2 * g * g
      //   w = w - lr * (m / bc1) / (sqrt(v / bc2) + eps)
      const float gg = gx[e];
      const float ww = __fmul_rn(wx[e], wdf);
      const float mm = __fadd_rn(__fmul_rn(b1, mx[e]), __fmul_rn(omb1, gg));
      const float vv =
          __fadd_rn(__fmul_rn(b2, vx[e]), __fmul_rn(__fmul_rn(omb2, gg), gg));
      const float mhat = __fdiv_rn(mm, bc1);
      const float vhat = __fdiv_rn(vv, bc2);
      wx[e] = __fsub_rn(ww, __fdiv_rn(__fmul_rn(lr, mhat),
                                      __fadd_rn(__fsqrt_rn(vhat), eps)));
      mx[e] = mm;
      vx[e] = vv;
    }
    store4(w + i, wx);
    store4(m + i, mx);
    store4(v + i, vx);
    if constexpr (kMaster) store4(p_out + i, wx);
  }
}

template <typename G, typename M, bool kMaster>
cudaError_t launch(const void* g, void* w, void* m, void* v, void* p_out,
                   const void* sc, size_t n, cudaStream_t stream) {
  const size_t groups = (n + kVec - 1) / kVec;
  size_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 resident blocks per SM
  if (blocks == 0) return cudaSuccess;
  adamw_kernel<G, M, kMaster><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
      static_cast<const G*>(g), static_cast<float*>(w), static_cast<M*>(m),
      static_cast<M*>(v), static_cast<__nv_bfloat16*>(p_out),
      static_cast<const float*>(sc), n);
  return cudaGetLastError();
}

}  // namespace

// Updates w (fp32), m and v in place. grad_dtype: 0 = float32 (fp32
// parameters: w is the parameter bucket, p_out unused) or 1 = bfloat16
// (bf16 parameters with an fp32 master w; p_out receives the bf16
// parameters). moment_dtype: 0 = float32, 1 = bfloat16. n: elements, a
// multiple of 4; every pointer 16-byte aligned.
// Returns a cudaError_t: 0 on a successful launch.
extern "C" int fused_adamw(const void* grads, void* w, void* m, void* v,
                           void* p_out, const void* scalars, long long n,
                           int grad_dtype, int moment_dtype, void* stream) {
  if (n < 0 || n % kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t N = static_cast<size_t>(n);
  cudaError_t e;
  if (grad_dtype == 0 && moment_dtype == 0)
    e = launch<float, float, false>(grads, w, m, v, p_out, scalars, N, s);
  else if (grad_dtype == 0 && moment_dtype == 1)
    e = launch<float, __nv_bfloat16, false>(grads, w, m, v, p_out, scalars,
                                            N, s);
  else if (grad_dtype == 1 && moment_dtype == 0)
    e = launch<__nv_bfloat16, float, true>(grads, w, m, v, p_out, scalars,
                                           N, s);
  else if (grad_dtype == 1 && moment_dtype == 1)
    e = launch<__nv_bfloat16, __nv_bfloat16, true>(grads, w, m, v, p_out,
                                                   scalars, N, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
