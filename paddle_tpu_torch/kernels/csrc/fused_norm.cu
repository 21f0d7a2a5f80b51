// RMSNorm over the rows of a 2-D (R, H) array for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/fused_norm.py::_kernel
// (`_kernel_plain` / `_kernel_res`, public entry `rms_norm_rows`). In the
// reference's op order, all in fp32: x = x (+ residual), var = mean(x * x),
// y = x * rsqrt(var + eps), out = (y * weight) cast to x's dtype. Forward
// only: the reference registers no backward.
//
// Bound on this card: bytes. A row does ~4 flops per element it reads and
// writes, far below the ~20 flop/byte where fp32 arithmetic would bind, so
// the design moves each byte once and keeps everything else on chip:
//   * one block of 256 threads per row; each thread walks the row in
//     16-byte vectors (8 bf16 or 4 fp32) where H and the pointers allow,
//     else element by element, so any H works;
//   * pass 1 sums x * x in fp32 (a warp-shuffle tree, then one warp over
//     the warps' sums); pass 2 reads the row again — from L2, since a row
//     is at most a few tens of KB — and writes y * w;
//   * rsqrtf is the card's reciprocal square root (within 2 ulp), so the
//     output agrees with the plain version within rounding, not bitwise.
// The kernel launches on the caller's stream and allocates nothing; the C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements of a row starting at column c: x (+ residual) in fp32
template <typename T, bool kRes, int V>
__device__ __forceinline__ void load_row(float (&f)[V], const T* x,
                                         const T* res, int c) {
  if constexpr (V == 1) {
    f[0] = to_f(x[c]);
    if constexpr (kRes) f[0] = f[0] + to_f(res[c]);
  } else {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + c);
    const T* xe = reinterpret_cast<const T*>(&xv);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(xe[i]);
    if constexpr (kRes) {
      const uint4 rv = *reinterpret_cast<const uint4*>(res + c);
      const T* re = reinterpret_cast<const T*>(&rv);
#pragma unroll
      for (int i = 0; i < V; ++i) f[i] = f[i] + to_f(re[i]);
    }
  }
}

template <typename T, bool kRes, int V>
__device__ __forceinline__ void store_row(T* out, const float (&f)[V],
                                          int c) {
  if constexpr (V == 1) {
    out[c] = from_f<T>(f[0]);
  } else {
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int i = 0; i < V; ++i) oe[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(out + c) = ov;
  }
}

// V: elements a thread takes at a time (16 bytes' worth, or 1)
template <typename T, typename W, bool kRes, int V>
__global__ void __launch_bounds__(kThreads)
rms_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const W* __restrict__ w, T* __restrict__ out, int H,
                float eps) {
  __shared__ float warp_sums[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * H;
  const T* rr = kRes ? res + row * H : nullptr;
  T* outr = out + row * H;

  float ss = 0.f;
  for (int c = threadIdx.x * V; c < H; c += kThreads * V) {
    float f[V];
    load_row<T, kRes, V>(f, xr, rr, c);
#pragma unroll
    for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) warp_sums[0] = ss;
  }
  __syncthreads();
  const float rs = rsqrtf(warp_sums[0] / static_cast<float>(H) + eps);

  for (int c = threadIdx.x * V; c < H; c += kThreads * V) {
    float f[V];
    load_row<T, kRes, V>(f, xr, rr, c);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = (f[i] * rs) * to_f(w[c + i]);
    store_row<T, kRes, V>(outr, f, c);
  }
}

template <typename T, typename W, bool kRes>
cudaError_t launch(const void* x, const void* res, const void* w, void* out,
                   int R, int H, float eps, bool vec, cudaStream_t stream) {
  constexpr int kV = 16 / static_cast<int>(sizeof(T));
  const dim3 grid(R);
  if (vec)
    rms_rows_kernel<T, W, kRes, kV><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<const W*>(w), static_cast<T*>(out), H, eps);
  else
    rms_rows_kernel<T, W, kRes, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<const W*>(w), static_cast<T*>(out), H, eps);
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t dispatch_res(const void* x, const void* res, const void* w,
                         void* out, int R, int H, float eps, bool vec,
                         cudaStream_t stream) {
  if (res) return launch<T, W, true>(x, res, w, out, R, H, eps, vec, stream);
  return launch<T, W, false>(x, res, w, out, R, H, eps, vec, stream);
}

template <typename T>
cudaError_t dispatch_w(const void* x, const void* res, const void* w,
                       void* out, int R, int H, float eps, int wdtype,
                       bool vec, cudaStream_t stream) {
  if (wdtype == 0)
    return dispatch_res<T, float>(x, res, w, out, R, H, eps, vec, stream);
  return dispatch_res<T, __nv_bfloat16>(x, res, w, out, R, H, eps, vec,
                                        stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// x, residual (nullable) and out (R, H) contiguous in `dtype`, weight (H,)
// in `wdtype` (0 = float32, 1 = bfloat16 for both). Returns a cudaError_t:
// 0 on a successful launch (nothing is launched for R == 0).
extern "C" int rms_norm_rows(const void* x, const void* residual,
                             const void* weight, void* out, int R, int H,
                             float eps, int dtype, int wdtype, void* stream) {
  if (R < 0 || H <= 0 || (dtype != 0 && dtype != 1) ||
      (wdtype != 0 && wdtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = (H * elem) % 16 == 0 && aligned16(x) && aligned16(out) &&
                   (!residual || aligned16(residual));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_w<float>(x, residual, weight, out, R, H, eps, wdtype, vec, s);
  else
    e = dispatch_w<__nv_bfloat16>(x, residual, weight, out, R, H, eps, wdtype,
                                  vec, s);
  return static_cast<int>(e);
}
