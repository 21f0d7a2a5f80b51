// Weight-only int8 dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of
// paddle_tpu/kernels/quant_matmul.py (driven by `quant_matmul`):
//   out[m, n] = cast((sum_k x[m, k] * q[k, n]) * scale[n])
// with x (M, K) bf16 or fp32, q (K, N) int8 row-major, scale (N,) fp32,
// out (M, N) in x's dtype, fp32 accumulation and the per-column scale
// applied once at the flush (not per K step), as on the TPU. Any M, K, N:
// ragged edges are zero-filled in shared memory and never stored.
//
// What it keeps: the port's Hopper kernels take bf16 x whose operands
// TMA can address (quant_decode_sm90.cu at M <= 16, quant_matmul_sm90.cu
// above), so this file serves fp32 x at every M and the shapes TMA cannot
// address (K not a multiple of 8, N not of 16, an unaligned base) in
// either type; no bf16 launch of the serving path reaches it. Bound on
// this card: bytes at decode rows (~2 M flops per weight byte, far below
// the ~295 where the bf16 tensor cores bind), operations at prefill rows
// in fp32. The design:
//   * a block of 4 warps owns a BM x BN output tile and walks K in
//     32-deep tiles: x and int8 weight tiles are loaded with 16-byte
//     vectors where the shape and alignment allow (byte or element loads
//     on a ragged edge), held in registers while the previous tile is
//     computed (one tile of prefetch), and stored to shared memory, the
//     weight converted to the compute type on the way;
//   * bf16 x: int8 -> bf16 is exact (|q| <= 127) and bf16 x bf16
//     products are exact in fp32, so mma.sync m16n8k16 with fp32
//     accumulation is the fp32 computation x.float() @ q.float() up to
//     the order of summation;
//   * fp32 x: fp32 FMAs (never TF32), each thread computing the same
//     accumulator fragment positions, so the epilogue is shared;
//   * M <= 16 (decode rows): BM 16, BN 128, the 4 warps side by side in
//     N; M > 16 (prefill rows): BM 64, BN 64, the warps stacked in M;
//   * when the output tiles alone leave the card short of blocks, K is
//     split over a third grid axis; each split writes its fp32 partial
//     tile to a workspace and a second kernel sums the splits in a fixed
//     order, applies the scale and casts: deterministic, no atomics
//     (`quant_matmul_splits` picks the count).
// Not done here (later work): TMA/cp.async multi-stage pipelines, wgmma,
// int8 x int8 tensor-core products with a per-row activation scale.
//
// The kernels launch on the caller's stream and allocate nothing; each C
// entry returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;

template <bool kBf16>
struct Tr;
template <>
struct Tr<true> {
  using T = __nv_bfloat16;
  static constexpr int kPad = 8;  // row padding (elements) against bank conflicts
};
template <>
struct Tr<false> {
  using T = float;
  static constexpr int kPad = 4;
};

// WM warps along M (1 or 4), the rest along N, NT n8-tiles per warp.
template <bool kBf16, int WM, int NT>
struct Cfg {
  using T = typename Tr<kBf16>::T;
  static constexpr int kWN = 4 / WM;
  static constexpr int kBM = 16 * WM;
  static constexpr int kBN = kWN * NT * 8;
  static constexpr int kLdx = kBK + Tr<kBf16>::kPad;
  static constexpr int kLdw = kBN + Tr<kBf16>::kPad;
  static constexpr int kXPer = 16 / static_cast<int>(sizeof(T));  // per chunk
  static constexpr int kXChunks = kBM * kBK / kXPer;
  static constexpr int kWChunks = kBK * kBN / 16;
  static constexpr int kXV = (kXChunks + kThreads - 1) / kThreads;
  static constexpr int kWV = (kWChunks + kThreads - 1) / kThreads;
};

// 16 bytes of elements of ES bytes from src, of which the first n_valid
// lie inside the matrix: one vector load when all are valid and `vec`
// says the address is 16-byte aligned, else element loads, zero-filled.
template <int ES>
__device__ __forceinline__ uint4 load16(const void* src, int n_valid,
                                        bool vec) {
  constexpr int kN = 16 / ES;
  if (vec && n_valid >= kN) return *reinterpret_cast<const uint4*>(src);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    if (i < n_valid) {
      uint32_t v;
      if constexpr (ES == 1)
        v = reinterpret_cast<const uint8_t*>(src)[i];
      else if constexpr (ES == 2)
        v = reinterpret_cast<const uint16_t*>(src)[i];
      else
        v = reinterpret_cast<const uint32_t*>(src)[i];
      w[(i * ES) / 4] |= v << (8 * ((i * ES) % 4));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 values (one uint4) -> 16 elements of the compute type at dst
// (16-byte aligned); int8 -> bf16 / fp32 is exact.
template <bool kBf16>
__device__ __forceinline__ void store_w16(typename Tr<kBf16>::T* dst,
                                          uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float f[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(
        static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  if constexpr (kBf16) {
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      p[i] = pack2(__float2bfloat16_rn(f[2 * i]),
                   __float2bfloat16_rn(f[2 * i + 1]));
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(p[0], p[1], p[2], p[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(p[4], p[5], p[6], p[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(dst)[i] =
          make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  }
}

// Accumulator fragment of a warp's 16 x (NT*8) tile, in mma.sync's C
// layout: with g = lane / 4 and t = lane % 4, acc[j][0..1] hold row g,
// columns 8j + 2t + {0, 1}; acc[j][2..3] the same columns of row g + 8.
// acc += A (16 x kBK, row-major, lda) * B (kBK x NT*8, row-major, ldb)
template <bool kBf16, int NT>
__device__ __forceinline__ void gemm_ab(float (&acc)[NT][4],
                                        const typename Tr<kBf16>::T* A,
                                        int lda,
                                        const typename Tr<kBf16>::T* B,
                                        int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(A + g * lda + kk + 2 * t);
      a[1] = ld32(A + (g + 8) * lda + kk + 2 * t);
      a[2] = ld32(A + g * lda + kk + 8 + 2 * t);
      a[3] = ld32(A + (g + 8) * lda + kk + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* b = B + (kk + 2 * t) * ldb + j * 8 + g;
        mma16816(acc[j], a, pack2(b[0], b[ldb]),
                 pack2(b[8 * ldb], b[9 * ldb]));
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = B[k * ldb + j * 8 + 2 * t];
        const float b1 = B[k * ldb + j * 8 + 2 * t + 1];
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ void store_out(void* out, size_t i, float x) {
  if constexpr (kBf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(out)[i] = x;
}

// grid (ceil(N / BN), ceil(M / BM), splits), kThreads threads. Split z
// covers K tiles [z * kt_per, min((z + 1) * kt_per, ceil(K / kBK))). With
// one split the block flushes out = cast(acc * scale); with more it
// writes acc to ws[z] (splits, M, N) fp32 for `reduce_splits`.
template <bool kBf16, int WM, int NT>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const void* __restrict__ xp, const int8_t* __restrict__ q,
                    const float* __restrict__ scale, void* __restrict__ out,
                    float* __restrict__ ws, int M, int K, int N, int kt_per,
                    int vec_x, int vec_w) {
  using C = Cfg<kBf16, WM, NT>;
  using T = typename C::T;
  // raw 16-byte words, viewed as T: no constructor runs on shared memory
  __shared__ uint4 xs_raw[(C::kBM * C::kLdx * sizeof(T) + 15) / 16];
  __shared__ uint4 ws_raw[(kBK * C::kLdw * sizeof(T) + 15) / 16];
  T* xs = reinterpret_cast<T*>(xs_raw);
  T* wsm = reinterpret_cast<T*>(ws_raw);
  const T* x = static_cast<const T*>(xp);

  const int n0 = blockIdx.x * C::kBN;
  const int m0 = blockIdx.y * C::kBM;
  const int kt_total = (K + kBK - 1) / kBK;
  const int kt0 = blockIdx.z * kt_per;
  const int kt1 = min(kt0 + kt_per, kt_total);
  const int warp = threadIdx.x >> 5;
  const int wm = warp / C::kWN, wn = warp % C::kWN;

  uint4 xr[C::kXV], wr[C::kWV];
  auto load = [&](int kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < C::kXV; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (kBK / C::kXPer);
      const int col = (c % (kBK / C::kXPer)) * C::kXPer;
      const int m = m0 + r, k = k0 + col;
      const int valid = (c < C::kXChunks && m < M) ? min(C::kXPer, K - k) : 0;
      xr[i] = load16<sizeof(T)>(x + static_cast<size_t>(m) * K + k, valid,
                                vec_x);
    }
#pragma unroll
    for (int i = 0; i < C::kWV; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / (C::kBN / 16);
      const int col = (c % (C::kBN / 16)) * 16;
      const int k = k0 + r, n = n0 + col;
      const int valid = (c < C::kWChunks && k < K) ? min(16, N - n) : 0;
      wr[i] = load16<1>(q + static_cast<size_t>(k) * N + n, valid, vec_w);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < C::kXV; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < C::kXChunks) {
        const int r = c / (kBK / C::kXPer);
        const int col = (c % (kBK / C::kXPer)) * C::kXPer;
        *reinterpret_cast<uint4*>(xs + r * C::kLdx + col) = xr[i];
      }
    }
#pragma unroll
    for (int i = 0; i < C::kWV; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c < C::kWChunks) {
        const int r = c / (C::kBN / 16);
        const int col = (c % (C::kBN / 16)) * 16;
        store_w16<kBf16>(wsm + r * C::kLdw + col, wr[i]);
      }
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (kt0 < kt1) load(kt0);
  for (int kt = kt0; kt < kt1; ++kt) {
    stash();
    __syncthreads();
    if (kt + 1 < kt1) load(kt + 1);  // in flight during the products
    gemm_ab<kBf16, NT>(acc, xs + wm * 16 * C::kLdx, C::kLdx,
                       wsm + wn * NT * 8, C::kLdw);
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 16 + g + (e >= 2 ? 8 : 0);
      const int n = n0 + wn * NT * 8 + j * 8 + 2 * t + (e & 1);
      if (m < M && n < N) {
        const size_t i = static_cast<size_t>(m) * N + n;
        if (gridDim.z == 1)
          store_out<kBf16>(out, i, acc[j][e] * scale[n]);
        else
          ws[static_cast<size_t>(blockIdx.z) * M * N + i] = acc[j][e];
      }
    }
  }
}

// out[m, n] = cast((sum over z in order of ws[z, m, n]) * scale[n])
template <bool kBf16>
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ ws, const float* __restrict__ scale,
              void* __restrict__ out, int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < mn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    store_out<kBf16>(out, i, s * scale[i % N]);
  }
}

// Tile shape by M: decode (M <= 16) or prefill.
inline bool small_m(int M) { return M <= 16; }

template <bool kBf16, int WM, int NT>
cudaError_t launch(const void* x, const int8_t* q, const float* scale,
                   void* out, float* ws, int M, int K, int N, int splits,
                   cudaStream_t s) {
  using C = Cfg<kBf16, WM, NT>;
  const int kt_total = (K + kBK - 1) / kBK;
  const int kt_per = (kt_total + splits - 1) / splits;
  const int vec_x = (K % C::kXPer == 0) &&
                    (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int vec_w = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(q) % 16 == 0);
  const dim3 grid((N + C::kBN - 1) / C::kBN, (M + C::kBM - 1) / C::kBM,
                  splits);
  quant_matmul_kernel<kBf16, WM, NT><<<grid, kThreads, 0, s>>>(
      x, q, scale, out, ws, M, K, N, kt_per, vec_x, vec_w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(
      mn / 256 + 1 < 4096 ? mn / 256 + 1 : 4096);
  reduce_splits<kBf16><<<blocks, 256, 0, s>>>(ws, scale, out, M, N, splits);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t dispatch(const void* x, const int8_t* q, const float* scale,
                     void* out, float* ws, int M, int K, int N, int splits,
                     cudaStream_t s) {
  if (small_m(M))
    return launch<kBf16, 1, 4>(x, q, scale, out, ws, M, K, N, splits, s);
  return launch<kBf16, 4, 8>(x, q, scale, out, ws, M, K, N, splits, s);
}

}  // namespace

// How many K splits `quant_matmul` takes for (M, K, N) on a card with
// num_sms SMs: enough blocks for ~4 per SM, each split at least 16 K
// tiles (512) deep; 1 when the output tiles already fill the card. The
// caller sizes the (splits, M, N) fp32 workspace from it.
extern "C" int quant_matmul_splits(int M, int K, int N, int num_sms) {
  if (M <= 0 || K <= 0 || N <= 0 || num_sms <= 0) return 1;
  const int bm = small_m(M) ? 16 : 64, bn = small_m(M) ? 128 : 64;
  const long long tiles = static_cast<long long>((N + bn - 1) / bn) *
                          ((M + bm - 1) / bm);
  const long long want = 4LL * num_sms;
  const int kt_total = (K + kBK - 1) / kBK;
  long long splits = (want + tiles - 1) / tiles;
  const int deepest = kt_total / 16;
  if (splits > deepest) splits = deepest;
  if (splits <= 1) return 1;
  const int kt_per = static_cast<int>((kt_total + splits - 1) / splits);
  return (kt_total + kt_per - 1) / kt_per;  // no empty split
}

// dtype: 0 = float32, 1 = bfloat16 (x and out share it). ws: a (splits,
// M, N) fp32 workspace, unused (may be null) when splits == 1.
// Returns a cudaError_t: 0 when the launches succeeded.
extern "C" int quant_matmul(const void* x, const void* q, const void* scale,
                            void* out, void* ws, int M, int K, int N,
                            int splits, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || splits <= 0 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* wp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch<false>(x, qp, sp, out, wp, M, K, N, splits, s);
  else if (dtype == 1)
    e = dispatch<true>(x, qp, sp, out, wp, M, K, N, splits, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
