// Weight-only int8 dequant-matmul at prefill widths for Hopper (sm_90a):
// wgmma over a TMA tile ring. Plain C interface.
//
// Replaces, for bf16 x of more than 16 rows, the Pallas TPU kernel
// `_kernel` of paddle_tpu/kernels/quant_matmul.py (driven by
// `quant_matmul`):
//   out[m, n] = cast((sum_k x[m, k] * q[k, n]) * scale[n])
// x (M, K) bf16, q (K, N) int8 row-major, scale (N,) fp32, out (M, N)
// bf16; fp32 accumulation, the per-column scale once at the flush, as on
// the TPU. TMA addresses the operands, so K must be a multiple of 8 (x's
// row stride a multiple of 16 bytes), N a multiple of 16 (q's) and both
// bases 16-byte aligned; the wrapper's route sends bf16 rows of at most
// 16 to quant_decode_sm90.cu, and fp32 x and every other shape to
// quant_matmul.cu.
//
// Bound on this card: operations. A serving prefill chunk runs it at M up
// to 512 over the MLP weights: at gate/up (512, 4096, 14336) 60 GFLOP
// against 59 MB of int8 weight, ~1000 flop per byte, above the ~295 where
// the bf16 tensor cores bind. quant_matmul.cu's mma.sync tile of 64 x 64
// re-read x 224 times, built B fragments from 16-bit scalar loads and
// overlapped nothing (0.557 ms, ~110 TFLOP/s). The design:
//   * a block of three warpgroups owns a 128-column x BM-row output tile
//     (BM 64, 128 or 256, chosen with the split count by the wrapper);
//     warpgroup 2 is the producer: one thread keeps a ring of kStages
//     stages in flight, each an x tile (BM x 64 bf16) and a q tile
//     (64 x 128 int8), both loaded by TMA in the 128-byte swizzle and
//     completed on the stage's `full` mbarrier; the consumers release a
//     stage on its `empty` mbarrier (one arrival per consumer warp);
//   * the product runs transposed, out^T = q^T x^T: each consumer
//     warpgroup's 64 output columns are the M side of wgmma m64nBMk16, A
//     = q^T from registers (RS) and B = the x tile, K-major as TMA lays it.
//     int8 -> bf16 is exact and happens in registers on the way to the A
//     fragment (a byte placed in the float 2^23 + 128 + b, less 2^23 +
//     128, is b exactly, and its bf16 is the float's upper half), so the
//     dequantized weight never returns to shared memory: no generic-proxy
//     write for wgmma to see, and nothing shared between the consumers but
//     the ring. A thread's two A rows are mapped to adjacent columns n and
//     n + 1, so one 16-bit shared load gives both;
//   * a consumer converts A fragments, then runs their products (all four
//     k16 steps of a stage at once, or two at a time at BM 256, where the
//     accumulator leaves room for no more under the 168-register limit);
//     while one consumer converts, the other's products keep the tensor
//     cores busy, and the ring keeps kStages - 1 loads in flight;
//   * the flush scales each column by its fp32 scale and stores bf16
//     pairs (a thread's two rows are adjacent columns of one output row);
//   * when the output tiles leave the card short of blocks, K is split
//     over a third grid axis: each split writes its fp32 partial tile to a
//     workspace and `reduce_splits` sums them in a fixed order, applies
//     the scale and casts: deterministic, no atomics.
//
// The kernels launch on the caller's stream and allocate nothing; the C
// entry returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;       // K depth of a stage
constexpr int kBN = 128;      // output columns of a block (64 a consumer)
constexpr int kStages = 4;
constexpr int kThreads = 384;  // consumers: warpgroups 0-1; producer: 2

template <int BM>
struct Cfg {
  static constexpr int kXBytes = BM * kBK * 2;
  static constexpr int kWBytes = kBK * kBN;
  static constexpr int kStageBytes = kXBytes + kWBytes;  // 1024-multiple
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
};

// two int8 bytes i, j of w (already XORed with 0x80808080) -> bf16x2
// (low half byte i), exactly
__device__ __forceinline__ uint32_t i8x2_bf16x2(uint32_t w, int i, int j) {
  const float lo =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | j)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (BM == 256)
    wgmma_rs_n256<0>(d, a, db);
  else if constexpr (BM == 128)
    wgmma_rs_n128<0>(d, a, db);
  else
    wgmma_rs_n64<0>(d, a, db);
}

// grid (ceil(N / 128), ceil(M / BM), splits), kThreads threads. Split z
// covers K tiles [z * kt_per, min((z + 1) * kt_per, kt_total)), at least
// one. One split: out = cast(acc * scale); more: ws[z] = acc (fp32).
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
qmm_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ scale,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                int M, int N, int kt_total, int kt_per) {
  using C = Cfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * kt_per;
  const int nk = min(kt0 + kt_per, kt_total) - kt0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // ---------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * C::kStageBytes;
        mbar_arrive_expect_tx(&full[s], C::kStageBytes);
        const int k0 = (kt0 + i) * kBK;
        tma_load_2d(st, &xmap, &full[s], k0, m0);
        tma_load_2d(st + C::kXBytes, &wmap, &full[s], n0, k0);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's A rows g and g + 8 are the tile's columns nl, nl + 1
  const int nl = wg * 64 + warp * 16 + 2 * g;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  // The A fragments of kBatch k16 steps (4 registers each) are converted,
  // then multiplied. At BM 256 the 128 accumulator registers leave room
  // for two steps' (8) under the 168 registers a thread has when three
  // warps share an SM sub-partition; smaller tiles take the stage's four.
  constexpr int kBatch = BM == 256 ? 2 : 4;
  uint32_t a[4 * kBatch];
  // the thread reads q rows k = 16kk + 8h + 2t + {0, 1}: as k % 8 is
  // 2t + {0, 1}, their swizzled offsets are sw128(2t + {0, 1}, nl) plus
  // (16kk + 8h) * 128, a constant
  const int o0 = sw128(2 * t, nl), o1 = sw128(2 * t + 1, nl);

  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    const uint8_t* x = smem + s * C::kStageBytes;
    const uint8_t* w = x + C::kXBytes;
    // a k16 step moves the descriptor's start by 32 bytes (2 units)
    const uint64_t dx = desc_sw128(x, 16, 1024);
    mbar_wait(&full[s], (i / kStages) & 1);
#pragma unroll
    for (int k0 = 0; k0 < 4; k0 += kBatch) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint8_t* row = w + (16 * (k0 + j) + 8 * h) * 128;
          const uint32_t h0 = *reinterpret_cast<const uint16_t*>(row + o0);
          const uint32_t h1 = *reinterpret_cast<const uint16_t*>(row + o1);
          // bytes: q[k][nl], q[k][nl + 1], q[k + 1][nl], q[k + 1][nl + 1]
          const uint32_t u = __byte_perm(h0, h1, 0x5410) ^ 0x80808080u;
          a[4 * j + 2 * h] = i8x2_bf16x2(u, 0, 2);      // row g: column nl
          a[4 * j + 2 * h + 1] = i8x2_bf16x2(u, 1, 3);  // row g + 8: nl + 1
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        wgmma_rs<BM>(acc, a + 4 * j, dx + 2 * (k0 + j));
      wgmma_commit();
      wgmma_wait<0>();  // before `a` is rewritten
    }
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  fence_operand(acc);

  // flush: acc row g (h 0) / g + 8 (h 1) is column n + h, acc column
  // 8j + 2t + e is output row m0 + 8j + 2t + e
  const int n = n0 + nl;
  if (n >= N) return;  // N is a multiple of 16 and n even: n + 1 < N
  const bool partial = gridDim.z > 1;
  const float s0 = partial ? 1.f : scale[n], s1 = partial ? 1.f : scale[n + 1];
  float* wz = ws + static_cast<size_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m < M) {
        const size_t i = static_cast<size_t>(m) * N + n;
        const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        if (partial)
          *reinterpret_cast<float2*>(wz + i) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + i) =
              __floats2bfloat162_rn(v0 * s0, v1 * s1);
      }
    }
  }
}

// out[m, n] = cast((sum over z in order of ws[z, m, n]) * scale[n])
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ ws, const float* __restrict__ scale,
              __nv_bfloat16* __restrict__ out, int M, int N, int splits) {
  const size_t mn = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < mn; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[z * mn + i];
    out[i] = __float2bfloat16_rn(s * scale[i % N]);
  }
}

template <int BM>
cudaError_t launch(const void* x, const void* q, const float* scale,
                   __nv_bfloat16* out, float* ws, int M, int K, int N,
                   int splits, cudaStream_t s) {
  using C = Cfg<BM>;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {kBK, BM};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t wbox[2] = {kBN, kBK};
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride,
                xbox) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstride,
                wbox))
    return cudaErrorInvalidValue;
  const int kt_total = (K + kBK - 1) / kBK;
  const int kt_per = (kt_total + splits - 1) / splits;
  cudaError_t e = cudaFuncSetAttribute(
      qmm_sm90_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  qmm_sm90_kernel<BM><<<grid, kThreads, C::kSmem, s>>>(
      xmap, wmap, scale, out, ws, M, N, kt_total, kt_per);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t mn = static_cast<size_t>(M) * N;
  const int blocks =
      static_cast<int>(mn / 256 + 1 < 4096 ? mn / 256 + 1 : 4096);
  reduce_splits<<<blocks, 256, 0, s>>>(ws, scale, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, q (K, N) int8, scale (N,) fp32 -> out (M, N) bf16, with
// bm (64, 128 or 256) output rows a block and `splits` K splits (every
// split non-empty; ws a (splits, M, N) fp32 workspace when splits > 1,
// else unused). Refuses (cudaErrorInvalidValue) what TMA cannot address:
// K not a multiple of 8, N not a multiple of 16, a base not 16-byte
// aligned. Returns a cudaError_t: 0 when the launches succeeded.
extern "C" int quant_matmul_sm90(const void* x, const void* q,
                                 const void* scale, void* out, void* ws,
                                 int M, int K, int N, int bm, int splits,
                                 void* stream) {
  const int kt_total = (K + kBK - 1) / kBK;
  if (M <= 0 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      splits <= 0 || (splits > 1 && ws == nullptr) ||
      (kt_total + splits - 1) / splits * (splits - 1) >= kt_total ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(scale);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  float* wp = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bm == 256)
    e = launch<256>(x, q, sp, op, wp, M, K, N, splits, s);
  else if (bm == 128)
    e = launch<128>(x, q, sp, op, wp, M, K, N, splits, s);
  else if (bm == 64)
    e = launch<64>(x, q, sp, op, wp, M, K, N, splits, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
