// Weight-only int8 dequant-matmul at decode rows (M <= 16) for Hopper
// (sm_90a): one balanced launch streaming the weight through a TMA ring.
// Plain C interface.
//
// Replaces, for bf16 x of at most 16 rows, the Pallas TPU kernel `_kernel`
// of paddle_tpu/kernels/quant_matmul.py (driven by `quant_matmul`):
//   out[m, n] = bf16((sum_k x[m, k] * q[k, n]) * scale[n])
// x (M, K) bf16, q (K, N) int8 row-major, scale (N,) fp32, out (M, N)
// bf16; fp32 accumulation, the per-column scale once at the flush, as on
// the TPU. TMA addresses the operands, so K must be a multiple of 8 (x's
// row stride a multiple of 16 bytes), N a multiple of 16 (q's) and both
// bases 16-byte aligned; the wrapper's route sends fp32 x and every other
// shape at M <= 16 to quant_matmul.cu.
//
// Bound on this card: bytes. Serving runs it at the decode batch bucket
// (M 16) over the MLP's and the LM head's weights, and at M 1 for the
// head's row at the end of each prefill chunk: ~2 M = 32 flops per weight
// byte, far below the ~295 where the bf16 tensor cores bind. At gate/up
// (16, 4096, 14336) the 58.7 MB of int8 weight take 17.5 us at 3.35 TB/s,
// which leaves 25 KB of bytes in flight per SM at ~1 us of latency. The
// design:
//   * work units of 64 K rows x 256 output columns (16 KB of weight),
//     ordered column tile by column tile, K inside; the grid is one CTA
//     an SM (no more than there are units) and CTA i takes the contiguous
//     run of units [i * U / G, (i + 1) * U / G) (shares differ by at most
//     one unit; `quant_decode_split` is the rule in Python). A run may
//     start or end inside a column tile: a column tile covered by one CTA
//     is flushed by it; one shared by several is merged in the same
//     launch — each CTA writes its fp32 partial to a workspace slot and
//     draws a ticket from the tile's counter (__threadfence first); the
//     CTA that draws the last ticket sums the partials in K order (CTA
//     order), applies the scale, stores, and resets the counter to 0 for
//     the next launch. No float atomics and no second launch: repeated
//     launches are bitwise equal;
//   * a producer warp keeps a ring of kStages units in flight (64 KB of
//     weight an SM), each stage the unit's weight as two 128-column boxes
//     and the matching x slice (64 K columns x 8 or 16 rows of x; rows
//     beyond M arrive as zeros and are never stored), all by TMA in the
//     128-byte swizzle, completed on the stage's `full` mbarrier; the 8
//     consumer warps release it on its `empty` mbarrier;
//   * the product runs transposed, out^T = q^T x^T, on mma.sync
//     m16n8k16: output columns are the MMA's M side, the <= 16 rows of x
//     its N side (one n8 tile at M <= 8, two above). Consumer warp w owns
//     the unit's columns 32w..32w+31 over all 64 K rows, so its sums are
//     whole for the unit and a tile's flush needs no exchange between
//     warps; lane (g, t) reads the 4 bytes of columns 32w + 4g..+3 at its
//     four K rows of each k16 step (2t, 2t + 1, 2t + 8, 2t + 9) with one
//     32-bit shared load each (the swizzle puts a warp load's four rows
//     on distinct banks), and its A rows g and g + 8 of MMA j (0, 1) are
//     columns 32w + 4g + 2j and + 1. int8 -> bf16 is exact and happens in
//     registers (a byte placed in the float 2^23 + 128 + b, less 2^23 +
//     128, is b exactly, and its bf16 is the float's upper half): the
//     weight never returns to shared memory;
//   * the flush scales each column and stores a lane's four adjacent
//     columns of a row at once, once per output element.
//
// The kernel launches on the caller's stream and allocates nothing: the
// workspace (2 slots a CTA) and the ticket counters (one per 256-column
// tile, zero before the first launch) are the caller's. The C entry
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;        // K rows of a work unit (one ring stage)
constexpr int kBN = 256;       // output columns of a work unit
constexpr int kBox = 128;      // columns of a weight box (the swizzle width)
constexpr int kStages = 4;
constexpr int kConsumers = 8;  // warps, 32 columns each
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kWBytes = kBK * kBN;
constexpr int kSumThreads = 32 * kConsumers;
constexpr int kBatch = 4;      // partials the merge loads at a time

// kN8: n8 tiles of x rows (1: M <= 8, 2: M <= 16)
template <int kN8>
struct Cfg {
  static constexpr int kXBytes = 8 * kN8 * kBK * 2;
  static constexpr int kStageBytes = kWBytes + kXBytes;  // 1024-multiple
  static constexpr int kAcc = 8 * kN8;  // a consumer thread's sums
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 16 +
                               1024;
};

// The balanced split of U units over G CTAs: the first U % G CTAs take
// one unit more than the others, each a contiguous run.
struct Split {
  int base, rem;
  __device__ __forceinline__ int start(int i) const {
    return i * base + min(i, rem);
  }
  __device__ __forceinline__ int owner(int u) const {
    const int big = rem * (base + 1);
    return u < big ? u / (base + 1) : rem + (u - big) / base;
  }
};

// brings a kernel parameter's tensor map into the cache ahead of its
// first TMA load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// the consumer warps' own barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kSumThreads) : "memory");
}

// byte i of p and of q (int8 values already XORed with 0x80) -> bf16x2,
// p's in the low half; exact
__device__ __forceinline__ uint32_t bf16x2_of(uint32_t p, uint32_t q, int i) {
  const float lo =
      __uint_as_float(__byte_perm(p, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One consumer warp's share of a stage: its 32 columns over the 64 K
// rows. acc[h][j] is MMA j's accumulator for x rows 8h..8h+7: with lane
// (g, t), acc[h][j][e] is out[8h + 2t + (e & 1)][column 4g + 2j + (e >> 1)
// of the warp's 32].
template <int kN8>
__device__ __forceinline__ void mma_stage(float (&acc)[kN8][2][4],
                                          const uint8_t* st, int warp, int g,
                                          int t) {
  // the warp's box and its columns' byte offset in a 128-byte box row
  const uint8_t* w = st + (warp / 4) * (kBK * kBox);
  const int cb = 32 * (warp % 4) + 4 * g;
  const uint8_t* xs = st + kWBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int r = 16 * kk + 2 * t;
    const uint32_t p = *reinterpret_cast<const uint32_t*>(w + sw128(r, cb));
    const uint32_t q =
        *reinterpret_cast<const uint32_t*>(w + sw128(r + 1, cb));
    const uint32_t u =
        *reinterpret_cast<const uint32_t*>(w + sw128(r + 8, cb));
    const uint32_t v =
        *reinterpret_cast<const uint32_t*>(w + sw128(r + 9, cb));
    uint32_t b[kN8][2];
#pragma unroll
    for (int h = 0; h < kN8; ++h) {
      b[h][0] = *reinterpret_cast<const uint32_t*>(
          xs + sw128(8 * h + g, 32 * kk + 4 * t));
      b[h][1] = *reinterpret_cast<const uint32_t*>(
          xs + sw128(8 * h + g, 32 * kk + 16 + 4 * t));
    }
    const uint32_t p8 = p ^ 0x80808080u, q8 = q ^ 0x80808080u;
    const uint32_t u8 = u ^ 0x80808080u, v8 = v ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // A rows g and g + 8 are bytes 2j and 2j + 1 (columns 4g + 2j, + 1)
      const uint32_t a[4] = {bf16x2_of(p8, q8, 2 * j),
                             bf16x2_of(p8, q8, 2 * j + 1),
                             bf16x2_of(u8, v8, 2 * j),
                             bf16x2_of(u8, v8, 2 * j + 1)};
#pragma unroll
      for (int h = 0; h < kN8; ++h) mma16816(acc[h][j], a, b[h][0], b[h][1]);
    }
  }
}

// A consumer thread's sums v (acc flattened: [h][j][e]) -> bf16(v *
// scale) at out; its columns n..n+3 (n = the warp's first column + 4g)
template <int kN8>
__device__ __forceinline__ void store_out(const float* v,
                                          const float* __restrict__ scale,
                                          __nv_bfloat16* __restrict__ out,
                                          int M, int N, int n, int t) {
  if (n >= N) return;  // N is a multiple of 16 and n of 4: n + 3 < N
  const float s0 = scale[n], s1 = scale[n + 1];
  const float s2 = scale[n + 2], s3 = scale[n + 3];
#pragma unroll
  for (int h = 0; h < kN8; ++h) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * h + 2 * t + e;
      if (m < M) {
        const float* a = v + 8 * h;  // [j][e']: column 2j + (e' >> 1)
        const __nv_bfloat162 lo = __floats2bfloat162_rn(a[e] * s0,
                                                        a[2 + e] * s1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a[4 + e] * s2,
                                                        a[6 + e] * s3);
        *reinterpret_cast<uint2*>(out + static_cast<size_t>(m) * N + n) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

// grid (G), kThreads threads; G <= units = tiles * kt_total.
template <int kN8>
__global__ void __launch_bounds__(kThreads, 1)
qmm_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ tickets, int M, int N, int kt_total,
                  int units) {
  using C = Cfg<kN8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * C::kStageBytes);
  uint64_t* empty = full + kStages;
  int* s_last = reinterpret_cast<int*>(empty + kStages);
  const Split sp{units / static_cast<int>(gridDim.x),
                 units % static_cast<int>(gridDim.x)};
  const int cta = blockIdx.x;
  const int u0 = sp.start(cta), u1 = sp.start(cta + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == kConsumers) {  // ------------------------------- producer
    if (lane == 0) {
      prefetch_map(&wmap);
      prefetch_map(&xmap);
      for (int u = u0, i = 0; u < u1; ++u, ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * C::kStageBytes;
        mbar_arrive_expect_tx(&full[s], C::kStageBytes);
        const int tile = u / kt_total, k0 = (u - tile * kt_total) * kBK;
        tma_load_2d(st, &wmap, &full[s], tile * kBN, k0);
        tma_load_2d(st + kBK * kBox, &wmap, &full[s], tile * kBN + kBox, k0);
        tma_load_2d(st + kWBytes, &xmap, &full[s], k0, 0);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x;
  float acc[kN8][2][4];
  int i = 0;
  for (int u = u0; u < u1;) {
    const int tile = u / kt_total;
    const int ka = u - tile * kt_total;
    const int seg_end = min(u1, (tile + 1) * kt_total);
    const bool whole = ka == 0 && seg_end == (tile + 1) * kt_total;
#pragma unroll
    for (int h = 0; h < kN8; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.f;
    for (; u < seg_end; ++u, ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* st = smem + s * C::kStageBytes;
      mma_stage<kN8>(acc, st, warp, g, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float* v = &acc[0][0][0];
    const int n = tile * kBN + 32 * warp + 4 * g;
    if (whole) {
      store_out<kN8>(v, scale, out, M, N, n, t);
      continue;
    }
    // shared tile: this CTA's partial to its slot (0: its first tile,
    // 1: its last), then a ticket; the last to draw one merges
    const int first = sp.owner(tile * kt_total);
    const int last = sp.owner((tile + 1) * kt_total - 1);
    const int slot = u0 / kt_total == tile ? 0 : 1;
    float* mine = ws + (static_cast<size_t>(cta * 2 + slot) * kSumThreads +
                        tid) * C::kAcc;
#pragma unroll
    for (int r = 0; r < C::kAcc; r += 4)
      *reinterpret_cast<float4*>(mine + r) =
          make_float4(v[r], v[r + 1], v[r + 2], v[r + 3]);
    __threadfence();
    consumers_sync();
    if (tid == 0) {
      const int ticket = atomicAdd(&tickets[tile], 1);
      *s_last = ticket == last - first;
      if (*s_last) tickets[tile] = 0;  // every part has drawn
    }
    consumers_sync();
    if (!*s_last) continue;
    __threadfence();
    // the parts in K order (CTA order), kBatch at a time: their loads
    // all in flight before the adds
    const int parts = last - first + 1;
    float sum[C::kAcc];
#pragma unroll
    for (int r = 0; r < C::kAcc; ++r) sum[r] = 0.f;
    for (int b0 = 0; b0 < parts; b0 += kBatch) {
      float4 part[kBatch][C::kAcc / 4];
#pragma unroll
      for (int b = 0; b < kBatch && b0 + b < parts; ++b) {
        const int j = first + b0 + b;
        const int sl = sp.start(j) / kt_total == tile ? 0 : 1;
        const float4* src = reinterpret_cast<const float4*>(
            ws + (static_cast<size_t>(j * 2 + sl) * kSumThreads + tid) *
                     C::kAcc);
#pragma unroll
        for (int r = 0; r < C::kAcc / 4; ++r)
          part[b][r] = j == cta ? make_float4(v[4 * r], v[4 * r + 1],
                                              v[4 * r + 2], v[4 * r + 3])
                                : __ldcg(src + r);
      }
#pragma unroll
      for (int b = 0; b < kBatch && b0 + b < parts; ++b) {
#pragma unroll
        for (int r = 0; r < C::kAcc / 4; ++r) {
          sum[4 * r] += part[b][r].x;
          sum[4 * r + 1] += part[b][r].y;
          sum[4 * r + 2] += part[b][r].z;
          sum[4 * r + 3] += part[b][r].w;
        }
      }
    }
    store_out<kN8>(sum, scale, out, M, N, n, t);
  }
}

template <int kN8>
cudaError_t launch(const void* x, const void* q, const float* scale,
                   __nv_bfloat16* out, float* ws, int* tickets, int M, int K,
                   int N, int ctas, int units, cudaStream_t s) {
  using C = Cfg<kN8>;
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {kBK, 8 * kN8};
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(N),
                               static_cast<cuuint64_t>(K)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(N)};
  const cuuint32_t wbox[2] = {kBox, kBK};
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride,
                xbox) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstride,
                wbox))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      qmm_decode_kernel<kN8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return e;
  qmm_decode_kernel<kN8><<<ctas, kThreads, C::kSmem, s>>>(
      xmap, wmap, scale, out, ws, tickets, M, N, (K + kBK - 1) / kBK, units);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 with 1 <= M <= 16, q (K, N) int8, scale (N,) fp32 -> out
// (M, N) bf16 over `ctas` CTAs (1 <= ctas <= the work units, ceil(N /
// 256) * ceil(K / 64)). ws: ctas * 2 * 4096 fp32 (a launch reads back all
// it writes, so launches in one stream's order may share it); tickets:
// ceil(N / 256) int32 counters that are 0 (each launch leaves them 0).
// Refuses (cudaErrorInvalidValue) what TMA cannot address: K not a
// multiple of 8, N not a multiple of 16, a base not 16-byte aligned.
// Returns a cudaError_t: 0 when the launch succeeded.
extern "C" int quant_decode_sm90(const void* x, const void* q,
                                 const void* scale, void* out, void* ws,
                                 void* tickets, int M, int K, int N, int ctas,
                                 void* stream) {
  const long long units = static_cast<long long>((N + kBN - 1) / kBN) *
                          ((K + kBK - 1) / kBK);
  if (M <= 0 || M > 16 || K <= 0 || N <= 0 || K % 8 != 0 || N % 16 != 0 ||
      ctas <= 0 || ctas > units || units >= (1LL << 31) || ws == nullptr ||
      tickets == nullptr || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(scale);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  float* wp = static_cast<float*>(ws);
  int* tp = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int u = static_cast<int>(units);
  const cudaError_t e =
      M <= 8 ? launch<1>(x, q, sp, op, wp, tp, M, K, N, ctas, u, s)
             : launch<2>(x, q, sp, op, wp, tp, M, K, N, ctas, u, s);
  return static_cast<int>(e);
}
