// Flash attention backward for Hopper (sm_90a): dQ and dK/dV on wgmma over
// a TMA tile ring. Plain C interface.
//
// Replaces, for bf16 in the plain mode (causal or none) at head_dim <= 128,
// the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel` of
// paddle_tpu/kernels/flash_attention.py (the backward from the saved lse;
// delta = rowsum(dO * O) arrives precomputed, a plain op outside the
// kernels, as in the reference's `_bwd`). flash_attention.cu keeps fp32,
// head_dim > 128 and the segment and flashmask modes. Layout (B*H, S, D),
// contiguous; causal is bottom-right aligned: key j is visible to query i
// iff j <= i + (Sk - Sq). A masked probability is forced to exactly 0
// (never exp(-1e30 - lse)), so a query row that sees no key gives zero
// gradients, as the plain versions beside the wrapper give.
//
// Bound on this card: operations. At the training shape (B*H 32, S 4096,
// D 128, causal) dQ does 206 GFLOP (S = Q K^T, dP = dO V^T, dQ = dS K) and
// dK/dV 275 GFLOP (S^T, dP^T, dV = P^T dO, dK = dS^T Q) over 43-51 MB:
// about D/2 multiply-adds a byte, far above the ~295 flop/byte where the
// bf16 tensor cores bind. flash_attention.cu's versions ran mma.sync on
// fragments built from scalar shared loads, loaded synchronously, and
// passed P and dS through shared memory with a __syncthreads a tile (1.73
// and 2.12 ms, ~120-130 TFLOP/s). The design:
//   * two kernels, as on the TPU: dQ and dK/dV each own their output rows,
//     so no atomics are needed and the gradients are deterministic (two
//     launches give bitwise equal results);
//   * dQ: a block owns 128 query rows of one head (64 a consumer
//     warpgroup), loads Q and dO once and streams 64-key K and V tiles
//     through the ring. S = Q K^T and dP = dO V^T are wgmma m64n64k16 SS
//     (every operand K-major as stored); P = exp(S scale - lse) and
//     dS = P (dP - delta) scale run in registers on the accumulators, and
//     dS is rounded to bf16 there: the accumulator layout is the RS
//     A-fragment layout, so dQ += dS K is wgmma RS with K as the
//     transposed (MN-major) B operand and dS never goes through shared
//     memory. S and dP are committed apart, so P's exponentials run while
//     dP is still on the tensor cores. The loop stops at the causal
//     diagonal;
//   * dK/dV: a block owns 128 keys (64 a consumer warpgroup), loads K and
//     V once and streams 64-query Q and dO tiles, each with its lse or
//     delta (fp32, a 1-D TMA box), through the ring. S^T = K Q^T and
//     dP^T = V dO^T put the keys on the accumulators' rows, so P^T and
//     dS^T come out in the A-fragment layout: dV += P^T dO and
//     dK += dS^T Q are RS with dO and Q MN-major. lse and delta are per
//     query, a column of S^T: read from the stage in shared memory, not
//     held in registers. The loop starts at the first query tile that sees
//     the block's first key (the reference's predicate, transposed);
//   * the grid is (B*H, tiles) with the heaviest causal tiles first over
//     every head (the last query tiles in dQ, the first key tiles in
//     dK/dV), so the short blocks fill the tail;
//   * the ring: 3 stages; each tile's two halves (K and V, or Q + lse and
//     dO + delta) complete on their own mbarriers, so the first product
//     starts before the second half lands; the consumers free a stage on
//     its `empty` mbarrier (one arrival a consumer warp) once the product
//     that read it last has retired;
//   * registers, which set each kernel's shape. Three warps on each SM
//     sub-partition (384 threads: two consumer warpgroups and a producer)
//     cap a thread at 168, and ptxas (CUDA 12.9) compiles the consumer
//     path within 168 even after setmaxnreg.inc 232 in a strict if / else
//     of the two roles. dQ needs dQ 64 + S 32 + dP 32 + dS 16 at 64-key
//     tiles and fits with no spill: it keeps the forward's producer
//     warpgroup (without it, 0.67 ms against 0.46 at the training shape
//     on an H100). dK/dV needs dK 64 + dV 64 + S^T 32 + dP^T 32 + P^T
//     16 + dS^T 16: at 168 it spilled (696 bytes at D 128), so it runs two
//     consumer warpgroups alone (256 threads, up to 255 registers each;
//     236 used) and thread 0 issues the loads, refilling the stage the
//     previous tile released after issuing its own first two products
//     (issuing dV += P^T dO before dP^T retires, or refilling without
//     blocking on the other warpgroup, measured slower);
//   * edges: TMA zero-fills rows past S and columns past D (a tile's D is
//     laid out as 64-wide column blocks); only tiles that cross the causal
//     diagonal or the end of S evaluate the mask; nothing past S or D is
//     stored.
//
// The kernels launch on the caller's stream and allocate nothing; each C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBig = 128;    // rows a block owns: queries (dQ), keys (dK/dV)
constexpr int kSmall = 64;   // rows of a ring tile: keys (dQ), queries (dK/dV)
constexpr int kStages = 3;
constexpr int kConsumerWarps = 8;  // two consumer warpgroups

// DP: the head dim the tiles are laid out for (64 or 128; D <= DP).
template <int DP>
struct Cfg {
  static constexpr int kBlocks = DP / 64;  // 64-wide column blocks
  static constexpr int kBigBytes = kBig * DP * 2;
  static constexpr int kSmallBytes = kSmall * DP * 2;
  // descriptor units (16 bytes) between the column blocks of a tile
  static constexpr int kBigCb = kBig * 128 / 16;
  static constexpr int kSmallCb = kSmall * 128 / 16;
  static constexpr int kVecBytes = kSmall * 4;  // a tile's lse or delta
  static constexpr int kBars = 1 + 3 * kStages;
  static constexpr int smem(bool vecs) {
    return 2 * kBigBytes +
           kStages * (2 * kSmallBytes + (vecs ? 2 * kVecBytes : 0)) +
           kBars * 8 + 1024;
  }
};

// The block's two fixed tiles (Q and dO in dQ, K and V in dK/dV), the
// ring's two tiles a stage (K and V; Q and dO) with dK/dV's lse and delta,
// and the barriers: `fixed`, then full0 / full1 / empty a stage.
struct Smem {
  uint8_t *big0, *big1, *ring0, *ring1;
  float *vec0, *vec1;
  uint64_t *fixed, *full0, *full1, *empty;
};

template <int DP>
__device__ __forceinline__ Smem carve(uint8_t* raw, bool vecs) {
  using C = Cfg<DP>;
  Smem m;
  m.big0 = align1024(raw);
  m.big1 = m.big0 + C::kBigBytes;
  m.ring0 = m.big1 + C::kBigBytes;
  m.ring1 = m.ring0 + kStages * C::kSmallBytes;
  uint8_t* p = m.ring1 + kStages * C::kSmallBytes;
  m.vec0 = reinterpret_cast<float*>(p);
  m.vec1 = m.vec0 + kStages * kSmall;
  if (vecs) p += 2 * kStages * C::kVecBytes;
  m.fixed = reinterpret_cast<uint64_t*>(p);
  m.full0 = m.fixed + 1;
  m.full1 = m.full0 + kStages;
  m.empty = m.full1 + kStages;
  return m;
}

__device__ __forceinline__ void init_barriers(const Smem& m) {
  mbar_init(m.fixed, 1);
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&m.full0[s], 1);
    mbar_init(&m.full1[s], 1);
    mbar_init(&m.empty[s], kConsumerWarps);
  }
  mbar_fence_init();
}

// the block's fixed tiles: rows [row, row + 128) of head bh of both maps
template <int DP>
__device__ __forceinline__ void load_fixed(const Smem& m, const CUtensorMap* m0,
                                           const CUtensorMap* m1, int row,
                                           int bh) {
  using C = Cfg<DP>;
  mbar_arrive_expect_tx(m.fixed, 2 * C::kBigBytes);
  for (int c = 0; c < C::kBlocks; ++c) {
    tma_load_3d(m.big0 + c * kBig * 128, m0, m.fixed, 64 * c, row, bh);
    tma_load_3d(m.big1 + c * kBig * 128, m1, m.fixed, 64 * c, row, bh);
  }
}

// ring tile t: rows [row, row + 64) of head bh of both maps (with the fp32
// vectors at element vrow of v0 / v1 when kVecs) into stage t % kStages,
// once the stage's previous tile has been released
template <int DP, bool kVecs>
__device__ __forceinline__ void load_stage(const Smem& m, const CUtensorMap* m0,
                                           const CUtensorMap* m1,
                                           const CUtensorMap* v0,
                                           const CUtensorMap* v1, int t,
                                           int row, int bh, int vrow) {
  using C = Cfg<DP>;
  constexpr uint32_t kBytes = C::kSmallBytes + (kVecs ? C::kVecBytes : 0);
  const int s = t % kStages;
  mbar_wait(&m.empty[s], ((t / kStages) & 1) ^ 1);
  uint8_t* r0 = m.ring0 + s * C::kSmallBytes;
  uint8_t* r1 = m.ring1 + s * C::kSmallBytes;
  mbar_arrive_expect_tx(&m.full0[s], kBytes);
  for (int c = 0; c < C::kBlocks; ++c)
    tma_load_3d(r0 + c * kSmall * 128, m0, &m.full0[s], 64 * c, row, bh);
  if constexpr (kVecs) tma_load_1d(m.vec0 + s * kSmall, v0, &m.full0[s], vrow);
  mbar_arrive_expect_tx(&m.full1[s], kBytes);
  for (int c = 0; c < C::kBlocks; ++c)
    tma_load_3d(r1 + c * kSmall * 128, m1, &m.full1[s], 64 * c, row, bh);
  if constexpr (kVecs) tma_load_1d(m.vec1 + s * kSmall, v1, &m.full1[s], vrow);
}

// d = A B^T over the head dim (DP / 16 k16 steps): A the warpgroup's 64
// rows of a fixed tile, B a ring tile's 64 rows, both K-major. The first
// step only writes d. Descriptors move in 16-byte units: 32 bytes a k16
// step, a tile's rows of 128 bytes a column block.
template <int DP>
__device__ __forceinline__ void ss_product(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  using C = Cfg<DP>;
  wgmma_ss_n64<0, false>(d, da, db);
#pragma unroll
  for (int kk = 1; kk < DP / 16; ++kk)
    wgmma_ss_n64<0, true>(d, da + (kk / 4) * C::kBigCb + (kk % 4) * 2,
                          db + (kk / 4) * C::kSmallCb + (kk % 4) * 2);
}

// acc += A B over a ring tile's 64 rows (4 k16 steps of 16 rows): A in
// registers (bf16 pairs in the accumulator order of a 64 x 64 product), B
// the tile MN-major (leading offset: the distance between its column
// blocks; a k16 step is 16 rows of 128 bytes)
template <int DP>
__device__ __forceinline__ void rs_product(float (&acc)[DP / 2],
                                           const uint32_t (&a)[16],
                                           const uint8_t* b) {
  const uint64_t db = desc_sw128(b, kSmall * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (DP == 128)
      wgmma_rs_n128<1>(acc, a + 4 * kk, db + 128 * kk);
    else
      wgmma_rs_n64<1>(acc, a + 4 * kk, db + 128 * kk);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a thread's accumulator rows row0 and row0 + 8 (of `rows`) -> bf16 rows
// of `out` (row-major, D wide), columns past D dropped
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[DP / 2],
                                           int row0, int rows, int D, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)  // D is a multiple of 8, so col + 1 < D too
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * D +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) x[i] = 0.f;
}

// ------------------------------------------------------------------- dQ
// One consumer warpgroup's part of a dQ block: rows [qw, qw + 64) of the
// block's 128 at q0, over its n key tiles.
template <int DP>
__device__ __forceinline__ void dq_consumer(
    const Smem& m, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int D, float scale, int causal, int q0, int n, int bh, int wg) {
  using C = Cfg<DP>;
  const int off = Sk - Sq;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qw = q0 + wg * 64;          // this warpgroup's first row
  const int row0 = qw + warp * 16 + g;  // this thread's rows: +0, +8
  const float scale_log2 = scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const size_t r = static_cast<size_t>(bh) * Sq + row;
    lse2[h] = row < Sq ? lse[r] * kLog2e : 0.f;
    dlt[h] = row < Sq ? delta[r] : 0.f;
  }
  const uint64_t dq_a = desc_sw128(m.big0 + wg * 64 * 128, 16, 1024);
  const uint64_t ddo_a = desc_sw128(m.big1 + wg * 64 * 128, 16, 1024);
  float acc[DP / 2], sc[32], dp[32];
  uint32_t ds[16];
  zero(acc);

  if (n > 0) mbar_wait(m.fixed, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = it * kSmall;
    const uint8_t* kt = m.ring0 + s * C::kSmallBytes;
    const uint8_t* vt = m.ring1 + s * C::kSmallBytes;

    mbar_wait(&m.full0[s], par);
    wgmma_fence();
    ss_product<DP>(sc, dq_a, desc_sw128(kt, 16, 1024));  // S = Q K^T
    wgmma_commit();
    mbar_wait(&m.full1[s], par);
    ss_product<DP>(dp, ddo_a, desc_sw128(vt, 16, 1024));  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_operand(sc);

    // P on the accumulator while dP runs: rows row0 (h 0) and row0 + 8,
    // columns k0 + 8j + 2t4 + e
    const bool masked_tile =
        k0 + kSmall > Sk || (causal && k0 + kSmall - 1 > qw + off);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
          if (masked_tile) {
            const int col = k0 + 8 * j + 2 * t4 + e;
            if (col >= Sk || (causal && col > row0 + 8 * h + off)) p = 0.f;
          }
          sc[i] = p;
        }
    fence_operand(sc);
    wgmma_wait<0>();
    fence_operand(dp);
    // dS in bf16 pairs in accumulator order
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        ds[2 * j + h] =
            pack_bf16(sc[i] * (dp[i] - dlt[h]) * scale,
                      sc[i + 1] * (dp[i + 1] - dlt[h]) * scale);
      }

    wgmma_fence();
    rs_product<DP>(acc, ds, kt);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    if (lane == 0) mbar_arrive(&m.empty[s]);
  }
  store_rows<DP>(dq + static_cast<size_t>(bh) * Sq * D, acc, row0, Sq, D, t4);
}

// grid (B*H, ceil(Sq / 128)), 384 threads: warpgroup 2 is the producer
// and gives its registers to the consumers; the two roles split in one
// if / else and never join.
template <int DP>
__global__ void __launch_bounds__(384, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int D,
                     float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<DP>(smem_raw, false);
  const int bh = blockIdx.x;
  const int nq = (Sq + kBig - 1) / kBig;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBig;
  // key tiles this block visits: all, or under causal those that start at
  // or before its last row's diagonal
  const int last = q0 + kBig - 1 + Sk - Sq;
  const int nk_all = (Sk + kSmall - 1) / kSmall;
  const int n =
      !causal ? nk_all : (last < 0 ? 0 : min(nk_all, last / kSmall + 1));

  if (threadIdx.x == 0) init_barriers(m);
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // -------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256 && n > 0) {
      load_fixed<DP>(m, &qmap, &domap, q0, bh);
      for (int t = 0; t < n; ++t)
        load_stage<DP, false>(m, &kmap, &vmap, nullptr, nullptr, t,
                              t * kSmall, bh, 0);
    }
  } else {  // ------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    dq_consumer<DP>(m, lse, delta, dq, Sq, Sk, D, scale, causal, q0, n, bh,
                    wg);
  }
}

// ---------------------------------------------------------------- dK/dV
// the ring tiles of a dK/dV block: the 64 query rows of tile qt0 + t, with
// their lse and delta, into stage t % kStages
template <int DP>
__device__ __forceinline__ void load_query_tile(
    const Smem& m, const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* lsemap, const CUtensorMap* deltamap, int t, int qt0,
    int bh, int Sq) {
  const int q0 = (qt0 + t) * kSmall;
  load_stage<DP, true>(m, qmap, domap, lsemap, deltamap, t, q0, bh,
                       bh * Sq + q0);
}

// One consumer warpgroup's part of a dK/dV block: keys [kw, kw + 64) of
// the block's 128 at k0, over its n query tiles from qt0. Thread 0 refills
// each stage the previous tile released.
template <int DP>
__device__ __forceinline__ void dkv_consumer(
    const Smem& m, const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* lsemap, const CUtensorMap* deltamap,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
    int Sk, int D, float scale, int causal, int k0, int qt0, int n, int bh,
    int wg) {
  using C = Cfg<DP>;
  const int off = Sk - Sq;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = k0 + wg * 64;          // this warpgroup's first key
  const int key0 = kw + warp * 16 + g;  // this thread's keys: +0, +8
  const float scale_log2 = scale * kLog2e;
  const uint64_t dk_a = desc_sw128(m.big0 + wg * 64 * 128, 16, 1024);
  const uint64_t dv_a = desc_sw128(m.big1 + wg * 64 * 128, 16, 1024);
  float acc_k[DP / 2], acc_v[DP / 2], sc[32], dp[32];
  uint32_t pt[16], ds[16];
  zero(acc_k);
  zero(acc_v);

  if (n > 0) mbar_wait(m.fixed, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int q0 = (qt0 + it) * kSmall;
    const uint8_t* qt = m.ring0 + s * C::kSmallBytes;
    const uint8_t* dot = m.ring1 + s * C::kSmallBytes;
    const float* lse_s = m.vec0 + s * kSmall;
    const float* dl_s = m.vec1 + s * kSmall;

    mbar_wait(&m.full0[s], par);
    wgmma_fence();
    ss_product<DP>(sc, dk_a, desc_sw128(qt, 16, 1024));  // S^T = K Q^T
    wgmma_commit();
    mbar_wait(&m.full1[s], par);
    ss_product<DP>(dp, dv_a, desc_sw128(dot, 16, 1024));  // dP^T = V dO^T
    wgmma_commit();
    if (threadIdx.x == 0 && it > 0 && it - 1 + kStages < n)
      load_query_tile<DP>(m, qmap, domap, lsemap, deltamap, it - 1 + kStages,
                          qt0, bh, Sq);
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);

    // P^T and dS^T on the accumulators: rows (keys) key0 (h 0) and
    // key0 + 8, columns (queries) q0 + 8j + 2t4 + e; both in bf16 pairs in
    // accumulator order
    const bool masked_tile =
        q0 + kSmall > Sq || (causal && kw + kSmall - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 dl = *reinterpret_cast<const float2*>(dl_s + c);
      const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
      const float dlt[2] = {dl.x, dl.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p2[2], d2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          float p = exp2f(fmaf(sc[i], scale_log2, -l2[e]));
          if (masked_tile) {
            const int q = q0 + c + e;
            if (q >= Sq || (causal && key0 + 8 * h > q + off)) p = 0.f;
          }
          p2[e] = p;
          d2[e] = p * (dp[i] - dlt[e]) * scale;
        }
        pt[2 * j + h] = pack_bf16(p2[0], p2[1]);
        ds[2 * j + h] = pack_bf16(d2[0], d2[1]);
      }
    }

    wgmma_fence();
    rs_product<DP>(acc_v, pt, dot);  // dV += P^T dO
    rs_product<DP>(acc_k, ds, qt);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc_v);
    fence_operand(acc_k);
    if (lane == 0) mbar_arrive(&m.empty[s]);
  }
  const size_t base = static_cast<size_t>(bh) * Sk * D;
  store_rows<DP>(dk + base, acc_k, key0, Sk, D, t4);
  store_rows<DP>(dv + base, acc_v, key0, Sk, D, t4);
}

// grid (B*H, ceil(Sk / 128)), 256 threads: no producer warpgroup (see the
// registers above); thread 0 issues the loads between its own products.
template <int DP>
__global__ void __launch_bounds__(256, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap lsemap,
                      const __grid_constant__ CUtensorMap deltamap,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int D,
                      float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  const Smem m = carve<DP>(smem_raw, true);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBig;
  // query tiles that see the block's first key: all, or under causal
  // those whose last row's diagonal reaches k0
  const int nq_all = (Sq + kSmall - 1) / kSmall;
  const int first = k0 - (Sk - Sq) - (kSmall - 1);
  const int qt0 = !causal || first <= 0 ? 0 : (first + kSmall - 1) / kSmall;
  const int n = max(0, nq_all - qt0);

  if (threadIdx.x == 0) init_barriers(m);
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    load_fixed<DP>(m, &kmap, &vmap, k0, bh);
    for (int t = 0; t < min(n, kStages); ++t)
      load_query_tile<DP>(m, &qmap, &domap, &lsemap, &deltamap, t, qt0, bh,
                          Sq);
  }
  dkv_consumer<DP>(m, &qmap, &domap, &lsemap, &deltamap, dk, dv, Sq, Sk, D,
                   scale, causal, k0, qt0, n, bh, threadIdx.x >> 7);
}

// ------------------------------------------------------------- launches
// the 3-D map of a (BH, S, D) bf16 tensor in boxes of 64 columns x `rows`
bool map_rows(CUtensorMap* map, const void* base, int BH, int S, int D,
              int rows) {
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t str[2] = {static_cast<cuuint64_t>(D) * 2,
                             static_cast<cuuint64_t>(S) * D * 2};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, str,
                  box);
}

// the 1-D map of BH * Sq fp32 values in boxes of 64, as stored (a box that
// runs past a head's rows reads the next head's, which the kernel masks)
bool map_vec(CUtensorMap* map, const void* base, int n) {
  const cuuint32_t box[1] = {kSmall};
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t str[1] = {4};  // unused at rank 1
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, str,
                  box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int Sq, int Sk, int D, float scale,
                      int causal, cudaStream_t s) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!map_rows(&qmap, q, BH, Sq, D, kBig) ||
      !map_rows(&domap, dout, BH, Sq, D, kBig) ||
      !map_rows(&kmap, k, BH, Sk, D, kSmall) ||
      !map_rows(&vmap, v, BH, Sk, D, kSmall))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Cfg<DP>::smem(false);
  auto kernel = flash_dq_sm90_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Sq + kBig - 1) / kBig);
  kernel<<<grid, 384, kSmem, s>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Sq,
      Sk, D, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Sq, int Sk, int D,
                       float scale, int causal, cudaStream_t s) {
  CUtensorMap qmap, kmap, vmap, domap, lsemap, deltamap;
  if (!map_rows(&kmap, k, BH, Sk, D, kBig) ||
      !map_rows(&vmap, v, BH, Sk, D, kBig) ||
      !map_rows(&qmap, q, BH, Sq, D, kSmall) ||
      !map_rows(&domap, dout, BH, Sq, D, kSmall) ||
      !map_vec(&lsemap, lse, BH * Sq) || !map_vec(&deltamap, delta, BH * Sq))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Cfg<DP>::smem(true);
  auto kernel = flash_dkv_sm90_kernel<DP>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Sk + kBig - 1) / kBig);
  kernel<<<grid, 256, kSmem, s>>>(
      qmap, kmap, vmap, domap, lsemap, deltamap,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Sk, D, scale, causal);
  return cudaGetLastError();
}

// what both entries take: D a multiple of 8 up to 128, B*H <= 65535, the
// tile rows within the grid's y limit, B*H*Sq addressable by the 1-D map,
// 16-byte aligned inputs
bool refuse(const void* const* ptrs, int n, int BH, int Sq, int Sk, int D) {
  if (BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || (Sq + kBig - 1) / kBig > 65535 ||
      (Sk + kBig - 1) / kBig > 65535 ||
      static_cast<long long>(BH) * Sq >= (1ll << 31))
    return true;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return true;
  return false;
}

}  // namespace

// q/dout/dq (BH, Sq, D), k/v/dk/dv (BH, Sk, D) bf16, contiguous, 16-byte
// aligned; lse and delta (BH, Sq) fp32. Refuses (cudaErrorInvalidValue) D
// > 128 or not a multiple of 8, BH > 65535, BH * Sq >= 2^31, unaligned
// inputs. Each returns a cudaError_t: 0 on a successful launch.
extern "C" int flash_attention_dq_sm90(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, int BH, int Sq, int Sk,
                                       int D, float scale, int causal,
                                       void* stream) {
  const void* in[6] = {q, k, v, dout, lse, delta};
  if (refuse(in, 6, BH, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D <= 64 ? launch_dq<64>(q, k, v, dout, lse, delta, dq, BH, Sq, Sk, D,
                              scale, causal, s)
              : launch_dq<128>(q, k, v, dout, lse, delta, dq, BH, Sq, Sk, D,
                               scale, causal, s);
  return static_cast<int>(e);
}

extern "C" int flash_attention_dkv_sm90(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dk, void* dv, int BH, int Sq,
                                        int Sk, int D, float scale,
                                        int causal, void* stream) {
  const void* in[6] = {q, k, v, dout, lse, delta};
  if (refuse(in, 6, BH, Sq, Sk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D <= 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk,
                               D, scale, causal, s)
              : launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, Sq,
                                Sk, D, scale, causal, s);
  return static_cast<int>(e);
}
