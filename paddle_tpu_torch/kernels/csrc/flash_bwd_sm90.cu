// Flash attention backward for Hopper (sm_90a): dQ and dK/dV on wgmma over
// a TMA tile ring. Plain C interface.
//
// Replaces, for bf16 at head_dim <= 128 in every mask mode, the Pallas TPU
// kernels `_dq_kernel` and `_dkv_kernel` of
// paddle_tpu/kernels/flash_attention.py (the backward from the saved lse;
// delta = rowsum(dO * O) arrives precomputed, a plain op outside the
// kernels, as in the reference's `_bwd`). flash_attention.cu keeps fp32
// and head_dim > 128 (and every masked forward). Layout (B*H, S, D),
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
// The segment and flashmask modes (`kMode`, a template parameter, as in
// flash_attention.cu; the plain instantiations keep their contiguous
// causal range, grid order and registers) keep the block's shape and the
// ring. What changes is which ring tiles a block walks and the mask:
//   * the walk (flash_walk.cuh, shared with the masked forward of
//     flash_fwd_sm90.cu): before the roles split, every warp of the block
//     evaluates the reference's `_block_contributes` (flash_mask.cuh, over
//     the wrapper's per-32-row summaries) for 32 ring tiles at once, one lane
//     a tile, for each warpgroup's 64 fixed rows, and keeps the ballots in
//     shared memory: a word a warpgroup and group of 32 tiles (8 bytes a
//     group: every length the grid takes fits). The ring carries, in
//     ascending order, the tiles at least one warpgroup computes; the
//     loading thread walks the words and writes each stage's tile and the
//     two warpgroups' bits beside it, so the consumers read them with the
//     stage. A warpgroup whose pair does not contribute skips its
//     products but still waits on the stage and frees it. `visits` gains
//     the pairs the warpgroups compute (the 64 x 64 pairs of
//     `flash_visits_ref`);
//   * the mask, on the accumulators in registers: each thread's two fixed
//     rows keep their segment (id, position); the ring tile's (dQ: the
//     keys' (id, position) or their C flashmask bound rows; dK/dV: the
//     queries' (id, position)) travel in its stage as 1-D TMA boxes of 64
//     int32 over the flattened tensors, and dK/dV's key bounds (C rows of
//     128) load once with K and V. A box must start 16-byte aligned, so
//     the wrapper pads each of those rows (and dK/dV's lse and delta) to a
//     multiple of 4 elements when S is not one (`row4`). Each score is
//     tested without a branch (flashmask bounds as two row bands), and a
//     pair the summaries show to be whole (one segment on both sides with
//     every key at or before every query; or, for C == 1 causal bounds,
//     every row before the tile's smallest start and the causal bound
//     clear) skips the test. A masked probability is exactly 0, so a
//     query that sees no key gets dQ 0 and a key no query sees dK = dV =
//     0.
//
// The kernels launch on the caller's stream and allocate nothing; each C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_mask.cuh"
#include "flash_walk.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using namespace flash_mask;

constexpr float kLog2e = 1.4426950408889634f;
// rows a block owns: queries (dQ), keys (dK/dV); rows of a ring tile:
// keys (dQ), queries (dK/dV)
constexpr int kBig = kFixedRows;
constexpr int kSmall = kRingRows;
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
  // the masked modes add the walk's region after the barriers
  // (flash_walk.cuh)
  static constexpr int smem_masked(bool vecs, int groups) {
    return smem(vecs) + walk_bytes(kStages, groups);
  }
};

// The block's two fixed tiles (Q and dO in dQ, K and V in dK/dV), the
// ring's two tiles a stage (K and V; Q and dO) with dK/dV's lse and delta,
// and the barriers: `fixed`, then full0 / full1 / empty a stage; in the
// masked modes the walk's region after them (`Walk`, flash_walk.cuh).
struct Smem : Walk {
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

// The masked modes' int rows of a stage or of the block: n rows of the
// 1-D int32 map, the first at element c0, each `stride` past the last.
struct Rows {
  const CUtensorMap* map = nullptr;
  int c0 = 0, n = 0, stride = 0;
};

// the block's fixed tiles: rows [row, row + 128) of head bh of both maps
// (and, in the masked modes, `kr`'s rows of 128 into kfm)
template <int DP, int kMode = kPlain>
__device__ __forceinline__ void load_fixed(const Smem& m, const CUtensorMap* m0,
                                           const CUtensorMap* m1, int row,
                                           int bh, const Rows& kr = Rows{}) {
  using C = Cfg<DP>;
  uint32_t bytes = 2 * C::kBigBytes;
  if constexpr (kMode != kPlain) bytes += kr.n * kBig * 4;
  mbar_arrive_expect_tx(m.fixed, bytes);
  for (int c = 0; c < C::kBlocks; ++c) {
    tma_load_3d(m.big0 + c * kBig * 128, m0, m.fixed, 64 * c, row, bh);
    tma_load_3d(m.big1 + c * kBig * 128, m1, m.fixed, 64 * c, row, bh);
  }
  if constexpr (kMode != kPlain)
    for (int i = 0; i < kr.n; ++i)
      tma_load_1d(m.kfm + i * kBig, kr.map, m.fixed, kr.c0 + i * kr.stride);
}

// ring tile t: rows [row, row + 64) of head bh of both maps (with the fp32
// vectors at element vrow of v0 / v1 when kVecs) into stage t % kStages,
// once the stage's previous tile has been released; in the masked modes
// also `ir`'s rows of 64 (with the first half) and the stage's word
template <int DP, bool kVecs, int kMode = kPlain>
__device__ __forceinline__ void load_stage(const Smem& m, const CUtensorMap* m0,
                                           const CUtensorMap* m1,
                                           const CUtensorMap* v0,
                                           const CUtensorMap* v1, int t,
                                           int row, int bh, int vrow,
                                           const Rows& ir = Rows{},
                                           int word = 0) {
  using C = Cfg<DP>;
  constexpr uint32_t kBytes = C::kSmallBytes + (kVecs ? C::kVecBytes : 0);
  const int s = t % kStages;
  mbar_wait(&m.empty[s], ((t / kStages) & 1) ^ 1);
  uint8_t* r0 = m.ring0 + s * C::kSmallBytes;
  uint8_t* r1 = m.ring1 + s * C::kSmallBytes;
  uint32_t bytes0 = kBytes;
  if constexpr (kMode != kPlain) {
    m.word[s] = word;  // released to the consumers by the arrive below
    bytes0 += ir.n * kSmall * 4;
  }
  mbar_arrive_expect_tx(&m.full0[s], bytes0);
  for (int c = 0; c < C::kBlocks; ++c)
    tma_load_3d(r0 + c * kSmall * 128, m0, &m.full0[s], 64 * c, row, bh);
  if constexpr (kVecs) tma_load_1d(m.vec0 + s * kSmall, v0, &m.full0[s], vrow);
  if constexpr (kMode != kPlain)
    for (int i = 0; i < ir.n; ++i)
      tma_load_1d(m.ivec + s * kIvec + i * kSmall, ir.map, &m.full0[s],
                  ir.c0 + i * ir.stride);
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
// block's 128 at q0, over its n key tiles (the masked modes: the n ring
// tiles of the list, each named by its stage's word).
template <int DP, int kMode>
__device__ __forceinline__ void dq_consumer(
    const Smem& m, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int D, float scale, int causal, int q0, int n, int bh, int wg,
    const Mask& mk) {
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
  // segment mode: this thread's rows' (id, position)
  const bool causal_b = causal != 0;
  int rid[2] = {0, 0}, rpos[2] = {0, 0};
  if constexpr (kMode == kSegment) {
    const int ld = row4(Sq);
    const int* seg = mk.segq + static_cast<size_t>(bh / mk.H) * 2 * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < Sq) {
        rid[h] = seg[row];
        rpos[h] = seg[ld + row];
      }
    }
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
    int k0 = it * kSmall;
    const uint8_t* kt = m.ring0 + s * C::kSmallBytes;
    const uint8_t* vt = m.ring1 + s * C::kSmallBytes;

    mbar_wait(&m.full0[s], par);
    bool whole = false;
    if constexpr (kMode != kPlain) {
      const int word = m.word[s];
      k0 = (word & 0xffffff) * kSmall;
      whole = (word >> (26 + wg)) & 1;
      if (((word >> (24 + wg)) & 1) == 0) {  // the other warpgroup's tile
        mbar_wait(&m.full1[s], par);
        if (lane == 0) mbar_arrive(&m.empty[s]);
        continue;
      }
    }
    // the masked modes: the key tile's (id, position) or bound rows
    const int* cols = m.ivec + s * kIvec;
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
    if constexpr (kMode == kPlain) {
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
    } else {
      // a whole pair skips the mask; any other tests every score without
      // a branch (a divergent branch a score costs more than its products)
      auto probs = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t4 + e;  // the key within the tile
            const int col = k0 + c;
            int kid = 0, kpos = 0;
            FmBands bd{};
            if constexpr (decltype(masked)::value) {
              if constexpr (kMode == kSegment) {
                kid = cols[c];
                kpos = cols[kSmall + c];
              } else {
                bd = fm_bands(cols + c, kSmall, mk.C, mk.fm_causal);
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              const float p = exp2f(fmaf(sc[i], scale_log2, -lse2[h]));
              if constexpr (decltype(masked)::value) {
                const int row = row0 + 8 * h;
                bool out;
                if constexpr (kMode == kSegment)
                  out = (kid != rid[h]) | (causal_b & (kpos > rpos[h]));
                else
                  out = (causal_b & (col > row + off)) | in_bands(bd, row);
                sc[i] = (col >= Sk) | out ? 0.f : p;
              } else {
                sc[i] = p;
              }
            }
          }
      };
      if (whole)
        probs(std::false_type{});
      else
        probs(std::true_type{});
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
// if / else and never join. The masked modes take the key tiles' int rows
// through `imap` (1-D int32, boxes of 64) and their inputs in `mk`.
template <int DP, int kMode>
__global__ void __launch_bounds__(384, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int D,
                     float scale, int causal,
                     const __grid_constant__ CUtensorMap imap,
                     const Mask mk) {
  extern __shared__ uint8_t smem_raw[];
  Smem m = carve<DP>(smem_raw, false);
  const int bh = blockIdx.x;
  const int nq = (Sq + kBig - 1) / kBig;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBig;
  // key tiles this block visits: all, or under causal those that start at
  // or before its last row's diagonal
  const int last = q0 + kBig - 1 + Sk - Sq;
  const int nk_all = (Sk + kSmall - 1) / kSmall;
  int n = !causal ? nk_all : (last < 0 ? 0 : min(nk_all, last / kSmall + 1));

  if constexpr (kMode != kPlain)
    carve_walk(m, m.empty + kStages, kStages, (nk_all + 31) / 32);
  if (threadIdx.x == 0) {
    init_barriers(m);
    if constexpr (kMode != kPlain) init_list(m);
  }
  __syncthreads();
  const int b = kMode == kPlain ? 0 : bh / mk.H;
  const int fh = mk.Hm == 1 ? b : bh;  // the flashmask bounds' row
  if constexpr (kMode != kPlain) {  // the masked modes' list of key tiles
    build_list<kMode, true>(m, mk, q0, Sq, Sk, causal, b, fh, 12);
    __syncthreads();
    n = m.cnt[0];
    if (threadIdx.x == 0 && mk.visits) atomicAdd(mk.visits, m.cnt[1]);
  }
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {  // -------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256 && n > 0) {
      load_fixed<DP>(m, &qmap, &domap, q0, bh);
      for (int t = 0; t < n; ++t) {
        if constexpr (kMode == kPlain) {
          load_stage<DP, false>(m, &kmap, &vmap, nullptr, nullptr, t,
                                t * kSmall, bh, 0);
        } else {
          // the key tile's segment (id, position) or C bound rows
          const int word = next_word(m);
          const int k0 = (word & 0xffffff) * kSmall;
          const int ld = row4(Sk);
          const Rows ir =
              kMode == kSegment
                  ? Rows{&imap, b * 2 * ld + k0, 2, ld}
                  : Rows{&imap, fh * mk.C * ld + k0, mk.C, ld};
          load_stage<DP, false, kMode>(m, &kmap, &vmap, nullptr, nullptr, t,
                                       k0, bh, 0, ir, word);
        }
      }
    }
  } else {  // ------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    dq_consumer<DP, kMode>(m, lse, delta, dq, Sq, Sk, D, scale, causal, q0,
                           n, bh, wg, mk);
  }
}

// ---------------------------------------------------------------- dK/dV
// the ring tiles of a dK/dV block: the 64 query rows of tile qt0 + t, with
// their lse and delta (rows of row4(Sq)), into stage t % kStages; in the
// masked modes the
// list's next tile, with segment mode's query (id, position) rows (`imap`,
// batch row b)
template <int DP, int kMode = kPlain>
__device__ __forceinline__ void load_query_tile(
    const Smem& m, const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* lsemap, const CUtensorMap* deltamap, int t, int qt0,
    int bh, int Sq, const CUtensorMap* imap = nullptr, int b = 0) {
  const int ld = row4(Sq);  // lse and delta rows, as padded
  if constexpr (kMode == kPlain) {
    const int q0 = (qt0 + t) * kSmall;
    load_stage<DP, true>(m, qmap, domap, lsemap, deltamap, t, q0, bh,
                         bh * ld + q0);
  } else {
    const int word = next_word(m);
    const int q0 = (word & 0xffffff) * kSmall;
    const Rows ir{imap, b * 2 * ld + q0, kMode == kSegment ? 2 : 0, ld};
    load_stage<DP, true, kMode>(m, qmap, domap, lsemap, deltamap, t, q0, bh,
                                bh * ld + q0, ir, word);
  }
}

// One consumer warpgroup's part of a dK/dV block: keys [kw, kw + 64) of
// the block's 128 at k0, over its n query tiles from qt0 (the masked
// modes: the n ring tiles of the list, each named by its stage's word).
// Thread 0 refills each stage the previous tile released.
template <int DP, int kMode>
__device__ __forceinline__ void dkv_consumer(
    const Smem& m, const CUtensorMap* qmap, const CUtensorMap* domap,
    const CUtensorMap* lsemap, const CUtensorMap* deltamap,
    const CUtensorMap* imap, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int D, float scale,
    int causal, int k0, int qt0, int n, int bh, int wg, const Mask& mk) {
  using C = Cfg<DP>;
  const int off = Sk - Sq;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = k0 + wg * 64;          // this warpgroup's first key
  const int key0 = kw + warp * 16 + g;  // this thread's keys: +0, +8
  const float scale_log2 = scale * kLog2e;
  const int b = kMode == kPlain ? 0 : bh / mk.H;
  const bool causal_b = causal != 0;
  // segment mode: this thread's keys' (id, position)
  int kid[2] = {0, 0}, kpos[2] = {0, 0};
  if constexpr (kMode == kSegment) {
    const int ld = row4(Sk);
    const int* seg = mk.segk + static_cast<size_t>(b) * 2 * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key < Sk) {
        kid[h] = seg[key];
        kpos[h] = seg[ld + key];
      }
    }
  }
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
    int q0 = (qt0 + it) * kSmall;
    const uint8_t* qt = m.ring0 + s * C::kSmallBytes;
    const uint8_t* dot = m.ring1 + s * C::kSmallBytes;
    const float* lse_s = m.vec0 + s * kSmall;
    const float* dl_s = m.vec1 + s * kSmall;

    mbar_wait(&m.full0[s], par);
    bool whole = false;
    if constexpr (kMode != kPlain) {
      const int word = m.word[s];
      q0 = (word & 0xffffff) * kSmall;
      whole = (word >> (26 + wg)) & 1;
      const bool mine = (word >> (24 + wg)) & 1;
      if (!mine) {  // the other warpgroup's tile: wait, refill, free
        mbar_wait(&m.full1[s], par);
        if (threadIdx.x == 0 && it > 0 && it - 1 + kStages < n)
          load_query_tile<DP, kMode>(m, qmap, domap, lsemap, deltamap,
                                     it - 1 + kStages, qt0, bh, Sq, imap, b);
        if (lane == 0) mbar_arrive(&m.empty[s]);
        continue;
      }
    }
    // segment mode: the query tile's (id, position) rows
    const int* qseg = m.ivec + s * kIvec;
    wgmma_fence();
    ss_product<DP>(sc, dk_a, desc_sw128(qt, 16, 1024));  // S^T = K Q^T
    wgmma_commit();
    mbar_wait(&m.full1[s], par);
    ss_product<DP>(dp, dv_a, desc_sw128(dot, 16, 1024));  // dP^T = V dO^T
    wgmma_commit();
    if (threadIdx.x == 0 && it > 0 && it - 1 + kStages < n)
      load_query_tile<DP, kMode>(m, qmap, domap, lsemap, deltamap,
                                 it - 1 + kStages, qt0, bh, Sq, imap, b);
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);

    // P^T and dS^T on the accumulators: rows (keys) key0 (h 0) and
    // key0 + 8, columns (queries) q0 + 8j + 2t4 + e; both in bf16 pairs in
    // accumulator order
    if constexpr (kMode == kPlain) {
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
    } else {
      // as dQ's: a whole pair skips the mask, any other tests every score
      // without a branch
      auto probs = [&](auto masked) {
        FmBands bd[2] = {};  // flashmask: the bands of this thread's keys
        if constexpr (kMode == kFlashmask && decltype(masked)::value) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            bd[h] = fm_bands(m.kfm + (key0 + 8 * h - k0), kBig, mk.C,
                             mk.fm_causal);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * t4;
          const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 dl = *reinterpret_cast<const float2*>(dl_s + c);
          const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
          const float dlt[2] = {dl.x, dl.y};
          int qid[2] = {0, 0}, qpos[2] = {0, 0};  // segment: the queries'
          if constexpr (kMode == kSegment && decltype(masked)::value) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              qid[e] = qseg[c + e];
              qpos[e] = qseg[kSmall + c + e];
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float pm[2], dm[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              float p = exp2f(fmaf(sc[i], scale_log2, -l2[e]));
              if constexpr (decltype(masked)::value) {
                const int q = q0 + c + e;
                bool out;
                if constexpr (kMode == kSegment)
                  out = (qid[e] != kid[h]) | (causal_b & (kpos[h] > qpos[e]));
                else
                  out = (causal_b & (key0 + 8 * h > q + off)) |
                        in_bands(bd[h], q);
                p = (q >= Sq) | out ? 0.f : p;
              }
              pm[e] = p;
              dm[e] = p * (dp[i] - dlt[e]) * scale;
            }
            pt[2 * j + h] = pack_bf16(pm[0], pm[1]);
            ds[2 * j + h] = pack_bf16(dm[0], dm[1]);
          }
        }
      };
      if (whole)
        probs(std::false_type{});
      else
        probs(std::true_type{});
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
// The masked modes take segment mode's query rows (1-D int32, boxes of
// 64) or the flashmask bound rows (boxes of 128) through `imap` and their
// inputs in `mk`.
template <int DP, int kMode>
__global__ void __launch_bounds__(256, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap domap,
                      const __grid_constant__ CUtensorMap lsemap,
                      const __grid_constant__ CUtensorMap deltamap,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int D,
                      float scale, int causal,
                      const __grid_constant__ CUtensorMap imap,
                      const Mask mk) {
  extern __shared__ uint8_t smem_raw[];
  Smem m = carve<DP>(smem_raw, true);
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBig;
  // query tiles that see the block's first key: all, or under causal
  // those whose last row's diagonal reaches k0
  const int nq_all = (Sq + kSmall - 1) / kSmall;
  const int first = k0 - (Sk - Sq) - (kSmall - 1);
  const int qt0 = !causal || first <= 0 ? 0 : (first + kSmall - 1) / kSmall;
  int n = max(0, nq_all - qt0);

  if constexpr (kMode != kPlain)
    carve_walk(m, m.empty + kStages, kStages, (nq_all + 31) / 32);
  if (threadIdx.x == 0) {
    init_barriers(m);
    if constexpr (kMode != kPlain) init_list(m);
  }
  __syncthreads();
  const int b = kMode == kPlain ? 0 : bh / mk.H;
  const int fh = mk.Hm == 1 ? b : bh;  // the flashmask bounds' row
  if constexpr (kMode != kPlain) {  // the masked modes' list of query tiles
    build_list<kMode, false>(m, mk, k0, Sq, Sk, causal, b, fh, 8);
    __syncthreads();
    n = m.cnt[0];
    if (threadIdx.x == 0 && mk.visits) atomicAdd(mk.visits, m.cnt[1]);
  }
  if (threadIdx.x == 0 && n > 0) {
    // flashmask: the block's keys' C bound rows, with K and V
    load_fixed<DP, kMode>(m, &kmap, &vmap, k0, bh,
                          kMode == kFlashmask
                              ? Rows{&imap, fh * mk.C * row4(Sk) + k0, mk.C,
                                     row4(Sk)}
                              : Rows{});
    for (int t = 0; t < min(n, kStages); ++t)
      load_query_tile<DP, kMode>(m, &qmap, &domap, &lsemap, &deltamap, t,
                                 qt0, bh, Sq, &imap, b);
  }
  dkv_consumer<DP, kMode>(m, &qmap, &domap, &lsemap, &deltamap, &imap, dk,
                          dv, Sq, Sk, D, scale, causal, k0, qt0, n, bh,
                          threadIdx.x >> 7, mk);
}

// ------------------------------------------------------------- launches
// the 1-D map of n fp32 values (BH rows of row4(Sq)) in boxes of 64 (a box
// that runs past a head's rows reads the next head's, which the kernel
// masks)
bool map_vec(CUtensorMap* map, const void* base, int n) {
  const cuuint32_t box[1] = {kSmall};
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t str[1] = {4};  // unused at rank 1
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, base, dims, str,
                  box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP, int kMode>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int Sq, int Sk, int D, float scale,
                      int causal, const CUtensorMap& imap, const Mask& mk,
                      cudaStream_t s) {
  CUtensorMap qmap, kmap, vmap, domap;
  if (!map_rows(&qmap, q, BH, Sq, D, kBig) ||
      !map_rows(&domap, dout, BH, Sq, D, kBig) ||
      !map_rows(&kmap, k, BH, Sk, D, kSmall) ||
      !map_rows(&vmap, v, BH, Sk, D, kSmall))
    return cudaErrorInvalidValue;
  const int groups = ((Sk + kSmall - 1) / kSmall + 31) / 32;
  const int smem = kMode == kPlain ? Cfg<DP>::smem(false)
                                   : Cfg<DP>::smem_masked(false, groups);
  auto kernel = flash_dq_sm90_kernel<DP, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Sq + kBig - 1) / kBig);
  kernel<<<grid, 384, smem, s>>>(
      qmap, kmap, vmap, domap, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Sq,
      Sk, D, scale, causal, imap, mk);
  return cudaGetLastError();
}

template <int DP, int kMode>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int Sq, int Sk, int D,
                       float scale, int causal, const CUtensorMap& imap,
                       const Mask& mk, cudaStream_t s) {
  CUtensorMap qmap, kmap, vmap, domap, lsemap, deltamap;
  if (!map_rows(&kmap, k, BH, Sk, D, kBig) ||
      !map_rows(&vmap, v, BH, Sk, D, kBig) ||
      !map_rows(&qmap, q, BH, Sq, D, kSmall) ||
      !map_rows(&domap, dout, BH, Sq, D, kSmall) ||
      !map_vec(&lsemap, lse, BH * row4(Sq)) ||
      !map_vec(&deltamap, delta, BH * row4(Sq)))
    return cudaErrorInvalidValue;
  const int groups = ((Sq + kSmall - 1) / kSmall + 31) / 32;
  const int smem = kMode == kPlain ? Cfg<DP>::smem(true)
                                   : Cfg<DP>::smem_masked(true, groups);
  auto kernel = flash_dkv_sm90_kernel<DP, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Sk + kBig - 1) / kBig);
  kernel<<<grid, 256, smem, s>>>(
      qmap, kmap, vmap, domap, lsemap, deltamap,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Sk, D, scale, causal, imap, mk);
  return cudaGetLastError();
}

}  // namespace

// q/dout/dq (BH, Sq, D), k/v/dk/dv (BH, Sk, D) bf16, contiguous, 16-byte
// aligned; lse and delta (BH, Sq) fp32, and for dK/dV (BH, row4(Sq)): each
// row padded to a multiple of 4 (its TMA boxes start 16-byte aligned).
// Refuses (cudaErrorInvalidValue) D > 128 or not a multiple of 8, BH >
// 65535, BH * Sq >= 2^31, unaligned inputs. Each returns a cudaError_t: 0
// on a successful launch.
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
  const CUtensorMap none{};
  const Mask plain{};
  const cudaError_t e =
      D <= 64 ? launch_dq<64, kPlain>(q, k, v, dout, lse, delta, dq, BH, Sq,
                                      Sk, D, scale, causal, none, plain, s)
              : launch_dq<128, kPlain>(q, k, v, dout, lse, delta, dq, BH, Sq,
                                       Sk, D, scale, causal, none, plain, s);
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
  const CUtensorMap none{};
  const Mask plain{};
  const cudaError_t e =
      D <= 64 ? launch_dkv<64, kPlain>(q, k, v, dout, lse, delta, dk, dv, BH,
                                       Sq, Sk, D, scale, causal, none, plain,
                                       s)
              : launch_dkv<128, kPlain>(q, k, v, dout, lse, delta, dk, dv,
                                        BH, Sq, Sk, D, scale, causal, none,
                                        plain, s);
  return static_cast<int>(e);
}

// The segment (mode 1) and flashmask (mode 2) modes of the same kernels,
// with flash_attention.cu's masked tail (less its dtype): segq/segk (B, 2,
// row4(S)) int32, each row padded to a multiple of 4 as lse and delta
// are for dK/dV, and their (B, 4, ceil(S/32)) summaries of the unpadded
// rows, or fm (B*fm_heads, fm_cols, row4(Sk)) int32, padded so, and its
// (B*fm_heads, 2, ceil(Sk/32)) start summary
// (fm_cols 1 with fm_causal only); H heads per batch row; `visits`, if
// not null, gains the 64 x 64 (q, k) tile pairs the warpgroups compute.
// Pointers a mode does not use may be null. Refuses what the plain
// entries refuse and what `refuse_mask` does.
extern "C" int flash_attention_dq_sm90_masked(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* segq,
    const void* segk, const void* qsum, const void* ksum, const void* fm,
    const void* fmsum, void* visits, int BH, int Sq, int Sk, int D, int H,
    int fm_heads, int fm_cols, float scale, int causal, int fm_causal,
    int mode, void* stream) {
  const void* in[6] = {q, k, v, dout, lse, delta};
  const Mask mk = make_mask(segq, segk, qsum, ksum, fm, fmsum, visits, H,
                            fm_heads, fm_cols, fm_causal);
  CUtensorMap imap;
  if (refuse(in, 6, BH, Sq, Sk, D) || refuse_mask(mk, mode, BH, Sq, Sk) ||
      !mask_map(&imap, mk, mode, mk.segk, BH, Sk, kSmall))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kSegment)
    e = D <= 64 ? launch_dq<64, kSegment>(q, k, v, dout, lse, delta, dq, BH,
                                          Sq, Sk, D, scale, causal, imap, mk,
                                          s)
                : launch_dq<128, kSegment>(q, k, v, dout, lse, delta, dq, BH,
                                           Sq, Sk, D, scale, causal, imap, mk,
                                           s);
  else
    e = D <= 64 ? launch_dq<64, kFlashmask>(q, k, v, dout, lse, delta, dq,
                                            BH, Sq, Sk, D, scale, causal,
                                            imap, mk, s)
                : launch_dq<128, kFlashmask>(q, k, v, dout, lse, delta, dq,
                                             BH, Sq, Sk, D, scale, causal,
                                             imap, mk, s);
  return static_cast<int>(e);
}

extern "C" int flash_attention_dkv_sm90_masked(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* segq,
    const void* segk, const void* qsum, const void* ksum, const void* fm,
    const void* fmsum, void* visits, int BH, int Sq, int Sk, int D, int H,
    int fm_heads, int fm_cols, float scale, int causal, int fm_causal,
    int mode, void* stream) {
  const void* in[6] = {q, k, v, dout, lse, delta};
  const Mask mk = make_mask(segq, segk, qsum, ksum, fm, fmsum, visits, H,
                            fm_heads, fm_cols, fm_causal);
  CUtensorMap imap;
  if (refuse(in, 6, BH, Sq, Sk, D) || refuse_mask(mk, mode, BH, Sq, Sk) ||
      !mask_map(&imap, mk, mode, mk.segq, BH, Sq,
                mode == kSegment ? kSmall : kBig))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kSegment)
    e = D <= 64 ? launch_dkv<64, kSegment>(q, k, v, dout, lse, delta, dk, dv,
                                           BH, Sq, Sk, D, scale, causal, imap,
                                           mk, s)
                : launch_dkv<128, kSegment>(q, k, v, dout, lse, delta, dk,
                                            dv, BH, Sq, Sk, D, scale, causal,
                                            imap, mk, s);
  else
    e = D <= 64 ? launch_dkv<64, kFlashmask>(q, k, v, dout, lse, delta, dk,
                                             dv, BH, Sq, Sk, D, scale,
                                             causal, imap, mk, s)
                : launch_dkv<128, kFlashmask>(q, k, v, dout, lse, delta, dk,
                                              dv, BH, Sq, Sk, D, scale,
                                              causal, imap, mk, s);
  return static_cast<int>(e);
}
