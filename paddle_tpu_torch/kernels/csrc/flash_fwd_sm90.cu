// Flash attention forward for Hopper (sm_90a): wgmma over a TMA tile ring.
// Plain C interface.
//
// Replaces, for bf16 at head_dim <= 128 in every mask mode (plain: causal
// or none; segment; flashmask), the Pallas TPU kernel `_fwd_kernel` of
// paddle_tpu/kernels/flash_attention.py (online-softmax attention; out and
// the fp32 logsumexp; under `use_seg` / `fm_cols > 0` with
// `_block_contributes` and `_flashmask_block_mask`). flash_attention.cu
// keeps fp32 and head_dim > 128; flash_bwd_sm90.cu has dQ and dK/dV.
// Layout (B*H, S, D), contiguous; causal is bottom-right aligned: key j is
// visible to query i iff j <= i + (Sk - Sq). A masked score contributes
// exactly 0; the row sum is clamped at 1e-30 at the end, so a row that
// sees no key gives zeros and lse = -1e30 + log(1e-30), as the plain
// version beside the wrapper.
//
// Bound on this card: operations (the training shape, S 4096, D 128,
// causal: 137 GFLOP over 34 MB of q/k/v/out). flash_attention.cu's forward
// ran mma.sync on fragments built from scalar shared loads, loaded K and V
// synchronously and passed P through shared memory, two __syncthreads a
// tile (1.30 ms, ~105 TFLOP/s). The design:
//   * a block of three warpgroups owns 128 query rows of one head; the
//     heaviest causal query tiles run first. Warpgroup 2 is the producer:
//     one thread loads Q once and streams K and V tiles through a ring
//     with TMA (128-byte swizzle, zeros past S and D; D is laid out as
//     64-wide column blocks), K and V completing on their own mbarriers so
//     S = QK^T can start before V lands; the consumers free a stage on its
//     `empty` mbarrier (one arrival per consumer warp) once the product
//     that read it has retired;
//   * each consumer warpgroup owns 64 of the rows: S = Q K^T is wgmma SS
//     (Q and K both K-major as stored); the online softmax runs in
//     registers on the accumulator (the max over a row's quad of threads,
//     exp2 of scores pre-scaled by log2 e);
//   * P is rounded to bf16 in registers (as FlashAttention-2 and
//     flash_attention.cu round it) and is directly the RS A operand of
//     O += P V (wgmma m64nDk16, V as the transposed, MN-major B operand):
//     the accumulator layout of S is the A-fragment layout of P, so P never
//     goes through shared memory; the row sums and max stay fp32;
//   * registers: three warps share each SM sub-partition, so a thread has
//     168 at launch; setmaxnreg moves the producer's to the consumers.
//
// Two kernels (`Cfg`'s `kMode`, as in flash_bwd_sm90.cu):
//   * plain (`flash_fwd_sm90_kernel`): 128-key tiles through a 2-stage
//     ring, the contiguous causal range; S (64), O (64) and P (32) fit
//     because the first k16 step of S only writes its accumulator (last
//     tile's scores are dead by then). Only tiles that cross the causal
//     diagonal or the end of K evaluate the mask;
//   * segment and flashmask (`flash_fwd_sm90_masked_kernel`): 64-key tiles
//     (S 32 registers, P 16, room for each row's segment (id, position))
//     through a 4-stage ring, walked as the masked dQ walks them
//     (flash_walk.cuh): before the roles split every warp ballots the
//     reference's `_block_contributes` for 32 ring tiles at once per
//     warpgroup, the ring carries the tiles either warpgroup computes,
//     and the loading thread writes each stage's tile and the two
//     warpgroups' bits beside it. Each key tile's (id, position) rows or C
//     flashmask bound rows ride in its stage as 1-D TMA boxes of 64 int32
//     (rows padded to a multiple of 4 by the wrapper, `row4`); each
//     thread's two query rows keep their (id, position) in registers.
//     Every score is tested without a branch (flashmask bounds as two row
//     bands), and a pair the summaries show to be whole skips the test,
//     the choice made once a tile outside the unrolled loop. Tile i's
//     P V is issued after tile i + 1's S, so each softmax overlaps the
//     last tile's product (`masked_rows`); for that no wgmma may sit in a
//     branch, so both warpgroups run the products of every ring tile, a
//     pair the predicate skips having every score masked (at the packed
//     row 4-8% more products: 2210 against 2055 pairs a head in segment
//     mode). `visits` gains the 64 x 64 pairs the predicate lets through.
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

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;       // query rows of a block (64 a consumer)
constexpr int kThreads = 384;  // consumers: warpgroups 0-1; producer: 2

// DP: the head dim the tiles are laid out for (64 or 128; D <= DP); kMode:
// the plain mode's 128-key tiles in 2 stages, or the masked modes' 64-key
// ring tiles in 4.
template <int DP, int kMode>
struct Cfg {
  static constexpr int kBN = kMode == kPlain ? 128 : kRingRows;
  static constexpr int kStages = kMode == kPlain ? 2 : 4;
  static constexpr int kBlocks = DP / 64;        // 64-wide column blocks
  static constexpr int kQBytes = kBM * DP * 2;
  static constexpr int kKVBytes = kBN * DP * 2;  // one K or V tile
  // descriptor units (16 bytes) between the column blocks of Q and of K
  static constexpr int kQCb = kBM * 128 / 16;
  static constexpr int kKCb = kBN * 128 / 16;
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + (1 + 3 * kStages) * 8 + 1024;
  // the masked modes add the walk's region after the barriers, for a
  // list of `groups` groups of 32 ring tiles
  static constexpr int smem(int groups) {
    return kSmem + walk_bytes(kStages, groups);
  }
};

// S = Q K^T over DP / 16 k16 steps (4 per 64-wide column block): the
// warpgroup's 64 query rows against the tile's kBN keys. The first step
// only writes S. Descriptors move in 16-byte units: 32 bytes a k16 step,
// a tile's rows of 128 bytes a column block.
template <int DP, int kMode>
__device__ __forceinline__ void qk_product(float (&sc)[Cfg<DP, kMode>::kBN / 2],
                                           uint64_t dq, uint64_t dk) {
  using C = Cfg<DP, kMode>;
  if constexpr (C::kBN == 128) {
    wgmma_ss_n128<0, false>(sc, dq, dk);
#pragma unroll
    for (int kk = 1; kk < DP / 16; ++kk)
      wgmma_ss_n128<0, true>(sc, dq + (kk / 4) * C::kQCb + (kk % 4) * 2,
                             dk + (kk / 4) * C::kKCb + (kk % 4) * 2);
  } else {
    wgmma_ss_n64<0, false>(sc, dq, dk);
#pragma unroll
    for (int kk = 1; kk < DP / 16; ++kk)
      wgmma_ss_n64<0, true>(sc, dq + (kk / 4) * C::kQCb + (kk % 4) * 2,
                            dk + (kk / 4) * C::kKCb + (kk % 4) * 2);
  }
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t* p, uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_n128<1>(o, p, db);
  else
    wgmma_rs_n64<1>(o, p, db);
}

// The online softmax of row h (row0 + 8h) over a tile's scores, already
// scaled by log2 e and -inf where masked, given this thread's max `mx` of
// them: the quad's max, the rescale of the running sum (and, kRescale, of
// O), and the scores replaced by their exponentials. Returns the rescale.
template <int DP, int kBN, bool kRescale = true>
__device__ __forceinline__ float softmax_row(float (&sc)[kBN / 2],
                                             float (&o)[DP / 2],
                                             float (&m)[2], float (&l)[2],
                                             int h, float mx) {
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float mn = fmaxf(m[h], mx);
  const float alpha = m[h] <= kNegInf / 2 ? 0.f : exp2f(m[h] - mn);
  // a row with no visible key yet: every score is -inf, exp2 gives 0
  const float base = mn <= kNegInf / 2 ? 0.f : mn;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pv = exp2f(sc[4 * j + 2 * h + e] - base);
      sc[4 * j + 2 * h + e] = pv;
      sum += pv;
    }
  l[h] = l[h] * alpha + sum;  // this thread's columns; the quad adds up
  m[h] = mn;
  if constexpr (kRescale) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j + 2 * h] *= alpha;
      o[4 * j + 2 * h + 1] *= alpha;
    }
  }
  return alpha;
}

// P in bf16: accumulator pairs (4j + 0..1, 4j + 2..3) are the A
// fragment's registers in order
template <int kBN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBN / 4],
                                       const float (&sc)[kBN / 2]) {
#pragma unroll
  for (int i = 0; i < kBN / 4; ++i) {
    const __nv_bfloat162 pr = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
    p[i] = *reinterpret_cast<const uint32_t*>(&pr);
  }
}

// keeps registers an asynchronous wgmma still reads (P, its A operand)
// live until the wait that retires it
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One consumer warpgroup's rows of a masked block (rows row0 and row0 + 8
// of this thread) over its nk ring tiles, each named by its stage's word.
// Tile i's O += P V is issued after
// tile i + 1's S = Q K^T, so tile i + 1's softmax runs while the tensor
// cores finish the product, and O's rescale by tile i + 1's alpha waits
// until the next issue (FlashAttention-3's intra-warpgroup overlap). Every
// ring tile takes the same products, so no wgmma sits in a branch (ptxas
// serializes wgmma whose registers cross one): a tile the warpgroup does
// not compute is one whose every score the mask hides (the skip predicate
// is exact there), so it adds nothing but its products' time.
template <int DP, int kMode>
__device__ __forceinline__ void masked_rows(
    const Walk& w, const Mask& mk, const uint8_t* sK, const uint8_t* sV,
    uint64_t* kfull, uint64_t* vfull, uint64_t* empty, uint64_t dq,
    float (&o)[DP / 2], float (&m)[2], float (&l)[2], int nk, int Sq,
    int Sk, float scale_log2, int causal, int row0, int b, int wg) {
  using C = Cfg<DP, kMode>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int off = Sk - Sq;
  const bool causal_b = causal != 0;
  if (nk == 0) return;
  // segment mode: this thread's rows' (id, position)
  int rid[2] = {0, 0}, rpos[2] = {0, 0};
  if constexpr (kMode == kSegment) {
    const int ld = row4(Sq);
    const int* seg = mk.segq + static_cast<size_t>(b) * 2 * ld;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < Sq) {
        rid[h] = seg[row];
        rpos[h] = seg[ld + row];
      }
    }
  }
  float sc[kBN / 2];
  uint32_t p[kBN / 4];
  float alpha[2];
  // S = Q K^T of ring tile `it`, issued
  auto products = [&](int it) {
    const int s = it % kStages;
    mbar_wait(&kfull[s], (it / kStages) & 1);
    wgmma_fence();
    qk_product<DP, kMode>(sc, dq, desc_sw128(sK + s * C::kKVBytes, 16, 1024));
    wgmma_commit();
  };
  // O = alpha O, then O += P V of ring tile `it` (V MN-major; a k16 step
  // is 16 keys: 16 rows of 128 bytes), issued
  auto pv = [&](int it) {
    const int s = it % kStages;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    const uint64_t dv = desc_sw128(sV + s * C::kKVBytes, kBN * 128, 1024);
    mbar_wait(&vfull[s], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_pv<DP>(o, p + 4 * kk, dv + 128 * kk);
    wgmma_commit();
  };
  // ring tile it's P V retired: its stage freed
  auto retire = [&](int it) {
    wgmma_wait<0>();
    fence_operand(o);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&empty[it % kStages]);
  };
  // the mask and the softmax of ring tile `it`'s scores, P in bf16 after
  // `before_p` (the last product retired)
  auto softmax = [&](int it, auto before_p) {
    const int s = it % kStages;
    fence_operand(sc);
    const int word = w.word[s];
    const int k0 = (word & 0xffffff) * kBN;
    const bool whole = (word >> (26 + wg)) & 1;
    // the key tile's (id, position) or bound rows, as the stage holds
    // them; a whole pair skips the mask, any other tests every score
    // without a branch
    const int* cols = w.ivec + s * kIvec;
    auto scores = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;  // the key within the tile
          const int col = k0 + c;
          int kid = 0, kpos = 0;
          FmBands bd{};
          if constexpr (decltype(masked)::value) {
            if constexpr (kMode == kSegment) {
              kid = cols[c];
              kpos = cols[kBN + c];
            } else {
              bd = fm_bands(cols + c, kBN, mk.C, mk.fm_causal);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float x = sc[i] * scale_log2;
            if constexpr (decltype(masked)::value) {
              bool hide;
              if constexpr (kMode == kSegment)
                hide = (kid != rid[h]) | (causal_b & (kpos > rpos[h]));
              else
                hide = (causal_b & (col > row0 + 8 * h + off)) |
                       in_bands(bd, row0 + 8 * h);
              sc[i] = (col >= Sk) | hide ? __int_as_float(0xff800000) : x;
            } else {
              sc[i] = x;
            }
          }
        }
    };
    if (whole)
      scores(std::false_type{});
    else
      scores(std::true_type{});
    // the softmax, O's rescale left to the next issue
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      alpha[h] = softmax_row<DP, kBN, false>(sc, o, m, l, h, mx);
    }
    before_p();
    pack_p<kBN>(p, sc);
  };

  products(0);
  wgmma_wait<0>();
  softmax(0, [] {});
  for (int it = 1; it < nk; ++it) {
    products(it);
    pv(it - 1);
    wgmma_wait<1>();
    softmax(it, [&] { retire(it - 1); });
  }
  pv(nk - 1);
  retire(nk - 1);
}

// a consumer thread's rows row0 and row0 + 8 of (BH, Sq, D) out and (BH,
// Sq) lse at head bh: O over the quad's row sum, the sum clamped at 1e-30
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           float* __restrict__ lse,
                                           const float (&o)[DP / 2],
                                           const float (&m)[2],
                                           const float (&l)[2], int bh,
                                           int row0, int Sq, int D, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float safe = fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * h;
    if (row >= Sq) continue;
    const size_t r = static_cast<size_t>(bh) * Sq + row;
    if (t == 0)
      lse[r] = (m[h] <= kNegInf / 2 ? kNegInf : m[h] * kLn2) + logf(safe);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < D)  // D is a multiple of 8, so col + 1 < D too
        *reinterpret_cast<__nv_bfloat162*>(out + r * D + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] / safe,
                                  o[4 * j + 2 * h + 1] / safe);
    }
  }
}

// The plain mode: grid (ceil(Sq / 128), B*H), kThreads threads.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      float scale_log2, int causal) {
  using C = Cfg<DP, kPlain>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + C::kQBytes;                  // kStages K tiles
  uint8_t* sV = sK + kStages * C::kKVBytes;       // kStages V tiles
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sV + kStages * C::kKVBytes);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int nq = (Sq + kBM - 1) / kBM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kBM;
  const int bh = blockIdx.y;
  const int off = Sk - Sq;
  // key tiles this block visits: all, or under causal those that start at
  // or before its last row's diagonal (the TPU kernel's predicate)
  const int last = q0 + kBM - 1 + off;
  const int nk_all = (Sk + kBN - 1) / kBN;
  const int nk =
      !causal ? nk_all : (last < 0 ? 0 : min(nk_all, last / kBN + 1));

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // ---------------------------------------- producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(qfull, C::kQBytes);
      for (int c = 0; c < C::kBlocks; ++c)
        tma_load_3d(sQ + c * kBM * 128, &qmap, qfull, 64 * c, q0, bh);
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        uint8_t* k = sK + s * C::kKVBytes;
        uint8_t* v = sV + s * C::kKVBytes;
        mbar_arrive_expect_tx(&kfull[s], C::kKVBytes);
        for (int c = 0; c < C::kBlocks; ++c)
          tma_load_3d(k + c * kBN * 128, &kmap, &kfull[s], 64 * c, it * kBN,
                      bh);
        mbar_arrive_expect_tx(&vfull[s], C::kKVBytes);
        for (int c = 0; c < C::kBlocks; ++c)
          tma_load_3d(v + c * kBN * 128, &vmap, &vfull[s], 64 * c, it * kBN,
                      bh);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<240>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + wg * 64;             // this warpgroup's first row
  const int row0 = qw + warp * 16 + g;     // this thread's rows: +0, +8
  // its Q rows in each column block
  const uint64_t dq = desc_sw128(sQ + wg * 64 * 128, 16, 1024);
  float o[DP / 2], sc[kBN / 2];
  uint32_t p[kBN / 4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(qfull, 0);
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = it * kBN;
    const uint8_t* k = sK + s * C::kKVBytes;
    const uint8_t* v = sV + s * C::kKVBytes;

    const uint64_t dk = desc_sw128(k, 16, 1024);
    mbar_wait(&kfull[s], par);
    wgmma_fence();
    qk_product<DP, kPlain>(sc, dq, dk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);

    // online softmax on the accumulator, rows row0 (h 0) and row0 + 8;
    // only tiles that cross the causal diagonal or the end of K evaluate
    // the mask
    const bool masked_tile =
        k0 + kBN > Sk || (causal && k0 + kBN - 1 > qw + off);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * h + e] * scale_log2;
          if (masked_tile) {
            const int col = k0 + 8 * j + 2 * t + e;
            if (col >= Sk || (causal && col > row + off))
              x = __int_as_float(0xff800000);  // -inf
          }
          sc[4 * j + 2 * h + e] = x;
          mx = fmaxf(mx, x);
        }
      softmax_row<DP, kBN>(sc, o, m, l, h, mx);
    }
    pack_p<kBN>(p, sc);

    // O += P V over kBN / 16 k16 steps of 16 keys (V MN-major)
    // a k16 step is 16 keys: 16 rows of 128 bytes
    const uint64_t dv = desc_sw128(v, kBN * 128, 1024);
    mbar_wait(&vfull[s], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_pv<DP>(o, p + 4 * kk, dv + 128 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(o);
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_rows<DP>(out, lse, o, m, l, bh, row0, Sq, D, t);
}

// The masked modes (segment, flashmask): grid (B*H, ceil(Sq / 128)),
// kThreads threads: the heads of one query tile in turn, the last tiles
// first, as masked dQ's grid. (Ordered as the plain kernel's, a head's
// query tiles in turn, the last heads' longest blocks, those whose rows
// straddle two documents, start near the end of the grid: the packed row
// takes 8-11% longer on an H100, `chip_flash_mask_breakdown.py`'s
// `grid_by_head`.) Before the roles split every warp
// ballots the block's list of ring tiles (flash_walk.cuh); warpgroup 2's
// loading thread walks it and streams each listed key tile with its (id,
// position) or bound rows (`imap`, 1-D int32, boxes of 64) through the
// ring, the stage's word beside it.
template <int DP, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_masked_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int Sq, int Sk, int D,
                             float scale_log2, int causal,
                             const __grid_constant__ CUtensorMap imap,
                             const Mask mk) {
  using C = Cfg<DP, kMode>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + C::kQBytes;                  // kStages K tiles
  uint8_t* sV = sK + kStages * C::kKVBytes;       // kStages V tiles
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sV + kStages * C::kKVBytes);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;
  Walk w;
  carve_walk(w, empty + kStages, kStages, ((Sk + kBN - 1) / kBN + 31) / 32);

  const int nq = (Sq + kBM - 1) / kBM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kBM;
  const int bh = blockIdx.x;
  const int b = bh / mk.H;
  const int fh = mk.Hm == 1 ? b : bh;  // the flashmask bounds' row
  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
    init_list(w);
  }
  __syncthreads();
  if (threadIdx.x == 256) {  // Q once, while the block builds its list
    mbar_arrive_expect_tx(qfull, C::kQBytes);
    for (int c = 0; c < C::kBlocks; ++c)
      tma_load_3d(sQ + c * kBM * 128, &qmap, qfull, 64 * c, q0, bh);
  }
  build_list<kMode, true>(w, mk, q0, Sq, Sk, causal, b, fh, kThreads / 32);
  __syncthreads();
  const int nk = w.cnt[0];
  if (threadIdx.x == 0 && mk.visits) atomicAdd(mk.visits, w.cnt[1]);
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // ---------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      // each key tile's segment (id, position) or C bound rows, with K
      const int ld = row4(Sk);
      const int nrows = kMode == kSegment ? 2 : mk.C;
      const int c0 = kMode == kSegment ? b * 2 * ld : fh * mk.C * ld;
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const int word = next_word(w);
        const int k0 = (word & 0xffffff) * kBN;
        w.word[s] = word;  // released to the consumers by the arrive below
        uint8_t* k = sK + s * C::kKVBytes;
        uint8_t* v = sV + s * C::kKVBytes;
        mbar_arrive_expect_tx(&kfull[s], C::kKVBytes + nrows * kBN * 4);
        for (int c = 0; c < C::kBlocks; ++c)
          tma_load_3d(k + c * kBN * 128, &kmap, &kfull[s], 64 * c, k0, bh);
        for (int i = 0; i < nrows; ++i)
          tma_load_1d(w.ivec + s * kIvec + i * kBN, &imap, &kfull[s],
                      c0 + k0 + i * ld);
        mbar_arrive_expect_tx(&vfull[s], C::kKVBytes);
        for (int c = 0; c < C::kBlocks; ++c)
          tma_load_3d(v + c * kBN * 128, &vmap, &vfull[s], 64 * c, k0, bh);
      }
    }
    return;
  }

  // ---------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row0 = q0 + wg * 64 + warp * 16 + (lane >> 2);  // rows +0, +8
  // its Q rows in each column block
  const uint64_t dq = desc_sw128(sQ + wg * 64 * 128, 16, 1024);
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qfull, 0);
  masked_rows<DP, kMode>(w, mk, sK, sV, kfull, vfull, empty, dq, o, m, l, nk,
                         Sq, Sk, scale_log2, causal, row0, b, wg);
  store_rows<DP>(out, lse, o, m, l, bh, row0, Sq, D, lane & 3);
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int Sq, int Sk, int D, float scale,
                   int causal, cudaStream_t s) {
  using C = Cfg<DP, kPlain>;
  CUtensorMap qmap, kmap, vmap;
  if (!map_rows(&qmap, q, BH, Sq, D, kBM) ||
      !map_rows(&kmap, k, BH, Sk, D, C::kBN) ||
      !map_rows(&vmap, v, BH, Sk, D, C::kBN))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBM - 1) / kBM, BH);
  flash_fwd_sm90_kernel<DP><<<grid, kThreads, C::kSmem, s>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, D, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int DP, int kMode>
cudaError_t launch_masked(const void* q, const void* k, const void* v,
                          void* out, void* lse, int BH, int Sq, int Sk,
                          int D, float scale, int causal,
                          const CUtensorMap& imap, const Mask& mk,
                          cudaStream_t s) {
  using C = Cfg<DP, kMode>;
  CUtensorMap qmap, kmap, vmap;
  if (!map_rows(&qmap, q, BH, Sq, D, kBM) ||
      !map_rows(&kmap, k, BH, Sk, D, C::kBN) ||
      !map_rows(&vmap, v, BH, Sk, D, C::kBN))
    return cudaErrorInvalidValue;
  const int smem = C::smem(((Sk + C::kBN - 1) / C::kBN + 31) / 32);
  auto kernel = flash_fwd_sm90_masked_kernel<DP, kMode>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(BH, (Sq + kBM - 1) / kBM);
  kernel<<<grid, kThreads, smem, s>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, D, scale * kLog2e, causal, imap, mk);
  return cudaGetLastError();
}

}  // namespace

// q/out (BH, Sq, D), k/v (BH, Sk, D) bf16, contiguous, 16-byte aligned;
// lse (BH, Sq) fp32. Refuses (cudaErrorInvalidValue) D > 128 or not a
// multiple of 8, BH > 65535, unaligned bases. Returns a cudaError_t: 0 on
// a successful launch.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int BH, int Sq, int Sk, int D,
                                        float scale, int causal,
                                        void* stream) {
  if (BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      D <= 64 ? launch<64>(q, k, v, out, lse, BH, Sq, Sk, D, scale, causal, s)
              : launch<128>(q, k, v, out, lse, BH, Sq, Sk, D, scale, causal,
                            s);
  return static_cast<int>(e);
}

// The segment (mode 1) and flashmask (mode 2) modes of the same kernel,
// with flash_attention.cu's masked tail (less its dtype), as the masked
// dQ and dK/dV of flash_bwd_sm90.cu take it: segq/segk (B, 2, row4(S))
// int32, each row padded to a multiple of 4, and their (B, 4, ceil(S/32))
// summaries of the unpadded rows, or fm (B*fm_heads, fm_cols, row4(Sk))
// int32, padded so, and its (B*fm_heads, 2, ceil(Sk/32)) start summary
// (fm_cols 1 with fm_causal only); H heads per batch row; `visits`, if not
// null, gains the 64 x 64 (q, k) tile pairs the skip predicate lets
// through.
// Pointers a mode does not use may be null. Refuses what `refuse` and
// `refuse_mask` (flash_walk.cuh) do.
extern "C" int flash_attention_fwd_sm90_masked(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* segq, const void* segk, const void* qsum, const void* ksum,
    const void* fm, const void* fmsum, void* visits, int BH, int Sq, int Sk,
    int D, int H, int fm_heads, int fm_cols, float scale, int causal,
    int fm_causal, int mode, void* stream) {
  const void* in[3] = {q, k, v};
  const Mask mk = make_mask(segq, segk, qsum, ksum, fm, fmsum, visits, H,
                            fm_heads, fm_cols, fm_causal);
  CUtensorMap imap;
  if (refuse(in, 3, BH, Sq, Sk, D) || refuse_mask(mk, mode, BH, Sq, Sk) ||
      !mask_map(&imap, mk, mode, mk.segk, BH, Sk, kRingRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (mode == kSegment)
    e = D <= 64 ? launch_masked<64, kSegment>(q, k, v, out, lse, BH, Sq, Sk,
                                              D, scale, causal, imap, mk, s)
                : launch_masked<128, kSegment>(q, k, v, out, lse, BH, Sq,
                                               Sk, D, scale, causal, imap,
                                               mk, s);
  else
    e = D <= 64 ? launch_masked<64, kFlashmask>(q, k, v, out, lse, BH, Sq,
                                                Sk, D, scale, causal, imap,
                                                mk, s)
                : launch_masked<128, kFlashmask>(q, k, v, out, lse, BH, Sq,
                                                 Sk, D, scale, causal, imap,
                                                 mk, s);
  return static_cast<int>(e);
}
