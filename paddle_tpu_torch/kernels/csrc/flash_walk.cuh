// The masked modes' walk of a block's ring tiles, shared by the wgmma flash
// kernels (flash_fwd_sm90.cu: the forward; flash_bwd_sm90.cu: dQ and
// dK/dV). A block fixes 128 rows (queries in the forward and dQ, keys in
// dK/dV), 64 a consumer warpgroup, and streams 64-row ring tiles (keys,
// or queries); which tiles it streams, and which pairs of a warpgroup's
// rows and a ring tile skip the per-score mask, come from the reference's
// `_block_contributes` (flash_mask.cuh) over the wrapper's per-32-row
// summaries:
//   * `build_list`, run by every warp before the roles split, ballots
//     the predicate for 32 ring tiles at once, one lane a tile, for each
//     warpgroup's 64 rows, and keeps the ballots in shared memory: a word
//     a warpgroup and group of 32 tiles (8 bytes a group; 16 with the
//     whole-pair words, up to kWholeGroups groups);
//   * `next_word`, for the one thread that loads the ring, walks the words
//     in ascending order: the next tile either warpgroup computes, with
//     the two warpgroups' bits beside it, which it writes into the
//     stage's word for the consumers to read with the stage;
//   * the masked region of shared memory (`carve_walk`): each stage's int
//     rows (the tile's segment (id, position) or C flashmask bound rows,
//     1-D TMA boxes of 64 int32), dK/dV's key bounds, the stage words,
//     the counters and the list.
// And the host side the wgmma flash entries share: the tile maps, the row
// padding TMA needs (`row4`), the masked entries' int32 maps and what
// they refuse.
// Device and host helpers only; no kernel lives here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace flash_mask {

constexpr int kFixedRows = 128;  // rows a block fixes
constexpr int kRingRows = 64;    // rows of a ring tile
// the int rows of a stage (a segment's id and position, or up to 4
// flashmask bound rows, kRingRows each), and the longest list (groups of
// 32 ring tiles) that also keeps which pairs are whole
constexpr int kIvec = 4 * kRingRows;
constexpr int kWholeGroups = 2048;
constexpr int kMaxStages = 4;  // the stage words the region keeps

// The length of a row that TMA reads in 1-D boxes (dK/dV's lse and delta,
// the masked modes' segment rows and bounds): S rounded up to a multiple
// of 4 elements, since a box must start 16-byte aligned. The wrapper pads
// those rows to it.
__host__ __device__ __forceinline__ int row4(int S) { return (S + 3) & ~3; }

// The masked region's pointers: each stage's int rows, dK/dV's key bounds
// (4 rows of 128), the stage words (the ring tile and the warpgroups'
// bits, `next_word`), the counters (cnt[0] the ring's length, cnt[1] the
// computed pairs, cnt[2..3] the loading thread's place in the list) and
// the list (`build_list`), with its whole-pair words.
struct Walk {
  int *ivec = nullptr, *kfm = nullptr, *word = nullptr, *cnt = nullptr;
  uint32_t *list = nullptr, *whole = nullptr;
};

// the bytes of the masked region for `stages` stages and a list of
// `groups` groups of 32 ring tiles (128 of them for its alignment)
__host__ __device__ constexpr int walk_bytes(int stages, int groups) {
  return 128 + stages * kIvec * 4 + 4 * kFixedRows * 4 + 32 +
         (groups <= kWholeGroups ? 16 : 8) * groups;
}

// the masked region from `p` (the end of a kernel's own shared memory),
// 128-byte aligned; no `whole` words past kWholeGroups groups
__device__ __forceinline__ void carve_walk(Walk& w, void* p, int stages,
                                           int groups) {
  uint8_t* b = static_cast<uint8_t*>(p);
  b += (128 - (hopper::smem_u32(b) & 127)) & 127;
  w.ivec = reinterpret_cast<int*>(b);
  w.kfm = w.ivec + stages * kIvec;
  w.word = w.kfm + 4 * kFixedRows;
  w.cnt = w.word + kMaxStages;
  w.list = reinterpret_cast<uint32_t*>(w.cnt + 4);
  w.whole = groups <= kWholeGroups ? w.list + 2 * groups : nullptr;
}

// the list's counters before the build: nothing counted, the loading
// thread before the first group
__device__ __forceinline__ void init_list(const Walk& w) {
  w.cnt[0] = w.cnt[1] = 0;
  w.cnt[2] = -1;
  w.cnt[3] = 0;
}

// The block's list, built by every thread (`warps` warps) before the roles
// split: for each group of 32 ring tiles, a word a
// warpgroup of the tiles it computes — the reference's
// `_block_contributes` for the pair of its 64 fixed rows (queries from
// `fixed0` in the forward and dQ, kQueries; keys in dK/dV) and the 64-row
// ring tile — and, with `w.whole`, a word of those whose pair has no
// masked score. A warp takes a group at a time, a lane a tile. cnt[0]
// gains the tiles either warpgroup computes (the ring's length), cnt[1]
// the pairs computed.
template <int kMode, bool kQueries>
__device__ __forceinline__ void build_list(const Walk& w, const Mask& mk,
                                           int fixed0, int Sq, int Sk,
                                           int causal, int b, int fh,
                                           int warps) {
  const int off = Sk - Sq;
  const int nqg = (Sq + kGroup - 1) / kGroup;
  const int nkg = (Sk + kGroup - 1) / kGroup;
  const int* qsum = mk.qsum + static_cast<size_t>(b) * 4 * nqg;
  const int* ksum = mk.ksum + static_cast<size_t>(b) * 4 * nkg;
  const int* fmsum = mk.fmsum + static_cast<size_t>(fh) * 2 * nkg;
  const bool doc = mk.C == 1 && mk.fm_causal;  // the C == 1 causal skip
  const int nt = ((kQueries ? Sk : Sq) + kRingRows - 1) / kRingRows;
  const int fixed_rows = kQueries ? Sq : Sk;
  const int lane = threadIdx.x & 31;
  for (int gi = threadIdx.x >> 5; gi < (nt + 31) / 32; gi += warps) {
    const int t = 32 * gi + lane;
    bool c[2], wh[2];
#pragma unroll
    for (int wg = 0; wg < 2; ++wg) {
      const int r0 = fixed0 + 64 * wg;  // the warpgroup's first fixed row
      const int q0 = kQueries ? r0 : t * kRingRows;
      const int k0 = kQueries ? t * kRingRows : r0;
      c[wg] = wh[wg] = false;
      if (t >= nt || r0 >= fixed_rows) continue;
      if constexpr (kMode == kSegment) {
        const SegRange qr = seg_range(qsum, nqg, q0, kRingRows);
        const SegRange kr = seg_range(ksum, nkg, k0, kRingRows);
        c[wg] = seg_contributes(qr, kr, causal);
        wh[wg] = seg_whole(qr, kr, causal);
      } else {
        c[wg] = fm_contributes(
            q0, k0, kRingRows, off, causal, mk,
            doc ? fm_start_max(fmsum, nkg, k0, kRingRows) : 0);
        wh[wg] = doc && (!causal || k0 + kRingRows - 1 <= q0 + off) &&
                 q0 + kRingRows - 1 < fm_start_min(fmsum, nkg, k0, kRingRows);
      }
      wh[wg] = c[wg] && wh[wg] && q0 + kRingRows <= Sq && k0 + kRingRows <= Sk;
    }
    const uint32_t c0 = __ballot_sync(0xffffffffu, c[0]);
    const uint32_t c1 = __ballot_sync(0xffffffffu, c[1]);
    const uint32_t w0 = __ballot_sync(0xffffffffu, wh[0]);
    const uint32_t w1 = __ballot_sync(0xffffffffu, wh[1]);
    if (lane == 0) {
      w.list[2 * gi] = c0;
      w.list[2 * gi + 1] = c1;
      if (w.whole) {
        w.whole[2 * gi] = w0;
        w.whole[2 * gi + 1] = w1;
      }
      atomicAdd(&w.cnt[0], __popc(c0 | c1));
      atomicAdd(&w.cnt[1], __popc(c0) + __popc(c1));
    }
  }
}

// The next ring tile of the list, for the one thread that loads the ring:
// its stage word, the tile (bits 0-23), then bit 24 + wg when warpgroup wg
// computes it and bit 26 + wg when that pair is whole.
__device__ __forceinline__ int next_word(const Walk& w) {
  int g = w.cnt[2];
  uint32_t left = static_cast<uint32_t>(w.cnt[3]);
  while (left == 0) {
    ++g;
    left = w.list[2 * g] | w.list[2 * g + 1];
  }
  const int bit = __ffs(left) - 1;
  w.cnt[2] = g;
  w.cnt[3] = static_cast<int>(left & (left - 1));
  int word = (32 * g + bit) | (((w.list[2 * g] >> bit) & 1) << 24) |
             (((w.list[2 * g + 1] >> bit) & 1) << 25);
  if (w.whole)
    word |= (((w.whole[2 * g] >> bit) & 1) << 26) |
            (((w.whole[2 * g + 1] >> bit) & 1) << 27);
  return word;
}

// ------------------------------------------------------------------ host
// the 3-D map of a (BH, S, D) bf16 tensor in boxes of 64 columns x `rows`
// (every wgmma flash entry's Q, K, V, dO)
inline bool map_rows(CUtensorMap* map, const void* base, int BH, int S,
                     int D, int rows) {
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t str[2] = {static_cast<cuuint64_t>(D) * 2,
                             static_cast<cuuint64_t>(S) * D * 2};
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base,
                          dims, str, box);
}

// what the wgmma flash entries take: D a multiple of 8 up to 128, B*H <=
// 65535, the block rows within the grid's y limit, B*H*Sq addressable by
// a 1-D map, 16-byte aligned inputs
inline bool refuse(const void* const* ptrs, int n, int BH, int Sq, int Sk,
                   int D) {
  if (BH <= 0 || BH > 65535 || Sq <= 0 || Sk <= 0 || D <= 0 || D > 128 ||
      D % 8 != 0 || (Sq + kFixedRows - 1) / kFixedRows > 65535 ||
      (Sk + kFixedRows - 1) / kFixedRows > 65535 ||
      static_cast<long long>(BH) * Sq >= (1ll << 31))
    return true;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return true;
  return false;
}

// What the masked entries also take: mode 1 (segment: segq, segk and
// their summaries) or 2 (flashmask: fm, Sq == Sk, Hm 1 or H, C 1|2 with
// causal bounds or 2|4 without, the start summary for C == 1 causal), H
// dividing B*H, and the tensors TMA reads (segq and segk, or fm) 16-byte
// aligned and within reach of its 32-bit coordinates.
inline bool refuse_mask(const Mask& mk, int mode, int BH, int Sq, int Sk) {
  if (mk.H <= 0 || BH % mk.H != 0) return true;
  const long long B = BH / mk.H;
  long long n = 0;
  const void* rows[2] = {nullptr, nullptr};
  if (mode == kSegment) {
    if (!mk.segq || !mk.segk || !mk.qsum || !mk.ksum) return true;
    rows[0] = mk.segq;
    rows[1] = mk.segk;
    n = 2 * B * row4(Sq > Sk ? Sq : Sk);
  } else if (mode == kFlashmask) {
    if (!mk.fm || Sq != Sk || (mk.Hm != 1 && mk.Hm != mk.H)) return true;
    if (mk.fm_causal ? (mk.C != 1 && mk.C != 2) : (mk.C != 2 && mk.C != 4))
      return true;
    if (mk.C == 1 && mk.fm_causal && !mk.fmsum) return true;
    rows[0] = mk.fm;
    n = B * mk.Hm * mk.C * row4(Sk);
  } else {
    return true;
  }
  for (const void* r : rows)
    if (reinterpret_cast<uintptr_t>(r) % 16 != 0) return true;
  return n >= (1ll << 31);
}

inline Mask make_mask(const void* segq, const void* segk, const void* qsum,
                      const void* ksum, const void* fm, const void* fmsum,
                      void* visits, int H, int fm_heads, int fm_cols,
                      int fm_causal) {
  Mask mk{};
  mk.segq = static_cast<const int*>(segq);
  mk.segk = static_cast<const int*>(segk);
  mk.qsum = static_cast<const int*>(qsum);
  mk.ksum = static_cast<const int*>(ksum);
  mk.fm = static_cast<const int*>(fm);
  mk.fmsum = static_cast<const int*>(fmsum);
  mk.visits = static_cast<int*>(visits);
  mk.H = H;
  mk.Hm = fm_heads;
  mk.C = fm_cols;
  mk.fm_causal = fm_causal;
  return mk;
}

// the 1-D map of n int32 mask values (a flattened (B, 2, row4(S)) segment
// or (B*Hm, C, row4(Sk)) bound tensor) in boxes of `box`; a box that runs
// past a row's S reads its padding or the next row's, which the kernels
// mask (key or query >= S)
inline bool map_ints(CUtensorMap* map, const void* base, long long n,
                     int box) {
  const cuuint32_t b[1] = {static_cast<cuuint32_t>(box)};
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t str[1] = {4};  // unused at rank 1
  return hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, base, dims,
                          str, b, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// the int map of a masked launch: the (B, 2, row4(S)) segment rows or the
// (B*Hm, C, row4(S)) bounds, flattened, in boxes of `box`
inline bool mask_map(CUtensorMap* map, const Mask& mk, int mode,
                     const int* seg, int BH, int S, int box) {
  const long long B = BH / mk.H;
  if (mode == kSegment) return map_ints(map, seg, 2 * B * row4(S), box);
  return map_ints(map, mk.fm, B * mk.Hm * mk.C * row4(S), box);
}

}  // namespace flash_mask
