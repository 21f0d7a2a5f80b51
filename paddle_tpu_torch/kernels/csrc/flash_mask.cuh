// The flash kernels' mask modes and skip predicate, shared by
// flash_attention.cu (mma.sync: fp32 and head_dim > 128 in every kernel)
// and the wgmma kernels of flash_fwd_sm90.cu and flash_bwd_sm90.cu (bf16
// at head_dim <= 128: the masked forward, dQ and dK/dV; their walk of the
// ring tiles is flash_walk.cuh's). Device helpers only; no kernel lives
// here.
//
// They carry over the Pallas TPU kernels' `_block_contributes` and
// `_flashmask_block_mask` (paddle_tpu/kernels/flash_attention.py): the
// per-tile skip predicate from per-32-row summaries the wrapper builds
// with plain torch ops once per call, and the per-score flashmask test.
#pragma once

#include <cuda_runtime.h>

namespace flash_mask {

enum { kPlain = 0, kSegment = 1, kFlashmask = 2 };
constexpr int kGroup = 32;  // rows a summary entry covers

// The TPU kernel's `_block_contributes` for plain causal attention: can
// the (q tile, k tile) pair hold any unmasked score?
__device__ __forceinline__ bool contributes(int q0, int k0, int tile,
                                            int off, int causal) {
  return !causal || k0 <= q0 + tile - 1 + off;
}

// The masked modes' extra inputs (null in the plain mode). Summaries are
// over 32-row groups of the in-range rows; a tile (64 or 32 rows) spans
// one or two groups.
struct Mask {
  const int* segq;   // (B, 2, Sq): segment id, position in its sequence
  const int* segk;   // (B, 2, Sk)
  const int* qsum;   // (B, 4, ceil(Sq/32)): min id, max id, min pos, max pos
  const int* ksum;   // (B, 4, ceil(Sk/32))
  const int* fm;     // (B*Hm, C, Sk): row bounds of each key column
  const int* fmsum;  // (B*Hm, 2, ceil(Sk/32)): largest and smallest bound 0
                     // (C == 1 causal)
  int* visits;       // null, or a count of the (q, k) tile pairs visited
  int H, Hm, C, fm_causal;
};

// adds a ballot's visited tiles to `visits`: once a block (every warp
// holds the same ballot) and only from the first D chunk
__device__ __forceinline__ void count_visits(const Mask& mk, unsigned live) {
  if (mk.visits && threadIdx.x == 0 && blockIdx.z == 0)
    atomicAdd(mk.visits, __popc(live));
}

struct SegRange {
  int idmin, idmax, posmin, posmax;
};

// the summary of rows [r0, r0 + tile) from a batch row's (4, ng) summary
__device__ __forceinline__ SegRange seg_range(const int* sum, int ng, int r0,
                                              int tile) {
  SegRange r{0x7fffffff, -0x7fffffff - 1, 0x7fffffff, -0x7fffffff - 1};
  const int g1 = min(ng, (r0 + tile) / kGroup);
  for (int g = r0 / kGroup; g < g1; ++g) {
    r.idmin = min(r.idmin, sum[g]);
    r.idmax = max(r.idmax, sum[ng + g]);
    r.posmin = min(r.posmin, sum[2 * ng + g]);
    r.posmax = max(r.posmax, sum[3 * ng + g]);
  }
  return r;
}

// `_block_contributes` under segments: the id ranges overlap, and under
// causal the pair is not one shared sequence with every key after every
// query.
__device__ __forceinline__ bool seg_contributes(const SegRange& q,
                                                const SegRange& k,
                                                int causal) {
  const bool overlap = q.idmin <= k.idmax && q.idmax >= k.idmin;
  const bool one_seq = q.idmin == k.idmax && q.idmax == k.idmin;
  const bool all_future = k.posmin > q.posmax;
  return overlap && !(causal && one_seq && all_future);
}

// no score of the pair is masked under segments: one id on both sides
// and, under causal, every key position at or before every query's
__device__ __forceinline__ bool seg_whole(const SegRange& q,
                                          const SegRange& k, int causal) {
  return q.idmin == q.idmax && k.idmin == k.idmax && q.idmin == k.idmin &&
         (!causal || k.posmax <= q.posmin);
}

// the largest bound-0 entry over key rows [k0, k0 + tile)
__device__ __forceinline__ int fm_start_max(const int* sum, int ng, int k0,
                                            int tile) {
  int mx = -0x7fffffff - 1;
  const int g1 = min(ng, (k0 + tile) / kGroup);
  for (int g = k0 / kGroup; g < g1; ++g) mx = max(mx, sum[g]);
  return mx;
}

// the smallest bound-0 entry over key rows [k0, k0 + tile) (the summary's
// second row)
__device__ __forceinline__ int fm_start_min(const int* sum, int ng, int k0,
                                            int tile) {
  int mn = 0x7fffffff;
  const int g1 = min(ng, (k0 + tile) / kGroup);
  for (int g = k0 / kGroup; g < g1; ++g) mn = min(mn, sum[ng + g]);
  return mn;
}

// `_block_contributes` under flashmask: the causal bound, then the C == 1
// causal document skip (every row of the q tile at or past every start).
__device__ __forceinline__ bool fm_contributes(int q0, int k0, int tile,
                                               int off, int causal,
                                               const Mask& mk,
                                               int start_max) {
  return contributes(q0, k0, tile, off, causal) &&
         !(mk.C == 1 && mk.fm_causal && q0 >= start_max);
}

// `_flashmask_block_mask` for one score: is `row` masked by the bounds
// b[0], b[stride], ... of its key column?
__device__ __forceinline__ bool fm_masked(int row, const int* b, int stride,
                                          int C, int fm_causal) {
  if (fm_causal)
    return C == 1 ? row >= b[0] : (row >= b[0] && row < b[stride]);
  if (C == 2) return row >= b[0] || row < b[stride];
  return (row >= b[0] && row < b[stride]) ||
         (row >= b[2 * stride] && row < b[3 * stride]);
}

// The bounds of one key column as two row bands [lo0, hi0) and [lo1,
// hi1), either possibly empty: a row is masked iff it lies in one. Every
// bound count and meaning of `fm_masked` in one form, so the per-score
// test has no branch (b[stride] is read even when C == 1, and unused).
struct FmBands {
  int lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ FmBands fm_bands(const int* b, int stride, int C,
                                            int fm_causal) {
  constexpr int kMax = 0x7fffffff, kMin = -0x7fffffff - 1;
  const bool open0 = C == 1 || (!fm_causal && C == 2);  // [b0, inf)
  const int b1 = b[stride];
  FmBands r;
  r.lo0 = b[0];
  r.hi0 = open0 ? kMax : b1;
  r.lo1 = C == 4 ? b[2 * stride] : (fm_causal ? kMax : kMin);
  r.hi1 = C == 4 ? b[3 * stride] : (fm_causal ? kMin : b1);
  return r;
}

__device__ __forceinline__ bool in_bands(const FmBands& f, int row) {
  return ((row >= f.lo0) & (row < f.hi0)) | ((row >= f.lo1) & (row < f.hi1));
}

}  // namespace flash_mask
