// Paged-KV decode attention for Hopper (sm_90a), plain C interface:
// split-KV over pages (flash-decoding), each block fed by a ring of 1-D
// bulk copies (TMA, mbarrier complete_tx).
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (paddle_tpu/kernels/paged_attention.py, driven by
// `paged_attention_decode`): one decode token per sequence attends over
// its KV pages through an int32 block table, grouped-query heads
// (query head h reads KV head h / G), positions >= seq_len masked, fp32
// online softmax, output in the query dtype. Both of the TPU kernel's
// variants are here, chosen by the template flag kInt8: full-width K/V
// pages in the query dtype, and (quantized=True there) int8 K/V pages
// with fp32 per-(page, head, slot) scale pages at the same page ids.
//
// Bound on this card: bytes. Each live K/V row is read once (one token's
// K+V for all KV heads of Llama-3-8B is 4 KiB in bf16, 2 KiB + 64 B in
// int8) and the arithmetic is ~2*G flops per byte, far below the ~295
// flop/byte the H100 needs before its ALUs bind.
//
// What the first port lost, and why: its grid was (KVH, B), one block a
// sequence, so the serve batch (B 16, KVH 8) ran 128 blocks on 132 SMs
// and a single long request 8; the longest row set the kernel's time.
// Each of its warps issued the K/V rows of 4 tokens, waited for them,
// then summed every q.k with a 5-step butterfly: loads and arithmetic
// took turns, ~425 GB/s at the serve shape, and int8's halved bytes
// bought nothing.
//
// The design:
//   * split-KV on the card: the grid is (KVH, chunks + B); a block takes
//     the query heads h*G .. h*G+G-1 (GQA reuse) against one split of one
//     row's pages. Every block reads seq_lens and computes the same plan
//     of the whole batch: a split holds at most Q pages, Q from the
//     launch's shapes alone (`split_pages`: the batch bucket B at the
//     table's full width P shares about `chunks` splits per KV head; the
//     host picks `chunks` to fill the card once, `paged_decode_plan`), and
//     each row splits by Q and its own length, so short and long rows cost
//     blocks in proportion and the grid runs in one wave. A row's splits
//     never depend on another row's length: its result is bitwise the
//     same alone or batched, in a batch of the same shapes (the
//     reference's kernel reads each row alone). An earlier plan sized Q
//     from the batch's total pages, which balanced mixed batches better
//     but made a row's rounding depend on its neighbours. The host never
//     reads seq_lens (no sync on the decode path); blocks past the
//     batch's splits exit at once;
//   * a ring of stages (64 tokens for bf16 queries, 32 for fp32): K, V
//     (and the int8 scales) of a stage come as one 1-D bulk copy per page
//     segment (a (page, KV head) block is contiguous in the (num_pages,
//     KVH, page, D) layout), all completing on the stage's full
//     mbarrier. The block stages its split's block-table slice in shared
//     memory first;
//   * bf16 queries (the serving path), tensor cores: a producer warp
//     keeps the ring full, refilling a stage when the 4 consumer warps
//     have arrived on its empty mbarrier. Each consumer warp takes 16
//     tokens of every stage and runs an online softmax of its own (no
//     block barrier per stage): S = Q K^T and O^T = V^T P^T on mma.sync
//     m16n8k16, the G heads as the padded 16 (or 8) side. Q's fragments
//     stay in registers for the whole block and K's B fragments are
//     16-byte row pieces (the k order of a dot product is free, so the q
//     fragments follow the order the loads give); S's accumulator layout
//     is P^T's B-fragment layout, so P never leaves registers; V^T's A
//     fragments are 16-byte row pieces of 4 tokens paired along k by
//     byte permutes. P enters as two bf16 parts, hi + lo (~16 bits), so
//     the products are fp32-grade; int8 K and V become bf16 exactly on
//     the way. The 4 warps' states merge at the end with weights
//     2^(m_warp - max) (scores pre-scaled by log2 e for exp2; all state
//     fp32);
//   * fp32 queries, CUDA cores, fp32 throughout: thread 0 issues the
//     copies and the 4 warps go in step (two block barriers a stage):
//     q.k 4 lanes a token over 16-byte chunks (rotated by the token's
//     parity so a warp's 8 rows hit all 32 banks) against fp32 queries
//     in shared memory, two shuffles finishing each sum; the softmax a
//     warp per head, a lane per token; P V 8 columns x G heads a thread;
//   * one launch per layer, deterministic: a block whose sequence has
//     more than one live split writes its partial (m, l, unnormalised
//     acc) to an fp32 workspace, then takes a ticket from a per-(b, KV
//     head) counter (__threadfence first); the block that draws the last
//     ticket merges every live split in split order and resets the
//     counter to 0 for the next launch. No float atomics: results are
//     bitwise equal run to run. A sequence with one live split writes its
//     output directly;
//   * int8: the K scale multiplies the finished dot product and the V
//     scale the softmax weight p (sum_e q_e (k8_e s) = s sum_e q_e k8_e,
//     and p (v8_e s) = (p s) v8_e; only the rounding order differs from
//     the reference's dequantize-first); int8 becomes fp32 through a byte
//     permute into a float's mantissa (exact), not a conversion
//     instruction, and bf16 from there (exact);
//   * a sequence with seq_len == 0 (a bucket pad row) writes exact zeros
//     (the sum is clamped at 1e-30, as on the TPU); lengths past the
//     table's width are cut to it, as the reference's gather is.
//
// The kernel launches on the caller's stream and allocates nothing (the
// wrapper passes the workspace and the counters); the C entry returns
// cudaGetLastError() of the launch. Concurrent launches on other streams
// must not share a workspace or a counter buffer.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_arrive;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxTablePages = 2048;  // block-table width
constexpr int kMaxSplits = 64;        // live splits a merge stages
constexpr int kConsumers = 4;         // consumer warps
constexpr int kRingBytes = 65536;     // the ring's target size
constexpr int kPvElems = 8;           // CUDA cores: P V columns a thread

// kQ: the query/output type, 1 bf16, 0 fp32. kInt8: int8 caches with fp32
// scales, else caches of the query type.
template <int kQ, bool kInt8, int G, int D>
struct Cfg {
  // bf16 queries: tensor cores, each consumer warp an online softmax of
  // its own over 16 tokens of a 64-token stage, a producer warp; fp32
  // queries: CUDA cores, 32-token stages, the 4 warps in step (two block
  // barriers a stage), thread 0 issuing the copies
  static constexpr bool kMma = kQ == 1;
  static constexpr int kThreads = 32 * kConsumers + (kMma ? 32 : 0);
  static constexpr int kTile = kMma ? 64 : 32;
  static constexpr int kElemBytes = kInt8 ? 1 : (kQ == 1 ? 2 : 4);
  static constexpr int kRowBytes = D * kElemBytes;     // a K or V row
  static constexpr int kChunkElems = 16 / kElemBytes;  // a 16-byte chunk
  static constexpr int kChunks = kRowBytes / 16;       // a multiple of 4
  static constexpr int kKBytes = kTile * kRowBytes;
  static constexpr int kScaleBytes = kInt8 ? kTile * 4 : 0;
  // stage: K rows, V rows, K scales, V scales
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kScaleBytes;
  static constexpr int kFit = kRingBytes / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 8 ? 8 : kFit);
  // bytes a token costs a stage: K + V (+ their scales)
  static constexpr int kTokenBytes = 2 * kRowBytes + (kInt8 ? 8 : 0);
  // CUDA cores: a thread owns kPvElems columns of P V in one of kGroups
  // token groups
  static constexpr int kColThreads = D / kPvElems;
  static constexpr int kGroups = kMma ? 1 : 32 * kConsumers / kColThreads;
  // the partial states the block merges at the end: a warp's own online
  // softmax (tensor cores) or a token group's share (CUDA cores)
  static constexpr int kParts = kMma ? kConsumers : kGroups;
  // tensor cores: 16-byte K loads a lane makes per 8 tokens, the bf16
  // pairs of Q a lane holds, 64-column groups of a V row
  static constexpr int kKLoads = kRowBytes / 64;
  static constexpr int kQWords = D / 8;
  static constexpr int kCg = D / 64;
  // shared memory (byte offsets): the ring, which becomes the parts'
  // buffer (kParts x G x D fp32), then the merge's weights, once every
  // stage is consumed; CUDA cores only: fp32 q (G x D), scores and
  // probabilities (G x kTile), m, l, alpha (G each); the parts' m and l
  // (kParts x G each), the ticket flag and the block's split; full and
  // empty barriers; the block-table slice (int32, its pages)
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kPartBytes = kParts * G * D * 4;
  static constexpr int kQOff = kRing > kPartBytes ? kRing : kPartBytes;
  static constexpr int kSOff = kQOff + (kMma ? 0 : G * D * 4);
  static constexpr int kPOff = kSOff + (kMma ? 0 : G * kTile * 4);
  static constexpr int kStatOff = kPOff + (kMma ? 0 : G * kTile * 4);
  static constexpr int kPartMOff = kStatOff + 3 * G * 4;
  static constexpr int kPartLOff = kPartMOff + kParts * G * 4;
  static constexpr int kFlagOff = kPartLOff + kParts * G * 4;
  static constexpr int kBarOff = (kFlagOff + 6 * 4 + 15) / 16 * 16;
  static constexpr int kTableOff = kBarOff + 2 * kStages * 8;
  static_assert(kChunks % 4 == 0, "a row is a multiple of 64 bytes");
  static_assert(kMaxSplits * G * 2 * 4 <= kQOff, "merge weights fit");
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bf16 pair in a word (element 0 in the low half) -> fp32, exact
__device__ __forceinline__ void bf16x2(uint32_t w, float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// four int8 in a word -> fp32, exact: the biased byte b + 128 goes into
// the mantissa of 2^23 (byte permute), and 2^23 + 128 comes off
__device__ __forceinline__ void int8x4(uint32_t w, float* x) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) -
           8388736.f;
}

// the 16-byte chunk at p (shared memory) -> fp32
template <int kBytes>
__device__ __forceinline__ void load_chunk(const uint8_t* p,
                                           float (&x)[16 / kBytes]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  if constexpr (kBytes == 4) {
    x[0] = __uint_as_float(w.x);
    x[1] = __uint_as_float(w.y);
    x[2] = __uint_as_float(w.z);
    x[3] = __uint_as_float(w.w);
  } else if constexpr (kBytes == 2) {
    bf16x2(w.x, x);
    bf16x2(w.y, x + 2);
    bf16x2(w.z, x + 4);
    bf16x2(w.w, x + 6);
  } else {
    int8x4(w.x, x);
    int8x4(w.y, x + 4);
    int8x4(w.z, x + 8);
    int8x4(w.w, x + 12);
  }
}

// kPvElems = 8 consecutive elements at p (shared memory) -> fp32
template <int kBytes>
__device__ __forceinline__ void load8(const uint8_t* p, float (&x)[8]) {
  if constexpr (kBytes == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else if constexpr (kBytes == 2) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    bf16x2(w.x, x);
    bf16x2(w.y, x + 2);
    bf16x2(w.z, x + 4);
    bf16x2(w.w, x + 6);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    int8x4(w.x, x);
    int8x4(w.y, x + 4);
  }
}

// `W` 32-bit words at p (shared memory), as wide as p's alignment
// (W * 4 bytes) allows
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint32_t*>(p)[i];
  }
}

// N int8 at p (shared memory, 2-byte aligned, 4-byte when N % 4 == 0)
// -> fp32, exact
template <int N>
__device__ __forceinline__ void load_int8(const uint8_t* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
    uint32_t w[N / 4];
    load_words<N / 4>(p, w);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) int8x4(w[i], x + 4 * i);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t h = reinterpret_cast<const uint16_t*>(p)[i];
      x[2 * i] = static_cast<float>(static_cast<int8_t>(h & 0xffu));
      x[2 * i + 1] = static_cast<float>(static_cast<int8_t>(h >> 8));
    }
  }
}

// two fp32 -> a bf16 pair (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b: mma.sync m16n8k16, bf16 in, fp32 accumulate. Lane (g, t) =
// (lane / 4, lane % 4) holds a = {A[g][2t..2t+1], A[g+8][2t..2t+1],
// A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]}, b = {B[2t..2t+1][g],
// B[2t+8..2t+9][g]}, d = {D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// pages of a row of seq_len `len` (cut to the table's width)
__device__ __forceinline__ int row_pages(int len, int page, int max_pages) {
  return (min(max(len, 0), max_pages * page) + page - 1) / page;
}

// The most pages a split takes, from the launch's shapes alone (B rows,
// a P-page table, `chunks`, `min_chunk`): Q = max(ceil(B * P / c),
// min_chunk, ceil(P / kMaxSplits)), capped at P, with c = chunks - B when
// that is at least half of chunks, else ceil(chunks / 2). Every row splits
// by this Q and its own page count only, so a row's splits, and the order
// of its merge, are the same in any batch of the same shapes; B rows take
// at most B * P / Q + B <= chunks + B splits, the grid's y extent.
__host__ __device__ __forceinline__ int split_pages(int B, int P, int chunks,
                                                    int min_chunk) {
  const int c = chunks - B >= (chunks + 1) / 2 ? chunks - B : (chunks + 1) / 2;
  const long long total = static_cast<long long>(B) * P;
  long long q = (total + c - 1) / c;
  q = q > min_chunk ? q : min_chunk;
  const long long s = (P + kMaxSplits - 1) / kMaxSplits;
  q = q > s ? q : s;
  return static_cast<int>(q < P ? q : P);
}

// one query element (global memory) -> fp32
template <int kQ>
__device__ __forceinline__ float load_q(const void* q, size_t i) {
  if constexpr (kQ == 1)
    return __uint_as_float(
        static_cast<uint32_t>(reinterpret_cast<const uint16_t*>(q)[i]) << 16);
  else
    return reinterpret_cast<const float*>(q)[i];
}

// fp32 -> the output type, bf16 rounded to nearest even (torch's
// .to(bfloat16)), NaN kept
template <int kQ>
__device__ __forceinline__ void store_out(void* out, size_t i, float x) {
  if constexpr (kQ == 1) {
    uint32_t u = __float_as_uint(x);
    uint16_t r;
    if ((u & 0x7fffffffu) > 0x7f800000u) {
      r = 0x7fc0;
    } else {
      u += 0x7fffu + ((u >> 16) & 1u);
      r = static_cast<uint16_t>(u >> 16);
    }
    reinterpret_cast<uint16_t*>(out)[i] = r;
  } else {
    reinterpret_cast<float*>(out)[i] = x;
  }
}

// Tile i of the split [t0, t1) (first page p0): its K and V rows (and
// scales) into stage i % kStages, whole 8-token chunks (a page is a
// multiple of 8), one bulk copy per page segment, all completing on the
// stage's full barrier. One thread calls it.
template <class C, bool kInt8>
__device__ __forceinline__ void issue_tile(
    uint8_t* smem, uint64_t* full, const int32_t* s_table, const uint8_t* kc,
    const uint8_t* vc, const float* ks, const float* vs, int i, int t0,
    int t1, int p0, int page, int KVH, int h) {
  const int s = i % C::kStages;
  uint8_t* st = smem + s * C::kStageBytes;
  const int a = t0 + i * C::kTile;
  const int e = min(a + C::kTile, (t1 + 7) & ~7);
  mbar_arrive_expect_tx(&full[s], (e - a) * C::kTokenBytes);
  for (int t = a; t < e;) {
    const int pi = t / page;
    const int n = min(e, (pi + 1) * page) - t;
    const size_t row =
        (static_cast<size_t>(s_table[pi - p0]) * KVH + h) * page +
        (t - pi * page);
    const int off = t - a;
    bulk_load(st + off * C::kRowBytes, kc + row * C::kRowBytes,
              n * C::kRowBytes, &full[s]);
    bulk_load(st + C::kKBytes + off * C::kRowBytes, vc + row * C::kRowBytes,
              n * C::kRowBytes, &full[s]);
    if constexpr (kInt8) {
      bulk_load(st + 2 * C::kKBytes + off * 4, ks + row, n * 4, &full[s]);
      bulk_load(st + 2 * C::kKBytes + C::kScaleBytes + off * 4, vs + row,
                n * 4, &full[s]);
    }
    t += n;
  }
}

// grid (KVH, chunks + B), Cfg::kThreads threads, dynamic shared memory
// Cfg::kTableOff + 4 * max_split_pages. ws: fp32 [KVH * gridDim.y][G * D]
// partial accumulators, then [...][G][2] (m, l); tickets: int32
// [B * KVH], 0 between launches.
template <int kQ, bool kInt8, int G, int D>
__device__ __forceinline__ void paged_decode(
    const void* __restrict__ q, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const int32_t* __restrict__ block_tables,
    const int32_t* __restrict__ seq_lens, void* __restrict__ out,
    float* __restrict__ ws, int32_t* __restrict__ tickets, int B, int H,
    int page, int max_pages, int chunks, int min_chunk, float qscale) {
  using C = Cfg<kQ, kInt8, G, D>;
  constexpr int kTile = C::kTile;
  constexpr int kThreads = C::kThreads;
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_q = reinterpret_cast<float*>(smem + C::kQOff);
  float* s_s = reinterpret_cast<float*>(smem + C::kSOff);
  float* s_p = reinterpret_cast<float*>(smem + C::kPOff);
  float* s_m = reinterpret_cast<float*>(smem + C::kStatOff);
  float* s_l = s_m + G;
  float* s_alpha = s_l + G;
  float* s_pm = reinterpret_cast<float*>(smem + C::kPartMOff);
  float* s_pl = reinterpret_cast<float*>(smem + C::kPartLOff);
  int* s_last = reinterpret_cast<int*>(smem + C::kFlagOff);
  int* s_split = s_last + 1;  // row, split, its row's splits, pps, first
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  int32_t* s_table = reinterpret_cast<int32_t*>(smem + C::kTableOff);

  const int KVH = gridDim.x, h = blockIdx.x, j = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the split plan, the same in every block (warp 0): row r holds n_r
  // pages (seq_len cut to the table) and takes ceil(n_r / pps_r) splits of
  // pps_r = ceil(n_r / ceil(n_r / Q)) pages, Q = split_pages(...) from the
  // launch's shapes (none empty; one for an empty row, which writes its
  // zeros), rows in order along blockIdx.y. No other row's length enters
  // a row's splits: its result is bitwise the same in any batch
  if (warp == 0) {
    const int Q = split_pages(B, max_pages, chunks, min_chunk);
    if (lane == 0) s_split[0] = -1;  // past the batch's splits
    __syncwarp();
    int first = 0;
    for (int r0 = 0; r0 < B; r0 += 32) {
      const int r = r0 + lane;
      int sp = 0, pr = 1;
      if (r < B) {
        const int n = row_pages(seq_lens[r], page, max_pages);
        sp = 1;
        if (n > 0) {
          pr = (n + (n + Q - 1) / Q - 1) / ((n + Q - 1) / Q);
          sp = (n + pr - 1) / pr;
        }
      }
      int inc = sp;  // inclusive scan of the splits over the lanes
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int at = first + inc - sp;
      if (r < B && j >= at && j < at + sp) {
        s_split[0] = r;
        s_split[1] = j - at;
        s_split[2] = sp;
        s_split[3] = pr;
        s_split[4] = at;
      }
      first += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  const int b = s_split[0];
  if (b < 0) return;
  const int split = s_split[1], live = s_split[2], pps = s_split[3];
  const int len = min(max(seq_lens[b], 0), max_pages * page);
  const int n_pages = (len + page - 1) / page;
  const size_t row0 = static_cast<size_t>(b) * H + h * G;  // first q head
  if (n_pages == 0) {  // seq_len 0: exact zeros
    for (int i = tid; i < G * D; i += kThreads)
      store_out<kQ>(out, row0 * D + i, 0.f);
    return;
  }
  const int p0 = split * pps;
  const int np = min(pps, n_pages - p0);
  const int t0 = p0 * page;                     // first token of the split
  const int t1 = min(len, (p0 + np) * page);    // one past its last
  const int n_tiles = (t1 - t0 + kTile - 1) / kTile;

  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < np; i += kThreads)
    s_table[i] = block_tables[static_cast<size_t>(b) * max_pages + p0 + i];
  if constexpr (!C::kMma) {
    for (int i = tid; i < G * D; i += kThreads)
      s_q[i] = load_q<kQ>(q, row0 * D + i) * qscale;
    if (tid < G) {
      s_m[tid] = kNegInf;
      s_l[tid] = 0.f;
    }
  }
  __syncthreads();

  // mma fragments: lane (g, t) = (lane / 4, lane % 4)
  const int g = lane >> 2, t = lane & 3;
  float* part = reinterpret_cast<float*>(smem);  // kParts x G x D, at the end

  if constexpr (C::kMma) {
    // consumer warp `warp`: tokens 16 warp .. 16 warp + 15 of every stage,
    // an online softmax of its own (head g: m, and this lane's share of
    // l); O^T accumulators: block 4 cg + j has row g = column 64 cg + 8 g
    // + 2 j and row g + 8 the next column, columns = heads 2t, 2t + 1
    float oacc[4 * C::kCg][4];
#pragma unroll
    for (int j = 0; j < 4 * C::kCg; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
    float m_run = kNegInf, l_run = 0.f;
    if (warp == kConsumers) {
      // the producer warp: lane 0 keeps the ring full, refilling a stage
      // once the consumer warps have released it
      if (lane == 0)
        for (int i = 0; i < n_tiles; ++i) {
          const int s = i % C::kStages;
          if (i >= C::kStages) mbar_wait(&empty[s], (i / C::kStages - 1) & 1);
          issue_tile<C, kInt8>(smem, full, s_table, kc, vc, ks, vs, i, t0,
                               t1, p0, page, KVH, h);
        }
      __syncwarp();
    } else {
      // Q is the A operand of S = Q K^T (rows = the G heads, zero past
      // G): lane (g, t) holds q[g][4E jj + E t + 0 .. E) for each 16-byte
      // K load jj (E elements: 8 bf16 or 16 int8), the order the K loads
      // give the B operand's k index
      constexpr int kE = C::kChunkElems;
      uint32_t qa[C::kQWords];
      const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
      for (int jj = 0; jj < C::kKLoads; ++jj)
#pragma unroll
        for (int w = 0; w < kE / 2; ++w)
          qa[jj * kE / 2 + w] =
              g < G ? q32[((row0 + g) * D + 4 * kE * jj + kE * t) / 2 + w]
                    : 0u;
      const int base = 16 * warp;

      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::kStages;
        const uint8_t* st = smem + s * C::kStageBytes;
        const float* st_ks =
            reinterpret_cast<const float*>(st + 2 * C::kKBytes);
        const float* st_vs = st_ks + kTile;
        const int n_valid = min(kTile, t1 - t0 - i * kTile);
        mbar_wait(&full[s], (i / C::kStages) & 1);
        if (base < n_valid) {
          // S = Q K^T over the n8 blocks of tokens base + 8 nb + 0 .. 7
          float c[2][4];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
            for (int e = 0; e < 4; ++e) c[nb][e] = 0.f;
            const uint8_t* krow =
                st + (base + 8 * nb + g) * C::kRowBytes + t * 16;
#pragma unroll
            for (int jj = 0; jj < C::kKLoads; ++jj) {
              uint32_t w[4];
              load_words<4>(krow + jj * 64, w);
              if constexpr (kInt8) {
#pragma unroll
                for (int hh = 0; hh < 4; ++hh) {
                  float f[4];
                  int8x4(w[hh], f);
                  const uint32_t a[4] = {qa[jj * 8 + 2 * hh], 0u,
                                         qa[jj * 8 + 2 * hh + 1], 0u};
                  mma_bf16(c[nb], a, pack_bf16(f[0], f[1]),
                           pack_bf16(f[2], f[3]));
                }
              } else {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                  const uint32_t a[4] = {qa[jj * 4 + 2 * hh], 0u,
                                         qa[jj * 4 + 2 * hh + 1], 0u};
                  mma_bf16(c[nb], a, w[2 * hh], w[2 * hh + 1]);
                }
              }
            }
          }
          // head g's scores (log2 domain) of tokens base + 8 nb + 2t + e
          // (index 2 nb + e), masked past the stage's live tokens
          float sc[4], p[4];
          float mx = kNegInf;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int tok = base + 8 * (k >> 1) + 2 * t + (k & 1);
            float v = c[k >> 1][k & 1] * qscale;
            if constexpr (kInt8) v *= st_ks[tok];
            sc[k] = tok < n_valid ? v : kNegInf;
            mx = fmaxf(mx, sc[k]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run, mx);
          const float alpha = exp2f(m_run - m_new);  // 0 on the first
          float psum = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int tok = base + 8 * (k >> 1) + 2 * t + (k & 1);
            p[k] = tok < n_valid ? exp2f(sc[k] - m_new) : 0.f;
            psum += p[k];
            if constexpr (kInt8) p[k] = tok < n_valid ? p[k] * st_vs[tok] : 0.f;
          }
          l_run = l_run * alpha + psum;
          m_run = m_new;
          // P^T as the B operand (k = token, n = head g), in two bf16
          // parts, hi + lo, so P enters at ~16 bits: b0 = tokens base +
          // 2t, 2t + 1; b1 = base + 8 + 2t, + 1
          const uint32_t bh0 = pack_bf16(p[0], p[1]);
          const uint32_t bh1 = pack_bf16(p[2], p[3]);
          const uint32_t bl0 =
              pack_bf16(p[0] - __uint_as_float(bh0 << 16),
                        p[1] - __uint_as_float(bh0 & 0xffff0000u));
          const uint32_t bl1 =
              pack_bf16(p[2] - __uint_as_float(bh1 << 16),
                        p[3] - __uint_as_float(bh1 & 0xffff0000u));
          // alpha of heads 2t and 2t + 1, held by lanes 8t and 8t + 4
          const float al0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
          const float al1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
          for (int j = 0; j < 4 * C::kCg; ++j) {
            oacc[j][0] *= al0;
            oacc[j][1] *= al1;
            oacc[j][2] *= al0;
            oacc[j][3] *= al1;
          }
          // O^T += V^T P^T: per 64-column group a lane loads its 8
          // columns of the 4 token rows it holds as k (2t, 2t + 1, 2t + 8,
          // 2t + 9); byte permutes pair them along k
          const int toks[4] = {base + 2 * t, base + 2 * t + 1,
                               base + 2 * t + 8, base + 2 * t + 9};
#pragma unroll
          for (int cg = 0; cg < C::kCg; ++cg) {
            const uint8_t* vcol =
                st + C::kKBytes + (64 * cg + 8 * g) * C::kElemBytes;
            if constexpr (kInt8) {
              float f[4][8];
#pragma unroll
              for (int r = 0; r < 4; ++r)
                load_int8<8>(vcol + toks[r] * C::kRowBytes, f[r]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const uint32_t a[4] = {
                    pack_bf16(f[0][2 * j], f[1][2 * j]),
                    pack_bf16(f[0][2 * j + 1], f[1][2 * j + 1]),
                    pack_bf16(f[2][2 * j], f[3][2 * j]),
                    pack_bf16(f[2][2 * j + 1], f[3][2 * j + 1])};
                mma_bf16(oacc[4 * cg + j], a, bh0, bh1);
                mma_bf16(oacc[4 * cg + j], a, bl0, bl1);
              }
            } else {
              // a row past the live tokens may hold any bits (NaN): its p
              // is 0, but 0 * NaN is not, so it enters as 0
              uint32_t w[4][4];
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                load_words<4>(vcol + toks[r] * C::kRowBytes, w[r]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  w[r][j] = toks[r] < n_valid ? w[r][j] : 0u;
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const uint32_t a[4] = {__byte_perm(w[0][j], w[1][j], 0x5410),
                                       __byte_perm(w[0][j], w[1][j], 0x7632),
                                       __byte_perm(w[2][j], w[3][j], 0x5410),
                                       __byte_perm(w[2][j], w[3][j], 0x7632)};
                mma_bf16(oacc[4 * cg + j], a, bh0, bh1);
                mma_bf16(oacc[4 * cg + j], a, bl0, bl1);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
      l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
    }
    __syncthreads();  // every warp is past its last read of the ring
    if (warp < kConsumers) {
      if (t == 0 && g < G) {
        s_pm[warp * G + g] = m_run;
        s_pl[warp * G + g] = l_run;
      }
#pragma unroll
      for (int cg = 0; cg < C::kCg; ++cg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hd = 2 * t + (e & 1);
            if (hd < G)
              part[(warp * G + hd) * D + 64 * cg + 8 * g + 2 * j + (e >> 1)] =
                  oacc[4 * cg + j][e];
          }
    }
  } else {
    // CUDA cores, fp32: thread 0 issues the copies; q.k a warp per 8
    // tokens, 4 lanes a token; the softmax a warp per head, a lane per
    // token; P V kColThreads threads a token group, kPvElems columns each
    if (tid == 0)
      for (int i = 0; i < C::kStages && i < n_tiles; ++i)
        issue_tile<C, kInt8>(smem, full, s_table, kc, vc, ks, vs, i, t0, t1,
                             p0, page, KVH, h);
    const int my_tok = warp * 8 + g;
    const int col = tid % C::kColThreads, grp = tid / C::kColThreads;
    float acc[G][kPvElems];
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
#pragma unroll
      for (int e = 0; e < kPvElems; ++e) acc[gg][e] = 0.f;

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::kStages;
      const uint8_t* st = smem + s * C::kStageBytes;
      const float* st_ks = reinterpret_cast<const float*>(st + 2 * C::kKBytes);
      const float* st_vs = st_ks + kTile;
      const int n_valid = min(kTile, t1 - t0 - i * kTile);
      mbar_wait(&full[s], (i / C::kStages) & 1);

      {  // scores (log2 domain) of this stage's tokens; masked ones -1e30
        float dot[G];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) dot[gg] = 0.f;
        const uint8_t* krow = st + my_tok * C::kRowBytes;
#pragma unroll
        for (int j = 0; j < C::kChunks / 4; ++j) {
          // a token's 4 lanes take its chunks t, t + 4, ...; odd tokens
          // start half a row further, so a warp's 8 rows cover all banks
          const int c = (4 * j + t + 4 * (g & 1)) % C::kChunks;
          float kx[C::kChunkElems];
          load_chunk<C::kElemBytes>(krow + c * 16, kx);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            const float4* qp = reinterpret_cast<const float4*>(
                s_q + gg * D + c * C::kChunkElems);
            float d = dot[gg];
#pragma unroll
            for (int v = 0; v < C::kChunkElems / 4; ++v) {
              const float4 qq = qp[v];
              d = fmaf(qq.x, kx[4 * v], d);
              d = fmaf(qq.y, kx[4 * v + 1], d);
              d = fmaf(qq.z, kx[4 * v + 2], d);
              d = fmaf(qq.w, kx[4 * v + 3], d);
            }
            dot[gg] = d;
          }
        }
        const float ksc = kInt8 ? st_ks[my_tok] : 1.f;
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          float d = dot[gg];
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          if ((gg & 3) == t)
            s_s[gg * kTile + my_tok] = my_tok < n_valid ? d * ksc : kNegInf;
        }
      }
      __syncthreads();
      // every thread is past the previous stage's last read: refill it
      if (tid == 0 && i >= 1 && i - 1 + C::kStages < n_tiles)
        issue_tile<C, kInt8>(smem, full, s_table, kc, vc, ks, vs,
                             i - 1 + C::kStages, t0, t1, p0, page, KVH, h);

      // online softmax, a warp per head, a lane per token
      for (int gg = warp; gg < G; gg += kConsumers) {
        const float sc = s_s[gg * kTile + lane];
        const float m_old = s_m[gg];
        const float m_new = fmaxf(m_old, warp_max(sc));
        const float p = lane < n_valid ? exp2f(sc - m_new) : 0.f;
        const float psum = warp_sum(p);
        const float alpha = exp2f(m_old - m_new);   // 0 on the first stage
        s_p[gg * kTile + lane] =
            kInt8 && lane < n_valid ? p * st_vs[lane] : p;
        __syncwarp();
        if (lane == 0) {
          s_m[gg] = m_new;
          s_l[gg] = s_l[gg] * alpha + psum;
          s_alpha[gg] = alpha;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P V over this stage's live tokens
      if (grp < C::kGroups) {
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          const float al = s_alpha[gg];
#pragma unroll
          for (int e = 0; e < kPvElems; ++e) acc[gg][e] *= al;
        }
        const uint8_t* vc0 =
            st + C::kKBytes + col * kPvElems * C::kElemBytes;
        for (int tt = grp; tt < n_valid; tt += C::kGroups) {
          float vx[kPvElems];
          load8<C::kElemBytes>(vc0 + tt * C::kRowBytes, vx);
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            const float pg = s_p[gg * kTile + tt];
#pragma unroll
            for (int e = 0; e < kPvElems; ++e)
              acc[gg][e] = fmaf(pg, vx[e], acc[gg][e]);
          }
        }
      }
    }
    __syncthreads();  // every stage is consumed
    // the token groups share the block's m; group 0 carries l
    if (tid < C::kGroups * G) {
      s_pm[tid] = s_m[tid % G];
      s_pl[tid] = tid < G ? s_l[tid] : 0.f;
    }
    if (grp < C::kGroups)
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
#pragma unroll
        for (int e = 0; e < kPvElems; ++e)
          part[(grp * G + gg) * D + col * kPvElems + e] = acc[gg][e];
  }
  __syncthreads();

  // the block's state: the parts merged with weights 2^(m_part - max)
  // partial k of row b sits at ws slot h * gridDim.y + first + k
  const size_t slot = static_cast<size_t>(h) * gridDim.y + s_split[4];
  float* ws_acc = ws;
  float* ws_ml = ws + static_cast<size_t>(KVH) * gridDim.y * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int gg = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < C::kParts; ++r) mx = fmaxf(mx, s_pm[r * G + gg]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int r = 0; r < C::kParts; ++r) {
      const float f = exp2f(s_pm[r * G + gg] - mx);
      a = fmaf(part[r * G * D + i], f, a);
      l = fmaf(s_pl[r * G + gg], f, l);
    }
    if (live == 1) {
      store_out<kQ>(out, row0 * D + i, a / fmaxf(l, 1e-30f));
    } else {
      ws_acc[(slot + split) * G * D + i] = a;
      if (i % D == 0) {
        ws_ml[((slot + split) * G + gg) * 2] = mx;
        ws_ml[((slot + split) * G + gg) * 2 + 1] = l;
      }
    }
  }
  if (live == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(&tickets[b * KVH + h], 1);
    *s_last = ticket == live - 1;
    if (*s_last) tickets[b * KVH + h] = 0;  // every live split has drawn
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  // the last block: the live splits' weights 2^(m - max) and l 2^(m -
  // max) (the ring's bytes again), then every output element as a sum
  // over the splits in split order
  float* s_w = reinterpret_cast<float*>(smem);
  float* s_wl = s_w + kMaxSplits * G;
  const float* ml = ws_ml + slot * G * 2;
  for (int gg = warp; gg < G; gg += kThreads / 32) {
    float mx = kNegInf;
    for (int r = lane; r < live; r += 32)
      mx = fmaxf(mx, __ldcg(ml + (r * G + gg) * 2));
    mx = warp_max(mx);
    for (int r = lane; r < live; r += 32) {
      const float w = exp2f(__ldcg(ml + (r * G + gg) * 2) - mx);
      s_w[r * G + gg] = w;
      s_wl[r * G + gg] = __ldcg(ml + (r * G + gg) * 2 + 1) * w;
    }
  }
  __syncthreads();
  const float4* part_acc =
      reinterpret_cast<const float4*>(ws_acc + slot * G * D);
  for (int i = tid; i < G * D / 4; i += kThreads) {
    const int gg = 4 * i / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll 8
    for (int r = 0; r < live; ++r) {
      const float4 x = __ldcg(part_acc + r * (G * D / 4) + i);
      const float w = s_w[r * G + gg];
      a.x = fmaf(x.x, w, a.x);
      a.y = fmaf(x.y, w, a.y);
      a.z = fmaf(x.z, w, a.z);
      a.w = fmaf(x.w, w, a.w);
      l += s_wl[r * G + gg];
    }
    l = fmaxf(l, 1e-30f);
    const size_t o = row0 * D + 4 * i;
    store_out<kQ>(out, o, a.x / l);
    store_out<kQ>(out, o + 1, a.y / l);
    store_out<kQ>(out, o + 2, a.z / l);
    store_out<kQ>(out, o + 3, a.w / l);
  }
}

// The kernel entries: the same body under the launch bounds each
// instantiation compiles best with. ptxas picks register targets from
// them; these are the ones with which no instantiation spills and the
// int8 serving path keeps its faster code (113 registers; with no bounds
// it took 133 and ran ~20% slower): the maximum threads alone for the
// tensor-core path at D >= 128, with 3 blocks an SM at D 64, 1 block an
// SM for the fp32 path (`paged_decode_kernel_mb`).
#define PAGED_DECODE_PARAMS                                                  \
  const void *__restrict__ q, const uint8_t *__restrict__ kc,                \
      const uint8_t *__restrict__ vc, const float *__restrict__ ks,          \
      const float *__restrict__ vs,                                          \
      const int32_t *__restrict__ block_tables,                              \
      const int32_t *__restrict__ seq_lens, void *__restrict__ out,          \
      float *__restrict__ ws, int32_t *__restrict__ tickets, int B, int H,   \
      int page, int max_pages, int chunks, int min_chunk, float qscale
#define PAGED_DECODE_ARGS                                                    \
  q, kc, vc, ks, vs, block_tables, seq_lens, out, ws, tickets, B, H, page,   \
      max_pages, chunks, min_chunk, qscale

template <int kQ, bool kInt8, int G, int D>
constexpr int kMinBlocks = kQ == 0 ? 1 : (D == 64 ? 3 : 0);

template <int kQ, bool kInt8, int G, int D>
__global__ void __launch_bounds__(Cfg<kQ, kInt8, G, D>::kThreads)
    paged_decode_kernel(PAGED_DECODE_PARAMS) {
  paged_decode<kQ, kInt8, G, D>(PAGED_DECODE_ARGS);
}

template <int kQ, bool kInt8, int G, int D>
__global__ void __launch_bounds__(Cfg<kQ, kInt8, G, D>::kThreads,
                                  kMinBlocks<kQ, kInt8, G, D>)
    paged_decode_kernel_mb(PAGED_DECODE_PARAMS) {
  paged_decode<kQ, kInt8, G, D>(PAGED_DECODE_ARGS);
}
#undef PAGED_DECODE_PARAMS
#undef PAGED_DECODE_ARGS

// The launch's arguments, passed down the dispatch by reference.
struct Args {
  const void* q;
  const void* kc;
  const void* vc;
  const float* ks;
  const float* vs;
  const int32_t* bt;
  const int32_t* sl;
  void* out;
  float* ws;
  int32_t* tickets;
  int B, H, KVH, page, max_pages, chunks, min_chunk;
  float qscale;
  cudaStream_t stream;
};

template <int kQ, bool kInt8, int G, int D, class Kernel>
cudaError_t launch_kernel(Kernel kernel, const Args& a) {
  using C = Cfg<kQ, kInt8, G, D>;
  // the block-table slice: the most pages a split takes
  const int smem =
      C::kTableOff + 4 * split_pages(a.B, a.max_pages, a.chunks, a.min_chunk);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.KVH, a.chunks + a.B);
  kernel<<<grid, C::kThreads, smem, a.stream>>>(
      a.q, static_cast<const uint8_t*>(a.kc),
      static_cast<const uint8_t*>(a.vc), a.ks, a.vs, a.bt, a.sl, a.out, a.ws,
      a.tickets, a.B, a.H, a.page, a.max_pages, a.chunks, a.min_chunk,
      a.qscale);
  return cudaGetLastError();
}

template <int kQ, bool kInt8, int G, int D>
cudaError_t launch(const Args& a) {
  if constexpr (kMinBlocks<kQ, kInt8, G, D> > 0)
    return launch_kernel<kQ, kInt8, G, D>(
        paged_decode_kernel_mb<kQ, kInt8, G, D>, a);
  else
    return launch_kernel<kQ, kInt8, G, D>(
        paged_decode_kernel<kQ, kInt8, G, D>, a);
}

template <int kQ, bool kInt8, int G>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch<kQ, kInt8, G, 64>(a);
    case 128:
      return launch<kQ, kInt8, G, 128>(a);
    case 192:
      return launch<kQ, kInt8, G, 192>(a);
    case 256:
      return launch<kQ, kInt8, G, 256>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kQ, bool kInt8>
cudaError_t dispatch_g(int G, int D, const Args& a) {
  switch (G) {
    case 1:
      return dispatch_d<kQ, kInt8, 1>(D, a);
    case 2:
      return dispatch_d<kQ, kInt8, 2>(D, a);
    case 4:
      return dispatch_d<kQ, kInt8, 4>(D, a);
    case 8:
      return dispatch_d<kQ, kInt8, 8>(D, a);
    default:
      return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it). With k_scale
// and v_scale null the caches hold q's dtype; with both given they are
// int8 and the scales fp32 (num_pages, KVH, page). The grid is (KVH,
// chunks + B): the kernel splits the batch's rows into about `chunks`
// splits per KV head of at least `min_chunk` pages each (see the
// kernel). ws is an fp32 workspace of KVH * (chunks + B) * G * (D + 2)
// elements and tickets B * KVH int32 counters that are 0 (each launch
// leaves them 0).
// Returns a cudaError_t: 0 on a successful launch.
extern "C" int paged_attention_decode(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* k_scale,
                                      const void* v_scale,
                                      const int32_t* block_tables,
                                      const int32_t* seq_lens, void* out,
                                      void* ws, int32_t* tickets, int B,
                                      int H, int KVH, int D, int page,
                                      int max_pages, int chunks,
                                      int min_chunk, float scale, int dtype,
                                      void* stream) {
  const bool int8 = k_scale != nullptr;
  if (B <= 0 || KVH <= 0 || KVH > 65535 || H % KVH != 0 || page <= 0 ||
      page % 8 != 0 || max_pages <= 0 || max_pages > kMaxTablePages ||
      (k_scale == nullptr) != (v_scale == nullptr) || chunks <= 0 ||
      min_chunk <= 0 || chunks + B > 65535 || ws == nullptr ||
      tickets == nullptr || !aligned16(k_cache) || !aligned16(v_cache) ||
      (int8 && (!aligned16(k_scale) || !aligned16(v_scale))) ||
      !aligned16(ws))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KVH;
  const Args a{q,
               k_cache,
               v_cache,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               block_tables,
               seq_lens,
               out,
               static_cast<float*>(ws),
               tickets,
               B,
               H,
               KVH,
               page,
               max_pages,
               chunks,
               min_chunk,
               scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (dtype == 0)
    e = int8 ? dispatch_g<0, true>(G, D, a) : dispatch_g<0, false>(G, D, a);
  else if (dtype == 1)
    e = int8 ? dispatch_g<1, true>(G, D, a) : dispatch_g<1, false>(G, D, a);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
