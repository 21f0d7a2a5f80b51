// Multi-LoRA delta for Hopper (sm_90a): one launch per projection, every
// rank bucket and the y + delta epilogue fused, rows grouped by slot. Plain
// C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of paddle_tpu/kernels/
// lora_matmul.py (:176, pallas_call :229) together with the composition the
// reference wraps around it for one projection of one launch
// (paddle_tpu/serving/lora/runtime.py: `LoRAContext.delta` :71-96, one call
// per rank bucket summed in fp32, and `apply_lora` :138-149, the cast and
// the add):
//   out[m] = y[m] + (d_0[m] + d_1[m] + ...).to(y.dtype)
//   d_b[m] = (x[m] @ A_b[s]) @ B_b[s]
// x (M, H) bf16 or fp32; y and out (M, N) bf16 or fp32 (out may be y); for
// every rank bucket b, A_b (S_b, H, R_b) and B_b (S_b, R_b, N) fp32 with the
// per-slot alpha/rank scaling folded into B_b. Row m belongs to entry m / t
// of row_slots (B entries of t = M / B consecutive rows: a decode row, or a
// prefill chunk's tokens); its global slot g lies in bucket b when first_b
// <= g < first_b + S_b, at local slot s = g - first_b. Local slot 0 (the
// null adapter), or a slot in no bucket, gives the composition's exact 0.0.
// The buckets sum in fp32 in bucket order with the exact zeros included (a
// row lies in one bucket, so the sum is d + 0.0 when there are two or
// more); the sum is rounded once to y's dtype and added in fp32, rounded
// once: PyTorch's bf16 add. Rows with no adapter get y + 0.0, written like
// every other row. The delta-only instantiation (no y) writes the fp32
// bucket sum.
//
// Bound on this card: bytes. At decode (16 rows) a projection does ~2 flops
// for each weight byte it reads. At a 512-row prefill chunk of one slot the
// products (0.30 GFLOP at gate_proj, rank 16) take 4.5 us at fp32's 67
// TFLOP/s, less than the epilogue's bytes (x 4.2 MB, y read and written 29.4
// MB: ~10 us). So the products are fp32 FMAs on the CUDA cores: no TF32 and
// no tensor cores, which would round the fp32 weights.
//
// The design:
//   * rows grouped by slot, on the card: every block reads row_slots and
//     derives the same grouping (a count per (bucket, slot) key, a warp scan
//     over the keys, a ballot scan over the entries): units of up to T rows
//     of one key, the keys in (bucket, slot) order, the null key last.
//     `lora_groups` in lora_matmul.py is the same rule in Python. The host
//     sizes the grid from the shapes alone (an upper bound of the units,
//     `lora_apply_plan`) and never reads the ids; blocks past the last unit
//     exit at once. Each live slot's A and B stream from memory once a
//     launch, not once a row (the repeats of a unit's column clusters come
//     from L2), and a unit's x rows are staged in shared memory once;
//   * the H reduction split over a thread-block cluster of C CTAs, with no
//     second launch: each CTA reduces its slice of H for all of the unit's
//     rows. The unit's x rows and its slot's A rows come through a ring of
//     stages: 1-D bulk copies (TMA) completing on one mbarrier a stage,
//     issued by warp 0, or cp.async where a shape breaks the copies'
//     16-byte alignment. A stage is as wide in H as the ring allows two of
//     (a decode unit's whole slice is one stage: a launch of 16 rows moves
//     few bytes, and each copy request costs more than its bytes). On an
//     H100 the bulk copies (and the y stages they allow) take ~5% off the
//     decode projection and ~12% off a 512-row prefill chunk against a
//     build that stages every shape by cp.async (chip_ab.py). One
//     thread per (rank, h split) sums every row of the unit in registers,
//     as many as the unit's rows rounded up to a power of 2 (a fixed
//     64-row body, guarded, ran all 64 rows' loads and FMAs at decode:
//     ~5x the time); the h splits add in a fixed order (a shuffle tree
//     inside a warp, then the warps in order) into the CTA's (rows, R)
//     partial in shared memory. After a cluster barrier each CTA reads the
//     C partials over distributed shared memory in CTA order (no atomics,
//     no workspace), then expands its own slice of N. The slot's B columns
//     of that slice and the unit's y rows (a ring of two 8-row blocks) come
//     by bulk copies the other warps issue while warp 0 issues the ring's,
//     so they land while the shrink runs; one thread per 4 columns and 4
//     or 8 rows computes from shared memory and stores out with vector
//     stores. A unit spans K clusters; each recomputes the shrink, its
//     repeats of A and x coming from L2;
//   * fp32 throughout, bf16 x widened exactly.
//
// Determinism: a row's output depends only on its own x, its own y, its
// slot's weights and the shapes. Its reduction order is fixed by H, C (the
// H slices) and R (the h splits, whose quads a stage's width never
// reorders) alone; the grouping changes which block computes a row, never
// how. No float atomics: repeat launches are bitwise equal.
//
// The kernel launches on the caller's stream and allocates nothing; the C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bulk_load;
using hopper::mbar_arrive_expect_tx;
using hopper::mbar_fence_init;
using hopper::mbar_init;
using hopper::mbar_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBuckets = 8;
constexpr int kMaxRank = 256;
constexpr int kMaxKeys = 1024;     // live (bucket, slot) keys + the null key
constexpr int kMaxRowTile = 64;
constexpr int kMaxStages = 8;
constexpr unsigned kMaxCluster = 8;
constexpr int kRowBlock = 8;       // rows an expanding thread holds at once
constexpr int kYStages = 2;        // y row blocks in flight
constexpr int kRingBytes = 40 * 1024;
constexpr int kBStageBytes = 40 * 1024;  // a CTA's B columns, when they fit
constexpr int kYStageBytes = 24 * 1024;  // its y stages, when they fit

struct Bucket {
  const float* a;  // (S, H, R)
  const float* b;  // (S, R, N)
  int R, RP, KS;   // rank, its padded width (a power of 2, >= 4), h splits
  int first, S, key0;
};

struct Params {
  const void* x;
  const void* y;   // nullptr: the delta-only instantiation
  void* out;
  const int* slots;
  Bucket bk[kMaxBuckets];
  int nb, nkeys;   // nkeys: the live keys and the null key (the last)
  int H, N, B, t;
  int HC, Hs, W;   // H chunk, H slice of a cluster rank, columns of a CTA
  int tma;         // bulk copies for x, A, B and y (all 16-byte aligned)
  int vec_a, vec_x, pair_x, vec_b, vec_y;  // the cp.async / load paths
  int ring_bytes;  // [0, ring_bytes): the x / A ring, then the split sums, xa
  int p_off;       // the CTA's partial (T, RP)
  int b_off, b_stage;  // its B columns (R, W), when staged
  int y_off, y_stage;  // its y row blocks (kYStages, 8, W), when staged
};

constexpr int kKeyCache = 1024;  // entries whose key the first pass keeps

struct Meta {
  int cnt[kMaxKeys];
  short keys[kKeyCache];
  int rows[kMaxRowTile];
  int win[kMaxRowTile + 1];
  int warp_n[kWarps];
  int info[2];
  uint64_t bar[kMaxStages + 1 + kYStages];  // the ring's stages, B, y stages
};

template <typename XT>
struct XOps;
template <>
struct XOps<float> {
  static __device__ __forceinline__ float4 quad(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
};
template <>
struct XOps<__nv_bfloat16> {
  static __device__ __forceinline__ float4 quad(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16(0.f);
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// src_bytes 0 copies nothing and zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// a float of CTA `rank`'s shared memory, at the address `local` has here
// (volatile: kept after the cluster barrier, whose asm orders memory)
__device__ __forceinline__ float ld_dsmem(const float* local, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote));
  return v;
}

// the key of global slot g: bucket b's live slots s = 1 .. S_b - 1 are keys
// key0_b + s - 1; slot 0 of a bucket, or a slot in none, is the null key
__device__ __forceinline__ int key_of(const Params& p, int g) {
  int key = p.nkeys - 1;
  bool found = false;
#pragma unroll
  for (int b = 0; b < kMaxBuckets; ++b) {  // static indices: constant loads
    const long long local = static_cast<long long>(g) - p.bk[b].first;
    if (!found && b < p.nb && local >= 0 && local < p.bk[b].S) {
      found = true;
      if (local > 0) key = p.bk[b].key0 + static_cast<int>(local) - 1;
    }
  }
  return key;
}

// The unit of this block: its key, its first row within the key and its
// rows (meta.rows[0 .. n)). Returns the row count, 0 past the last unit.
template <int kT>
__device__ __forceinline__ int find_unit(const Params& p, Meta& meta,
                                         int& key) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.y;
  for (int k = tid; k < p.nkeys; k += kThreads) meta.cnt[k] = 0;
  __syncthreads();
  for (int i = tid; i < p.B; i += kThreads) {
    const int k = key_of(p, p.slots[i]);
    if (i < kKeyCache) meta.keys[i] = static_cast<short>(k);
    atomicAdd(&meta.cnt[k], 1);
  }
  __syncthreads();
  // key k takes ceil(cnt_k * t / T) units, the keys in order
  if (warp == 0) {
    int base = 0, found = -1, start = 0;
    for (int k0 = 0; k0 < p.nkeys && found < 0; k0 += 32) {
      const int k = k0 + lane;
      const int tiles =
          k < p.nkeys
              ? static_cast<int>((static_cast<long long>(meta.cnt[k]) * p.t +
                                  kT - 1) / kT)
              : 0;
      int incl = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int first = base + incl - tiles;
      const unsigned hit = __ballot_sync(
          0xffffffffu, unit >= first && unit < first + tiles);
      if (hit) {
        const int src = __ffs(hit) - 1;
        found = __shfl_sync(0xffffffffu, k, src);
        start = __shfl_sync(0xffffffffu, first, src);
      }
      base += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) {
      meta.info[0] = found;
      meta.info[1] = start;
    }
  }
  __syncthreads();
  key = meta.info[0];
  if (key < 0) return 0;
  const int row0 = (unit - meta.info[1]) * kT;
  const long long key_rows = static_cast<long long>(meta.cnt[key]) * p.t;
  const int n = static_cast<int>(key_rows - row0 < kT ? key_rows - row0 : kT);
  const int p_lo = row0 / p.t, p_hi = (row0 + n - 1) / p.t;
  // the key's entries at positions p_lo .. p_hi, in entry order
  int base = 0;
  for (int i0 = 0; i0 < p.B && base <= p_hi; i0 += kThreads) {
    const int i = i0 + tid;
    const bool mine =
        i < p.B &&
        (i < kKeyCache ? meta.keys[i] : key_of(p, p.slots[i])) == key;
    const unsigned bal = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) meta.warp_n[warp] = __popc(bal);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int c = meta.warp_n[w];
      if (w < warp) off += c;
      total += c;
    }
    if (mine) {
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
      if (pos >= p_lo && pos <= p_hi) meta.win[pos - p_lo] = i;
    }
    base += total;
    __syncthreads();
  }
  for (int q = tid; q < n; q += kThreads) {
    const int r = row0 + q;
    const int pos = r / p.t;
    meta.rows[q] = meta.win[pos - p_lo] * p.t + (r - pos * p.t);
  }
  __syncthreads();
  return n;
}

// x rows rows[0 .. n) at h0 .. h0 + HC (zeros past h_end) into xs (n, HC)
template <typename XT>
__device__ __forceinline__ void load_x(const Params& p, const int* rows, int n,
                                       int HC, int h0, int h_end, XT* xs) {
  const XT* x = static_cast<const XT*>(p.x);
  if (p.vec_x) {
    constexpr int E = 16 / sizeof(XT);
    const int per = HC / E;
    for (int i = threadIdx.x; i < n * per; i += kThreads) {
      const int q = i / per, e = (i - q * per) * E, h = h0 + e;
      const bool ok = h < h_end;
      cp_async16(xs + q * HC + e,
                 ok ? x + static_cast<size_t>(rows[q]) * p.H + h : x,
                 ok ? 16 : 0);
    }
  } else if (p.pair_x) {  // 4-byte pieces: fp32 x, or bf16 x with H even
    constexpr int E = 4 / sizeof(XT);
    const int per = HC / E;
    for (int i = threadIdx.x; i < n * per; i += kThreads) {
      const int q = i / per, e = (i - q * per) * E, h = h0 + e;
      const bool ok = h < h_end;
      cp_async4(xs + q * HC + e,
                ok ? x + static_cast<size_t>(rows[q]) * p.H + h : x,
                ok ? 4 : 0);
    }
  } else {  // bf16 x with H odd: element by element
    for (int i = threadIdx.x; i < n * HC; i += kThreads) {
      const int q = i / HC, e = i - q * HC, h = h0 + e;
      xs[q * HC + e] = h < h_end ? x[static_cast<size_t>(rows[q]) * p.H + h]
                                 : XOps<XT>::zero();
    }
  }
}

// A rows h0 .. h0 + HC of one slot (zeros past h_end) into as (HC, R),
// contiguous as in memory
__device__ __forceinline__ void load_a(const Params& p, const Bucket& bk,
                                       const float* a, int HC, int h0,
                                       int h_end, float* as) {
  const int total = HC * bk.R;
  const int valid = (h_end - h0) * bk.R;  // floats of the chunk inside H
  const float* src = a + static_cast<size_t>(h0) * bk.R;
  if (p.vec_a) {
    for (int f = threadIdx.x * 4; f < total; f += kThreads * 4) {
      const int v = valid - f < 0 ? 0 : (valid - f > 4 ? 4 : valid - f);
      cp_async16(as + f, v ? src + f : a, 4 * v);
    }
  } else {
    for (int f = threadIdx.x; f < total; f += kThreads)
      cp_async4(as + f, f < valid ? src + f : a, f < valid ? 4 : 0);
  }
}

// Warp 0: chunk c of the H slice into ring stage c % ns by bulk copies (the
// unit's x rows, then the slot's A rows), completing on bar[c % ns]
template <typename XT>
__device__ __forceinline__ void tma_chunk(const Params& p, const Bucket& bk,
                                          const float* a, const int* rows,
                                          int n, int HC, int c, int h_begin,
                                          int h_end, int ns, int stage_bytes,
                                          int xs_bytes, unsigned char* smem,
                                          uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const int s = c % ns;
  const int h0 = h_begin + c * HC;
  const int hv = min(HC, h_end - h0);
  unsigned char* st = smem + s * stage_bytes;
  const uint32_t xrow = hv * static_cast<int>(sizeof(XT));
  const uint32_t abytes = hv * bk.R * 4;
  if (lane == 0) mbar_arrive_expect_tx(&bar[s], n * xrow + abytes);
  __syncwarp();
  const XT* x = static_cast<const XT*>(p.x);
  for (int q = lane; q < n; q += 32)
    bulk_load(st + q * HC * static_cast<int>(sizeof(XT)),
              x + static_cast<size_t>(rows[q]) * p.H + h0, xrow, &bar[s]);
  if (lane == 0)
    bulk_load(st + xs_bytes, a + static_cast<size_t>(h0) * bk.R, abytes,
              &bar[s]);
}

// Warp 0: the unit's y rows of row block rb at columns n0 .. n0 + wv into
// y stage rb % kYStages by bulk copies, completing on bar[rb % kYStages]
template <int kMode>
__device__ __forceinline__ void tma_y(const Params& p, const int* rows, int n,
                                      int rb, int n0, int wv,
                                      unsigned char* yst, uint64_t* bar) {
  constexpr int ys = kMode == 2 ? 2 : 4;
  const int lane = threadIdx.x & 31;
  const int s = rb % kYStages;
  const int m0 = rb * kRowBlock;
  const int nr = min(kRowBlock, n - m0);
  if (lane == 0) mbar_arrive_expect_tx(&bar[s], nr * wv * ys);
  __syncwarp();
  const unsigned char* y = static_cast<const unsigned char*>(p.y);
  unsigned char* dst = yst + s * kRowBlock * p.W * ys;
  for (int i = lane; i < nr; i += 32)
    bulk_load(dst + i * p.W * ys,
              y + (static_cast<size_t>(rows[m0 + i]) * p.N + n0) * ys,
              wv * ys, &bar[s]);
}

// Threads first .. 255: the slot's B rows at this CTA's columns n0 .. n0 +
// wv into bst (R, W), then the unit's y rows of the first kYStages row
// blocks into their stages, one bulk copy a thread (thread 0 has armed
// b_bar and y_bar[] with their bytes)
template <int kMode>
__device__ __forceinline__ void tma_rows(const Params& p, const Bucket& bk,
                                         int slot, const int* rows, int n,
                                         int n0, int wv, float* bst,
                                         unsigned char* yst, uint64_t* b_bar,
                                         uint64_t* y_bar, int first) {
  constexpr int ys = kMode == 2 ? 2 : 4;
  const int nbr = bst ? bk.R : 0;
  const int nyr = yst ? min(n, kYStages * kRowBlock) : 0;
  const unsigned char* y = static_cast<const unsigned char*>(p.y);
  for (int j = static_cast<int>(threadIdx.x) - first; j < nbr + nyr;
       j += kThreads - first) {
    if (j < nbr) {
      bulk_load(bst + j * p.W,
                bk.b + (static_cast<size_t>(slot) * bk.R + j) * p.N + n0,
                wv * 4, b_bar);
    } else {
      const int i = j - nbr;  // stage i / 8 holds rows i / 8 * 8 ...
      bulk_load(yst + i * p.W * ys,
                y + (static_cast<size_t>(rows[i]) * p.N + n0) * ys, wv * ys,
                &y_bar[i / kRowBlock]);
    }
  }
}

// This CTA's partial over its H slice: part[m * RP + r] for the unit's n
// <= kNR rows. Thread (kp, r) sums the h quads kp, kp + KS, ... of every
// chunk in h order; the KS splits then add by a shuffle tree inside each
// warp and the warps in order. kNR, the rows a thread's registers hold,
// is the unit's row count rounded up to a power of 2 (the guarded rows of
// a fixed unrolled loop would be computed all the same). On the
// bulk-copy path warp 0 issues the ring's copies.
template <typename XT, int kNR>
__device__ __forceinline__ void shrink(const Params& p, const Bucket& bk,
                                       int slot, int n, const int* rows,
                                       unsigned char* smem, float* part,
                                       uint64_t* bar) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int h_begin = static_cast<int>(cluster_rank()) * p.Hs;
  const int h_end = min(p.H, h_begin + p.Hs);
  const int span = h_end - h_begin;
  // a stage keeps kNR x rows: rows n .. kNR - 1 are computed (on stale
  // bytes) and never stored, so the unrolled row loop has no branch
  const int row_bytes = kNR * static_cast<int>(sizeof(XT));
  // the chunk: p.HC doubled while the ring still holds two stages (one,
  // if it is the only chunk). p.HC / 4 is a multiple of KS, so a thread's
  // h quads, and so every sum's order, do not depend on the chunk
  int HC = p.HC;
  while (HC < span) {
    const int hc = 2 * HC;
    const int st = hc * row_bytes + ((hc * bk.R * 4 + 15) & ~15);
    if ((hc < span ? 2 : 1) * st > p.ring_bytes) break;
    HC = hc;
  }
  const int xs_bytes = HC * row_bytes;
  const int stage_bytes = xs_bytes + ((HC * bk.R * 4 + 15) & ~15);
  int ns = p.ring_bytes / stage_bytes;
  ns = ns < kMaxStages ? ns : kMaxStages;
  const int nch = span > 0 ? (span + HC - 1) / HC : 0;
  const float* a = bk.a + static_cast<size_t>(slot) * p.H * bk.R;
  const int r = tid & (bk.RP - 1), kp = tid / bk.RP;
  const bool active = r < bk.R && kp < bk.KS;
  float acc[kNR];
#pragma unroll
  for (int m = 0; m < kNR; ++m) acc[m] = 0.f;

  int issued = 0;
  auto issue = [&]() {  // the cp.async path: every thread copies its part
    unsigned char* st = smem + (issued % ns) * stage_bytes;
    const int h0 = h_begin + issued * HC;
    load_x<XT>(p, rows, n, HC, h0, h_end, reinterpret_cast<XT*>(st));
    load_a(p, bk, a, HC, h0, h_end, reinterpret_cast<float*>(st + xs_bytes));
    cp_async_commit();
    ++issued;
  };
  if (p.tma) {
    if (warp == 0) {
      for (int c = 0; c < nch && c < ns; ++c)
        tma_chunk<XT>(p, bk, a, rows, n, HC, c, h_begin, h_end, ns,
                      stage_bytes, xs_bytes, smem, bar);
    }
  } else {
    while (issued < nch && issued < ns - 1) issue();
  }
  for (int ch = 0; ch < nch; ++ch) {
    if (p.tma) {
      mbar_wait(&bar[ch % ns], (ch / ns) & 1);
    } else {
      if (issued < nch) issue();
      cp_async_wait(issued - ch - 1);
      __syncthreads();
    }
    if (active) {
      const unsigned char* st = smem + (ch % ns) * stage_bytes;
      const XT* xs = reinterpret_cast<const XT*>(st);
      const float* as = reinterpret_cast<const float*>(st + xs_bytes);
      const int hv = min(HC, h_end - (h_begin + ch * HC));
      for (int hq = kp * 4; hq < hv; hq += bk.KS * 4) {
        const float a0 = as[(hq + 0) * bk.R + r];
        const float a1 = as[(hq + 1) * bk.R + r];
        const float a2 = as[(hq + 2) * bk.R + r];
        const float a3 = as[(hq + 3) * bk.R + r];
#pragma unroll
        for (int m = 0; m < kNR; ++m) {
          const float4 v = XOps<XT>::quad(xs + m * HC + hq);
          float s = acc[m];
          s = fmaf(v.x, a0, s);
          s = fmaf(v.y, a1, s);
          s = fmaf(v.z, a2, s);
          s = fmaf(v.w, a3, s);
          acc[m] = s;
        }
      }
    }
    __syncthreads();
    if (p.tma && warp == 0 && ch + ns < nch)
      tma_chunk<XT>(p, bk, a, rows, n, HC, ch + ns, h_begin, h_end, ns,
                    stage_bytes, xs_bytes, smem, bar);
  }
  // the h splits: lanes of a warp with the same r first (a fixed xor
  // tree), then the warps' sums in order (over the ring, which is done)
  int sets = bk.KS, g = kp;
  bool writer = active;
  if (bk.RP < 32) {
    for (int off = 16; off >= bk.RP; off >>= 1) {
#pragma unroll
      for (int m = 0; m < kNR; ++m)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    }
    sets = bk.KS * bk.RP / 32;
    g = warp;
    writer = active && (tid & 31) < bk.RP;
  }
  float* red = reinterpret_cast<float*>(smem);  // (sets, n, RP)
  if (writer) {
#pragma unroll
    for (int m = 0; m < kNR; ++m)
      if (m < n) red[(g * n + m) * bk.RP + r] = acc[m];
  }
  __syncthreads();
  for (int o = tid; o < n * bk.R; o += kThreads) {
    const int m = o / bk.R, rr = o - m * bk.R;
    float s = red[m * bk.RP + rr];
    for (int k = 1; k < sets; ++k) s += red[(k * n + m) * bk.RP + rr];
    part[m * bk.RP + rr] = s;
  }
}

template <int kMode>
__device__ __forceinline__ void load_y(const Params& p, int row, int col,
                                       int nc, float (&v)[4]) {
  const size_t at = static_cast<size_t>(row) * p.N + col;
  if (kMode == 1) {
    const float* src = static_cast<const float*>(p.y) + at;
    if (p.vec_y && nc == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = c < nc ? src[c] : 0.f;
    }
  } else {
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(p.y) + at;
    if (p.vec_y && nc == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
      v[0] = lo.x;
      v[1] = lo.y;
      v[2] = hi.x;
      v[3] = hi.y;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = c < nc ? __bfloat162float(src[c]) : 0.f;
    }
  }
}

// kMode 0: out = d (fp32); 1: out = y + d (fp32); 2: out = bf16(y +
// float(bf16(d))), PyTorch's y + d.to(bfloat16)
template <int kMode>
__device__ __forceinline__ void store_out(const Params& p, int row, int col,
                                          int nc, const float (&d)[4],
                                          const float (&yv)[4]) {
  const size_t at = static_cast<size_t>(row) * p.N + col;
  if (kMode != 2) {
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = kMode == 0 ? d[c] : yv[c] + d[c];
    float* dst = static_cast<float*>(p.out) + at;
    if (p.vec_y && nc == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nc) dst[c] = o[c];
    }
  } else {
    __nv_bfloat16 o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o[c] = __float2bfloat16_rn(
          yv[c] + __bfloat162float(__float2bfloat16_rn(d[c])));
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out) + at;
    if (p.vec_y && nc == 4) {
      uint2 u;
      *reinterpret_cast<__nv_bfloat162*>(&u.x) = __halves2bfloat162(o[0], o[1]);
      *reinterpret_cast<__nv_bfloat162*>(&u.y) = __halves2bfloat162(o[2], o[3]);
      *reinterpret_cast<uint2*>(dst) = u;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (c < nc) dst[c] = o[c];
    }
  }
}

// B row r of the slot at columns col .. col + 3 (zeros past R or nc)
__device__ __forceinline__ void load_b(const float* bs, int r, int R, int N,
                                       int col, int nc, bool vec,
                                       float (&v)[4]) {
  if (r < R) {
    const float* src = bs + static_cast<size_t>(r) * N + col;
    if (vec && nc == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src));
      v[0] = t.x;
      v[1] = t.y;
      v[2] = t.z;
      v[3] = t.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = c < nc ? __ldg(src + c) : 0.f;
    }
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}

// The cp.async path: the slot's B rows at this CTA's columns n0 .. n0 + wv
// into bst (R, W) (N a multiple of 4: vec_b)
__device__ __forceinline__ void stage_b(const Params& p, const Bucket& bk,
                                        int slot, int n0, int wv,
                                        float* bst) {
  const int per = (wv + 3) / 4;
  const float* bs = bk.b + static_cast<size_t>(slot) * bk.R * p.N + n0;
  for (int i = threadIdx.x; i < bk.R * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * 4;
    cp_async16(bst + r * p.W + c, bs + static_cast<size_t>(r) * p.N + c, 16);
  }
}

// This CTA's columns n0 .. n0 + wv of every row of the unit: d = xa @
// B[slot] (zeros for the null key, bk == nullptr), then the epilogue. Row
// blocks of 8 in order; in each, thread q takes columns 4q .. 4q + 3 of
// its 8 rows, neighbouring threads on neighbouring columns. B comes from
// bst and y from the y stages when staged, else from global memory.
template <int kMode, int kRB>
__device__ __forceinline__ void expand_rows(const Params& p, const Bucket* bk,
                                       int slot, int n, const int* rows,
                                       const float* xa, int n0, int wv,
                                       const float* bst, unsigned char* yst,
                                       uint64_t* ybar) {
  constexpr int ys = kMode == 2 ? 2 : 4;
  const int nq = (wv + 3) >> 2;
  const int nrb = (n + kRB - 1) / kRB;
  const int R = bk ? bk->R : 0;
  const int RP = bk ? bk->RP : 4;
  const float* bs =
      bk ? bk->b + static_cast<size_t>(slot) * bk->R * p.N : nullptr;
  const bool two = p.nb > 1;
  for (int rb = 0; rb < nrb; ++rb) {
    const int m0 = rb * kRB;
    const unsigned char* yb =
        yst ? yst + (rb % kYStages) * kRowBlock * p.W * ys : nullptr;
    if (yst) mbar_wait(&ybar[rb % kYStages], (rb / kYStages) & 1);
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const int col = n0 + 4 * q;
      const int nc = min(4, wv - 4 * q);
      float acc[kRB][4];
      float yv[kRB][4];
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = yv[i][c] = 0.f;
        if (kMode != 0 && m0 + i < n) {
          if (yb && kMode == 1) {
            const float4 t = *reinterpret_cast<const float4*>(
                yb + (i * p.W + 4 * q) * ys);
            yv[i][0] = t.x;
            yv[i][1] = t.y;
            yv[i][2] = t.z;
            yv[i][3] = t.w;
          } else if (yb) {
            const float4 t = XOps<__nv_bfloat16>::quad(
                reinterpret_cast<const __nv_bfloat16*>(yb) + i * p.W + 4 * q);
            yv[i][0] = t.x;
            yv[i][1] = t.y;
            yv[i][2] = t.z;
            yv[i][3] = t.w;
          } else {
            load_y<kMode>(p, rows[m0 + i], col, nc, yv[i]);
          }
        }
      }
      // acc[i][c] += xa[m0 + i][r .. r + 3] . bv[0 .. 3][c], r in order
      auto fma4 = [&](const float (&bv)[4][4], int r) {
#pragma unroll
        for (int i = 0; i < kRB; ++i) {  // rows past n: computed, not stored
          const float4 w =
              *reinterpret_cast<const float4*>(xa + (m0 + i) * RP + r);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float s = acc[i][c];
            s = fmaf(w.x, bv[0][c], s);
            s = fmaf(w.y, bv[1][c], s);
            s = fmaf(w.z, bv[2][c], s);
            s = fmaf(w.w, bv[3][c], s);
            acc[i][c] = s;
          }
        }
      };
      if (bst) {  // B from shared memory; a short last group guarded
        const float* bq = bst + 4 * q;
        for (int r = 0; r < R; r += 4) {
          float bv[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
            if (r + 4 <= R || r + j < R)
              t = *reinterpret_cast<const float4*>(bq + (r + j) * p.W);
            bv[j][0] = t.x;
            bv[j][1] = t.y;
            bv[j][2] = t.z;
            bv[j][3] = t.w;
          }
          fma4(bv, r);
        }
      } else {
        for (int r = 0; r < R; r += 4) {
          float bv[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            load_b(bs, r + j, R, p.N, col, nc, p.vec_b, bv[j]);
          fma4(bv, r);
        }
      }
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        if (m0 + i < n) {
          float d[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            d[c] = two ? acc[i][c] + 0.f : acc[i][c];
          store_out<kMode>(p, rows[m0 + i], col, nc, d, yv[i]);
        }
      }
    }
    if (yst) {  // the stage is free: the row block kYStages on takes it
      __syncthreads();
      if (threadIdx.x < 32 && rb + kYStages < nrb)
        tma_y<kMode>(p, rows, n, rb + kYStages, n0, wv, yst, ybar);
    }
  }
}

// Rows a thread holds: 4 when the unit has no more (a decode unit), else 8
template <int kMode>
__device__ __forceinline__ void expand(const Params& p, const Bucket* bk,
                                       int slot, int n, const int* rows,
                                       const float* xa, int n0, int wv,
                                       const float* bst, unsigned char* yst,
                                       uint64_t* ybar) {
  if (n <= 4)
    expand_rows<kMode, 4>(p, bk, slot, n, rows, xa, n0, wv, bst, yst, ybar);
  else
    expand_rows<kMode, kRowBlock>(p, bk, slot, n, rows, xa, n0, wv, bst, yst,
                                  ybar);
}

template <typename XT, int kMode, int kT>
__global__ void __launch_bounds__(kThreads, 2)
    lora_apply_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Meta meta;
  if (p.tma && threadIdx.x == 0) {
    for (int i = 0; i < kMaxStages + 1 + kYStages; ++i)
      mbar_init(&meta.bar[i], 1);
    mbar_fence_init();
  }
  int key;
  const int n = find_unit<kT>(p, meta, key);  // its barriers publish bar[]
  if (n == 0) return;  // past the last unit: the whole cluster leaves
  const int n0 = blockIdx.x * p.W;
  const int wv = max(0, min(p.N, n0 + p.W) - n0);  // this CTA's columns
  constexpr int ys = kMode == 2 ? 2 : 4;
  uint64_t* b_bar = meta.bar + kMaxStages;
  uint64_t* y_bar = b_bar + 1;
  unsigned char* yst =
      kMode != 0 && p.y_stage && wv > 0 ? smem + p.y_off : nullptr;
  const bool live = key < p.nkeys - 1;
  Bucket bk = p.bk[0];
#pragma unroll
  for (int b = 1; b < kMaxBuckets; ++b)  // the bucket of key, by static loads
    if (b < p.nb && key >= p.bk[b].key0) bk = p.bk[b];
  const int slot = key - bk.key0 + 1;
  float* bst = live && p.b_stage && wv > 0
                   ? reinterpret_cast<float*>(smem + p.b_off)
                   : nullptr;
  if (p.tma && (bst || yst)) {
    // thread 0 arms B's and the first y stages' barriers; then warps 1 ..
    // (all warps for the null key) issue those rows while warp 0 issues
    // the ring's
    if (threadIdx.x == 0) {
      if (bst) mbar_arrive_expect_tx(b_bar, bk.R * wv * 4);
      for (int rb = 0; yst && rb < kYStages && rb * kRowBlock < n; ++rb)
        mbar_arrive_expect_tx(&y_bar[rb],
                              min(kRowBlock, n - rb * kRowBlock) * wv * ys);
    }
    __syncthreads();
    if (!live || threadIdx.x >= 32)
      tma_rows<kMode>(p, bk, slot, meta.rows, n, n0, wv, bst, yst, b_bar,
                      y_bar, live ? 32 : 0);
  }
  if (!live) {  // the null key: y + 0.0, no cluster barrier
    expand<kMode>(p, nullptr, 0, n, meta.rows, nullptr, n0, wv, nullptr,
                  yst, y_bar);
    return;
  }
  float* part = reinterpret_cast<float*>(smem + p.p_off);  // (kT, RP)
  if (bst && !p.tma) {  // the oldest cp.async group, ahead of the ring
    stage_b(p, bk, slot, n0, wv, bst);
    cp_async_commit();
  }
  if (n <= 4) {
    shrink<XT, 4>(p, bk, slot, n, meta.rows, smem, part, meta.bar);
  } else if (n <= 8) {
    shrink<XT, 8>(p, bk, slot, n, meta.rows, smem, part, meta.bar);
  } else if constexpr (kT == 16) {
    shrink<XT, 16>(p, bk, slot, n, meta.rows, smem, part, meta.bar);
  } else if (n <= 16) {
    shrink<XT, 16>(p, bk, slot, n, meta.rows, smem, part, meta.bar);
  } else if (n <= 32) {
    shrink<XT, 32>(p, bk, slot, n, meta.rows, smem, part, meta.bar);
  } else {
    shrink<XT, 64>(p, bk, slot, n, meta.rows, smem, part, meta.bar);
  }
  if (bst && !p.tma) cp_async_wait(0);  // B, when the slice had no chunk
  cluster_arrive();  // every partial of the cluster written
  cluster_wait();
  // xa = the partials of ranks 0, 1, ..., C - 1 in order (zeros in the
  // padding up to a multiple of 4), over the ring
  float* xa = reinterpret_cast<float*>(smem);  // (n, RP)
  const unsigned C = cluster_size();
  const int R4 = (bk.R + 3) & ~3;
  for (int o = threadIdx.x; o < n * R4; o += kThreads) {
    const int m = o / R4, r = o - m * R4;
    float s = 0.f;
    if (r < bk.R) {  // every rank's value in flight at once, then the sum
      const float* at = part + m * bk.RP + r;
      float v[kMaxCluster];
#pragma unroll
      for (unsigned c = 0; c < kMaxCluster; ++c)
        if (c < C) v[c] = ld_dsmem(at, c);
      s = v[0];
#pragma unroll
      for (unsigned c = 1; c < kMaxCluster; ++c)
        if (c < C) s += v[c];
    }
    xa[m * bk.RP + r] = s;
  }
  cluster_arrive();  // done reading the other CTAs' partials
  __syncthreads();
  if (bst && p.tma) mbar_wait(b_bar, 0);
  expand<kMode>(p, &bk, slot, n, meta.rows, xa, n0, wv, bst, yst, y_bar);
  cluster_wait();    // no CTA leaves while another may read its partial
}

struct LoraBucketC {  // one rank bucket as the host passes it
  int64_t a, b;       // device pointers of the A and B stacks
  int32_t R, first, S, pad;
};

int pad_rank(int R) {
  int rp = 4;
  while (rp < R) rp *= 2;
  return rp;
}

template <typename XT, int kMode, int kT>
int launch(const Params& p, dim3 grid, int C, size_t smem, cudaStream_t s) {
  auto kern = lora_apply_kernel<XT, kMode, kT>;
  static size_t allowed = 0;
  if (smem > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)   // the most shared memory, for two CTAs an SM
      e = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, int kMode>
int launch_t(const Params& p, dim3 grid, int C, int T, size_t smem,
             cudaStream_t s) {
  return T == 64 ? launch<XT, kMode, 64>(p, grid, C, smem, s)
                 : launch<XT, kMode, 16>(p, grid, C, smem, s);
}

template <typename XT>
int launch_mode(const Params& p, int y_dtype, dim3 grid, int C, int T,
                size_t smem, cudaStream_t s) {
  if (y_dtype < 0) return launch_t<XT, 0>(p, grid, C, T, smem, s);
  if (y_dtype == 0) return launch_t<XT, 1>(p, grid, C, T, smem, s);
  return launch_t<XT, 2>(p, grid, C, T, smem, s);
}

}  // namespace

// x (M, H); y and out (M, N), out may be y (y null: out is the fp32 delta);
// row_slots (B,) int32 with M = B * t; buckets: a host array of nb
// LoraBucketC, first slots ascending, ranges disjoint. x_dtype 0 = float32,
// 1 = bfloat16; y_dtype -1 = none, 0 = float32, 1 = bfloat16. The plan
// (cluster size C, column clusters K, row tile T, H chunk HC, units) comes
// from `lora_apply_plan`. Returns a cudaError_t: 0 when the launch
// succeeded.
extern "C" int lora_apply(const void* x, const void* y, void* out,
                          const void* row_slots, const void* buckets, int nb,
                          int M, int H, int N, int B, int x_dtype, int y_dtype,
                          int C, int K, int T, int HC, int units,
                          void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nb < 1 || nb > kMaxBuckets || M <= 0 || B <= 0 || M % B != 0 ||
      H < 0 || N <= 0 || K < 1 || units < 1 || units > 65535 ||
      (C != 1 && C != 2 && C != 4 && C != 8) ||
      static_cast<long long>(K) * C > 65535 || (T != 16 && T != 64) ||
      (HC != 16 && HC != 32 && HC != 64) || x_dtype < 0 || x_dtype > 1 ||
      y_dtype < -1 || y_dtype > 1 || (y_dtype < 0) != (y == nullptr) ||
      x == nullptr || out == nullptr || row_slots == nullptr)
    return bad;
  Params p = {};
  p.x = x;
  p.y = y;
  p.out = out;
  p.slots = static_cast<const int*>(row_slots);
  p.nb = nb;
  p.H = H;
  p.N = N;
  p.B = B;
  p.t = M / B;
  p.HC = HC;
  const LoraBucketC* rec = static_cast<const LoraBucketC*>(buckets);
  const int es = x_dtype ? 2 : 4;
  const int ys = y_dtype == 1 ? 2 : 4;
  int keys = 0, rp_max = 4, r_max = 1, red = 0;
  bool a16 = true, b16 = true;
  for (int b = 0; b < nb; ++b) {
    Bucket& bk = p.bk[b];
    bk.a = reinterpret_cast<const float*>(rec[b].a);
    bk.b = reinterpret_cast<const float*>(rec[b].b);
    bk.R = rec[b].R;
    bk.first = rec[b].first;
    bk.S = rec[b].S;
    if (bk.R < 1 || bk.R > kMaxRank || bk.S < 1 || bk.first < 0 ||
        (b > 0 && static_cast<long long>(bk.first) <
                      static_cast<long long>(p.bk[b - 1].first) +
                          p.bk[b - 1].S))
      return bad;
    bk.RP = pad_rank(bk.R);
    bk.KS = kThreads / bk.RP < HC / 4 ? kThreads / bk.RP : HC / 4;
    bk.key0 = keys;
    keys += bk.S - 1;
    if (keys >= kMaxKeys) return bad;
    a16 = a16 && reinterpret_cast<uintptr_t>(bk.a) % 16 == 0 &&
          (static_cast<long long>(H) * bk.R) % 4 == 0;
    b16 = b16 && reinterpret_cast<uintptr_t>(bk.b) % 16 == 0;
    rp_max = rp_max > bk.RP ? rp_max : bk.RP;
    r_max = r_max > bk.R ? r_max : bk.R;
    // the h-split sums: a set per warp below 32 ranks, per split above
    const int sets = bk.RP < 32 ? bk.KS * bk.RP / 32 : bk.KS;
    const int rb = sets * T * bk.RP * 4;
    red = red > rb ? red : rb;
  }
  p.nkeys = keys + 1;
  const int per = (H + C - 1) / C;
  p.Hs = (per + HC - 1) / HC * HC;
  const int slices = K * C;
  p.W = ((N + slices - 1) / slices + 7) / 8 * 8;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(x);
  const uintptr_t op = reinterpret_cast<uintptr_t>(out);
  const uintptr_t yp = reinterpret_cast<uintptr_t>(y);
  p.vec_a = a16;
  p.vec_x = (static_cast<long long>(H) * es) % 16 == 0 && xp % 16 == 0;
  p.pair_x = es == 4 || (H % 2 == 0 && xp % 4 == 0);
  p.vec_b = N % 4 == 0 && b16;
  const uintptr_t va = y_dtype == 1 ? 8 : 16;
  p.vec_y = N % 4 == 0 && op % va == 0 && (y_dtype < 0 || yp % va == 0);
  // bulk copies need 16-byte aligned rows and lengths: x rows, A slices
  // (H a multiple of 4), B columns and y rows
  p.tma = p.vec_x && H % 4 == 0 && a16 && p.vec_b &&
          (y_dtype < 0 ||
           (yp % 16 == 0 && (static_cast<long long>(N) * ys) % 16 == 0));
  // the ring holds two stages of a full unit at least; the h-split sums
  // and xa use the same bytes once the ring is done
  const int stage_max = T * HC * es + HC * r_max * 4;
  int ring = kRingBytes > 2 * stage_max ? kRingBytes : 2 * stage_max;
  ring = ring > red ? ring : red;
  ring = ring > T * rp_max * 4 ? ring : T * rp_max * 4;
  p.ring_bytes = ring;
  p.p_off = ring;
  p.b_off = ring + T * rp_max * 4;
  const long long b_bytes = static_cast<long long>(r_max) * p.W * 4;
  p.b_stage = p.vec_b && b_bytes <= kBStageBytes;
  p.y_off = p.b_off + (p.b_stage ? static_cast<int>(b_bytes) : 0);
  const long long y_bytes =
      static_cast<long long>(kYStages) * kRowBlock * p.W * ys;
  p.y_stage = p.tma && y_dtype >= 0 && y_bytes <= kYStageBytes;
  const size_t smem = static_cast<size_t>(p.y_off) +
                      (p.y_stage ? static_cast<size_t>(y_bytes) : 0);
  if (smem + sizeof(Meta) > 227 * 1024) return bad;
  const dim3 grid(slices, units);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? launch_mode<float>(p, y_dtype, grid, C, T, smem, s)
             : launch_mode<__nv_bfloat16>(p, y_dtype, grid, C, T, smem, s);
}
