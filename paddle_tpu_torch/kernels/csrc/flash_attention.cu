// Flash attention forward, dQ and dK/dV for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernels of paddle_tpu/kernels/flash_attention.py:
// `_fwd_kernel` (online-softmax attention; out and the fp32 logsumexp),
// `_dq_kernel` and `_dkv_kernel` (the backward from the saved lse; delta =
// rowsum(dO * O) arrives precomputed) where the wgmma kernels do not:
// every kernel in fp32 and at head_dim > 128. bf16 at head_dim <= 128 runs
// the wgmma kernels of flash_fwd_sm90.cu (the forward) and
// flash_bwd_sm90.cu (dQ and dK/dV), in every mode, and these entries
// refuse those shapes. Layout (B*H, S, D), contiguous;
// causal is bottom-right aligned: key j is visible to query i iff
// j <= i + (Sk - Sq). A masked score is -1e30 and contributes exactly 0;
// the softmax sum is clamped at 1e-30 at finalize, so a row that sees no
// key gives zeros (the plain versions beside the wrappers agree).
//
// Three mask modes, a template parameter of every kernel (never a branch
// at run time: the plain mode keeps its own loop and its speed):
//   * kPlain     — none, or the causal mask above (`flash_attention_bshd`);
//   * kSegment   — varlen packing (`flash_attention_varlen_bshd`): per-token
//                  (segment id, position in its sequence) rows of shape
//                  (B, 2, S); a query sees a key only in its own segment,
//                  and under `causal` only when pos_k <= pos_q. No global
//                  causal mask applies (the reference's `_apply_masks`);
//   * kFlashmask — per-key-column row bounds (B*Hm, C, Sk), Hm 1 or H
//                  (`flashmask_attention_bshd`); `causal` adds the global
//                  causal mask, `fm_causal` picks the bounds' meaning.
// Tiles are skipped with the TPU kernel's `_block_contributes`, carried
// over exactly: overlapping segment-id ranges, the one-sequence
// all-future skip, and the C == 1 causal document skip (q0 >= the tile's
// largest start). Those ranges come from per-32-row summaries the wrapper
// computes with plain torch ops, once for the three kernels of a call; a
// caller may ask for the count of visited tile pairs (`Mask::visits`).
// The predicate and the mask helpers live in flash_mask.cuh, shared with
// flash_fwd_sm90.cu and flash_bwd_sm90.cu.
// Under the masked modes a skipped tile can be followed by a contributing
// one, so each warp evaluates the predicate for 32 tiles at once (one
// lane per tile, every warp alike) and the loop visits the set bits of
// the ballot: no early exit, and a skipped tile costs no memory round
// trip of its own.
//
// Bound on this card: operations. At the training shape (S 4096, D 128)
// each kernel does ~D/2 multiply-adds per byte it must move, far above
// the ~295 flop/byte where the H100's bf16 tensor cores bind, so the
// design keeps the products on the tensor cores and every tile on chip:
//   * a block owns one tile of the parallel side (64 query rows in fwd
//     and dq, 64 key rows in dkv; 32 for fp32 at head_dim > 128) and one
//     chunk of <= 128 output columns; the TPU grid's sequential axis
//     (ki in fwd/dq, qi in dkv) is a loop inside the block, with the
//     running max, sum and accumulators in registers (Hopper has no
//     ordered grid to carry them across blocks);
//   * each warp owns 16 rows of the tile. bf16 products run on
//     mma.sync m16n8k16 with fp32 accumulation; fp32 runs fp32 FMAs
//     (never TF32) with each thread computing the same fragment
//     positions, so the softmax code is shared by both types;
//   * P (fwd, dkv) and dS (dq, dkv) pass from the accumulator layout to
//     the next product through the warp's own shared-memory slab. In
//     bf16 that is where they are ROUNDED to bf16 (as FlashAttention-2
//     does); the row sums, max and lse stay fp32 from unrounded values;
//   * dQ and dK/dV stay two kernels, as on the TPU, so no atomics are
//     needed and the gradients are deterministic;
//   * tiles that lie wholly above the causal diagonal are skipped with
//     the TPU kernel's `_block_contributes` predicate;
//   * ragged edges (S not a multiple of the tile, head_dim a multiple of
//     8 below the instantiated 64/128/256) are zero-filled in shared
//     memory and masked; nothing past S or D is stored.
// Not done here: wgmma/TMA (flash_fwd_sm90.cu and flash_bwd_sm90.cu have
// them for bf16 at head_dim <= 128), cp.async double buffering, ldmatrix,
// a persistent causal schedule.
//
// The kernels launch on the caller's stream and allocate nothing; each C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

using namespace flash_mask;

constexpr float kNegInf = -1e30f;

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

// DP: head dim the tiles are laid out for (64, 128 or 256; D <= DP is
// zero-padded). A tile has kTile rows: 64, or 32 where four 64-row tiles
// of that width would pass 200 KB of shared memory.
template <bool kBf16, int DP>
struct Cfg {
  using T = typename Tr<kBf16>::T;
  static constexpr int kLd = DP + Tr<kBf16>::kPad;
  static constexpr int kTile =
      (4 * 64 * kLd * static_cast<int>(sizeof(T)) <= 200 * 1024) ? 64 : 32;
  static constexpr int kWarps = kTile / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kDC = DP < 128 ? DP : 128;  // output columns a block owns
  static constexpr int kPLd = kTile + Tr<kBf16>::kPad;
  static constexpr int kTileElems = kTile * kLd;
  static constexpr int kSlabElems = 16 * kPLd;  // one warp's P or dS slab
};

// rows [r0, r0 + kTile) of a (S, D) matrix -> shared (kTile, kLd),
// zero-filled past S and past D; 16-byte vectors (D is a multiple of 8).
template <bool kBf16, int DP>
__device__ __forceinline__ void load_tile(typename Tr<kBf16>::T* dst,
                                          const typename Tr<kBf16>::T* src,
                                          int r0, int S, int D) {
  using C = Cfg<kBf16, DP>;
  using T = typename Tr<kBf16>::T;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecPerRow = DP / kVec;
  for (int i = threadIdx.x; i < C::kTile * kVecPerRow; i += C::kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i - r * kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S && c < D)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * C::kLd + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator fragment of a warp's 16 x (NT*8) tile, in mma.sync's C
// layout: with g = lane / 4 and t = lane % 4, acc[j][0..1] hold row g,
// columns 8j + 2t + {0, 1}; acc[j][2..3] the same columns of row g + 8.

// acc += A (16 x K, row-major, lda) * Bt^T, Bt (NT*8 x K, row-major, ldb)
template <bool kBf16, int NT, int K>
__device__ __forceinline__ void gemm_abt(float (&acc)[NT][4],
                                         const typename Tr<kBf16>::T* A,
                                         int lda,
                                         const typename Tr<kBf16>::T* Bt,
                                         int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t a[4];
      a[0] = ld32(A + g * lda + kk + 2 * t);
      a[1] = ld32(A + (g + 8) * lda + kk + 2 * t);
      a[2] = ld32(A + g * lda + kk + 8 + 2 * t);
      a[3] = ld32(A + (g + 8) * lda + kk + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* b = Bt + (j * 8 + g) * ldb + kk + 2 * t;
        mma16816(acc[j], a, ld32(b), ld32(b + 8));
      }
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A[g * lda + k], a1 = A[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = Bt[(j * 8 + 2 * t) * ldb + k];
        const float b1 = Bt[(j * 8 + 2 * t + 1) * ldb + k];
        acc[j][0] = fmaf(a0, b0, acc[j][0]);
        acc[j][1] = fmaf(a0, b1, acc[j][1]);
        acc[j][2] = fmaf(a1, b0, acc[j][2]);
        acc[j][3] = fmaf(a1, b1, acc[j][3]);
      }
    }
  }
}

// acc += A (16 x K, row-major, lda) * B, B (K x NT*8, row-major, ldb)
template <bool kBf16, int NT, int K>
__device__ __forceinline__ void gemm_ab(float (&acc)[NT][4],
                                        const typename Tr<kBf16>::T* A,
                                        int lda,
                                        const typename Tr<kBf16>::T* B,
                                        int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
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
    for (int k = 0; k < K; ++k) {
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

// A fragment -> the warp's (16, ld) slab in the storage type (bf16:
// round to nearest even — the rounding of P and dS).
template <bool kBf16, int NT>
__device__ __forceinline__ void store_frag(typename Tr<kBf16>::T* P, int ld,
                                           const float (&c)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = j * 8 + 2 * t;
    if constexpr (kBf16) {
      *reinterpret_cast<uint32_t*>(P + g * ld + col) = pack2(
          __float2bfloat16_rn(c[j][0]), __float2bfloat16_rn(c[j][1]));
      *reinterpret_cast<uint32_t*>(P + (g + 8) * ld + col) = pack2(
          __float2bfloat16_rn(c[j][2]), __float2bfloat16_rn(c[j][3]));
    } else {
      *reinterpret_cast<float2*>(P + g * ld + col) =
          make_float2(c[j][0], c[j][1]);
      *reinterpret_cast<float2*>(P + (g + 8) * ld + col) =
          make_float2(c[j][2], c[j][3]);
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ void store_out(typename Tr<kBf16>::T* p, float x) {
  if constexpr (kBf16)
    *p = __float2bfloat16_rn(x);
  else
    *p = x;
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// the key columns' mask inputs of tile [k0, k0 + tile) into shared memory:
// segment (id, pos) rows, or the C bound rows
template <int kMode>
__device__ __forceinline__ void stage_cols(int* dst, const Mask& mk,
                                           const int* seg_b, const int* fm_b,
                                           int k0, int tile, int S,
                                           int threads) {
  if constexpr (kMode == kSegment) {
    for (int i = threadIdx.x; i < tile; i += threads) {
      const int c = k0 + i;
      dst[i] = c < S ? seg_b[c] : 0;
      dst[tile + i] = c < S ? seg_b[S + c] : 0;
    }
  } else if constexpr (kMode == kFlashmask) {
    for (int i = threadIdx.x; i < mk.C * tile; i += threads) {
      const int cc = i / tile, c = k0 + i - cc * tile;
      dst[i] = c < S ? fm_b[static_cast<size_t>(cc) * S + c] : 0;
    }
  }
}

// (acc rows g, g+8) of the fragment in global memory, rows < S, columns
// [c0, c0 + NT*8) clipped at D, each divided by its row's `div` (a true
// division, as the plain version rounds).
template <bool kBf16, int NT>
__device__ __forceinline__ void store_rows(typename Tr<kBf16>::T* dst,
                                           const float (&acc)[NT][4],
                                           int row0, int S, int c0, int D,
                                           const float (&div)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = c0 + j * 8 + 2 * t;
      if (col < D) {  // D is even, so col + 1 < D too
        typename Tr<kBf16>::T* p = dst + static_cast<size_t>(row) * D + col;
        store_out<kBf16>(p, acc[j][2 * r] / div[r]);
        store_out<kBf16>(p + 1, acc[j][2 * r + 1] / div[r]);
      }
    }
  }
}

// ----------------------------------------------------------------- fwd
// grid (q tiles, B*H, D chunks); q tiles run last-first so the heaviest
// causal tiles start first.
template <bool kBf16, int DP, int kMode>
__global__ void __launch_bounds__(Cfg<kBf16, DP>::kThreads)
flash_fwd_kernel(const typename Tr<kBf16>::T* __restrict__ q,
                 const typename Tr<kBf16>::T* __restrict__ k,
                 const typename Tr<kBf16>::T* __restrict__ v,
                 typename Tr<kBf16>::T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int D, float scale,
                 int causal, const Mask mk) {
  using C = Cfg<kBf16, DP>;
  using T = typename Tr<kBf16>::T;
  constexpr int kT = C::kTile, kNT = kT / 8, kDT = C::kDC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + C::kTileElems;
  T* sV = sK + C::kTileElems;
  T* sP = sV + C::kTileElems;
  int* sCol = reinterpret_cast<int*>(sP + C::kWarps * C::kSlabElems);

  const int nq = (Sq + kT - 1) / kT;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kT;
  const size_t bh = blockIdx.y;
  const int dc0 = blockIdx.z * C::kDC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  load_tile<kBf16, DP>(sQ, q + bh * Sq * D, q0, Sq, D);
  const T* qw = sQ + warp * 16 * C::kLd;
  T* pw = sP + warp * C::kSlabElems;

  // the masked modes' inputs of this block's rows and batch row
  const size_t b = bh / (kMode == kPlain ? 1 : mk.H);
  const int* segk_b = kMode == kSegment ? mk.segk + b * 2 * Sk : nullptr;
  const size_t fh = mk.Hm == 1 ? b : bh;
  const int* fm_b = kMode == kFlashmask
                        ? mk.fm + fh * static_cast<size_t>(mk.C) * Sk
                        : nullptr;
  int rid[2] = {0, 0}, rpos[2] = {0, 0};
  if constexpr (kMode == kSegment) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < Sq) {
        rid[r] = mk.segq[b * 2 * Sq + row];
        rpos[r] = mk.segq[b * 2 * Sq + Sq + row];
      }
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[kDT][4];
  zero(acc);
  auto step = [&](int k0) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<kBf16, DP>(sK, kb, k0, Sk, D);
    load_tile<kBf16, DP>(sV, vb, k0, Sk, D);
    stage_cols<kMode>(sCol, mk, segk_b, fm_b, k0, kT, Sk, C::kThreads);
    __syncthreads();
    float s[kNT][4];
    zero(s);
    gemm_abt<kBf16, kNT, DP>(s, qw, C::kLd, sK, C::kLd);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cj = j * 8 + 2 * t + e;
          const int col = k0 + cj;
          const float x = s[j][2 * r + e] * scale;
          bool masked;
          if constexpr (kMode == kSegment)
            masked = col >= Sk || sCol[cj] != rid[r] ||
                     (causal && sCol[kT + cj] > rpos[r]);
          else if constexpr (kMode == kFlashmask)
            masked = col >= Sk || (causal && col > row + off) ||
                     fm_masked(row, sCol + cj, kT, mk.C, mk.fm_causal);
          else
            masked = col >= Sk || (causal && col > row + off);
          s[j][2 * r + e] = masked ? kNegInf : x;
          mx = fmaxf(mx, s[j][2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[r], mx);
      const float alpha = (m[r] <= kNegInf / 2) ? 0.f : expf(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * r + e];
          const float p = (x <= kNegInf / 2) ? 0.f : expf(x - mn);
          s[j][2 * r + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha + sum;
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    store_frag<kBf16, kNT>(pw, C::kPLd, s);
    __syncwarp();
    gemm_ab<kBf16, kDT, kT>(acc, pw, C::kPLd, sV + dc0, C::kLd);
    __syncwarp();
  };
  const int nk = (Sk + kT - 1) / kT;
  if constexpr (kMode == kPlain) {
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kT;
      if (!contributes(q0, k0, kT, off, causal)) break;
      step(k0);
    }
  } else {
    const int nqg = (Sq + kGroup - 1) / kGroup, nkg = (Sk + kGroup - 1) / kGroup;
    SegRange qr{};
    if constexpr (kMode == kSegment) qr = seg_range(mk.qsum + b * 4 * nqg, nqg, q0, kT);
    for (int base = 0; base < nk; base += 32) {
      const int kt = base + lane;
      bool c = false;
      if (kt < nk) {
        if constexpr (kMode == kSegment)
          c = seg_contributes(
              qr, seg_range(mk.ksum + b * 4 * nkg, nkg, kt * kT, kT), causal);
        else
          c = fm_contributes(
              q0, kt * kT, kT, off, causal, mk,
              mk.C == 1 && mk.fm_causal
                  ? fm_start_max(mk.fmsum + fh * 2 * nkg, nkg, kt * kT, kT)
                  : 0);
      }
      unsigned live = __ballot_sync(0xffffffffu, c);
      count_visits(mk, live);
      while (live) {
        step((base + __ffs(live) - 1) * kT);
        live &= live - 1;
      }
    }
  }

  float safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    safe[r] = fmaxf(l[r], 1e-30f);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (blockIdx.z == 0 && t == 0 && row < Sq)
      lse[bh * Sq + row] = m[r] + logf(safe[r]);
  }
  store_rows<kBf16, kDT>(out + bh * Sq * D, acc, q0 + warp * 16, Sq, dc0, D,
                         safe);
}

// ------------------------------------------------------------------ dq
// grid (q tiles, B*H, D chunks)
template <bool kBf16, int DP, int kMode>
__global__ void __launch_bounds__(Cfg<kBf16, DP>::kThreads)
flash_dq_kernel(const typename Tr<kBf16>::T* __restrict__ q,
                const typename Tr<kBf16>::T* __restrict__ k,
                const typename Tr<kBf16>::T* __restrict__ v,
                const typename Tr<kBf16>::T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                typename Tr<kBf16>::T* __restrict__ dq, int Sq, int Sk, int D,
                float scale, int causal, const Mask mk) {
  using C = Cfg<kBf16, DP>;
  using T = typename Tr<kBf16>::T;
  constexpr int kT = C::kTile, kNT = kT / 8, kDT = C::kDC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + C::kTileElems;
  T* sK = sdO + C::kTileElems;
  T* sV = sK + C::kTileElems;
  T* sS = sV + C::kTileElems;
  int* sCol = reinterpret_cast<int*>(sS + C::kWarps * C::kSlabElems);

  const int nq = (Sq + kT - 1) / kT;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kT;
  const size_t bh = blockIdx.y;
  const int dc0 = blockIdx.z * C::kDC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  load_tile<kBf16, DP>(sQ, q + bh * Sq * D, q0, Sq, D);
  load_tile<kBf16, DP>(sdO, dout + bh * Sq * D, q0, Sq, D);
  const T* qw = sQ + warp * 16 * C::kLd;
  const T* dow = sdO + warp * 16 * C::kLd;
  T* dsw = sS + warp * C::kSlabElems;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse_r[r] = row < Sq ? lse[bh * Sq + row] : 0.f;
    delta_r[r] = row < Sq ? delta[bh * Sq + row] : 0.f;
  }

  // the masked modes' inputs of this block's rows and batch row
  const size_t b = bh / (kMode == kPlain ? 1 : mk.H);
  const int* segk_b = kMode == kSegment ? mk.segk + b * 2 * Sk : nullptr;
  const size_t fh = mk.Hm == 1 ? b : bh;
  const int* fm_b = kMode == kFlashmask
                        ? mk.fm + fh * static_cast<size_t>(mk.C) * Sk
                        : nullptr;
  int rid[2] = {0, 0}, rpos[2] = {0, 0};
  if constexpr (kMode == kSegment) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      if (row < Sq) {
        rid[r] = mk.segq[b * 2 * Sq + row];
        rpos[r] = mk.segq[b * 2 * Sq + Sq + row];
      }
    }
  }

  float acc[kDT][4];
  zero(acc);
  auto step = [&](int k0) {
    __syncthreads();
    load_tile<kBf16, DP>(sK, kb, k0, Sk, D);
    load_tile<kBf16, DP>(sV, vb, k0, Sk, D);
    stage_cols<kMode>(sCol, mk, segk_b, fm_b, k0, kT, Sk, C::kThreads);
    __syncthreads();
    float s[kNT][4], dp[kNT][4];
    zero(s);
    zero(dp);
    gemm_abt<kBf16, kNT, DP>(s, qw, C::kLd, sK, C::kLd);
    gemm_abt<kBf16, kNT, DP>(dp, dow, C::kLd, sV, C::kLd);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = q0 + warp * 16 + g + 8 * r;
        const int cj = j * 8 + 2 * t + (e & 1);
        const int col = k0 + cj;
        bool masked;
        if constexpr (kMode == kSegment)
          masked = row >= Sq || col >= Sk || sCol[cj] != rid[r] ||
                   (causal && sCol[kT + cj] > rpos[r]);
        else if constexpr (kMode == kFlashmask)
          masked = row >= Sq || col >= Sk || (causal && col > row + off) ||
                   fm_masked(row, sCol + cj, kT, mk.C, mk.fm_causal);
        else
          masked = row >= Sq || col >= Sk || (causal && col > row + off);
        const float p = masked ? 0.f : expf(s[j][e] * scale - lse_r[r]);
        s[j][e] = p * (dp[j][e] - delta_r[r]) * scale;
      }
    store_frag<kBf16, kNT>(dsw, C::kPLd, s);
    __syncwarp();
    gemm_ab<kBf16, kDT, kT>(acc, dsw, C::kPLd, sK + dc0, C::kLd);
    __syncwarp();
  };
  const int nk = (Sk + kT - 1) / kT;
  if constexpr (kMode == kPlain) {
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * kT;
      if (!contributes(q0, k0, kT, off, causal)) break;
      step(k0);
    }
  } else {
    const int nqg = (Sq + kGroup - 1) / kGroup, nkg = (Sk + kGroup - 1) / kGroup;
    SegRange qr{};
    if constexpr (kMode == kSegment) qr = seg_range(mk.qsum + b * 4 * nqg, nqg, q0, kT);
    for (int base = 0; base < nk; base += 32) {
      const int kt = base + lane;
      bool c = false;
      if (kt < nk) {
        if constexpr (kMode == kSegment)
          c = seg_contributes(
              qr, seg_range(mk.ksum + b * 4 * nkg, nkg, kt * kT, kT), causal);
        else
          c = fm_contributes(
              q0, kt * kT, kT, off, causal, mk,
              mk.C == 1 && mk.fm_causal
                  ? fm_start_max(mk.fmsum + fh * 2 * nkg, nkg, kt * kT, kT)
                  : 0);
      }
      unsigned live = __ballot_sync(0xffffffffu, c);
      count_visits(mk, live);
      while (live) {
        step((base + __ffs(live) - 1) * kT);
        live &= live - 1;
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<kBf16, kDT>(dq + bh * Sq * D, acc, q0 + warp * 16, Sq, dc0, D,
                         one);
}

// ----------------------------------------------------------------- dkv
// grid (k tiles, B*H, D chunks); a block owns kTile key rows and loops
// over the q tiles that can see them.
template <bool kBf16, int DP, int kMode>
__global__ void __launch_bounds__(Cfg<kBf16, DP>::kThreads)
flash_dkv_kernel(const typename Tr<kBf16>::T* __restrict__ q,
                 const typename Tr<kBf16>::T* __restrict__ k,
                 const typename Tr<kBf16>::T* __restrict__ v,
                 const typename Tr<kBf16>::T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 typename Tr<kBf16>::T* __restrict__ dk,
                 typename Tr<kBf16>::T* __restrict__ dv, int Sq, int Sk,
                 int D, float scale, int causal, const Mask mk) {
  using C = Cfg<kBf16, DP>;
  using T = typename Tr<kBf16>::T;
  constexpr int kT = C::kTile, kNT = kT / 8, kDT = C::kDC / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + C::kTileElems;
  T* sQ = sV + C::kTileElems;
  T* sdO = sQ + C::kTileElems;
  T* sP = sdO + C::kTileElems;
  T* sS = sP + C::kWarps * C::kSlabElems;
  float* sLse = reinterpret_cast<float*>(sS + C::kWarps * C::kSlabElems);
  float* sDelta = sLse + kT;
  int* sCol = reinterpret_cast<int*>(sDelta + kT);  // the q tile's (id, pos)
  int* sKeyFm = sCol + 4 * kT;                      // this block's key bounds

  const int k0 = blockIdx.x * kT;
  const size_t bh = blockIdx.y;
  const int dc0 = blockIdx.z * C::kDC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const T* qb = q + bh * Sq * D;
  const T* dob = dout + bh * Sq * D;
  load_tile<kBf16, DP>(sK, k + bh * Sk * D, k0, Sk, D);
  load_tile<kBf16, DP>(sV, v + bh * Sk * D, k0, Sk, D);
  const T* kw = sK + warp * 16 * C::kLd;
  const T* vw = sV + warp * 16 * C::kLd;
  T* pw = sP + warp * C::kSlabElems;
  T* dsw = sS + warp * C::kSlabElems;

  // the masked modes' inputs of this block's keys and batch row
  const size_t b = bh / (kMode == kPlain ? 1 : mk.H);
  const int* segq_b = kMode == kSegment ? mk.segq + b * 2 * Sq : nullptr;
  const size_t fh = mk.Hm == 1 ? b : bh;
  int kid[2] = {0, 0}, kpos[2] = {0, 0};
  if constexpr (kMode == kSegment) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + warp * 16 + g + 8 * r;
      if (key < Sk) {
        kid[r] = mk.segk[b * 2 * Sk + key];
        kpos[r] = mk.segk[b * 2 * Sk + Sk + key];
      }
    }
  } else if constexpr (kMode == kFlashmask) {
    // read after the first step's __syncthreads
    stage_cols<kMode>(sKeyFm, mk, nullptr,
                      mk.fm + fh * static_cast<size_t>(mk.C) * Sk, k0, kT, Sk,
                      C::kThreads);
  }

  float acc_k[kDT][4], acc_v[kDT][4];
  zero(acc_k);
  zero(acc_v);
  auto step = [&](int q0) {
    __syncthreads();
    load_tile<kBf16, DP>(sQ, qb, q0, Sq, D);
    load_tile<kBf16, DP>(sdO, dob, q0, Sq, D);
    for (int i = threadIdx.x; i < kT; i += C::kThreads) {
      const bool live = q0 + i < Sq;
      sLse[i] = live ? lse[bh * Sq + q0 + i] : 0.f;
      sDelta[i] = live ? delta[bh * Sq + q0 + i] : 0.f;
    }
    if constexpr (kMode == kSegment)
      stage_cols<kMode>(sCol, mk, segq_b, nullptr, q0, kT, Sq, C::kThreads);
    __syncthreads();
    // transposed scores: rows are this warp's keys, columns queries
    float s[kNT][4], dp[kNT][4];
    zero(s);
    zero(dp);
    gemm_abt<kBf16, kNT, DP>(s, kw, C::kLd, sQ, C::kLd);
    gemm_abt<kBf16, kNT, DP>(dp, vw, C::kLd, sdO, C::kLd);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = warp * 16 + g + 8 * (e >> 1);
        const int key = k0 + kl;
        const int ci = j * 8 + 2 * t + (e & 1);
        const int qi = q0 + ci;
        bool masked;
        if constexpr (kMode == kSegment)
          masked = qi >= Sq || key >= Sk || sCol[ci] != kid[e >> 1] ||
                   (causal && kpos[e >> 1] > sCol[kT + ci]);
        else if constexpr (kMode == kFlashmask)
          masked = qi >= Sq || key >= Sk || (causal && key > qi + off) ||
                   fm_masked(qi, sKeyFm + kl, kT, mk.C, mk.fm_causal);
        else
          masked = qi >= Sq || key >= Sk || (causal && key > qi + off);
        const float p = masked ? 0.f : expf(s[j][e] * scale - sLse[ci]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sDelta[ci]) * scale;
      }
    store_frag<kBf16, kNT>(pw, C::kPLd, s);
    store_frag<kBf16, kNT>(dsw, C::kPLd, dp);
    __syncwarp();
    gemm_ab<kBf16, kDT, kT>(acc_v, pw, C::kPLd, sdO + dc0, C::kLd);
    gemm_ab<kBf16, kDT, kT>(acc_k, dsw, C::kPLd, sQ + dc0, C::kLd);
    __syncwarp();
  };
  const int nq = (Sq + kT - 1) / kT;
  if constexpr (kMode == kPlain) {
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * kT;
      if (!contributes(q0, k0, kT, off, causal)) continue;
      step(q0);
    }
  } else {
    const int nqg = (Sq + kGroup - 1) / kGroup, nkg = (Sk + kGroup - 1) / kGroup;
    SegRange kr{};
    int start_max = 0;
    if constexpr (kMode == kSegment)
      kr = seg_range(mk.ksum + b * 4 * nkg, nkg, k0, kT);
    else if (mk.C == 1 && mk.fm_causal)
      start_max = fm_start_max(mk.fmsum + fh * 2 * nkg, nkg, k0, kT);
    for (int base = 0; base < nq; base += 32) {
      const int qt = base + lane;
      bool c = false;
      if (qt < nq) {
        if constexpr (kMode == kSegment)
          c = seg_contributes(
              seg_range(mk.qsum + b * 4 * nqg, nqg, qt * kT, kT), kr, causal);
        else
          c = fm_contributes(qt * kT, k0, kT, off, causal, mk, start_max);
      }
      unsigned live = __ballot_sync(0xffffffffu, c);
      count_visits(mk, live);
      while (live) {
        step((base + __ffs(live) - 1) * kT);
        live &= live - 1;
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<kBf16, kDT>(dk + bh * Sk * D, acc_k, k0 + warp * 16, Sk, dc0, D,
                         one);
  store_rows<kBf16, kDT>(dv + bh * Sk * D, acc_v, k0 + warp * 16, Sk, dc0, D,
                         one);
}

// ------------------------------------------------------------- launches
template <bool kBf16, int DP>
size_t smem_bytes(int kind, int mode) {  // kind: 0 fwd, 1 dq, 2 dkv
  using C = Cfg<kBf16, DP>;
  const size_t e = sizeof(typename Tr<kBf16>::T);
  const size_t tile = C::kTileElems * e, slab = C::kWarps * C::kSlabElems * e;
  // the masked modes' column inputs (and dkv's key bounds), as ints
  const size_t cols = mode == kPlain ? 0 : (kind == 2 ? 8 : 4) * C::kTile * 4;
  if (kind == 0) return 3 * tile + slab + cols;
  if (kind == 1) return 4 * tile + slab + cols;
  return 4 * tile + 2 * slab + 2 * C::kTile * sizeof(float) + cols;
}

struct Args {
  const void *q, *k, *v, *dout, *lse_in, *delta;
  void *out, *lse, *dq, *dk, *dv;
  int BH, Sq, Sk, D;
  float scale;
  int causal, mode;
  Mask mk;
  cudaStream_t stream;
};

template <bool kBf16, int DP, int kMode>
cudaError_t launch(int kind, const Args& a) {
  using C = Cfg<kBf16, DP>;
  using T = typename Tr<kBf16>::T;
  const size_t sm = smem_bytes<kBf16, DP>(kind, kMode);
  const int rows = kind == 2 ? a.Sk : a.Sq;
  const dim3 grid((rows + C::kTile - 1) / C::kTile, a.BH,
                  (a.D + C::kDC - 1) / C::kDC);
  cudaError_t e;
  if (kind == 0) {
    e = cudaFuncSetAttribute(flash_fwd_kernel<kBf16, DP, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm));
    if (e != cudaSuccess) return e;
    flash_fwd_kernel<kBf16, DP, kMode><<<grid, C::kThreads, sm, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.lse), a.Sq, a.Sk, a.D, a.scale, a.causal,
        a.mk);
  } else if (kind == 1) {
    e = cudaFuncSetAttribute(flash_dq_kernel<kBf16, DP, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm));
    if (e != cudaSuccess) return e;
    flash_dq_kernel<kBf16, DP, kMode><<<grid, C::kThreads, sm, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.Sq,
        a.Sk, a.D, a.scale, a.causal, a.mk);
  } else {
    e = cudaFuncSetAttribute(flash_dkv_kernel<kBf16, DP, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(sm));
    if (e != cudaSuccess) return e;
    flash_dkv_kernel<kBf16, DP, kMode><<<grid, C::kThreads, sm, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse_in),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.Sq, a.Sk, a.D, a.scale, a.causal, a.mk);
  }
  return cudaGetLastError();
}

template <bool kBf16, int kMode>
cudaError_t dispatch_d(int kind, const Args& a) {
  if constexpr (kBf16) {
    // the wgmma kernels' shapes: every kernel of every mode
    if (a.D <= 128) return cudaErrorInvalidValue;
  } else {
    if (a.D <= 64) return launch<kBf16, 64, kMode>(kind, a);
    if (a.D <= 128) return launch<kBf16, 128, kMode>(kind, a);
  }
  return launch<kBf16, 256, kMode>(kind, a);
}

template <bool kBf16>
cudaError_t dispatch_mode(int kind, const Args& a) {
  if (a.mode == kSegment) return dispatch_d<kBf16, kSegment>(kind, a);
  if (a.mode == kFlashmask) return dispatch_d<kBf16, kFlashmask>(kind, a);
  return dispatch_d<kBf16, kPlain>(kind, a);
}

// What the masked modes take: their inputs present, H dividing B*H, Hm 1
// or H, C 1|2 with causal bounds or 2|4 without, and the start summary
// for the C == 1 causal skip.
bool mask_ok(const Args& a) {
  const Mask& m = a.mk;
  if (a.mode == kPlain) return true;
  if (m.H <= 0 || a.BH % m.H != 0) return false;
  if (a.mode == kSegment)
    return m.segq && m.segk && m.qsum && m.ksum;
  if (a.mode != kFlashmask || !m.fm || a.Sq != a.Sk) return false;
  if (m.Hm != 1 && m.Hm != m.H) return false;
  if (m.fm_causal ? (m.C != 1 && m.C != 2) : (m.C != 2 && m.C != 4))
    return false;
  return !(m.C == 1 && m.fm_causal && !m.fmsum);
}

int run(int kind, const Args& a, int dtype) {
  if (a.BH <= 0 || a.BH > 65535 || a.Sq <= 0 || a.Sk <= 0 || a.D <= 0 ||
      a.D > 256 || a.D % 8 != 0 || !mask_ok(a))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_mode<false>(kind, a);
  else if (dtype == 1)
    e = dispatch_mode<true>(kind, a);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

Args make_args(const void* segq, const void* segk, const void* qsum,
               const void* ksum, const void* fm, const void* fmsum,
               void* visits, int BH, int Sq, int Sk, int D, int H,
               int fm_heads, int fm_cols, float scale, int causal,
               int fm_causal, int mode, void* stream) {
  Args a{};
  a.BH = BH; a.Sq = Sq; a.Sk = Sk; a.D = D; a.scale = scale;
  a.causal = causal; a.mode = mode;
  a.mk.segq = static_cast<const int*>(segq);
  a.mk.segk = static_cast<const int*>(segk);
  a.mk.qsum = static_cast<const int*>(qsum);
  a.mk.ksum = static_cast<const int*>(ksum);
  a.mk.fm = static_cast<const int*>(fm);
  a.mk.fmsum = static_cast<const int*>(fmsum);
  a.mk.visits = static_cast<int*>(visits);
  a.mk.H = H; a.mk.Hm = fm_heads; a.mk.C = fm_cols;
  a.mk.fm_causal = fm_causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the outputs share
// it; lse and delta are float32). Shapes: q/dout/out/dq (BH, Sq, D),
// k/v/dk/dv (BH, Sk, D), lse/delta (BH, Sq). mode: 0 plain (causal or
// none), 1 segment, 2 flashmask. The masked modes' inputs, as in `Mask`:
// segq/segk (B, 2, S) int32 and their (B, 4, ceil(S/32)) summaries
// (segment mode); fm (B*fm_heads, fm_cols, Sk) int32 and its
// (B*fm_heads, 2, ceil(Sk/32)) start summary, largest and smallest
// (flashmask mode; the summary only for fm_cols 1 with fm_causal); H heads
// per batch row. `visits`, if not null, gains the (q, k) tile pairs a
// masked mode visits. Pointers a mode does not use may be null. Each
// returns a cudaError_t: 0 on a successful launch, cudaErrorInvalidValue
// for arguments it refuses (bf16 at D <= 128, among them: the wgmma
// kernels' shapes).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* segq, const void* segk, const void* qsum, const void* ksum,
    const void* fm, const void* fmsum, void* visits, int BH, int Sq, int Sk,
    int D, int H, int fm_heads, int fm_cols, float scale, int causal,
    int fm_causal, int mode, int dtype, void* stream) {
  Args a = make_args(segq, segk, qsum, ksum, fm, fmsum, visits, BH, Sq, Sk,
                     D, H, fm_heads, fm_cols, scale, causal, fm_causal, mode,
                     stream);
  a.q = q; a.k = k; a.v = v; a.out = out; a.lse = lse;
  return run(0, a, dtype);
}

extern "C" int flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* segq,
    const void* segk, const void* qsum, const void* ksum, const void* fm,
    const void* fmsum, void* visits, int BH, int Sq, int Sk, int D, int H,
    int fm_heads, int fm_cols, float scale, int causal, int fm_causal,
    int mode, int dtype, void* stream) {
  Args a = make_args(segq, segk, qsum, ksum, fm, fmsum, visits, BH, Sq, Sk,
                     D, H, fm_heads, fm_cols, scale, causal, fm_causal, mode,
                     stream);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dq = dq;
  return run(1, a, dtype);
}

extern "C" int flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* segq,
    const void* segk, const void* qsum, const void* ksum, const void* fm,
    const void* fmsum, void* visits, int BH, int Sq, int Sk, int D, int H,
    int fm_heads, int fm_cols, float scale, int causal, int fm_causal,
    int mode, int dtype, void* stream) {
  Args a = make_args(segq, segk, qsum, ksum, fm, fmsum, visits, BH, Sq, Sk,
                     D, H, fm_heads, fm_cols, scale, causal, fm_causal, mode,
                     stream);
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse_in = lse; a.delta = delta;
  a.dk = dk; a.dv = dv;
  return run(2, a, dtype);
}
