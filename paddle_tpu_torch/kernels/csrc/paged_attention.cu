// Paged-KV decode attention for Hopper (sm_90a), plain C interface.
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
// Bound on this card: bandwidth. Each live K/V row is read once (one
// token's K+V for all KV heads of Llama-3-8B is 4 KiB in bf16) and the
// arithmetic is ~2*G flops per byte, far below the ~295 flop/byte the
// H100 needs before its ALUs bind. So the design only has to keep
// enough loads in flight:
//   * one thread block per (KV head, sequence); it stages its own
//     block-table row in shared memory (the TPU kernel's scalar
//     prefetch) and walks only ceil(seq_len / page) pages — no work past
//     the live tokens, and no dependent global load of a page id before
//     each K/V load;
//   * up to 16 warps (as many as keep the merge buffer within 32 KiB)
//     split the tokens round-robin, kUnroll tokens per warp iteration,
//     issuing the K and V row loads of all kUnroll tokens before any
//     arithmetic so several loads are in flight per warp; a lane holds
//     D/32 contiguous elements of a row (16 B vector loads where the
//     width allows);
//   * q·k is a per-lane partial dot product plus a butterfly shuffle
//     sum; each warp keeps its own fp32 running max / sum / accumulator
//     in registers (the TPU kernel's VMEM scratch), and the warps
//     merge through shared memory in a fixed order, so results are
//     deterministic run to run;
//   * a sequence with seq_len == 0 (a bucket pad row) never enters the
//     loop and writes exact zeros (the sum is clamped at 1e-30, as on
//     the TPU).
// int8 variant: a lane loads its D/32 int8 values of the K and V rows
// (one 32-bit word at D = 128; 16-bit words at D = 64 and 192, where the
// lane's slice is not 4-byte aligned) plus the row's fp32 scale, which
// all lanes read from one address. The reference dequantizes first
// (k = q8 * scale, then q . k); here the K scale multiplies the
// warp-summed dot product and the V scale the softmax weight p, which
// is the same sum, since a row's scale is one factor of all its terms:
// sum_e q_e (k8_e s) = s sum_e q_e k8_e, and p (v8_e s) = (p s) v8_e.
// Only the rounding order differs. The bytes per live token halve
// (D + 4 against 2 D per head), but the kernel is latency-bound (a
// chain of dependent loads per warp), so it is not expected to run much
// faster than the full-width one; the scale load adds a second
// dependent load per row.
// Not done here (later work): split-K over pages when B*KVH < #SMs,
// cp.async/TMA pipelining of pages.
//
// The kernel launches on the caller's stream, allocates nothing, and
// the C entry returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// block-table entries a block stages in (dynamic) shared memory
constexpr int kMaxTablePages = 2048;

// Warps per block: as many as keep the (warps, G, D) fp32 merge buffer
// within 32 KiB, between 4 and 16.
template <int G, int D>
struct Warps {
  static constexpr int kFit = 32768 / (G * D * 4);
  static constexpr int value = kFit > 16 ? 16 : (kFit < 4 ? 4 : kFit);
};

// Load W 32-bit words with the widest aligned vector the width allows.
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
    const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = v[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (W % 2 == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < W / 2; ++i) {
      const uint2 x = v[i];
      w[2 * i] = x.x;
      w[2 * i + 1] = x.y;
    }
  } else {
    const uint32_t* v = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = v[i];
  }
}

// Element formats by raw bits: kBf16 packs two bf16 per word (element
// 2i in the low half), fp32 one float per word. bf16 -> fp32 is exact.
template <bool kBf16>
struct Elem {
  static constexpr int kPerWord = kBf16 ? 2 : 1;
  static constexpr int kBytes = kBf16 ? 2 : 4;
  __device__ __forceinline__ static void unpack(uint32_t w, float* x) {
    if constexpr (kBf16) {
      x[0] = __uint_as_float(w << 16);
      x[1] = __uint_as_float(w & 0xffff0000u);
    } else {
      x[0] = __uint_as_float(w);
    }
  }
  // fp32 -> storage, round to nearest even (torch's .to(bfloat16)).
  __device__ __forceinline__ static void store(void* base, size_t i,
                                               float x) {
    if constexpr (kBf16) {
      uint32_t u = __float_as_uint(x);
      uint16_t r;
      if ((u & 0x7fffffffu) > 0x7f800000u) {
        r = 0x7fc0;  // NaN stays NaN
      } else {
        u += 0x7fffu + ((u >> 16) & 1u);
        r = static_cast<uint16_t>(u >> 16);
      }
      reinterpret_cast<uint16_t*>(base)[i] = r;
    } else {
      reinterpret_cast<float*>(base)[i] = x;
    }
  }
};

// One lane's EPL int8 values of a row, sign-extended to fp32 (exact),
// loaded as the widest words the lane's byte offset (lane * EPL) keeps
// aligned.
template <int EPL>
__device__ __forceinline__ void load_row_int8(const void* base, size_t elem,
                                              float (&x)[EPL]) {
  const char* p = reinterpret_cast<const char*>(base) + elem;
  if constexpr (EPL % 4 == 0) {
    uint32_t w[EPL / 4];
    load_words<EPL / 4>(p, w);
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      x[i] = static_cast<float>(
          static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
  } else {
    static_assert(EPL % 2 == 0, "int8 rows need an even slice per lane");
    const uint16_t* v = reinterpret_cast<const uint16_t*>(p);
#pragma unroll
    for (int i = 0; i < EPL / 2; ++i) {
      const uint16_t h = v[i];
      x[2 * i] = static_cast<float>(static_cast<int8_t>(h & 0xffu));
      x[2 * i + 1] = static_cast<float>(static_cast<int8_t>(h >> 8));
    }
  }
}

template <bool kBf16, int EPL>
__device__ __forceinline__ void load_row(const void* base, size_t elem,
                                         float (&x)[EPL]) {
  using E = Elem<kBf16>;
  constexpr int W = EPL / E::kPerWord;
  uint32_t w[W];
  load_words<W>(reinterpret_cast<const char*>(base) + elem * E::kBytes, w);
#pragma unroll
  for (int i = 0; i < W; ++i) E::unpack(w[i], x + i * E::kPerWord);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (KVH, B), block Warps<G, D>::value * 32, dynamic shared memory
// max_pages int32. EPL = D / 32 elements per lane. kBf16 names the
// query/output type (and the cache type unless kInt8); kInt8 reads int8
// caches with the fp32 scale pages ks/vs (unused otherwise).
template <bool kBf16, bool kInt8, int G, int EPL>
__global__ void __launch_bounds__(Warps<G, EPL * 32>::value * 32)
paged_decode_kernel(const void* __restrict__ q, const void* __restrict__ kc,
                    const void* __restrict__ vc,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ seq_lens,
                    void* __restrict__ out, int H, int KVH, int page,
                    int max_pages, float scale) {
  constexpr int D = EPL * 32;
  constexpr int kWarps = Warps<G, D>::value;
  // fewer tokens in flight when the per-head state already fills the
  // registers
  constexpr int kUnroll = (G * EPL >= 32) ? 2 : 4;
  extern __shared__ int32_t s_table[];
  __shared__ float s_m[kWarps][G];
  __shared__ float s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = seq_lens[b];
  const int32_t* table = block_tables + static_cast<size_t>(b) * max_pages;
  const int n_pages = (len + page - 1) / page;
  for (int i = threadIdx.x; i < n_pages; i += kWarps * 32)
    s_table[i] = table[i];
  __syncthreads();

  float qv[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g)
    load_row<kBf16, EPL>(q, (static_cast<size_t>(b) * H + h * G + g) * D
                                + lane * EPL, qv[g]);

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float kx[kUnroll][EPL], vx[kUnroll][EPL];
    // per-row dequant scales (1 for full-width caches)
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      ksc[u] = 1.f;
      vsc[u] = 1.f;
      if (t < len) {
        const size_t pg = static_cast<size_t>(s_table[t / page]);
        const size_t row = (pg * KVH + h) * page + (t % page);
        const size_t off = row * D + lane * EPL;
        if constexpr (kInt8) {
          load_row_int8<EPL>(kc, off, kx[u]);
          load_row_int8<EPL>(vc, off, vx[u]);
          ksc[u] = ks[row];
          vsc[u] = vs[row];
        } else {
          load_row<kBf16, EPL>(kc, off, kx[u]);
          load_row<kBf16, EPL>(vc, off, vx[u]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kx[u][e] = 0.f;
          vx[u][e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[kUnroll];
      float mc = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qv[g][e], kx[u][e], part);
        s[u] = (t0 + u < len) ? warp_sum(part) * ksc[u] * scale : kNegInf;
        mc = fmaxf(mc, s[u]);
      }
      const float mn = fmaxf(m[g], mc);
      const float alpha = (m[g] <= kNegInf / 2) ? 0.f : expf(m[g] - mn);
      float p[kUnroll], pv[kUnroll];
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        p[u] = (s[u] <= kNegInf / 2) ? 0.f : expf(s[u] - mn);
        psum += p[u];
        pv[u] = kInt8 ? p[u] * vsc[u] : p[u];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) a = fmaf(pv[u], vx[u][e], a);
        acc[g][e] = a;
      }
      m[g] = mn;
    }
  }

  // merge the warps' partial softmax states in a fixed order
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kWarps * 32) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = s_m[w][g];
      const float f = (mw <= kNegInf / 2) ? 0.f : expf(mw - mx);
      lsum += s_l[w][g] * f;
      a += s_acc[w][g][d] * f;
    }
    Elem<kBf16>::store(out, (static_cast<size_t>(b) * H + h * G + g) * D + d,
                       a / fmaxf(lsum, 1e-30f));
  }
}

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
  int B, H, KVH, page, max_pages;
  float scale;
  cudaStream_t stream;
};

template <bool kBf16, bool kInt8, int G, int EPL>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.KVH, a.B);
  const size_t table_bytes = sizeof(int32_t) * a.max_pages;
  paged_decode_kernel<kBf16, kInt8, G, EPL>
      <<<grid, Warps<G, EPL * 32>::value * 32, table_bytes, a.stream>>>(
          a.q, a.kc, a.vc, a.ks, a.vs, a.bt, a.sl, a.out, a.H, a.KVH,
          a.page, a.max_pages, a.scale);
  return cudaGetLastError();
}

template <bool kBf16, bool kInt8, int G>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 64:
      return launch<kBf16, kInt8, G, 2>(a);
    case 128:
      return launch<kBf16, kInt8, G, 4>(a);
    case 192:
      return launch<kBf16, kInt8, G, 6>(a);
    case 256:
      return launch<kBf16, kInt8, G, 8>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kBf16, bool kInt8>
cudaError_t dispatch_g(int G, int D, const Args& a) {
  switch (G) {
    case 1:
      return dispatch_d<kBf16, kInt8, 1>(D, a);
    case 2:
      return dispatch_d<kBf16, kInt8, 2>(D, a);
    case 4:
      return dispatch_d<kBf16, kInt8, 4>(D, a);
    case 8:
      return dispatch_d<kBf16, kInt8, 8>(D, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out share it). With k_scale
// and v_scale null the caches hold q's dtype; with both given they are
// int8 and the scales fp32 (num_pages, KVH, page).
// Returns a cudaError_t: 0 on a successful launch.
extern "C" int paged_attention_decode(const void* q, const void* k_cache,
                                      const void* v_cache,
                                      const void* k_scale,
                                      const void* v_scale,
                                      const int32_t* block_tables,
                                      const int32_t* seq_lens, void* out,
                                      int B, int H, int KVH, int D, int page,
                                      int max_pages, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || page <= 0 || max_pages <= 0 ||
      max_pages > kMaxTablePages || (k_scale == nullptr) != (v_scale == nullptr))
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
               B,
               H,
               KVH,
               page,
               max_pages,
               scale,
               static_cast<cudaStream_t>(stream)};
  const bool int8 = k_scale != nullptr;
  cudaError_t e;
  if (dtype == 0)
    e = int8 ? dispatch_g<false, true>(G, D, a)
             : dispatch_g<false, false>(G, D, a);
  else if (dtype == 1)
    e = int8 ? dispatch_g<true, true>(G, D, a)
             : dispatch_g<true, false>(G, D, a);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
