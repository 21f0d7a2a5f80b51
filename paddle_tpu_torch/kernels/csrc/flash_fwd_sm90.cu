// Flash attention forward for Hopper (sm_90a): wgmma over a TMA tile ring.
// Plain C interface.
//
// Replaces, for bf16 in the plain mode (causal or none) at head_dim <= 128,
// the Pallas TPU kernel `_fwd_kernel` of
// paddle_tpu/kernels/flash_attention.py (online-softmax attention; out and
// the fp32 logsumexp). flash_attention.cu keeps fp32, head_dim > 128, the
// segment and flashmask modes, and dQ / dK-dV. Layout (B*H, S, D),
// contiguous; causal is bottom-right aligned: key j is visible to query i
// iff j <= i + (Sk - Sq). A masked score contributes exactly 0; the row sum
// is clamped at 1e-30 at the end, so a row that sees no key gives zeros
// and lse = -1e30 + log(1e-30), as the plain version beside the wrapper.
//
// Bound on this card: operations (the training shape, S 4096, D 128,
// causal: 137 GFLOP over 34 MB of q/k/v/out). flash_attention.cu's forward
// ran mma.sync on fragments built from scalar shared loads, loaded K and V
// synchronously and passed P through shared memory, two __syncthreads a
// tile (1.30 ms, ~105 TFLOP/s). The design:
//   * a block of three warpgroups owns 128 query rows of one head; the
//     heaviest causal query tiles run first. Warpgroup 2 is the producer:
//     one thread loads Q once and streams 128-key K and V tiles through a
//     2-stage ring with TMA (128-byte swizzle, zeros past S and D; D is
//     laid out as 64-wide column blocks), K and V completing on their own
//     mbarriers so S = QK^T can start before V lands; the consumers free a
//     stage on its `empty` mbarrier (one arrival per consumer warp) once
//     the product that read it has retired;
//   * each consumer warpgroup owns 64 of the rows: S = Q K^T is wgmma
//     m64n128k16 SS (Q and K both K-major as stored); the online softmax
//     runs in registers on the accumulator (the max over a row's quad of
//     threads, exp2 of scores pre-scaled by log2 e); only tiles that cross
//     the causal diagonal or the end of K evaluate the mask;
//   * P is rounded to bf16 in registers (as FlashAttention-2 and
//     flash_attention.cu round it) and is directly the RS A operand of
//     O += P V (wgmma m64nDk16, V as the transposed, MN-major B operand):
//     the accumulator layout of S is the A-fragment layout of P, so P never
//     goes through shared memory; the row sums and max stay fp32;
//   * registers: three warps share each SM sub-partition, so a thread has
//     168; setmaxnreg moves the producer's to the consumers, but ptxas
//     still compiles the consumer path within 168. S (64), O (64) and P
//     (32) fit because the first k16 step of S only writes its
//     accumulator (last tile's scores are dead by then), which also
//     rules out holding a second S to overlap QK^T with the softmax.
//
// The kernel launches on the caller's stream and allocates nothing; the C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBM = 128;       // query rows of a block (64 a consumer)
constexpr int kBN = 128;       // keys of a ring stage
constexpr int kStages = 2;
constexpr int kThreads = 384;  // consumers: warpgroups 0-1; producer: 2

// DP: the head dim the tiles are laid out for (64 or 128; D <= DP).
template <int DP>
struct Cfg {
  static constexpr int kBlocks = DP / 64;        // 64-wide column blocks
  static constexpr int kQBytes = kBM * DP * 2;
  static constexpr int kKVBytes = kBN * DP * 2;  // one K or V tile
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + (1 + 3 * kStages) * 8 + 1024;
};

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t* p, uint64_t db) {
  if constexpr (DP == 128)
    wgmma_rs_n128<1>(o, p, db);
  else
    wgmma_rs_n64<1>(o, p, db);
}

// grid (ceil(Sq / 128), B*H), kThreads threads.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int D,
                      float scale_log2, int causal) {
  using C = Cfg<DP>;
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

    // S = Q K^T over DP / 16 k16 steps (4 per 64-wide column block)
    // descriptors move in 16-byte units: 32 bytes a k16 step, 128 rows of
    // 128 bytes a column block
    const uint64_t dk = desc_sw128(k, 16, 1024);
    mbar_wait(&kfull[s], par);
    wgmma_fence();
    wgmma_ss_n128<0, false>(sc, dq, dk);
#pragma unroll
    for (int kk = 1; kk < DP / 16; ++kk) {
      const int at = (kk / 4) * 1024 + (kk % 4) * 2;
      wgmma_ss_n128<0, true>(sc, dq + at, dk + at);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);

    // online softmax on the accumulator, rows row0 (h 0) and row0 + 8
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
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }
    // P in bf16: accumulator pairs (4j + 0..1, 4j + 2..3) are the A
    // fragment's registers in order
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) {
      const __nv_bfloat162 pr = __floats2bfloat162_rn(sc[2 * i], sc[2 * i + 1]);
      p[i] = *reinterpret_cast<const uint32_t*>(&pr);
    }

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

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int BH, int Sq, int Sk, int D, float scale,
                   int causal, cudaStream_t s) {
  using C = Cfg<DP>;
  CUtensorMap qmap, kmap, vmap;
  const cuuint32_t box[3] = {64, kBM, 1};  // kBM == kBN
  const cuuint64_t qdims[3] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(Sq),
                               static_cast<cuuint64_t>(BH)};
  const cuuint64_t qstr[2] = {static_cast<cuuint64_t>(D) * 2,
                              static_cast<cuuint64_t>(Sq) * D * 2};
  const cuuint64_t kdims[3] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(Sk),
                               static_cast<cuuint64_t>(BH)};
  const cuuint64_t kstr[2] = {static_cast<cuuint64_t>(D) * 2,
                              static_cast<cuuint64_t>(Sk) * D * 2};
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&qmap, bf16, 3, q, qdims, qstr, box) ||
      !make_map(&kmap, bf16, 3, k, kdims, kstr, box) ||
      !make_map(&vmap, bf16, 3, v, kdims, kstr, box))
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
