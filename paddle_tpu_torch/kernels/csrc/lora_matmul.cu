// Multi-LoRA segment matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of paddle_tpu/kernels/lora_matmul.py
// (driven by `lora_matmul`): every row b of one launch applies its OWN
// adapter's low-rank delta
//   out[b, :] = (x[b, :] @ A[id_b]) @ Bs[id_b]
// with x (rows, H) bf16 or fp32, ids (rows,) int32 slot ids, A (S, H, R) fp32,
// Bs (S, R, N) fp32 (the per-slot alpha/rank scaling already folded in),
// out (rows, N) fp32, fp32 accumulation. Slot 0 is the null adapter: a row
// whose id is 0, or outside [0, S), gets exact 0.0 and reads no weights.
//
// The TPU kernel sweeps every slot in its grid and masks the rows, so each
// slot's weights stream through VMEM once per output column block. That
// design is not carried over: on this card the 50 MB L2 holds a module's
// whole slot stack (A 1 MB, Bs for gate_proj 3.7 MB at Llama-3-8B, rank
// 16, 4 slots), so gathering each row's own slot costs L2 reads, not
// device-memory re-reads, and a slot sweep would redo the H reduction per
// output block. Instead, two kernels:
//   * lora_shrink: part[b, c, r] = sum over the c-th H chunk of
//     x[b, h] * A[id_b, h, r]. A block owns one (row, H chunk); its threads
//     form G = 256 / R groups of R, thread (g, r) takes the strided partial
//     sum over h = h0 + g, h0 + g + G, ... in fp32 FMAs (the 256 threads
//     read consecutive A elements, so the loads coalesce), then a
//     fixed-order pairwise tree over the groups in shared memory. bf16 x is
//     widened exactly to fp32. Splitting H over blocks keeps the card busy
//     at 16 decode rows (H 4096 = 8 chunks of 512 -> 128 blocks).
//   * lora_expand: out[b, n] = sum_r xa[r] * Bs[id_b, r, n] with
//     xa[r] = part[b, 0, r] + part[b, 1, r] + ... summed in chunk order at
//     the start of every block (R <= 256 values); one output column per
//     thread, FMAs in r order, consecutive threads on consecutive columns.
// Bound on this card: bytes at decode (16 rows do 2 flops per weight
// element read), operations at large prefill chunks, where the per-row
// gather re-reads a slot's weights from L2 for every row (grouping rows
// by slot and staging weights in shared memory are later work).
//
// Determinism: no atomics, and no reduction whose order depends on other
// rows: a row's result depends only on its own x, its slot's weights and
// the shapes (H, R, the chunk size), never on the other rows' ids or the
// other slots' weights. Every output element is written by one thread.
// Never TF32 or tensor cores on the fp32 weights: fp32 FMAs only.
//
// The kernels launch on the caller's stream and allocate nothing; each C
// entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // also the largest rank a launch takes
constexpr int kMaxRank = kThreads;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lora_shrink_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                       const float* __restrict__ a, float* __restrict__ part,
                       int H, int R, int S, int hchunk) {
  __shared__ float red[kThreads];
  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int chunks = gridDim.y;
  const int tid = threadIdx.x;
  const int id = ids[b];
  float* dst = part + (static_cast<size_t>(b) * chunks + c) * R;
  if (id <= 0 || id >= S) {  // null slot, or no slot at all
    if (tid < R) dst[tid] = 0.f;
    return;
  }
  const int G = kThreads / R;
  const int g = tid / R;
  const int r = tid - g * R;
  const int h0 = c * hchunk;
  const int h1 = min(H, h0 + hchunk);
  float acc = 0.f;
  if (g < G) {
    const T* xr = x + static_cast<size_t>(b) * H;
    const float* ar = a + static_cast<size_t>(id) * H * R + r;
#pragma unroll 4
    for (int h = h0 + g; h < h1; h += G)
      acc = fmaf(widen(xr[h]), ar[static_cast<size_t>(h) * R], acc);
  }
  red[tid] = acc;
  __syncthreads();
  // groups [half, n) add into [0, n - half): a fixed pairwise order
  for (int n = G; n > 1;) {
    const int half = (n + 1) / 2;
    if (tid < (n - half) * R) red[tid] += red[tid + half * R];
    __syncthreads();
    n = half;
  }
  if (tid < R) dst[tid] = red[tid];
}

__global__ void __launch_bounds__(kThreads)
    lora_expand_kernel(const float* __restrict__ part,
                       const int* __restrict__ ids,
                       const float* __restrict__ bs, float* __restrict__ out,
                       int N, int R, int S, int chunks) {
  __shared__ float xa[kMaxRank];
  const int b = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int slot = ids[b];
  float* orow = out + static_cast<size_t>(b) * N;
  if (slot <= 0 || slot >= S) {  // null slot, or no slot at all
    if (n < N) orow[n] = 0.f;
    return;
  }
  if (threadIdx.x < R) {
    const float* p = part + static_cast<size_t>(b) * chunks * R + threadIdx.x;
    float s = 0.f;
    for (int c = 0; c < chunks; ++c) s += p[static_cast<size_t>(c) * R];
    xa[threadIdx.x] = s;
  }
  __syncthreads();
  if (n >= N) return;
  const float* col = bs + static_cast<size_t>(slot) * R * N + n;
  float acc = 0.f;
#pragma unroll 8
  for (int r = 0; r < R; ++r)
    acc = fmaf(xa[r], col[static_cast<size_t>(r) * N], acc);
  orow[n] = acc;
}

bool bad_shape(int rows, int R, int S) {
  return rows <= 0 || R <= 0 || R > kMaxRank || S <= 0;
}

}  // namespace

// part: a (rows, ceil(H / hchunk), R) fp32 buffer. dtype: 0 = float32,
// 1 = bfloat16 (x's type). Returns a cudaError_t: 0 when the launch
// succeeded.
extern "C" int lora_shrink(const void* x, const void* ids, const void* a,
                           void* part, int rows, int H, int R, int S,
                           int hchunk, int dtype, void* stream) {
  if (bad_shape(rows, R, S) || H <= 0 || hchunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (H + hchunk - 1) / hchunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(ids);
  const float* ap = static_cast<const float*>(a);
  float* pp = static_cast<float*>(part);
  if (dtype == 0)
    lora_shrink_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), ip, ap, pp, H, R, S, hchunk);
  else if (dtype == 1)
    lora_shrink_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ip, ap, pp, H, R, S, hchunk);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// part: lora_shrink's (rows, chunks, R) partial sums; out: (rows, N) fp32.
extern "C" int lora_expand(const void* part, const void* ids, const void* bs,
                           void* out, int rows, int N, int R, int S,
                           int chunks, void* stream) {
  if (bad_shape(rows, R, S) || N <= 0 || chunks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int col_blocks = (N + kThreads - 1) / kThreads;
  if (col_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows, col_blocks);
  lora_expand_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int*>(ids),
      static_cast<const float*>(bs), static_cast<float*>(out), N, R, S,
      chunks);
  return static_cast<int>(cudaGetLastError());
}
