// K6: the front half of a cold-start IALM iteration for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/ialm_front.py
// (ialm_front, body _make_kernel).  Per window b of a (B, T, P) state with
// its scalar inv_mu[b]:
//
//   Eraw = X - A + inv_mu * Y
//   E    = max(Eraw - lmbda*inv_mu, 0) + min(Eraw + lmbda*inv_mu, 0)
//   M    = X - E + inv_mu * Y
//   G    = M M^T                  (T x T, summed over the P pixels)
//
// Operands: X is read as the solver holds it, u8 (rpca_store_x_u8) or f32;
// A and Y as bf16 (rpca_state_bf16) or f32, both the same.  Each is
// widened to f32 in registers; the widenings are exact, so E and M are
// the f32 values of the plain chain on the widened operands.  E, M and G
// are written in f32.  The build's -fmad=false keeps `x - a + im*y` from
// being contracted into an FMA, and the shrink is `(float)lmbda * im` as
// in the TPU kernel and the plain chain, so E and M are bit-equal to the
// plain version.  Only the Gram uses fmaf: its sum runs in another order
// than a GEMM's anyway and is compared with a tolerance.
//
// What bounds it: bytes.  At the main path's shapes (B = 16, T = 21,
// P = 93,312) it reads 1 + 2 + 2 bytes and writes 4 + 4 bytes a pixel,
// about 408 MB (627 MB with f32 operands), against a Gram of about
// 1.3 GFLOP.  The design reads each operand once, coalesced along P, and
// keeps the Gram out of device memory until the end:
//
//   * one block per (window, strided set of 256-pixel chunks); each thread
//     owns one pixel column of a chunk and walks the T rows, so every load
//     and store is a contiguous 1 KB (or 512 B, 256 B) row segment;
//   * no padding: columns at or past P are masked (stored nowhere, staged
//     as 0, which adds nothing to the Gram), so any P >= 1 is taken;
//   * the chunk's M tile (T x 256 f32, row stride 257 so that threads of a
//     warp that read different rows hit different banks) is staged in
//     shared memory, and thread p < T(T+1)/2 accumulates the dot product
//     of one lower-triangle pair (i, j) over the chunk in a register,
//     across all of the block's chunks;
//   * the TPU kernel carries G from one grid step to the next; Hopper's
//     blocks run in parallel and in no order, so each block writes its
//     partial Gram to scratch and a second kernel sums the partials of a
//     window in block order and mirrors the triangle.  No float atomics:
//     G, and so the solver's iteration counts, are the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;    // pixel columns per chunk = threads per block
constexpr int kStride = kChunk + 1;
constexpr int kMaxT = 32;
constexpr int kMaxPairsPerThread = (kMaxT * (kMaxT + 1) / 2 + kChunk - 1) / kChunk;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// Lower-triangle pair p -> (i, j), j <= i, in the order (0,0), (1,0), (1,1), ...
__device__ __forceinline__ void pair_of(int p, int* i, int* j) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= p) ++r;
  *i = r;
  *j = p - r * (r + 1) / 2;
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(kChunk)
ialm_front_kernel(const TX* __restrict__ x, const TS* __restrict__ a,
                  const TS* __restrict__ y, const float* __restrict__ inv_mu,
                  float* __restrict__ e, float* __restrict__ m,
                  float* __restrict__ gpart, int T, int P, float lmbda) {
  extern __shared__ float tile[];   // [T][kStride]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_chunks = (P + kChunk - 1) / kChunk;
  const int n_pairs = T * (T + 1) / 2;
  const float im = inv_mu[b];
  const float shrink = lmbda * im;
  const size_t base = (size_t)b * T * P;

  int pi[kMaxPairsPerThread], pj[kMaxPairsPerThread];
  float acc[kMaxPairsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxPairsPerThread; ++k) {
    acc[k] = 0.f;
    const int p = tid + k * kChunk;
    if (p < n_pairs) pair_of(p, &pi[k], &pj[k]);
  }

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int col = c * kChunk + tid;
    const bool inside = col < P;
#pragma unroll 7
    for (int r = 0; r < T; ++r) {
      float mv = 0.f;
      if (inside) {
        const size_t g = base + (size_t)r * P + col;
        const float xv = widen(x[g]);
        const float av = widen(a[g]);
        const float iy = im * widen(y[g]);
        const float eraw = xv - av + iy;
        const float ev = fmaxf(eraw - shrink, 0.f) + fminf(eraw + shrink, 0.f);
        mv = xv - ev + iy;
        e[g] = ev;
        m[g] = mv;
      }
      tile[r * kStride + tid] = mv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxPairsPerThread; ++k) {
      if (tid + k * kChunk < n_pairs) {
        const float* ri = tile + pi[k] * kStride;
        const float* rj = tile + pj[k] * kStride;
        float s = acc[k];
        for (int q = 0; q < kChunk; ++q) s = fmaf(ri[q], rj[q], s);
        acc[k] = s;
      }
    }
    __syncthreads();
  }

  float* out = gpart + ((size_t)b * gridDim.x + blockIdx.x) * n_pairs;
#pragma unroll
  for (int k = 0; k < kMaxPairsPerThread; ++k) {
    const int p = tid + k * kChunk;
    if (p < n_pairs) out[p] = acc[k];
  }
}

// G[b] = sum over the window's blocks, in block order, of the partial
// Grams; both triangles written.
__global__ void __launch_bounds__(kChunk)
gram_reduce_kernel(const float* __restrict__ gpart, float* __restrict__ g,
                   int T, int n_blocks) {
  const int b = blockIdx.x;
  const int n_pairs = T * (T + 1) / 2;
  const float* src = gpart + (size_t)b * n_blocks * n_pairs;
  for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_blocks; ++k) s += src[(size_t)k * n_pairs + p];
    int i, j;
    pair_of(p, &i, &j);
    g[((size_t)b * T + i) * T + j] = s;
    g[((size_t)b * T + j) * T + i] = s;
  }
}

template <typename TX, typename TS>
int launch(const void* x, const void* a, const void* y, const void* inv_mu,
           void* e, void* m, void* gpart, void* g, int B, int T, int P,
           int n_blocks, float lmbda, cudaStream_t stream) {
  const dim3 grid(n_blocks, B);
  const size_t shmem = (size_t)T * kStride * sizeof(float);
  ialm_front_kernel<TX, TS><<<grid, kChunk, shmem, stream>>>(
      (const TX*)x, (const TS*)a, (const TS*)y, (const float*)inv_mu,
      (float*)e, (float*)m, (float*)gpart, T, P, lmbda);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_reduce_kernel<<<B, kChunk, 0, stream>>>((const float*)gpart, (float*)g, T, n_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K6 on `stream`.  x, a, y are (B, T, P); x is u8 when x_u8 else
// f32, a and y are bf16 when s_bf16 else f32.  inv_mu is (B,) f32.  e and m
// are (B, T, P) f32, g is (B, T, T) f32, gpart is scratch of
// B * n_blocks * T(T+1)/2 f32.  1 <= T <= 32, P >= 1, 1 <= B <= 65535,
// 1 <= n_blocks <= ceil(P / 256).  Returns a cudaError_t (0 on success).
int swt_ialm_front(const void* x, const void* a, const void* y, const void* inv_mu,
                   void* e, void* m, void* gpart, void* g, int B, int T, int P,
                   int n_blocks, int x_u8, int s_bf16, float lmbda, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || T > kMaxT || P < 1 || n_blocks < 1 ||
      n_blocks > (P + kChunk - 1) / kChunk) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (x_u8 && s_bf16)
    return launch<uint8_t, __nv_bfloat16>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks, lmbda, s);
  if (x_u8)
    return launch<uint8_t, float>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks, lmbda, s);
  if (s_bf16)
    return launch<float, __nv_bfloat16>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks, lmbda, s);
  return launch<float, float>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks, lmbda, s);
}

}  // extern "C"
