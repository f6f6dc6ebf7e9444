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
// 1.3 GFLOP: 0.12 ms of bytes against 0.02 ms of f32 FMA on CUDA cores.
// The Gram stays on CUDA cores in f32: TF32 tensor cores would need a
// three-pass split to stay inside G's tolerance, and buy nothing while
// bytes set the pace.  The design streams the operands once and keeps the
// Gram off the critical path:
//
//   * one block of 256 threads per (window, strided set of 512-pixel
//     chunks); each thread owns 2 consecutive pixel columns of a chunk and
//     walks the T rows two at a time, loads first: u8x2, bf16x2 (or f32x2)
//     loads and f32x2 stores of E and M when P % 4 == 0 and the pointers
//     are 16-byte aligned, else the same columns by scalar loads (any P >=
//     1 is taken; columns at or past P are stored nowhere and staged as 0,
//     which adds nothing to the Gram);
//   * the chunk's M tile is staged in shared memory with T padded by zero
//     rows to a multiple of 4 (row stride 516 floats); the Gram is
//     register-blocked: each thread accumulates one 4 x 4 block (I, J),
//     J <= I, of the lower triangle over a strided slice of the chunk's
//     float4 column groups, with 8 LDS.128 per 64 FMAs (21 blocks x 12
//     slices = 252 threads at T = 21);
//   * the tile takes about 49 KB at T = 21, so four blocks (1024 threads)
//     reside on an SM: while one computes its Gram, the others stream
//     (occupancy hides the Gram, no double buffer).  256 threads of 2
//     pixels and 2-row batches measured faster than 128 threads of 4
//     pixels, or than batches of 1, 4 or 8 rows, whose registers cut the
//     blocks that reside;
//   * the TPU kernel carries G from one grid step to the next; Hopper's
//     blocks run in parallel and in no order, so each block sums its
//     slices in a fixed order, writes its partial Gram to scratch, and a
//     second kernel sums the partials of a window in block order and
//     mirrors the triangle.  No float atomics: G, and so the solver's
//     iteration counts, are the same on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 2;                // consecutive pixel columns per thread
constexpr int kChunk = kPix * kThreads;  // pixel columns per chunk
constexpr int kStride = kChunk + 4;    // tile row stride, floats
constexpr int kGroups = kChunk / 4;    // float4 column groups per chunk
constexpr int kMaxT = 32;
constexpr int kRowBatch = 2;           // rows whose loads are in flight together

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// kPix consecutive operands from p (aligned for the vector path) as f32;
// bf16 -> f32 is the bit pattern shifted up, exact.
static_assert(kPix == 2, "load_pix and store_pix move 2 pixels");
__device__ __forceinline__ void load_pix(const uint8_t* p, float* v) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
  v[0] = (float)(w & 0xffu);
  v[1] = (float)(w >> 8);
}
__device__ __forceinline__ void load_pix(const __nv_bfloat16* p, float* v) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_pix(const float* p, float* v) {
  const float2 w = *reinterpret_cast<const float2*>(p);
  v[0] = w.x, v[1] = w.y;
}
__device__ __forceinline__ void store_pix(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// Lower-triangle pair p -> (i, j), j <= i, in the order (0,0), (1,0), (1,1), ...
__device__ __forceinline__ void pair_of(int p, int* i, int* j) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= p) ++r;
  *i = r;
  *j = p - r * (r + 1) / 2;
}

template <typename TX, typename TS, bool kGram>
__global__ void __launch_bounds__(kThreads)
ialm_front_kernel(const TX* __restrict__ x, const TS* __restrict__ a,
                  const TS* __restrict__ y, const float* __restrict__ inv_mu,
                  float* __restrict__ e, float* __restrict__ m,
                  float* __restrict__ gpart, int T, int P, float lmbda, bool vec) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);   // [TP][kStride]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_chunks = (P + kChunk - 1) / kChunk;
  const int TP = (T + 3) & ~3;
  const int nb = TP / 4, n_bpairs = nb * (nb + 1) / 2;
  const int slices = kThreads / n_bpairs;
  const int bp = tid / slices, sl = tid - bp * slices;
  const bool gram_thread = kGram && bp < n_bpairs;
  int bi = 0, bj = 0;
  if (gram_thread) pair_of(bp, &bi, &bj);
  const float im = inv_mu[b];
  const float shrink = lmbda * im;
  const size_t base = (size_t)b * T * P;

  for (int k = tid; k < (TP - T) * kStride; k += kThreads) tile[T * kStride + k] = 0.f;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int col = c * kChunk + kPix * tid;
    const int n_in = min(max(P - col, 0), kPix);   // columns of this thread inside P
    for (int r0 = 0; r0 < T; r0 += kRowBatch) {
      float xv[kRowBatch][kPix], av[kRowBatch][kPix], yv[kRowBatch][kPix];
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        const size_t g = base + (size_t)(r0 + k) * P + col;
        if (r0 + k < T && n_in == kPix && vec) {
          load_pix(x + g, xv[k]);
          load_pix(a + g, av[k]);
          load_pix(y + g, yv[k]);
        } else {
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            const bool in = r0 + k < T && q < n_in;
            xv[k][q] = in ? widen(x[g + q]) : 0.f;
            av[k][q] = in ? widen(a[g + q]) : 0.f;
            yv[k][q] = in ? widen(y[g + q]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowBatch; ++k) {
        if (r0 + k >= T) break;
        const size_t g = base + (size_t)(r0 + k) * P + col;
        float ev[kPix], mv[kPix];
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          const float iy = im * yv[k][q];
          const float eraw = xv[k][q] - av[k][q] + iy;
          ev[q] = fmaxf(eraw - shrink, 0.f) + fminf(eraw + shrink, 0.f);
          mv[q] = q < n_in ? xv[k][q] - ev[q] + iy : 0.f;
        }
        if (n_in == kPix && vec) {
          store_pix(e + g, ev);
          store_pix(m + g, mv);
        } else {
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            if (q < n_in) {
              e[g + q] = ev[q];
              m[g + q] = mv[q];
            }
          }
        }
        store_pix(tile + (r0 + k) * kStride + kPix * tid, mv);
      }
    }
    if (!kGram) continue;
    __syncthreads();
    if (gram_thread) {
      const float* ri = tile + 4 * bi * kStride;
      const float* rj = tile + 4 * bj * kStride;
      for (int gi = sl; gi < kGroups; gi += slices) {
        float4 vi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          vi[q] = *reinterpret_cast<const float4*>(ri + q * kStride + 4 * gi);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float4 vj = *reinterpret_cast<const float4*>(rj + jj * kStride + 4 * gi);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            float s = acc[ii][jj];
            s = fmaf(vi[ii].x, vj.x, s);
            s = fmaf(vi[ii].y, vj.y, s);
            s = fmaf(vi[ii].z, vj.z, s);
            s = fmaf(vi[ii].w, vj.w, s);
            acc[ii][jj] = s;
          }
        }
      }
    }
    __syncthreads();
  }
  if (!kGram) return;

  // the slices of each 4 x 4 block, summed in slice order through the
  // (now free) shared memory, then the block's partial Gram in pair order
  float* red = tile;   // [n_bpairs][slices][16], sized for it by the launch
  if (gram_thread) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) red[(bp * slices + sl) * 16 + ii * 4 + jj] = acc[ii][jj];
  }
  __syncthreads();
  const int n_pairs = T * (T + 1) / 2;
  float* out = gpart + ((size_t)b * gridDim.x + blockIdx.x) * n_pairs;
  for (int p = tid; p < n_pairs; p += kThreads) {
    int i, j;
    pair_of(p, &i, &j);
    const int I = i / 4, J = j / 4;
    const float* src = red + ((I * (I + 1) / 2 + J) * slices) * 16 + (i % 4) * 4 + j % 4;
    float s = 0.f;
    for (int k = 0; k < slices; ++k) s += src[k * 16];
    out[p] = s;
  }
}

// G[b] = sum over the window's blocks, in block order, of the partial
// Grams; both triangles written.
__global__ void __launch_bounds__(256)
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

template <typename TX, typename TS, bool kGram>
int launch(const void* x, const void* a, const void* y, const void* inv_mu, void* e,
           void* m, void* gpart, void* g, int B, int T, int P, int n_blocks, float lmbda,
           cudaStream_t stream) {
  // the M tile, or the slices' 4 x 4 partials at the end (at most 16 a
  // thread), whichever is larger
  const size_t shmem =
      sizeof(float) * (size_t)max(((T + 3) & ~3) * kStride, 16 * kThreads);
  const cudaError_t attr = cudaFuncSetAttribute(
      ialm_front_kernel<TX, TS, kGram>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (attr != cudaSuccess) return (int)attr;
  const bool vec = P % 4 == 0 && ((uintptr_t)x | (uintptr_t)a | (uintptr_t)y |
                                  (uintptr_t)e | (uintptr_t)m) % 16 == 0;
  ialm_front_kernel<TX, TS, kGram><<<dim3(n_blocks, B), kThreads, shmem, stream>>>(
      (const TX*)x, (const TS*)a, (const TS*)y, (const float*)inv_mu, (float*)e, (float*)m,
      (float*)gpart, T, P, lmbda, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !kGram) return (int)err;
  gram_reduce_kernel<<<B, 256, 0, stream>>>((const float*)gpart, (float*)g, T, n_blocks);
  return (int)cudaGetLastError();
}

template <bool kGram>
int dispatch(const void* x, const void* a, const void* y, const void* inv_mu, void* e,
             void* m, void* gpart, void* g, int B, int T, int P, int n_blocks, int x_u8,
             int s_bf16, float lmbda, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || T > kMaxT || P < 1 || n_blocks < 1 ||
      n_blocks > (P + kChunk - 1) / kChunk) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (x_u8 && s_bf16)
    return launch<uint8_t, __nv_bfloat16, kGram>(x, a, y, inv_mu, e, m, gpart, g, B, T, P,
                                                 n_blocks, lmbda, s);
  if (x_u8)
    return launch<uint8_t, float, kGram>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks,
                                         lmbda, s);
  if (s_bf16)
    return launch<float, __nv_bfloat16, kGram>(x, a, y, inv_mu, e, m, gpart, g, B, T, P,
                                               n_blocks, lmbda, s);
  return launch<float, float, kGram>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks,
                                     lmbda, s);
}

}  // namespace

extern "C" {

// Launches K6 on `stream`.  x, a, y are (B, T, P); x is u8 when x_u8 else
// f32, a and y are bf16 when s_bf16 else f32.  inv_mu is (B,) f32.  e and m
// are (B, T, P) f32, g is (B, T, T) f32, gpart is scratch of
// B * n_blocks * T(T+1)/2 f32.  1 <= T <= 32, P >= 1, 1 <= B <= 65535,
// 1 <= n_blocks <= ceil(P / 512).  Returns a cudaError_t (0 on success).
int swt_ialm_front(const void* x, const void* a, const void* y, const void* inv_mu,
                   void* e, void* m, void* gpart, void* g, int B, int T, int P,
                   int n_blocks, int x_u8, int s_bf16, float lmbda, void* stream) {
  return dispatch<true>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks, x_u8, s_bf16,
                        lmbda, stream);
}

// The same launch without the Gram (E and M only; gpart and g untouched):
// for measuring how K6's time splits between streaming and the Gram.
int swt_ialm_front_stream(const void* x, const void* a, const void* y, const void* inv_mu,
                          void* e, void* m, void* gpart, void* g, int B, int T, int P,
                          int n_blocks, int x_u8, int s_bf16, float lmbda, void* stream) {
  return dispatch<false>(x, a, y, inv_mu, e, m, gpart, g, B, T, P, n_blocks, x_u8, s_bf16,
                         lmbda, stream);
}

}  // extern "C"
