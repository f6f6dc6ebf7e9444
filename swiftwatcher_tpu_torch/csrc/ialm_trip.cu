// K8: the warm IALM trip's passes over whole windows, for Hopper (sm_90a),
// in two kernels: K8a (the front) and K8b (the back).
//
// Replaces no TPU kernel: the JAX package leaves the warm trip
// (swiftwatcher_tpu/ops/rpca.py, ialm_rpca_batched's update with
// warm_basis) to XLA, which fuses its elementwise chain on the TPU.  Run
// as plain PyTorch, the same trip is about 28 passes over (B, T, P) f32
// arrays and three f32 GEMMs.  Per window b of a (B, T, P) state, with
// its scalars inv_mu[b] and mu[b], the carried basis V0[b] and the
// polish's rotation Q[b] (T x T each):
//
//   K8a  Eraw = X - A + inv_mu*Y
//        E    = max(Eraw - lmbda*inv_mu, 0) + min(Eraw + lmbda*inv_mu, 0)
//        M    = X - E + inv_mu*Y
//        W1   = V0^T M                      (per pixel column)
//        G    = W1 W1^T                     (T x T, summed over the P pixels)
//   (between them, in PyTorch on (B, T, T) tensors: K7 on G, then S, the
//   floor, the ratio, Q = (Vn diag ratio) V1^T and Vn = V0 V1)
//   K8b  E, M and W1 again, bit-equal to K8a's
//        Aupd = Q W1,  Z = X - Aupd - E,  Ynew = Y + mu*Z,  zz = sum Z^2
//        A, E, Y <- Aupd, E, Ynew, each rounded to its storage type
//
// Operands: X as the solver holds it, u8 or f32; A, E and Y bf16 or f32,
// all the same; each widened to f32 in registers (exact).  The build's
// -fmad=false keeps the front's `x - a + im*y` and the back's `y + mu*z`
// from being contracted, so E is bit-equal to the plain chain's
// (ops/ialm_front.py:front_chain) and the bf16 stores round as
// `.to(torch.bfloat16)` does (__float2bfloat16_rn, nearest even; PARITY
// deviation 8).  The products W1, G, Aupd and zz use fmaf and sum in
// orders of their own, against a GEMM's unknown order: they are compared
// with tolerances (tests/test_torch_ialm_trip.py, chip_smoke.py phase 20).
// W1 is rotated column by column (V0^T (M M^T) V0 would lose the small
// singular values' relative accuracy, ops/rpca.py:_row_space_svd).
//
// What bounds it: bytes.  At the cells' shapes (B = 64, T = 21, P =
// 93,312, u8 X, bf16 state) K8a reads 1 + 2 + 2 bytes an element and K8b
// reads 5 and writes 6: 16 bytes, 2.0 GB a trip, 0.60 ms at 3.35 TB/s;
// the products are 672 + 882 FMA a column, 18.5 GFLOP, 0.28 ms at the f32
// peak.  Storing W1 for K8b would move 24 bytes an element, so K8b
// recomputes E, M and W1 instead.  The design:
//
//   * one block of 256 threads per (window, strided set of 512-pixel
//     chunks), 2 consecutive pixel columns a thread, as in K6
//     (csrc/ialm_front.cu); the grid fills the resident slots once
//     (ops/ialm_trip.py picks the blocks a window);
//   * a thread walks its columns' T rows eight at a time, the loads of the
//     eight first and kept packed as loaded (u8x2 and bf16x2 or f32x2
//     loads when P % 4 == 0 and the pointers are 16-byte aligned, else
//     scalar loads; columns past P read as 0 and are stored nowhere): the
//     kernels are bound by the latency of their loads more than by their
//     FMAs, so each thread keeps 24 loads in flight.  It rotates each row
//     of M into its W1 registers as an outer product with the row of V0
//     (one LDS.128 broadcast per 8 FMA).  W1 is padded to kTP rows, T
//     rounded up to a multiple of 8 (a template argument, so W1 stays in
//     registers); V0 and Q are padded with zeros, so rows past T are 0;
//   * K8a stages each chunk's W1 in shared memory and accumulates the
//     lower triangle of G on K6's schedule: one 4 x 4 block of row pairs
//     a thread over a strided slice of the chunk's float4 column groups;
//     the next chunk's first eight rows load while the Gram runs;
//   * K8b keeps each row's operands as loaded in shared memory (its own
//     slots: no barrier), then runs the rows a second time from there to
//     form Aupd row by row (Q's row from shared memory against the W1
//     registers), Z, Ynew and the stores, in place (A and Y are not
//     __restrict__; each element is read and written by one thread only);
//   * no float atomics: each block writes its partial G (K8a) or zz (K8b)
//     to scratch in a fixed order and a small kernel sums a window's
//     partials in block order, so the trips repeat bit for bit;
//   * a window whose active[b] is 0 (read on the device; a null pointer
//     means all are active) skips its work, writes zero partials and
//     leaves A, E and Y as they are: the plain chain's freeze.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 2;                  // consecutive pixel columns per thread
constexpr int kChunk = kPix * kThreads;  // pixel columns per chunk
constexpr int kStride = kChunk + 4;      // W1 tile row stride, floats
constexpr int kGroups = kChunk / 4;      // float4 column groups per chunk
constexpr int kMaxT = 32;
// Measured on the card at the cells' shape (PERF.md §6): 8 rows
// beat 4, 2 resident blocks beat 1 and 3, and K8a's prefetch of the next
// chunk's first rows across its Gram saves 0.03 ms.
constexpr int kRowBatch = 8;             // rows whose loads are in flight together
constexpr int kMinBlocks = 2;            // blocks an SM must hold (caps registers at 128)

// Two consecutive operands as loaded, before widening: u8 x 2, bf16 x 2,
// f32 x 2.
template <typename T> struct Raw;
template <> struct Raw<uint8_t> { using type = uint16_t; };
template <> struct Raw<__nv_bfloat16> { using type = uint32_t; };
template <> struct Raw<float> { using type = float2; };
template <typename T> using raw_t = typename Raw<T>::type;

static_assert(kPix == 2, "a Raw holds 2 pixels");
// The pair at p with the first n of its columns inside P (the rest 0): one
// vector load where n == 2 and vec (p aligned), else scalar loads.
__device__ __forceinline__ uint16_t load_raw(const uint8_t* p, int n, bool vec) {
  if (n == kPix && vec) return *reinterpret_cast<const uint16_t*>(p);
  return (uint16_t)((n > 0 ? p[0] : 0) | (n > 1 ? p[1] : 0) << 8);
}
__device__ __forceinline__ uint32_t load_raw(const __nv_bfloat16* p, int n, bool vec) {
  if (n == kPix && vec) return *reinterpret_cast<const uint32_t*>(p);
  return (uint32_t)(n > 0 ? __bfloat16_as_ushort(p[0]) : 0) |
         (uint32_t)(n > 1 ? __bfloat16_as_ushort(p[1]) : 0) << 16;
}
__device__ __forceinline__ float2 load_raw(const float* p, int n, bool vec) {
  if (n == kPix && vec) return *reinterpret_cast<const float2*>(p);
  return make_float2(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f);
}

// A pair widened to f32; bf16 -> f32 is the bit pattern shifted up, exact.
__device__ __forceinline__ void widen(uint16_t w, float* v) {
  v[0] = (float)(w & 0xffu);
  v[1] = (float)(w >> 8);
}
__device__ __forceinline__ void widen(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen(float2 w, float* v) { v[0] = w.x, v[1] = w.y; }

__device__ __forceinline__ void store_pix(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_pix(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Lower-triangle pair p -> (i, j), j <= i, in the order (0,0), (1,0), (1,1), ...
__device__ __forceinline__ void pair_of(int p, int* i, int* j) {
  int r = 0;
  while ((r + 1) * (r + 2) / 2 <= p) ++r;
  *i = r;
  *j = p - r * (r + 1) / 2;
}

// The front of one element, in front_chain's order.
__device__ __forceinline__ void front(float x, float a, float y, float im, float shrink,
                                      float* e, float* m) {
  const float iy = im * y;
  const float eraw = x - a + iy;
  *e = fmaxf(eraw - shrink, 0.f) + fminf(eraw + shrink, 0.f);
  *m = x - *e + iy;
}

// The operands of rows r0 .. r0 + kRowBatch - 1 at a thread's columns, as
// loaded (rows past T and columns past P: 0).
template <typename TX, typename TS>
struct Batch {
  raw_t<TX> x[kRowBatch];
  raw_t<TS> a[kRowBatch], y[kRowBatch];
};

// Loads rows r0 .. of the columns whose element of row 0 is x[g], the
// first n_in inside P, all issued together.
template <typename TX, typename TS>
__device__ __forceinline__ void load_batch(Batch<TX, TS>& bt, const TX* x, const TS* a,
                                           const TS* y, size_t g, int r0, int T, int P,
                                           int n_in, bool vec) {
#pragma unroll
  for (int k = 0; k < kRowBatch; ++k) {
    const size_t gk = g + (size_t)(r0 + k) * P;
    const int n = r0 + k < T ? n_in : 0;
    bt.x[k] = load_raw(x + gk, n, vec);
    bt.a[k] = load_raw(a + gk, n, vec);
    bt.y[k] = load_raw(y + gk, n, vec);
  }
}

// W1 = V0^T M at this thread's columns (element g of row 0 is x[g], the
// first n_in inside P): row j of M, as it is formed, times row j of V0
// (v0s, kTP x kTP in shared memory, zero-padded) into w, j = 0 .. T-1 in
// order, kRowBatch rows loaded at a time into bt (with kLoaded, the first
// rows are in bt already).  With kStash, each row's operands as loaded
// also go to sx, sa, sy ([T][kThreads] pairs in shared memory), for the
// thread's own second pass.
template <int kTP, bool kStash, bool kLoaded, typename TX, typename TS>
__device__ __forceinline__ void rotate_columns(Batch<TX, TS>& bt, const TX* x, const TS* a,
                                               const TS* y, size_t g, int T, int P, int n_in,
                                               bool vec, float im, float shrink,
                                               const float* v0s, float (&w)[kTP][kPix],
                                               raw_t<TX>* sx, raw_t<TS>* sa, raw_t<TS>* sy) {
#pragma unroll
  for (int i = 0; i < kTP; ++i)
#pragma unroll
    for (int q = 0; q < kPix; ++q) w[i][q] = 0.f;
  for (int r0 = 0; r0 < T; r0 += kRowBatch) {
    if (!kLoaded || r0 > 0) load_batch(bt, x, a, y, g, r0, T, P, n_in, vec);
#pragma unroll
    for (int k = 0; k < kRowBatch; ++k) {
      if (r0 + k >= T) break;
      if (kStash) {
        const int s = (r0 + k) * kThreads + threadIdx.x;
        sx[s] = bt.x[k];
        sa[s] = bt.a[k];
        sy[s] = bt.y[k];
      }
      float xv[kPix], av[kPix], yv[kPix], m[kPix];
      widen(bt.x[k], xv);
      widen(bt.a[k], av);
      widen(bt.y[k], yv);
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        float e;
        front(xv[q], av[q], yv[q], im, shrink, &e, &m[q]);
        if (q >= n_in) m[q] = 0.f;
      }
      const float* vr = v0s + (r0 + k) * kTP;
#pragma unroll
      for (int i = 0; i < kTP; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(vr + i);
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          w[i][q] = fmaf(v.x, m[q], w[i][q]);
          w[i + 1][q] = fmaf(v.y, m[q], w[i + 1][q]);
          w[i + 2][q] = fmaf(v.z, m[q], w[i + 2][q]);
          w[i + 3][q] = fmaf(v.w, m[q], w[i + 3][q]);
        }
      }
    }
  }
}

// src[b] (T x T, row-major) into dst (kTP x kTP), zero-padded.
template <int kTP>
__device__ __forceinline__ void stage_square(const float* src, float* dst, int T) {
  for (int k = threadIdx.x; k < kTP * kTP; k += kThreads) {
    const int r = k / kTP, c = k - r * kTP;
    dst[k] = (r < T && c < T) ? src[r * T + c] : 0.f;
  }
}

template <int kTP, typename TX, typename TS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trip_front_kernel(const TX* __restrict__ x, const TS* __restrict__ a,
                  const TS* __restrict__ y, const float* __restrict__ inv_mu,
                  const float* __restrict__ v0, const uint8_t* __restrict__ active,
                  float* __restrict__ gpart, int T, int P, float lmbda, bool vec) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);   // [kTP][kStride]: a chunk's W1
  float* v0s = tile + kTP * kStride;               // [kTP][kTP]: V0[b]
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n_pairs = T * (T + 1) / 2;
  float* out = gpart + ((size_t)b * gridDim.x + blockIdx.x) * n_pairs;
  if (active != nullptr && !active[b]) {
    for (int p = tid; p < n_pairs; p += kThreads) out[p] = 0.f;
    return;
  }
  stage_square<kTP>(v0 + (size_t)b * T * T, v0s, T);
  // K6's Gram schedule (ops/ialm_front.py:gram_blocks): T padded to a
  // multiple of 4; the tile's rows past that are written and never read
  const int TP = (T + 3) & ~3;
  const int nb = TP / 4, n_bpairs = nb * (nb + 1) / 2, slices = kThreads / n_bpairs;
  const int bp = tid / slices, sl = tid - bp * slices;
  const bool gram_thread = bp < n_bpairs;
  int bi = 0, bj = 0;
  if (gram_thread) pair_of(bp, &bi, &bj);
  const float im = inv_mu[b];
  const float shrink = lmbda * im;
  const size_t base = (size_t)b * T * P;
  const int n_chunks = (P + kChunk - 1) / kChunk;
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
  __syncthreads();

  // columns of this thread in chunk c inside P
  auto n_in_of = [&](int c) { return min(max(P - (c * kChunk + kPix * tid), 0), kPix); };
  Batch<TX, TS> bt;
  if (blockIdx.x < n_chunks)
    load_batch(bt, x, a, y, base + blockIdx.x * kChunk + kPix * tid, 0, T, P,
               n_in_of(blockIdx.x), vec);
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int col = c * kChunk + kPix * tid;
    const int n_in = n_in_of(c);
    float w[kTP][kPix];
    rotate_columns<kTP, false, true>(
        bt, x, a, y, base + col, T, P, n_in, vec, im, shrink, v0s, w, (raw_t<TX>*)nullptr,
        (raw_t<TS>*)nullptr, (raw_t<TS>*)nullptr);
#pragma unroll
    for (int i = 0; i < kTP; ++i) store_pix(tile + i * kStride + kPix * tid, w[i]);
    // the next chunk's first rows load while this one's Gram runs
    const int cn = c + gridDim.x;
    if (cn < n_chunks)
      load_batch(bt, x, a, y, base + cn * kChunk + kPix * tid, 0, T, P, n_in_of(cn), vec);
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

  // the slices of each 4 x 4 block, summed in slice order through the
  // (now free) tile, then the block's partial Gram in pair order
  float* red = tile;   // [n_bpairs][slices][16] <= 16 * kThreads floats
  if (gram_thread) {
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) red[(bp * slices + sl) * 16 + ii * 4 + jj] = acc[ii][jj];
  }
  __syncthreads();
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

// K8b's shared memory: V0 and Q (kTP x kTP each), the threads' zz, then
// the operands of the T rows as pass 1 loaded them ([T][kThreads] pairs of
// A, of Y, of X).
template <int kTP, typename TX, typename TS>
size_t back_shmem(int T) {
  return sizeof(float) * (2 * kTP * kTP + kThreads) +
         (size_t)T * kThreads * (2 * sizeof(raw_t<TS>) + sizeof(raw_t<TX>));
}

template <int kTP, typename TX, typename TS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
trip_back_kernel(const TX* __restrict__ x, TS* a, TS* e, TS* y,
                 const float* __restrict__ inv_mu, const float* __restrict__ mu,
                 const float* __restrict__ v0, const float* __restrict__ q,
                 const uint8_t* __restrict__ active, float* __restrict__ zpart, int T, int P,
                 float lmbda, bool vec) {
  extern __shared__ float4 smem4[];
  float* v0s = reinterpret_cast<float*>(smem4);   // [kTP][kTP]
  float* qs = v0s + kTP * kTP;                     // [kTP][kTP]
  float* red = qs + kTP * kTP;                     // [kThreads]
  raw_t<TS>* sa = reinterpret_cast<raw_t<TS>*>(red + kThreads);   // [T][kThreads]
  raw_t<TS>* sy = sa + T * kThreads;
  raw_t<TX>* sx = reinterpret_cast<raw_t<TX>*>(sy + T * kThreads);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  float* out = zpart + (size_t)b * gridDim.x + blockIdx.x;
  if (active != nullptr && !active[b]) {
    if (tid == 0) *out = 0.f;
    return;
  }
  stage_square<kTP>(v0 + (size_t)b * T * T, v0s, T);
  stage_square<kTP>(q + (size_t)b * T * T, qs, T);
  const float im = inv_mu[b];
  const float shrink = lmbda * im;
  const float mub = mu[b];
  const size_t base = (size_t)b * T * P;
  const int n_chunks = (P + kChunk - 1) / kChunk;
  float zz = 0.f;
  __syncthreads();

  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int col = c * kChunk + kPix * tid;
    const int n_in = min(max(P - col, 0), kPix);
    const size_t g = base + col;
    float w[kTP][kPix];
    Batch<TX, TS> bt;
    rotate_columns<kTP, true, false>(bt, x, a, y, g, T, P, n_in, vec, im, shrink, v0s, w, sx,
                                     sa, sy);
    // pass 2: each row from the thread's own stash (no barrier needed)
    for (int r = 0; r < T; ++r) {
      const int s = r * kThreads + tid;
      float xv[kPix], av[kPix], yv[kPix];
      widen(sx[s], xv);
      widen(sa[s], av);
      widen(sy[s], yv);
      const float* qr = qs + r * kTP;
      float au[kPix], ev[kPix], yn[kPix];
#pragma unroll
      for (int p = 0; p < kPix; ++p) au[p] = 0.f;
#pragma unroll
      for (int i = 0; i < kTP; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + i);
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          au[p] = fmaf(qv.x, w[i][p], au[p]);
          au[p] = fmaf(qv.y, w[i + 1][p], au[p]);
          au[p] = fmaf(qv.z, w[i + 2][p], au[p]);
          au[p] = fmaf(qv.w, w[i + 3][p], au[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        float m;
        front(xv[p], av[p], yv[p], im, shrink, &ev[p], &m);
        const float z = xv[p] - au[p] - ev[p];
        yn[p] = yv[p] + mub * z;
        if (p < n_in) zz = fmaf(z, z, zz);
      }
      const size_t gr = g + (size_t)r * P;
      if (n_in == kPix && vec) {
        store_pix(a + gr, au);
        store_pix(e + gr, ev);
        store_pix(y + gr, yn);
      } else {
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          if (p < n_in) {
            store_one(a + gr + p, au[p]);
            store_one(e + gr + p, ev[p]);
            store_one(y + gr + p, yn[p]);
          }
        }
      }
    }
  }

  // the block's zz: a halving tree over the threads in a fixed order
  red[tid] = zz;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) *out = red[0];
}

// G[b] = sum over the window's blocks, in block order, of the partial
// Grams; both triangles written.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ gpart, float* __restrict__ g, int T,
                   int n_blocks) {
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

// zz[b] = sum over the window's blocks, in block order, of their partials.
__global__ void __launch_bounds__(256)
zz_reduce_kernel(const float* __restrict__ zpart, float* __restrict__ zz, int B,
                 int n_blocks) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s = 0.f;
  for (int k = 0; k < n_blocks; ++k) s += zpart[(size_t)b * n_blocks + k];
  zz[b] = s;
}

// One trip's operands as the C entries receive them (pointers from
// torch's data_ptr; unused ones null).
struct TripArgs {
  const void* x;
  void *a, *e, *y;
  const void *inv_mu, *mu, *v0, *q, *active;
  void *part, *out;   // the blocks' partials, then G (K8a) or zz (K8b)
  int B, T, P, n_blocks;
  float lmbda;
  cudaStream_t stream;
};

bool vec_ok(int P, const void* p0, const void* p1, const void* p2, const void* p3) {
  return P % 4 == 0 &&
         ((uintptr_t)p0 | (uintptr_t)p1 | (uintptr_t)p2 | (uintptr_t)p3) % 16 == 0;
}

template <int kTP, typename TX, typename TS>
int launch_front(const TripArgs& t) {
  const size_t shmem = sizeof(float) * ((size_t)kTP * kStride + kTP * kTP);
  static_assert(kTP * kStride >= 16 * kThreads, "the tile must hold the slices' partials");
  const cudaError_t attr = cudaFuncSetAttribute(
      trip_front_kernel<kTP, TX, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (attr != cudaSuccess) return (int)attr;
  trip_front_kernel<kTP, TX, TS><<<dim3(t.n_blocks, t.B), kThreads, shmem, t.stream>>>(
      (const TX*)t.x, (const TS*)t.a, (const TS*)t.y, (const float*)t.inv_mu,
      (const float*)t.v0, (const uint8_t*)t.active, (float*)t.part, t.T, t.P, t.lmbda,
      vec_ok(t.P, t.x, t.a, t.y, nullptr));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gram_reduce_kernel<<<t.B, 256, 0, t.stream>>>((const float*)t.part, (float*)t.out, t.T,
                                                t.n_blocks);
  return (int)cudaGetLastError();
}

template <int kTP, typename TX, typename TS>
int launch_back(const TripArgs& t) {
  const size_t shmem = back_shmem<kTP, TX, TS>(t.T);
  const cudaError_t attr = cudaFuncSetAttribute(
      trip_back_kernel<kTP, TX, TS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (attr != cudaSuccess) return (int)attr;
  trip_back_kernel<kTP, TX, TS><<<dim3(t.n_blocks, t.B), kThreads, shmem, t.stream>>>(
      (const TX*)t.x, (TS*)t.a, (TS*)t.e, (TS*)t.y, (const float*)t.inv_mu,
      (const float*)t.mu, (const float*)t.v0, (const float*)t.q, (const uint8_t*)t.active,
      (float*)t.part, t.T, t.P, t.lmbda, vec_ok(t.P, t.x, t.a, t.y, t.e));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zz_reduce_kernel<<<(t.B + 255) / 256, 256, 0, t.stream>>>((const float*)t.part,
                                                            (float*)t.out, t.B, t.n_blocks);
  return (int)cudaGetLastError();
}

// K8a (kBack false) or K8b for these operands: kTP is T rounded up to a
// multiple of 8, X u8 or f32, the state bf16 or f32.
template <bool kBack, typename TX, typename TS>
int launch_for(const TripArgs& t) {
  switch ((t.T + 7) / 8) {
    case 1: return kBack ? launch_back<8, TX, TS>(t) : launch_front<8, TX, TS>(t);
    case 2: return kBack ? launch_back<16, TX, TS>(t) : launch_front<16, TX, TS>(t);
    case 3: return kBack ? launch_back<24, TX, TS>(t) : launch_front<24, TX, TS>(t);
    default: return kBack ? launch_back<32, TX, TS>(t) : launch_front<32, TX, TS>(t);
  }
}

template <bool kBack>
int launch_trip(const TripArgs& t, int x_u8, int s_bf16) {
  if (t.B < 1 || t.B > 65535 || t.T < 1 || t.T > kMaxT || t.P < 1 || t.n_blocks < 1 ||
      t.n_blocks > (t.P + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  if (x_u8 && s_bf16) return launch_for<kBack, uint8_t, __nv_bfloat16>(t);
  if (x_u8) return launch_for<kBack, uint8_t, float>(t);
  if (s_bf16) return launch_for<kBack, float, __nv_bfloat16>(t);
  return launch_for<kBack, float, float>(t);
}

}  // namespace

extern "C" {

// Launches K8a on `stream`.  x, a, y are (B, T, P): x u8 when x_u8 else
// f32, a and y bf16 when s_bf16 else f32.  inv_mu is (B,) f32, v0 is
// (B, T, T) f32, active is (B,) u8 or null (all active).  g is (B, T, T)
// f32; gpart is scratch of B * n_blocks * T(T+1)/2 f32.  1 <= T <= 32,
// P >= 1, 1 <= B <= 65535, 1 <= n_blocks <= ceil(P / 512).  Returns a
// cudaError_t (0 on success).
int swt_ialm_trip_front(const void* x, const void* a, const void* y, const void* inv_mu,
                        const void* v0, const void* active, void* gpart, void* g, int B,
                        int T, int P, int n_blocks, int x_u8, int s_bf16, float lmbda,
                        void* stream) {
  const TripArgs t{x, const_cast<void*>(a), nullptr, const_cast<void*>(y), inv_mu, nullptr,
                   v0, nullptr, active, gpart, g, B, T, P, n_blocks, lmbda,
                   (cudaStream_t)stream};
  return launch_trip<false>(t, x_u8, s_bf16);
}

// Launches K8b on `stream`.  x, a, e, y, inv_mu, v0 and active as for
// swt_ialm_trip_front (e of a's type); mu is (B,) f32, q is (B, T, T)
// f32.  a, e and y are written in place for the active windows; zz is
// (B,) f32 (0 for an inactive window); zpart is scratch of B * n_blocks
// f32.  Returns a cudaError_t (0 on success).
int swt_ialm_trip_back(const void* x, void* a, void* e, void* y, const void* inv_mu,
                       const void* mu, const void* v0, const void* q, const void* active,
                       void* zpart, void* zz, int B, int T, int P, int n_blocks, int x_u8,
                       int s_bf16, float lmbda, void* stream) {
  const TripArgs t{x, a, e, y, inv_mu, mu, v0, q, active, zpart, zz, B, T, P, n_blocks, lmbda,
                   (cudaStream_t)stream};
  return launch_trip<true>(t, x_u8, s_bf16);
}

}  // extern "C"
