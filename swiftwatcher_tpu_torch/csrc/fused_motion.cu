// K1: fused motion post-filter for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/fused_motion.py
// (fused_motion_filter, body _make_kernel).  Per frame, u8 in and u8 out:
//
//   circular 7x7 bilateral (sigma_color 15, sigma_space 1) on a
//   BORDER_REFLECT_101 pad -> threshold-to-zero -> 3x3 erosion -> 3x3
//   dilation, the last two replicating the edges of the thresholded and
//   eroded planes at the frame border.
//
// What bounds it: bytes, one read and one write of the u8 frames, as long
// as the motion is sparse (RPCA motion is mostly sub-threshold noise).
// The arithmetic is the bilateral's taps on the few pixels near motion.
// The design keeps every intermediate in shared memory as u8 and skips
// whatever provably yields zero:
//
//   * one block of 256 threads owns 24 rows x 128 columns of output; it
//     stages its input with a halo of radius + 2 rows and 16 columns (the
//     bilateral's reach plus the opening's two), so every staged row span
//     is 16-byte aligned.  Each thread starts all of its uint4 loads (two)
//     before it tests any; only spans at the frame edge go byte by byte,
//     and the reflect-101 columns are filled inside shared memory by the
//     blocks that touch the left or right border.  No division per
//     element.  24 rows fit the main path's 216-row crop (9 bands) and
//     measured faster there than 16, 32 or 64 rows, or 256 columns.
//   * quiet blocks: a byte-wise max of the staged words against the
//     threshold, then __syncthreads_or.  A block whose needed input is all
//     at or below the threshold stores zeros with uint4 stores: the
//     bilateral is a weighted mean, so it cannot exceed its window's
//     maximum, threshold-to-zero then kills every pixel, and the opening of
//     a zero plane is zero (the TPU kernel's row-chunk skip, per block).
//   * quiet pixels of hot blocks: the same argument per pixel.  A separable
//     max over the u8 stage (4 pixels a thread with __byte_perm and
//     __vmaxu4) gives each pixel's (2r+1)^2 window maximum; the tap loop
//     runs only where it exceeds the threshold.  Warps take 4 x 8 pixel
//     blocks, so lanes that skip sit together and a warp with no such
//     pixel skips the loop.
//   * a colour-weight table: d = s - c is an integer in [-255, 255], so
//     expf((d*d) * gc) takes 256 values; the block builds them with the
//     same expf on the same f32 arguments as the plain chain, and the tap
//     is w = sw[tap] * lut[|d|].  No expf in the tap loop.
//   * the thresholded and eroded planes are u8 (rounded integers, exact),
//     and the opening runs on 4 pixels a thread with __vminu4/__vmaxu4.
//     Edge replication is baked into the planes: blocks at the frame
//     border copy each out-of-frame cell from its clamped in-frame cell
//     before the next pass reads it.
//   * radius is a template parameter (1..8), so the tap loop unrolls with
//     constant offsets and constant space weights.
//   * 15-18 KB of static shared memory, 256 threads and 32 registers a
//     thread at radius 3: 8 blocks reside on an SM.  Blocks that each walk
//     many regions, loading the next region while computing this one,
//     measured slower than one block per region.
//
// Bit-equality with the plain PyTorch chain on the card needs the same
// float operations in the same order: taps accumulate in the order of
// bilateral_offsets, w = sw * lut[|d|] with lut[k] = expf((k*k) * gc),
// num = num + w*s and den = den + w with separate roundings (built with
// -fmad=false, no fast math), rintf (half to even) for the final rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 24;     // output rows per block
constexpr int kSegW = 128;    // output columns per block, a multiple of 16
constexpr int kMargin = 16;   // staged columns on each side (>= radius + 2)
constexpr int kThreads = 256;
constexpr int kMaxRadius = 8;
constexpr int kMaxTaps = 256;
constexpr int kStageW = kSegW + 2 * kMargin;  // staged row, bytes
constexpr int kQ = kStageW / 16;              // uint4 chunks per staged row
// The thresholded and eroded planes span global columns [x0 - 4, x0 + kSegW
// + 4): word-aligned, and wide enough for the opening's reach of 2.
constexpr int kPlaneW = kSegW + 8;
constexpr int kPlaneWords = kPlaneW / 4;
constexpr int kPlaneOff = kMargin - 4;        // staged column of plane column 0
constexpr int kTRows = kRows + 4;             // thresholded rows: y0 - 2 ..
constexpr int kERows = kRows + 2;             // eroded rows: y0 - 1 ..

struct SpaceWeights {
  float w[kMaxTaps];
};

__device__ __forceinline__ int reflect101(int k, int n) {
  if (k < 0) k = -k;
  if (k >= n) k = 2 * n - 2 - k;
  return k;
}

__device__ __forceinline__ int clampi(int k, int n) { return min(max(k, 0), n - 1); }

// floor(d / 4) for d >= -8, without relying on the sign of a shift.
__host__ __device__ constexpr int floor4(int d) { return (d + 8) / 4 - 2; }

// Bytes [s, s + 4) of the 8-byte pair (lo, hi), for a constant s in 0..3.
__device__ __forceinline__ uint32_t shifted(uint32_t lo, uint32_t hi, int s) {
  return s == 0 ? lo : __byte_perm(lo, hi, 0x3210 + 0x1111 * s);
}

// 0xff in each byte of w above tq (a threshold in 0..255), else 0.
__device__ __forceinline__ uint32_t above(uint32_t w, int tq) {
  return __vcmpgtu4(w, (uint32_t)tq * 0x01010101u);
}

__device__ __forceinline__ uint32_t vmax_bytes(uint4 v) {
  return __vmaxu4(__vmaxu4(v.x, v.y), __vmaxu4(v.z, v.w));
}

// Byte b of a uint4, b a constant after unrolling.
__device__ __forceinline__ uint32_t byte_of(const uint4& v, int b) {
  const uint32_t w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return (w >> (8 * (b & 3))) & 0xffu;
}

// Stores 16 output bytes at global column gx of row `row` (uint4 when the
// whole span lies in the frame and rows are 16-byte aligned).
__device__ __forceinline__ void store16(uint8_t* row, int gx, int W, bool vec, uint4 v) {
  if (vec && gx + 16 <= W) {
    *reinterpret_cast<uint4*>(row + gx) = v;
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (gx + b < W) row[gx + b] = (uint8_t)byte_of(v, b);
}

// The block's staged chunk k (row k / kQ, 16 columns from kMargin before
// x0): one uint4 load where the span lies in the frame and rows are
// 16-byte aligned; rows beyond the bilateral's reach of the frame and
// columns outside it are 0.
template <int R>
__device__ __forceinline__ uint4 stage_load(const uint8_t* __restrict__ src, int H, int W,
                                            int y0, int x0, int k, bool vec) {
  const int ly = k / kQ, q = k - ly * kQ;
  const int gy = y0 - (R + 2) + ly, gx = x0 - kMargin + 16 * q;
  if (gy < -R || gy >= H + R) return make_uint4(0, 0, 0, 0);
  const uint8_t* row = src + (size_t)reflect101(gy, H) * W;
  if (vec && gx >= 0 && gx + 16 <= W) return __ldg(reinterpret_cast<const uint4*>(row + gx));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (gx + b >= 0 && gx + b < W) w[b >> 2] |= (uint32_t)row[gx + b] << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Whether staged chunk k holds a byte above tq in the columns that feed
// the block's output, [x0 - halo, x0 + kSegW + halo).
template <int R>
__device__ __forceinline__ bool chunk_hot(uint4 v, int k, int tq) {
  const int q = k % kQ;
  if (q > 0 && q < kQ - 1) return above(vmax_bytes(v), tq) != 0;
  const int lo = q == 0 ? kMargin - (R + 2) : 0, hi = q == 0 ? 16 : R + 2;
  bool hot = false;
#pragma unroll
  for (int b = 0; b < 16; ++b) hot |= b >= lo && b < hi && (int)byte_of(v, b) > tq;
  return hot;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
fused_motion_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int W, SpaceWeights sw, float gauss_color, float thresh,
                    int tq, bool vec) {
  constexpr int kHalo = R + 2;
  constexpr int kIH = kRows + 2 * kHalo;      // staged rows
  constexpr int kChunks = kIH * kQ;           // staged uint4 chunks
  constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  __shared__ __align__(16) uint8_t s_in[kIH * kStageW];
  // the row window maxima, later the eroded plane
  __shared__ __align__(16) uint8_t s_hm[kIH * kPlaneW];
  // the hot-pixel mask, then the thresholded plane
  __shared__ __align__(16) uint8_t s_thr[kTRows * kPlaneW];
  __shared__ float s_lut[256];

  const int x0 = blockIdx.x * kSegW, y0 = blockIdx.y * kRows;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = in + frame;
  uint8_t* dst = out + frame;
  const int tid = threadIdx.x;

  // 1. all of the thread's staged loads first, then the quiet test on them
  uint4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = tid + i * kThreads;
    v[i] = k < kChunks ? stage_load<R>(src, H, W, y0, x0, k, vec) : make_uint4(0, 0, 0, 0);
  }
  bool hot = false;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = tid + i * kThreads;
    hot |= k < kChunks && chunk_hot<R>(v[i], k, tq);
  }
  if (!__syncthreads_or(hot)) {
    for (int k = tid; k < kRows * (kSegW / 16); k += kThreads) {
      const int r = k / (kSegW / 16), m = k - r * (kSegW / 16);
      if (y0 + r < H && x0 + 16 * m < W)
        store16(dst + (size_t)(y0 + r) * W, x0 + 16 * m, W, vec, make_uint4(0, 0, 0, 0));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = tid + i * kThreads;
    if (k < kChunks) *reinterpret_cast<uint4*>(s_in + 16 * k) = v[i];
  }
  for (int k = tid; k < 256; k += kThreads) s_lut[k] = expf((float)(k * k) * gauss_color);
  __syncthreads();

  const bool left = x0 == 0, right = x0 + kSegW + kHalo > W;
  // 2. reflect-101 columns, inside shared memory, at the left and right
  //    borders (reads in-frame columns, writes out-of-frame ones)
  if (left || right) {
    for (int k = tid; k < kIH * 2 * R; k += kThreads) {
      const int ly = k / (2 * R), j = k - ly * (2 * R);
      const int gx = j < R ? j - R : W + j - R;
      const int lx = gx - x0 + kMargin;
      if (lx >= 0 && lx < kStageW) {
        uint8_t* row = s_in + ly * kStageW;
        row[lx] = row[reflect101(gx, W) - x0 + kMargin];
      }
    }
    __syncthreads();
  }

  // 3. each staged row's max over 2r+1 columns, 4 plane columns a thread
  {
    constexpr int kLo = floor4(-R), kNW = floor4(R) + 2 - kLo;
    for (int k = tid; k < kIH * kPlaneWords; k += kThreads) {
      const int ly = k / kPlaneWords, w = k - ly * kPlaneWords;
      const uint32_t* row = reinterpret_cast<const uint32_t*>(s_in + ly * kStageW);
      uint32_t wv[kNW];
#pragma unroll
      for (int i = 0; i < kNW; ++i) wv[i] = row[w + kPlaneOff / 4 + kLo + i];
      uint32_t m = 0;
#pragma unroll
      for (int d = -R; d <= R; ++d) {
        const int f = floor4(d) - kLo;
        m = __vmaxu4(m, shifted(wv[f], wv[f + 1], d - 4 * floor4(d)));
      }
      reinterpret_cast<uint32_t*>(s_hm + ly * kPlaneW)[w] = m;
    }
  }
  __syncthreads();

  // 4. the window max over 2r+1 rows, as a mask of hot pixels
  for (int k = tid; k < kTRows * kPlaneWords; k += kThreads) {
    const int t = k / kPlaneWords, w = k - t * kPlaneWords;
    const uint32_t* col = reinterpret_cast<const uint32_t*>(s_hm) + t * kPlaneWords + w;
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i <= 2 * R; ++i) m = __vmaxu4(m, col[i * kPlaneWords]);
    reinterpret_cast<uint32_t*>(s_thr)[t * kPlaneWords + w] = above(m, tq);
  }
  __syncthreads();

  // 5. bilateral + threshold on the hot in-frame pixels of the plane's
  //    needed columns [2, kSegW + 6); every other cell becomes 0
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    constexpr int kBlocksX = kPlaneW / 8, kBlocks = (kTRows / 4) * kBlocksX;
    for (int wb = warp; wb < kBlocks; wb += kThreads / 32) {
      const int by = wb / kBlocksX, bx = wb - by * kBlocksX;
      const int t = 4 * by + (lane >> 3), c = 8 * bx + (lane & 7);
      const int gy = y0 - 2 + t, gx = x0 - 4 + c;
      uint8_t* cell = s_thr + t * kPlaneW + c;
      const bool active = *cell && c >= 2 && c < kSegW + 6 && gy >= 0 && gy < H &&
                          gx >= 0 && gx < W;
      if (!__any_sync(0xffffffffu, active)) {
        *cell = 0;
        continue;
      }
      uint8_t result = 0;
      if (active) {
        const uint8_t* center = s_in + (t + R) * kStageW + c + kPlaneOff;
        const int cv = *center;
        float num = 0.f, den = 0.f;
        int tap = 0;
#pragma unroll
        for (int i = -R; i <= R; ++i) {
#pragma unroll
          for (int j = -R; j <= R; ++j) {
            if (i * i + j * j > R * R) continue;
            const int s = center[i * kStageW + j];
            const float w = sw.w[tap++] * s_lut[abs(s - cv)];
            num = num + w * (float)s;
            den = den + w;
          }
        }
        const float b = rintf(num / den);
        result = b > thresh ? (uint8_t)b : 0;
      }
      *cell = result;
    }
  }
  __syncthreads();

  const bool edge = left || right || y0 == 0 || y0 + kRows + 2 > H;
  // 6. edge replication of the thresholded plane, out-of-frame cells of the
  //    needed region from their clamped in-frame cells
  if (edge) {
    for (int k = tid; k < kTRows * (kSegW + 4); k += kThreads) {
      const int t = k / (kSegW + 4), c = k - t * (kSegW + 4) + 2;
      const int gy = y0 - 2 + t, gx = x0 - 4 + c;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W)
        s_thr[t * kPlaneW + c] =
            s_thr[(clampi(gy, H) - y0 + 2) * kPlaneW + clampi(gx, W) - x0 + 4];
    }
    __syncthreads();
  }

  // 7. 3x3 erosion, 4 columns a thread (bytes outside the needed columns
  //    [3, kSegW + 5) may read a clamped neighbour word: never used)
  uint8_t* s_ero = s_hm;
  for (int k = tid; k < kERows * kPlaneWords; k += kThreads) {
    const int e = k / kPlaneWords, w = k - e * kPlaneWords;
    const int wl = max(w - 1, 0), wr = min(w + 1, kPlaneWords - 1);
    uint32_t m = 0xffffffffu;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(s_thr) + (e + i) * kPlaneWords;
      const uint32_t c = row[w];
      m = __vminu4(m, __vminu4(c, __vminu4(shifted(row[wl], c, 3), shifted(c, row[wr], 1))));
    }
    reinterpret_cast<uint32_t*>(s_ero)[e * kPlaneWords + w] = m;
  }
  __syncthreads();

  // 8. edge replication of the eroded plane on [3, kSegW + 5)
  if (edge) {
    for (int k = tid; k < kERows * (kSegW + 2); k += kThreads) {
      const int e = k / (kSegW + 2), c = k - e * (kSegW + 2) + 3;
      const int gy = y0 - 1 + e, gx = x0 - 4 + c;
      if (gy < 0 || gy >= H || gx < 0 || gx >= W)
        s_ero[e * kPlaneW + c] =
            s_ero[(clampi(gy, H) - y0 + 1) * kPlaneW + clampi(gx, W) - x0 + 4];
    }
    __syncthreads();
  }

  // 9. 3x3 dilation, 16 output columns a thread, one uint4 store
  for (int k = tid; k < kRows * (kSegW / 16); k += kThreads) {
    const int r = k / (kSegW / 16), m = k - r * (kSegW / 16);
    if (y0 + r < H && x0 + 16 * m < W) {
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int w = 1 + 4 * m + q;
        uint32_t v = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint32_t* row = reinterpret_cast<const uint32_t*>(s_ero) + (r + i) * kPlaneWords;
          const uint32_t c = row[w];
          v = __vmaxu4(v, __vmaxu4(c, __vmaxu4(shifted(row[w - 1], c, 3),
                                               shifted(c, row[w + 1], 1))));
        }
        o[q] = v;
      }
      store16(dst + (size_t)(y0 + r) * W, x0 + 16 * m, W, vec,
              make_uint4(o[0], o[1], o[2], o[3]));
    }
  }
}

// The number of taps of radius r, as bilateral_offsets counts them.
int taps_of(int r) {
  int n = 0;
  for (int i = -r; i <= r; ++i)
    for (int j = -r; j <= r; ++j) n += i * i + j * j <= r * r;
  return n;
}

template <int R>
cudaError_t launch(dim3 grid, cudaStream_t stream, const uint8_t* in, uint8_t* out, int H,
                   int W, const SpaceWeights& sw, float gc, float thresh, int tq, bool vec) {
  fused_motion_kernel<R><<<grid, kThreads, 0, stream>>>(in, out, H, W, sw, gc, thresh, tq, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over (N, H, W) u8 frames, one block per region
// of kRows x kSegW output pixels.  `space_weights` is a host array of
// `n_taps` f32 weights in tap order (bilateral_offsets).  `thresh` >= 0.
// Returns a cudaError_t (0 on success); argument errors return
// cudaErrorInvalidValue.
int swt_fused_motion(const void* in, void* out, int N, int H, int W, int radius,
                     const float* space_weights, int n_taps, float gauss_color,
                     float thresh, void* stream) {
  if (N <= 0 || N > 65535 || radius < 1 || radius > kMaxRadius || H <= radius ||
      W <= radius || n_taps != taps_of(radius) || (H + kRows - 1) / kRows > 65535 ||
      !(thresh >= 0.f)) {
    return (int)cudaErrorInvalidValue;
  }
  SpaceWeights sw;
  for (int t = 0; t < n_taps; ++t) sw.w[t] = space_weights[t];
  // u8 v > thresh  <=>  v > tq
  const int tq = thresh >= 255.f ? 255 : (int)thresh;
  const bool vec = W % 16 == 0 && (uintptr_t)in % 16 == 0 && (uintptr_t)out % 16 == 0;
  const dim3 grid((W + kSegW - 1) / kSegW, (H + kRows - 1) / kRows, N);
  const uint8_t* i8 = (const uint8_t*)in;
  uint8_t* o8 = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const float gc = gauss_color;
  switch (radius) {
    case 1: return (int)launch<1>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    case 2: return (int)launch<2>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    case 3: return (int)launch<3>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    case 4: return (int)launch<4>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    case 5: return (int)launch<5>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    case 6: return (int)launch<6>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    case 7: return (int)launch<7>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
    default: return (int)launch<8>(grid, s, i8, o8, H, W, sw, gc, thresh, tq, vec);
  }
}

}  // extern "C"
