// Tiled Jacobi 3x3 min sweeps in shared memory, for Hopper (sm_90a).
//
// Shared by K2 and K4 (rank_compact.cu) and K5 (ccl_sweep.cu).  One sweep
// of a frame's f32 plane under its foreground is
//
//   v = fg ? min over the 3x3 window of v (out-of-frame cells ignored) : s
//
// with s the sentinel (the background label).  A frame's plane does not fit
// a block, so a block owns one kTileH x kTileW tile of a frame and stages
// the tile with a halo of h pixels: two f32 planes, the u8 foreground and
// per (strip of kStrip rows, column) a bit mask of the strip's foreground
// rows.  Out-of-frame cells are staged as background holding the sentinel,
// which equals ignoring them for values at most the sentinel.
//
// Each sweep's dependency cone grows by one pixel, so after k <= h sweeps
// every cell at least k inside the staged edge equals the whole-frame
// result.  Sweep k computes only those cells, and only foreground ones:
// background cells hold the sentinel in both planes (after the first sweep
// where a loaded plane held other values there).  A sweep reuses row minima
// down a strip and skips strips without foreground, and the sweeps stop
// once one changes nothing.  Min is exact, so the result is bit-equal to
// the plain whole-frame version in any order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;       // a multiple of kSeg
constexpr int kSeg = 32;         // columns per root count: one warp ballot
constexpr int kTileThreads = 256;
constexpr int kStrip = 8;        // rows a thread sweeps down one column

// f(row, column) for every cell of a rows x cols block, a warp per row and
// a lane per column, with no division per cell: for passes over the staged
// planes.  Loops that read a device-memory plane cell by cell stay flat (one
// index per thread, divided into row and column), which the compiler
// unrolls, so a thread's loads are in flight together; on an H100 the
// nested form cost K2 11% on sparse frames, and the flat one 4% on dense
// frames where it replaced this in the staged passes.
template <class F>
__device__ __forceinline__ void for_each_cell(int rows, int cols, F f) {
  for (int r = threadIdx.x >> 5; r < rows; r += kTileThreads / 32)
    for (int c = threadIdx.x & 31; c < cols; c += 32) f(r, c);
}

// The staged planes of a tile with halo h: two f32 planes a, b of
// (SH, SW) cells, the u8 foreground m, and the strip masks.
struct Staged {
  int h, SH, SW, strips;
  float* a;
  float* b;
  uint8_t* m;
  uint8_t* strip_fg;
};

__host__ __device__ __forceinline__ size_t staged_bytes(int h) {
  const int SH = kTileH + 2 * h, SW = kTileW + 2 * h;
  return (size_t)SH * SW * (2 * sizeof(float) + 1) + (size_t)((SH + kStrip - 1) / kStrip) * SW;
}

__device__ __forceinline__ Staged staged_planes(float* smem, int h) {
  Staged st;
  st.h = h;
  st.SH = kTileH + 2 * h;
  st.SW = kTileW + 2 * h;
  st.strips = (st.SH + kStrip - 1) / kStrip;
  const int S = st.SH * st.SW;
  st.a = smem;
  st.b = smem + S;
  st.m = reinterpret_cast<uint8_t*>(smem + 2 * S);
  st.strip_fg = st.m + S;
  return st;
}

// Dynamic shared memory of a tile kernel with halo h (staged_bytes); above
// 48 KB the kernel must be allowed it first.
template <class K>
cudaError_t tile_smem(K kernel, int h, size_t* bytes) {
  *bytes = staged_bytes(h);
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// One Jacobi sweep a -> b of the staged foreground cells in rows
// [ry0, ry1) x columns [rx0, rx1): b = min over the 3x3 window of a (cells
// outside the staged region ignored).  A thread walks one column of a
// strip of kStrip rows, reusing row minima, and skips a strip without
// foreground.  Returns whether any computed cell changed.
__device__ __forceinline__ int stage_sweep(const Staged& st, const float* a, float* b,
                                           int ry0, int ry1, int rx0, int rx1) {
  int changed = 0;
  const int SH = st.SH, SW = st.SW, cols = rx1 - rx0;
  const int s0 = ry0 / kStrip, s1 = (ry1 + kStrip - 1) / kStrip;
  for (int w = threadIdx.x; w < (s1 - s0) * cols; w += kTileThreads) {
    const int sx = rx0 + w % cols, base = (s0 + w / cols) * kStrip;
    const int sy0 = max(base, ry0), sy1 = min(base + kStrip, ry1);
    const unsigned rows = st.strip_fg[(base / kStrip) * SW + sx] >> (sy0 - base) &
                          ((1u << (sy1 - sy0)) - 1u);
    if (!rows) continue;
    const int xa = max(sx - 1, 0), xb = min(sx + 1, SW - 1);
    auto row_min = [&](int y) {
      const float* r = a + y * SW;
      return fminf(fminf(r[xa], r[sx]), r[xb]);
    };
    float cur = row_min(sy0);
    float up = sy0 > 0 ? row_min(sy0 - 1) : cur;
    for (int y = sy0; y < sy1; ++y) {
      const float down = y + 1 < SH ? row_min(y + 1) : cur;
      if (rows >> (y - sy0) & 1u) {
        const int i = y * SW + sx;
        const float v = fminf(fminf(up, cur), down);
        changed |= v != a[i];
        b[i] = v;
      }
      up = cur;
      cur = down;
    }
  }
  return changed;
}

struct Tile {
  int n, ty0, tx0, th, tw;
};

// The tile of this block: blocks run over the tiles of frame 0 in row-major
// order, then frame 1, ...
__device__ __forceinline__ Tile tile_of_block(int H, int W, int tiles_x, int tiles) {
  Tile t;
  t.n = blockIdx.x / tiles;
  const int k = blockIdx.x - t.n * tiles;
  t.ty0 = (k / tiles_x) * kTileH;
  t.tx0 = (k % tiles_x) * kTileW;
  t.th = min(kTileH, H - t.ty0);
  t.tw = min(kTileW, W - t.tx0);
  return t;
}

// Foreground sources, by frame raster index: a u8 plane, or the cells of a
// converged label plane below the sentinel.
struct FgPlane {
  const uint8_t* fg;
  __device__ __forceinline__ bool operator()(int p) const { return fg[p]; }
};

struct FgBelow {
  const float* lbl;
  float sentinel;
  __device__ __forceinline__ bool operator()(int p) const { return lbl[p] < sentinel; }
};

// What a staged in-frame cell starts with, given its raster index and
// foreground: the raster index (background: sentinel), the sentinel, or
// the value of a given plane.
struct SeedIndex {
  float sentinel;
  __device__ __forceinline__ float operator()(int p, bool f) const {
    return f ? (float)p : sentinel;
  }
};

struct SeedSentinel {
  float sentinel;
  __device__ __forceinline__ float operator()(int, bool) const { return sentinel; }
};

struct SeedPlane {
  const float* v;
  __device__ __forceinline__ float operator()(int p, bool) const { return v[p]; }
};

// Whether the tile itself (not its halo) holds foreground.
template <class Fg>
__device__ __forceinline__ bool tile_has_fg(Fg fg, int W, const Tile& t) {
  int any = 0;
  for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads)
    any |= fg((t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw);
  return __syncthreads_or(any);
}

// Stage the tile plus its halo: m = fg (0 outside the frame), a = the
// seed (sentinel outside the frame), b = m ? a : sentinel; then the strip
// masks.  Returns whether a background cell holds anything but the
// sentinel in a.  Ends with a barrier.
template <class Fg, class Seed>
__device__ __forceinline__ bool stage(Fg fg, Seed seed, const Staged& st, int H, int W,
                                      const Tile& t, float sentinel) {
  const int y0 = t.ty0 - st.h, x0 = t.tx0 - st.h, SW = st.SW;
  int dirty = 0;
  for (int i = threadIdx.x; i < st.SH * SW; i += kTileThreads) {
    const int gy = y0 + i / SW, gx = x0 + i % SW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int p = gy * W + gx;
    const bool f = inside && fg(p);
    const float v = inside ? seed(p, f) : sentinel;
    st.m[i] = f;
    st.a[i] = v;
    st.b[i] = f ? v : sentinel;
    dirty |= !f && v != sentinel;
  }
  dirty = __syncthreads_or(dirty);
  for_each_cell(st.strips, SW, [&](int s, int c) {
    const int sy0 = s * kStrip, sy1 = min(sy0 + kStrip, st.SH);
    unsigned rows = 0;
    for (int y = sy0; y < sy1; ++y) rows |= (unsigned)st.m[y * SW + c] << (y - sy0);
    st.strip_fg[s * SW + c] = (uint8_t)rows;
  });
  __syncthreads();
  return dirty;
}

// Up to `sweeps` staged sweeps a <-> b; returns the plane holding the
// result and sets `moving` to whether the last sweep run changed anything
// (true when sweeps == 0).  Sweep k (from 1) computes only the cells at
// least k inside the staged edge, the only ones still exact, which are all
// that later sweeps read.  It stops once a sweep changes nothing: each
// later sweep would read the same values and change nothing either.
// `clear_bg` (a was staged with values other than the sentinel on
// background) sets a's background to the sentinel after the first sweep,
// before the second writes a: the two touch disjoint cells, so no barrier
// is needed between them.
__device__ __forceinline__ float* sweep_staged(const Staged& st, int sweeps, bool& moving,
                                               bool clear_bg = false) {
  float* a = st.a;
  float* b = st.b;
  moving = true;
  for (int k = 1; k <= sweeps && moving; ++k) {
    moving = __syncthreads_or(stage_sweep(st, a, b, k, st.SH - k, k, st.SW - k));
    if (k == 1 && clear_bg && moving && sweeps > 1)
      for_each_cell(st.SH, st.SW, [&](int r, int c) {
        const int i = r * st.SW + c;
        if (!st.m[i]) a[i] = b[i];  // b's background holds the sentinel
      });
    float* t = a; a = b; b = t;
  }
  return a;
}

}  // namespace
