// K3: whole-frame label convergence for Hopper (sm_90a), as a union-find.
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/ccl_local.py
// (converge_frames, body _make_kernel).  The TPU kernel floods each frame
// of an (N, H, W) f32 plane under its bool foreground by super-sweeps
// (3x3 min, then segmented min-scans along rows and columns) until one
// changes nothing.  That fixpoint has a closed form, which this kernel
// computes directly: with v = the first 3x3 min step (for a foreground p,
// the min of the input over p's 3x3 window inside the frame),
//
//   foreground p -> min of v over p's 8-connected foreground component
//   background p -> sentinel
//
// (after the first step background holds the sentinel and values only move
// within a component).  Inputs are label or rank planes: values in
// [0, sentinel].  A component's minimum is unique, so the output does not
// depend on the order the atomics below run in.  `max_iters` == 0 returns
// the input; any cap >= 1 gives the fixpoint (the TPU kernel and the plain
// version stop at their cap instead).
//
// What bounds it: bytes, a handful of passes over the planes, whatever a
// component's shape (super-sweeps need one per turn of its geodesic, each
// a chain of dependent steps).  Four launches:
//
//   1. local:    one block per 32x32 tile of a frame; a union-find over the
//                tile's foreground in shared memory.  A warp labels each
//                row's runs by ballot (a cell's parent is its run's first
//                cell), then each run joins the runs above it that touch it
//                by atomicMin on parent indices, so a parent index is never
//                above its child's.  Each pixel's root is written as a frame
//                raster index into `par` (int32, the wrapper's scratch
//                plane), and v into `out`;
//   2. boundary: pixels on a tile edge join their neighbours in other
//                tiles, by the same atomicMin merge on `par` in device
//                memory (Playne & Hawick, IEEE TPDS 2018; Allegretti,
//                Bolelli & Grana, IEEE TPDS 2019);
//   3. flatten:  per tile, the cells are grouped by their tile-local
//                representative and v is reduced over each group in shared
//                memory; each group finds its root once, atomicMins its
//                minimum into the root's slot of `out` on the float bits as
//                int (non-negative floats order as their bits do), and
//                every cell's `par` is pointed at its root;
//   4. write:    out[p] = fg ? out[par[p]] : sentinel.  Only roots' slots
//                are read, and a root rewrites its own value.
//
// Planes that a kernel writes are read through plain or volatile pointers,
// never const __restrict__ ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;  // one warp ballot per tile row
static_assert(kTile == 32, "a tile row is one warp");
constexpr int kThreads = 256;

__device__ __forceinline__ int find_root(const volatile int* L, int a) {
  int p;
  while ((p = L[a]) != a) a = p;
  return a;
}

// Join the trees of a and b: the larger root is linked under the smaller
// by atomicMin.  If that root was linked elsewhere meanwhile, retry with
// its new parent.  Works on shared and on global memory.
__device__ __forceinline__ void merge(int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a > b) { const int t = a; a = b; b = t; }
    const int old = atomicMin(L + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kThreads)
local_kernel(const float* __restrict__ in_all, const uint8_t* __restrict__ fg_all,
             float* out_all, int* par_all, int H, int W, int tiles_x, int tiles) {
  __shared__ int L[kTile * kTile];
  __shared__ unsigned row_fg[kTile];
  __shared__ float win[(kTile + 2) * (kTile + 2)];  // the input, halo 1
  const int n = blockIdx.x / tiles, t = blockIdx.x - n * tiles;
  const int ty0 = (t / tiles_x) * kTile, tx0 = (t % tiles_x) * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t off = (size_t)n * H * W;
  const float* in = in_all + off;
  const uint8_t* fg = fg_all + off;
  float* out = out_all + off;
  int* par = par_all + off;

  // one warp per tile row (kTile == 32 lanes): each foreground cell points
  // at the first cell of its run, found by ballot
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int y = ty0 + r, x = tx0 + lane;
    const bool f = y < H && x < W && fg[y * W + x];
    const unsigned bits = __ballot_sync(0xffffffffu, f);
    const unsigned starts = bits & ~(bits << 1);
    if (lane == 0) row_fg[r] = bits;
    L[r * kTile + lane] = r * kTile + 31 - __clz(starts & ((2u << lane) - 1u));
  }
  // out-of-frame cells as +inf, which the min ignores
  for (int i = threadIdx.x; i < (kTile + 2) * (kTile + 2); i += kThreads) {
    const int y = ty0 - 1 + i / (kTile + 2), x = tx0 - 1 + i % (kTile + 2);
    win[i] = y >= 0 && y < H && x >= 0 && x < W ? in[y * W + x] : INFINITY;
  }
  __syncthreads();
  // join each cell to the rows above: up; else up-left and up-right.  A
  // join is skipped where the left neighbour's joins already cover it (the
  // two cells share a run, and so do the cells above them)
  for (int r = 1 + warp; r < kTile; r += kThreads / 32) {
    const unsigned bits = row_fg[r], above = row_fg[r - 1];
    if (!(bits >> lane & 1u)) continue;
    const int i = r * kTile + lane;
    const bool left = lane > 0 && (bits >> (lane - 1) & 1u);
    const bool up_left = lane > 0 && (above >> (lane - 1) & 1u);
    const bool up_right = lane < 31 && (above >> (lane + 1) & 1u);
    if (above >> lane & 1u) {
      if (!(left && up_left)) merge(L, i, i - kTile);
    } else {
      if (up_left && !left) merge(L, i, i - kTile - 1);
      if (up_right) merge(L, i, i - kTile + 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    if (!(row_fg[i / kTile] >> (i % kTile) & 1u)) continue;
    const int y = ty0 + i / kTile, x = tx0 + i % kTile;
    const int root = find_root(L, i);
    par[y * W + x] = (ty0 + root / kTile) * W + tx0 + root % kTile;
    const float* w = win + (i / kTile) * (kTile + 2) + i % kTile;
    float v = INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) v = fminf(v, w[dy * (kTile + 2) + dx]);
    out[y * W + x] = v;
  }
}

// Joins across tile edges, with the local phase's rule of skipping a join
// that another one already covers.  A cell on a tile's top row joins the
// row above as in the local phase (its left neighbour, in this tile or the
// next, handles its own joins the same way).  A cell on a tile's left
// column joins its left neighbour unless the cells above it and above-left
// of it are foreground (the cell above then joined that pair), and its
// up-left neighbour if neither its left nor its up neighbour is
// foreground.  A cell on a tile's right column joins its up-right
// neighbour if its up neighbour is not foreground.
__global__ void __launch_bounds__(kThreads)
boundary_kernel(const uint8_t* __restrict__ fg_all, int* par_all, int H, int W,
                long long total) {
  const long long P = (long long)H * W;
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x; g < total;
       g += (long long)gridDim.x * kThreads) {
    if (!fg_all[g]) continue;
    const long long n = g / P;
    const int p = (int)(g - n * P), y = p / W, x = p - y * W;
    const int ty = y % kTile, tx = x % kTile;
    const bool top = ty == 0 && y > 0, left_col = tx == 0 && x > 0;
    const bool right_col = tx == kTile - 1 && ty != 0 && x + 1 < W;
    if (!top && !left_col && !right_col) continue;
    const uint8_t* fg = fg_all + n * P;
    int* par = par_all + n * P;
    const bool left = x > 0 && fg[p - 1];
    const bool up = y > 0 && fg[p - W];
    const bool up_left = y > 0 && x > 0 && fg[p - W - 1];
    const bool up_right = y > 0 && x + 1 < W && fg[p - W + 1];
    if (top) {
      if (up) {
        if (!(left && up_left)) merge(par, p, p - W);
      } else {
        if (up_left && !left) merge(par, p, p - W - 1);
        if (up_right) merge(par, p, p - W + 1);
      }
    }
    if (left_col) {
      if (left && (ty == 0 || !(up && up_left))) merge(par, p, p - 1);
      if (ty != 0 && up_left && !left && !up) merge(par, p, p - W - 1);
    }
    if (right_col && up_right && !up) merge(par, p, p - W + 1);
  }
}

// Per tile: group its foreground cells by representative (the cell's
// parent when that lies in the tile, else the cell itself; after the
// boundary merges a non-root cell still points at its tile-local root),
// reduce v over each group in shared memory, find each representative's
// root once, atomicMin the group's minimum into the root's slot, and point
// every cell at its root.  One global find and one global atomic per group
// instead of per pixel: a giant component would otherwise queue all its
// pixels' atomics on one address.
__global__ void __launch_bounds__(kThreads)
flatten_kernel(const uint8_t* __restrict__ fg_all, float* out_all, int* par_all, int H,
               int W, int tiles_x, int tiles) {
  __shared__ int gmin[kTile * kTile];
  __shared__ int root_of[kTile * kTile];
  __shared__ short rep[kTile * kTile];
  const int n = blockIdx.x / tiles, t = blockIdx.x - n * tiles;
  const int ty0 = (t / tiles_x) * kTile, tx0 = (t % tiles_x) * kTile;
  const size_t off = (size_t)n * H * W;
  const uint8_t* fg = fg_all + off;
  int* key = reinterpret_cast<int*>(out_all + off);
  int* par = par_all + off;

  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    gmin[i] = 0x7fffffff;
    root_of[i] = -1;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int y = ty0 + i / kTile, x = tx0 + i % kTile;
    rep[i] = -1;
    if (y >= H || x >= W || !fg[y * W + x]) continue;
    const int q = par[y * W + x], qy = q / W, qx = q - qy * W;
    const bool inside = qy >= ty0 && qy < ty0 + kTile && qx >= tx0 && qx < tx0 + kTile;
    const int r = inside ? (qy - ty0) * kTile + qx - tx0 : i;
    rep[i] = (short)r;
    atomicMin(gmin + r, key[y * W + x]);
    root_of[r] = 0;  // marks r as a representative
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    if (root_of[i] < 0) continue;
    const int p = (ty0 + i / kTile) * W + tx0 + i % kTile;
    const int root = find_root(par, p);
    root_of[i] = root;
    atomicMin(key + root, gmin[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    if (rep[i] < 0) continue;
    par[(ty0 + i / kTile) * W + tx0 + i % kTile] = root_of[rep[i]];
  }
}

__global__ void __launch_bounds__(kThreads)
write_kernel(const uint8_t* __restrict__ fg_all, float* out_all, const int* par_all, int P,
             long long total, float sentinel) {
  for (long long g = blockIdx.x * (long long)kThreads + threadIdx.x; g < total;
       g += (long long)gridDim.x * kThreads) {
    const long long base = g - g % P;
    out_all[g] = fg_all[g] ? out_all[base + par_all[g]] : sentinel;
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream`: four kernels, or one copy when max_iters == 0.
// in, out and scratch are (N, H, W) f32 and must not alias; fg is
// (N, H, W) u8 (0/1); scratch serves as the int32 parent plane.  Values
// must lie in [0, sentinel].  Returns a cudaError_t (0 on success).
int swt_converge_frames(const void* in, const void* fg, void* out, void* scratch, int N,
                        int H, int W, int max_iters, float sentinel, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 24) || max_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)N * H * W;
  if (max_iters == 0) {
    return (int)cudaMemcpyAsync(out, in, total * sizeof(float), cudaMemcpyDeviceToDevice, s);
  }
  const int tiles_x = (W + kTile - 1) / kTile, tiles_y = (H + kTile - 1) / kTile;
  const long long tile_blocks = (long long)N * tiles_x * tiles_y;
  if (tile_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int px_blocks = (int)((total + kThreads - 1) / kThreads < 65536
                                  ? (total + kThreads - 1) / kThreads : 65536);
  const uint8_t* f = (const uint8_t*)fg;
  float* o = (float*)out;
  int* par = (int*)scratch;
  local_kernel<<<(unsigned)tile_blocks, kThreads, 0, s>>>(
      (const float*)in, f, o, par, H, W, tiles_x, tiles_x * tiles_y);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  boundary_kernel<<<px_blocks, kThreads, 0, s>>>(f, par, H, W, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flatten_kernel<<<(unsigned)tile_blocks, kThreads, 0, s>>>(f, o, par, H, W, tiles_x,
                                                             tiles_x * tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_kernel<<<px_blocks, kThreads, 0, s>>>(f, o, par, H * W, total, sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
