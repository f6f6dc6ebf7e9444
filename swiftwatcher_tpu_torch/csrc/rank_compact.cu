// K2 and K4: connected-component labelling and rank compaction for Hopper
// (sm_90a).
//
// K2 replaces the TPU kernel swiftwatcher_tpu/ops/pallas/rank_compact.py
// (label_rank_fused, body _make_fused_kernel).  Per frame of an (N, H, W)
// bool foreground batch:
//
//   seed labels with the raster index (background = sentinel H*W)
//   -> S Jacobi 3x3 min sweeps under fg (out-of-frame cells ignored)
//   -> one probe sweep: the frame is flagged unless it changes nothing
//   -> rank the roots (fg pixels whose label is their own index) by a
//      raster-order prefix count
//   -> seed the ranks, S Jacobi sweeps -> compact labels 1..n (bg 0).
//
// Outputs: swept f32 labels, compact int32 labels, and a per-frame u8
// "not converged" flag (the TPU kernel encodes it as -(v+1) at [0, 0]).
// The probe certifies the label fixpoint: the sweep is monotone, so a
// sweep that changes nothing proves every pixel holds its component's
// root, and the rank flood (same propagation from the same unique roots)
// has then converged too.  A flagged frame's compact labels are not used
// by the caller, which recomputes it on the slow path.
//
// K4 replaces rank_seed_sweep (body _make_rank_kernel) in the same TPU
// file: the compaction half alone, for the slow path.  Per frame of
// converged f32 labels, whose foreground is implicit (label < sentinel):
// rank the roots, seed the ranks and run exactly S Jacobi sweeps, giving an
// f32 rank map (background = sentinel), plus a per-frame u8 "unsettled"
// flag: whether one more sweep would change the map.  The S sweeps are
// run, not replaced by a gather of each pixel's root rank: on a component
// deeper than S that gather gives the fixpoint, not the TPU kernel's map.
//
// What bounds both: bytes (K2's outputs, 9 bytes a pixel; K4's 4-byte
// input and output) on sparse frames, shared-memory traffic of the sweeps
// on dense ones.  A frame's f32 plane (373 KB at 216 x 432) does not fit a
// block, so the sweeps run on tiles in shared memory (tile_sweep.cuh):
// a 32x64 tile staged with a halo, sweep k only on the cells still exact,
// early stop, background skipped.  Ranks come from root counts per (row,
// 32-column segment), recorded by warp ballot with the root bits, and a
// per-frame scan of the counts; a root's rank is its segment's offset plus
// a popcount.  K2 is three launches:
//
//   1. labels: per tile, stage the foreground with a halo of S + 1 seeded
//      with the raster index, sweep S times, write the swept labels, run
//      the probe on the tile's own cells (exact with that halo) and OR it
//      into the frame's flag, and record the roots;
//   2. scan: one block per frame turns the counts into exclusive raster
//      offsets, in row-major order of (row, segment);
//   3. ranks: on an unflagged frame every swept label is its component's
//      root, and the rank flood from the same unique roots reaches every
//      pixel within the same S sweeps, so a block gathers each pixel's
//      root rank directly.  On a flagged frame a block stages the
//      foreground with a halo of S, seeds the staged roots' ranks, sweeps
//      S times and writes the compact labels.
//
// K4 is three launches of the same shape:
//
//   1. roots: per tile, the roots of each (row, segment) by ballot straight
//      from the label plane (a label equal to its raster index is below
//      the sentinel, so the cell is foreground); tile 0 clears the flag;
//   2. the same scan;
//   3. ranks: per tile, stage the foreground (label < sentinel) with a halo
//      of S + 1, seed the staged roots' ranks, sweep S times, write the
//      rank map, and run the probe on the tile's own cells into the flag.
//
// A tile without foreground of its own writes its background outputs and
// exits without staging.  Min is exact, so every output is bit-equal to the
// plain whole-frame version.
//
// Planes that a kernel writes are read through plain pointers, never
// const __restrict__ ones, which would let the compiler read them through
// the non-coherent cache.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_sweep.cuh"

namespace {

constexpr int kMaxSweeps = 32;

// The probe: one more sweep of the result plane a on the tile's own cells,
// exact when the halo is one more than the sweeps run; sets the frame's
// flag if it changes any.
__device__ __forceinline__ void probe(const Staged& st, const float* a, const Tile& t,
                                      uint8_t* flag) {
  float* b = a == st.a ? st.b : st.a;
  const int h = st.h;
  if (__syncthreads_or(stage_sweep(st, a, b, h, h + t.th, h, h + t.tw)) && threadIdx.x == 0)
    flag[t.n] = 1;
}

// ---- K2 launch 1: labels per tile ---------------------------------------

__global__ void __launch_bounds__(kTileThreads)
label_tiles_kernel(const uint8_t* __restrict__ fg_all, float* __restrict__ lbl_all,
                   int* __restrict__ cnt_all, unsigned* __restrict__ bits_all, uint8_t* flag,
                   int H, int W, int tiles_x, int tiles, int sweeps) {
  extern __shared__ float smem[];
  const Tile t = tile_of_block(H, W, tiles_x, tiles);
  const int P = H * W, nseg = (W + kSeg - 1) / kSeg;
  const float sentinel = (float)P;
  const uint8_t* fg = fg_all + (size_t)t.n * P;
  float* lbl = lbl_all + (size_t)t.n * P;
  int* cnt = cnt_all + (size_t)t.n * H * nseg;
  unsigned* root_bits = bits_all + (size_t)t.n * H * nseg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = (t.tw + kSeg - 1) / kSeg;

  if (!tile_has_fg(FgPlane{fg}, W, t)) {
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads)
      lbl[(t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw] = sentinel;
    for (int i = threadIdx.x; i < t.th * segs; i += kTileThreads) {
      const int k = (t.ty0 + i / segs) * nseg + t.tx0 / kSeg + i % segs;
      cnt[k] = 0;
      root_bits[k] = 0;
    }
    return;
  }

  const Staged st = staged_planes(smem, sweeps + 1);
  const int h = st.h, SW = st.SW;
  stage(FgPlane{fg}, SeedIndex{sentinel}, st, H, W, t, sentinel);
  bool moving;
  const float* a = sweep_staged(st, sweeps, moving);
  const uint8_t* m = st.m;
  if (moving) probe(st, a, t, flag);

  for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
    const int r = i / t.tw, c = i % t.tw;
    lbl[(t.ty0 + r) * W + t.tx0 + c] = a[(r + h) * SW + c + h];
  }
  // roots per (row, segment), as a count and as a bit per column; the
  // branch is uniform over the warp
  for (int k = warp; k < t.th * segs; k += kTileThreads / 32) {
    const int r = k / segs, sg = k % segs;
    const int c = sg * kSeg + lane, gy = t.ty0 + r;
    const float v = a[(r + h) * SW + c + h];
    const bool root = c < t.tw && m[(r + h) * SW + c + h] && v == (float)(gy * W + t.tx0 + c);
    const unsigned bits = __ballot_sync(0xffffffffu, root);
    if (lane == 0) {
      cnt[gy * nseg + t.tx0 / kSeg + sg] = __popc(bits);
      root_bits[gy * nseg + t.tx0 / kSeg + sg] = bits;
    }
  }
}

// ---- the scan (K2 and K4 launch 2) --------------------------------------

constexpr int kThreads = 1024;

// Block-wide exclusive prefix sum of one int per thread.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += n;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += n;
    }
    warp_sums[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  const int warp_off = warp ? warp_sums[warp - 1] : 0;
  return warp_off + inc - v;
}

// Per frame: the (H, nseg) root counts -> exclusive raster offsets, in
// place.  Each thread scans a contiguous chunk.
__global__ void __launch_bounds__(kThreads) scan_counts_kernel(int* cnt_all, int L) {
  __shared__ int warp_sums[32];
  int* c = cnt_all + (size_t)blockIdx.x * L;
  const int chunk = (L + kThreads - 1) / kThreads;
  const int p0 = min((int)threadIdx.x * chunk, L), p1 = min(p0 + chunk, L);
  int sum = 0;
  for (int p = p0; p < p1; ++p) sum += c[p];
  int run = block_exclusive_scan(sum, warp_sums);
  for (int p = p0; p < p1; ++p) {
    const int v = c[p];
    c[p] = run;
    run += v;
  }
}

// ---- the rank flood (K2 and K4 launch 3) --------------------------------

// The rank of the root at frame column x of row y (1-based, raster order):
// its segment's offset plus the roots of the segment up to x.
__device__ __forceinline__ int root_rank(const int* off, const unsigned* root_bits, int nseg,
                                         int y, int x) {
  const int k = y * nseg + x / kSeg;
  return off[k] + __popc(root_bits[k] & ((2u << (x % kSeg)) - 1u));
}

// Stage the tile's foreground into st, seed the staged roots with their
// ranks (every other cell: sentinel) and sweep `sweeps` times; returns the
// result plane (see sweep_staged).
template <class Fg>
__device__ __forceinline__ const float* flood_ranks(Fg fg, const Staged& st, int H, int W,
                                                    const Tile& t, float sentinel,
                                                    const int* off, const unsigned* root_bits,
                                                    int nseg, int sweeps, bool& moving) {
  stage(fg, SeedSentinel{sentinel}, st, H, W, t, sentinel);
  const int y0 = t.ty0 - st.h, x0 = t.tx0 - st.h;
  for_each_cell(st.SH, st.SW, [&](int r, int c) {
    const int i = r * st.SW + c, gy = y0 + r, gx = x0 + c;
    if (st.m[i] && root_bits[gy * nseg + gx / kSeg] >> (gx % kSeg) & 1u)
      st.a[i] = (float)root_rank(off, root_bits, nseg, gy, gx);
  });
  __syncthreads();
  return sweep_staged(st, sweeps, moving);
}

__global__ void __launch_bounds__(kTileThreads)
rank_tiles_kernel(const uint8_t* __restrict__ fg_all, const float* __restrict__ lbl_all,
                  const int* __restrict__ off_all, const unsigned* __restrict__ bits_all,
                  const uint8_t* __restrict__ flag, int32_t* __restrict__ labels_all, int H,
                  int W, int tiles_x, int tiles, int sweeps) {
  extern __shared__ float smem[];
  const Tile t = tile_of_block(H, W, tiles_x, tiles);
  const int P = H * W, nseg = (W + kSeg - 1) / kSeg;
  const float sentinel = (float)P;
  const uint8_t* fg = fg_all + (size_t)t.n * P;
  const float* lbl = lbl_all + (size_t)t.n * P;
  const int* off = off_all + (size_t)t.n * H * nseg;
  const unsigned* root_bits = bits_all + (size_t)t.n * H * nseg;
  int32_t* labels = labels_all + (size_t)t.n * P;

  if (!flag[t.n]) {
    // converged frame: every pixel's swept label is its root, which the
    // rank flood reaches within the same sweeps, so the flood's result is
    // the root's rank, gathered here
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
      const int p = (t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw;
      int rank = 0;
      if (fg[p]) {
        const int r = (int)lbl[p];
        rank = root_rank(off, root_bits, nseg, r / W, r % W);
      }
      labels[p] = rank;
    }
    return;
  }
  if (!tile_has_fg(FgPlane{fg}, W, t)) {
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads)
      labels[(t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw] = 0;
    return;
  }

  // flagged frame: the rank flood itself, from the staged roots
  const Staged st = staged_planes(smem, sweeps);
  const int h = st.h, SW = st.SW;
  bool moving;
  const float* a = flood_ranks(FgPlane{fg}, st, H, W, t, sentinel, off, root_bits, nseg, sweeps,
                               moving);
  for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
    const int r = i / t.tw, c = i % t.tw;
    const int s = (r + h) * SW + c + h;
    labels[(t.ty0 + r) * W + t.tx0 + c] = st.m[s] ? (int32_t)a[s] : 0;
  }
}

// ---- K4 launches 1 and 3 ------------------------------------------------

__global__ void __launch_bounds__(kTileThreads)
rank_roots_kernel(const float* __restrict__ lbl_all, int* __restrict__ cnt_all,
                  unsigned* __restrict__ bits_all, uint8_t* __restrict__ flag, int H, int W,
                  int tiles_x, int tiles) {
  const Tile t = tile_of_block(H, W, tiles_x, tiles);
  const int P = H * W, nseg = (W + kSeg - 1) / kSeg;
  const float* lbl = lbl_all + (size_t)t.n * P;
  int* cnt = cnt_all + (size_t)t.n * H * nseg;
  unsigned* root_bits = bits_all + (size_t)t.n * H * nseg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = (t.tw + kSeg - 1) / kSeg;
  if (blockIdx.x == t.n * tiles && threadIdx.x == 0) flag[t.n] = 0;
  // roots per (row, segment) by ballot, as in label_tiles_kernel; a tile
  // without foreground records none
  for (int k = warp; k < t.th * segs; k += kTileThreads / 32) {
    const int r = k / segs, sg = k % segs;
    const int c = sg * kSeg + lane, p = (t.ty0 + r) * W + t.tx0 + c;
    const unsigned bits = __ballot_sync(0xffffffffu, c < t.tw && lbl[p] == (float)p);
    if (lane == 0) {
      cnt[(t.ty0 + r) * nseg + t.tx0 / kSeg + sg] = __popc(bits);
      root_bits[(t.ty0 + r) * nseg + t.tx0 / kSeg + sg] = bits;
    }
  }
}

__global__ void __launch_bounds__(kTileThreads)
rank_sweep_kernel(const float* __restrict__ lbl_all, const int* __restrict__ off_all,
                  const unsigned* __restrict__ bits_all, float* __restrict__ out_all,
                  uint8_t* flag, int H, int W, int tiles_x, int tiles, int sweeps) {
  extern __shared__ float smem[];
  const Tile t = tile_of_block(H, W, tiles_x, tiles);
  const int P = H * W, nseg = (W + kSeg - 1) / kSeg;
  const float sentinel = (float)P;
  const FgBelow fg{lbl_all + (size_t)t.n * P, sentinel};
  float* out = out_all + (size_t)t.n * P;

  if (!tile_has_fg(fg, W, t)) {
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads)
      out[(t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw] = sentinel;
    return;
  }
  const Staged st = staged_planes(smem, sweeps + 1);
  const int h = st.h, SW = st.SW;
  bool moving;
  const float* a = flood_ranks(fg, st, H, W, t, sentinel, off_all + (size_t)t.n * H * nseg,
                               bits_all + (size_t)t.n * H * nseg, nseg, sweeps, moving);
  for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
    const int r = i / t.tw, c = i % t.tw;
    out[(t.ty0 + r) * W + t.tx0 + c] = a[(r + h) * SW + c + h];
  }
  if (moving) probe(st, a, t, flag);
}

}  // namespace

extern "C" {

// Launches K2 on `stream`: a flag reset and three kernels.  fg is
// (N, H, W) u8 (0/1); lbl f32 and ranks int32 are (N, H, W); counts is
// int32 with room for 2 * N * H * ceil(W / 32) (the root counts, then the
// root bits); flag is (N,) u8.
// 0 <= sweeps <= 32.  Returns a cudaError_t (0 on success).
int swt_label_rank_fused(const void* fg, void* lbl, void* ranks, void* counts, void* flag,
                         int N, int H, int W, int sweeps, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 24) || sweeps < 0 ||
      sweeps > kMaxSweeps) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)N * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nseg = (W + kSeg - 1) / kSeg;
  size_t smem_label, smem_rank;
  cudaError_t err = tile_smem(label_tiles_kernel, sweeps + 1, &smem_label);
  if (err == cudaSuccess) err = tile_smem(rank_tiles_kernel, sweeps, &smem_rank);
  if (err == cudaSuccess) err = cudaMemsetAsync(flag, 0, N, s);
  if (err != cudaSuccess) return (int)err;
  int* cnt = (int*)counts;
  unsigned* root_bits = (unsigned*)(cnt + (size_t)N * H * nseg);
  label_tiles_kernel<<<(unsigned)blocks, kTileThreads, smem_label, s>>>(
      (const uint8_t*)fg, (float*)lbl, cnt, root_bits, (uint8_t*)flag, H, W, tiles_x,
      tiles_x * tiles_y, sweeps);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_counts_kernel<<<N, kThreads, 0, s>>>(cnt, H * nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_tiles_kernel<<<(unsigned)blocks, kTileThreads, smem_rank, s>>>(
      (const uint8_t*)fg, (const float*)lbl, cnt, root_bits, (const uint8_t*)flag,
      (int32_t*)ranks, H, W, tiles_x, tiles_x * tiles_y, sweeps);
  return (int)cudaGetLastError();
}

// Launches K4 on `stream`: three kernels.  lbl (converged labels,
// background = H*W) and out are (N, H, W) f32 and must not alias; counts
// is int32 with room for 2 * N * H * ceil(W / 32); flag is (N,) u8.
// 0 <= sweeps <= 32.  Returns a cudaError_t (0 on success).
int swt_rank_seed_sweep(const void* lbl, void* out, void* counts, void* flag, int N, int H,
                        int W, int sweeps, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 24) || sweeps < 0 ||
      sweeps > kMaxSweeps) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)N * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nseg = (W + kSeg - 1) / kSeg;
  size_t smem;
  cudaError_t err = tile_smem(rank_sweep_kernel, sweeps + 1, &smem);
  if (err != cudaSuccess) return (int)err;
  int* cnt = (int*)counts;
  unsigned* root_bits = (unsigned*)(cnt + (size_t)N * H * nseg);
  rank_roots_kernel<<<(unsigned)blocks, kTileThreads, 0, s>>>(
      (const float*)lbl, cnt, root_bits, (uint8_t*)flag, H, W, tiles_x, tiles_x * tiles_y);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_counts_kernel<<<N, kThreads, 0, s>>>(cnt, H * nseg);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rank_sweep_kernel<<<(unsigned)blocks, kTileThreads, smem, s>>>(
      (const float*)lbl, cnt, root_bits, (float*)out, (uint8_t*)flag, H, W, tiles_x,
      tiles_x * tiles_y, sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
