// K2: fused connected-component labelling for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/rank_compact.py
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
// What bounds it: bytes (the outputs, 9 bytes a pixel) on sparse frames,
// shared-memory traffic of the sweeps on dense ones.  A frame's f32 plane
// (373 KB at 216 x 432) does not fit a block, so the design is temporal
// blocking over tiles, in three launches:
//
//   1. labels: one block per 32x64 tile of a frame stages the foreground
//      with a halo of S + 1 pixels (out-of-frame cells as background,
//      which equals ignoring them), seeds the raster index and sweeps in
//      shared memory.  Each sweep's dependency cone grows by one pixel, so
//      after s <= S + 1 sweeps every cell at least s inside the staged
//      edge equals the whole-frame result: the tile's swept labels after S
//      sweeps, and the probe after S + 1.  Sweep s computes only those
//      cells, and the block stops early once a sweep changes none of them
//      (later sweeps, the probe included, would change nothing).  It
//      writes the swept labels, ORs its probe into the frame's flag, and
//      records the roots of each (row, 32-column segment) by a warp
//      ballot: their count and their bits.
//   2. scan: one block per frame turns the counts into exclusive raster
//      offsets, in row-major order of (row, segment).
//   3. ranks: a root's rank is its segment's offset plus the roots before
//      it in the segment (a popcount of the segment's root bits).  On an
//      unflagged frame every swept label is its component's root, and the
//      rank flood from the same unique roots reaches every pixel within
//      the same S sweeps, so a block gathers each pixel's root rank
//      directly.  On a flagged frame one block per tile stages the
//      foreground with a halo of S, seeds the staged roots' ranks, sweeps
//      S times in shared memory (stopping early the same way), and writes
//      the compact labels.
//
// Sweeps skip background cells, which hold the sentinel in both staged
// planes.  A tile without foreground of its own writes the sentinel and 0
// and exits without staging.  Min is exact, so every output is bit-equal to
// the plain whole-frame version.
//
// K4, the compaction half alone, replaces rank_seed_sweep (body
// _make_rank_kernel) in the same TPU file: per frame of converged f32
// labels, whose foreground is implicit (label < sentinel), rank the roots,
// seed the ranks and run S Jacobi sweeps, giving an f32 rank map
// (background = sentinel).  The slow path of label_components runs it.
// One block of 1024 threads per frame, sweeping between two planes in
// device memory.
//
// Planes that a kernel writes are read through plain pointers, never
// const __restrict__ ones, which would let the compiler read them through
// the non-coherent cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- K2: tiled sweeps in shared memory ----------------------------------

constexpr int kTileH = 32;
constexpr int kTileW = 64;       // a multiple of kSeg
constexpr int kSeg = 32;         // columns per root count: one warp ballot
constexpr int kTileThreads = 256;
constexpr int kStrip = 8;        // rows a thread sweeps down one column
constexpr int kMaxSweeps = 32;

// The staged planes of a tile with halo h: two f32 planes a, b of
// (SH, SW) cells, the u8 foreground m, and per (strip of kStrip rows,
// column) a bit mask of the strip's foreground rows.
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

// One Jacobi sweep a -> b of the staged cells in rows [ry0, ry1) x
// columns [rx0, rx1): b = m ? min over the 3x3 window of a (cells outside
// the staged region ignored) : sentinel.  Background cells hold the
// sentinel in both planes from staging on, so only foreground cells are
// computed.  A thread walks one column of a strip of kStrip rows, reusing
// row minima, and skips a strip without foreground.  Returns whether any
// computed cell changed.
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

// Whether the tile itself (not its halo) holds foreground.
__device__ __forceinline__ bool tile_has_fg(const uint8_t* fg, int W, const Tile& t) {
  int any = 0;
  for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads)
    any |= fg[(t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw];
  return __syncthreads_or(any);
}

// Stage the tile plus its halo: m = fg (0 outside the frame), both planes
// = fg ? raster index : sentinel when `seed_index`, else the sentinel
// everywhere; then the strip masks.  Ends with a barrier.
__device__ __forceinline__ void stage(const uint8_t* fg, const Staged& st, int H, int W,
                                      const Tile& t, float sentinel, bool seed_index) {
  const int y0 = t.ty0 - st.h, x0 = t.tx0 - st.h, SW = st.SW;
  for (int i = threadIdx.x; i < st.SH * SW; i += kTileThreads) {
    const int gy = y0 + i / SW, gx = x0 + i % SW;
    const bool f = gy >= 0 && gy < H && gx >= 0 && gx < W && fg[gy * W + gx];
    st.m[i] = f;
    st.a[i] = st.b[i] = f && seed_index ? (float)(gy * W + gx) : sentinel;
  }
  __syncthreads();
  for (int w = threadIdx.x; w < st.strips * SW; w += kTileThreads) {
    const int sx = w % SW, sy0 = (w / SW) * kStrip, sy1 = min(sy0 + kStrip, st.SH);
    unsigned rows = 0;
    for (int y = sy0; y < sy1; ++y) rows |= (unsigned)st.m[y * SW + sx] << (y - sy0);
    st.strip_fg[w] = (uint8_t)rows;
  }
  __syncthreads();
}

// Up to `sweeps` staged sweeps a <-> b; returns the plane holding the
// result and sets `moving` to whether the last sweep run changed anything
// (true when sweeps == 0).  Sweep k (from 1) computes only the cells at
// least k inside the staged edge, the only ones still exact, which are all
// that later sweeps read.  It stops once a sweep changes nothing: each
// later sweep would read the same values and change nothing either.
__device__ __forceinline__ float* sweep_staged(const Staged& st, int sweeps, bool& moving) {
  float* a = st.a;
  float* b = st.b;
  moving = true;
  for (int k = 1; k <= sweeps && moving; ++k) {
    moving = __syncthreads_or(stage_sweep(st, a, b, k, st.SH - k, k, st.SW - k));
    float* t = a; a = b; b = t;
  }
  return a;
}

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

  if (!tile_has_fg(fg, W, t)) {
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
  stage(fg, st, H, W, t, sentinel, true);
  bool moving;
  const float* a = sweep_staged(st, sweeps, moving);
  const uint8_t* m = st.m;
  if (moving) {
    // the probe, on the tile's own cells
    float* b = a == st.a ? st.b : st.a;
    const int c = stage_sweep(st, a, b, h, h + t.th, h, h + t.tw);
    if (__syncthreads_or(c) && threadIdx.x == 0) flag[t.n] = 1;
  }

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

// ---- block-wide helpers (K2's scan, K4) ---------------------------------

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

// The rank of the root at frame column x of row y (1-based, raster order):
// its segment's offset plus the roots of the segment up to x.
__device__ __forceinline__ int root_rank(const int* off, const unsigned* root_bits, int nseg,
                                         int y, int x) {
  const int k = y * nseg + x / kSeg;
  return off[k] + __popc(root_bits[k] & ((2u << (x % kSeg)) - 1u));
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
  if (!tile_has_fg(fg, W, t)) {
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads)
      labels[(t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw] = 0;
    return;
  }

  // flagged frame: the rank flood itself, from the staged roots
  const Staged st = staged_planes(smem, sweeps);
  const int h = st.h, SW = st.SW;
  stage(fg, st, H, W, t, sentinel, false);
  const int y0 = t.ty0 - h, x0 = t.tx0 - h;
  for (int i = threadIdx.x; i < st.SH * SW; i += kTileThreads) {
    const int gy = y0 + i / SW, gx = x0 + i % SW;
    if (st.m[i] && root_bits[gy * nseg + gx / kSeg] >> (gx % kSeg) & 1u)
      st.a[i] = (float)root_rank(off, root_bits, nseg, gy, gx);
  }
  __syncthreads();
  bool moving;
  const float* a = sweep_staged(st, sweeps, moving);
  for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
    const int r = i / t.tw, c = i % t.tw;
    const int s = (r + h) * SW + c + h;
    labels[(t.ty0 + r) * W + t.tx0 + c] = st.m[s] ? (int32_t)a[s] : 0;
  }
}

// ---- K4: one block per frame, planes in device memory --------------------

// Foreground of a converged label plane that the kernel does not write.
struct MaskBelow {
  const float* lbl;
  float sentinel;
  __device__ __forceinline__ bool operator()(int p) const { return lbl[p] < sentinel; }
};

// One Jacobi sweep src -> dst: dst = fg ? min over the 3x3 window of src
// (out-of-frame cells ignored) : sentinel.
template <class Mask>
__device__ __forceinline__ void sweep(const float* src, float* dst, Mask fg, int H, int W,
                                      float sentinel) {
  const int P = H * W;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int y = p / W, x = p - y * W;
    float m = sentinel;
    if (fg(p)) {
      const int y0 = max(y - 1, 0), y1 = min(y + 1, H - 1);
      const int x0 = max(x - 1, 0), x1 = min(x + 1, W - 1);
      for (int yy = y0; yy <= y1; ++yy) {
        const float* row = src + yy * W;
        for (int xx = x0; xx <= x1; ++xx) m = fminf(m, row[xx]);
      }
    }
    dst[p] = m;
  }
}

// Rank the roots (fg pixels whose label is their own raster index) in
// raster order, 1-based, and write dst = root ? rank : sentinel.  Each
// thread counts a contiguous chunk; a block scan gives its chunk's offset.
template <class Mask>
__device__ __forceinline__ void seed_ranks(const float* lbl, Mask fg, float* dst, int P,
                                           float sentinel, int* warp_sums) {
  const int chunk = (P + kThreads - 1) / kThreads;
  const int p0 = min((int)threadIdx.x * chunk, P), p1 = min(p0 + chunk, P);
  int roots = 0;
  for (int p = p0; p < p1; ++p) roots += fg(p) && lbl[p] == (float)p;
  int rank = block_exclusive_scan(roots, warp_sums);
  for (int p = p0; p < p1; ++p) {
    const bool root = fg(p) && lbl[p] == (float)p;
    rank += root;
    dst[p] = root ? (float)rank : sentinel;
  }
}

// K4: converged labels -> seeded ranks -> `sweeps` Jacobi sweeps, ending
// in `out` (the seed goes to the plane that makes an even or odd count of
// sweeps end there).
__global__ void __launch_bounds__(kThreads)
rank_seed_kernel(const float* __restrict__ lbl_all, float* out_all, float* scratch_all,
                 int H, int W, int sweeps) {
  __shared__ int warp_sums[32];
  const int P = H * W;
  const float sentinel = (float)P;
  const size_t off = (size_t)blockIdx.x * P;
  const float* lbl = lbl_all + off;
  const MaskBelow mask{lbl, sentinel};
  float* a = (sweeps % 2 == 0 ? out_all : scratch_all) + off;
  float* b = (sweeps % 2 == 0 ? scratch_all : out_all) + off;
  seed_ranks(lbl, mask, a, P, sentinel, warp_sums);
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
    sweep(a, b, mask, H, W, sentinel);
    __syncthreads();
    float* t = a; a = b; b = t;
  }
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

// Launches K4 on `stream`: one block per frame.  lbl (converged labels,
// background = H*W), out and scratch are (N, H, W) f32 and must not alias.
// Returns a cudaError_t (0 on success).
int swt_rank_seed_sweep(const void* lbl, void* out, void* scratch, int N, int H, int W,
                        int sweeps, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 24) || sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  rank_seed_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)lbl, (float*)out, (float*)scratch, H, W, sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
