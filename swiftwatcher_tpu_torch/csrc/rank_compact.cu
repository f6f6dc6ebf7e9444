// K2: fused connected-component labelling for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/rank_compact.py
// (label_rank_fused, body _make_fused_kernel).  Per frame of an (N, H, W)
// bool foreground batch:
//
//   seed labels with the raster index (background = sentinel H*W)
//   -> S Jacobi 3x3 min sweeps under fg
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
// What bounds it: memory traffic of the sweeps.  A frame's f32 label plane
// (373 KB at 216 x 432) does not fit a block's 227 KB of shared memory, so
// the TPU's whole-frame-in-VMEM design does not carry over.  One block of
// 1024 threads owns a frame and sweeps between two planes in device memory
// (mostly served from L2), with __syncthreads() between sweeps; Jacobi
// sweeps (each reads only the previous plane) make the flagged set equal
// the TPU kernel's.  Empty frames exit after one pass over the mask.
//
// Planes: `lbl` ends as the swept labels; `scratch` and `ranks` (used as
// f32 until the final pass writes int32 into it) carry the ping-pong.
//
// K4, the compaction half alone, replaces rank_seed_sweep (body
// _make_rank_kernel) in the same TPU file: per frame of converged f32
// labels, whose foreground is implicit (label < sentinel), rank the roots,
// seed the ranks and run S Jacobi sweeps, giving an f32 rank map
// (background = sentinel).  The slow path of label_components runs it.
// Same design and bound as K2: one block per frame, two planes in device
// memory.
//
// Planes that a kernel writes are read through plain pointers, never
// const __restrict__ ones, which would let the compiler read them through
// the non-coherent cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

// Foreground as a u8 mask (K2), or as `label < sentinel` of a converged
// label plane that the kernel does not write (K4).
struct MaskU8 {
  const uint8_t* m;
  __device__ __forceinline__ bool operator()(int p) const { return m[p] != 0; }
};
struct MaskBelow {
  const float* lbl;
  float sentinel;
  __device__ __forceinline__ bool operator()(int p) const { return lbl[p] < sentinel; }
};

// One Jacobi sweep src -> dst: dst = fg ? min over the 3x3 window of src
// (out-of-frame cells ignored) : sentinel.  Returns whether any pixel this
// thread owns changed (only meaningful when `probe`; then dst is unused).
template <class Mask>
__device__ __forceinline__ int sweep(const float* src, float* dst, Mask fg, int H, int W,
                                     float sentinel, bool probe) {
  int changed = 0;
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
    if (probe) {
      changed |= m != src[p];
    } else {
      dst[p] = m;
    }
  }
  return changed;
}

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

// Rank the roots (fg pixels whose label is their own raster index) in
// raster order, 1-based, and write dst = root ? rank : sentinel.  Each
// thread counts a contiguous chunk; a block scan gives its chunk's offset.
template <class Mask>
__device__ __forceinline__ void seed_ranks(const float* lbl, Mask fg, float* dst, int P,
                                           float sentinel, int* warp_sums) {
  const int chunk = (P + kThreads - 1) / kThreads;
  const int p0 = min(threadIdx.x * chunk, P), p1 = min(p0 + chunk, P);
  int roots = 0;
  for (int p = p0; p < p1; ++p) roots += fg(p) && lbl[p] == (float)p;
  int rank = block_exclusive_scan(roots, warp_sums);
  for (int p = p0; p < p1; ++p) {
    const bool root = fg(p) && lbl[p] == (float)p;
    rank += root;
    dst[p] = root ? (float)rank : sentinel;
  }
}

__global__ void __launch_bounds__(kThreads)
label_rank_kernel(const uint8_t* __restrict__ fg_all, float* __restrict__ lbl_all,
                  int32_t* __restrict__ ranks_all, float* __restrict__ scratch_all,
                  uint8_t* __restrict__ flag, int H, int W, int sweeps) {
  __shared__ int warp_sums[32];
  const int P = H * W;
  const float sentinel = (float)P;
  const size_t off = (size_t)blockIdx.x * P;
  const uint8_t* fg = fg_all + off;
  float* lbl = lbl_all + off;
  float* scr = scratch_all + off;
  float* rnk = reinterpret_cast<float*>(ranks_all + off);
  const MaskU8 mask{fg};

  // seed labels with the raster index; find empty frames
  int any = 0;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const int f = fg[p] != 0;
    lbl[p] = f ? (float)p : sentinel;
    any |= f;
  }
  if (!__syncthreads_or(any)) {
    for (int p = threadIdx.x; p < P; p += kThreads) ranks_all[off + p] = 0;
    if (threadIdx.x == 0) flag[blockIdx.x] = 0;
    return;
  }

  // label flood: lbl -> scr -> lbl ... (an odd count ends in scr; copy back)
  float* a = lbl;
  float* b = scr;
  for (int s = 0; s < sweeps; ++s) {
    sweep(a, b, mask, H, W, sentinel, false);
    __syncthreads();
    float* t = a; a = b; b = t;
  }
  if (a != lbl) {
    for (int p = threadIdx.x; p < P; p += kThreads) lbl[p] = a[p];
    __syncthreads();
  }
  const int changed = sweep(lbl, nullptr, mask, H, W, sentinel, true);
  const int flagged = __syncthreads_or(changed);
  if (threadIdx.x == 0) flag[blockIdx.x] = (uint8_t)flagged;

  seed_ranks(lbl, mask, scr, P, sentinel, warp_sums);
  __syncthreads();

  // rank flood: scr -> rnk -> scr ...
  a = scr;
  b = rnk;
  for (int s = 0; s < sweeps; ++s) {
    sweep(a, b, mask, H, W, sentinel, false);
    __syncthreads();
    float* t = a; a = b; b = t;
  }
  // compact labels; when the flood ended in the int32 plane itself, each
  // thread converts only the cells it reads, so no cell is read after
  // another thread wrote it
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float r = a[p];
    ranks_all[off + p] = fg[p] ? (int32_t)r : 0;
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
    sweep(a, b, mask, H, W, sentinel, false);
    __syncthreads();
    float* t = a; a = b; b = t;
  }
}

}  // namespace

extern "C" {

// Launches K2 on `stream`: one block per frame.  fg is (N, H, W) u8 (0/1);
// lbl f32, ranks int32 and scratch f32 are (N, H, W); flag is (N,) u8.
// Returns a cudaError_t (0 on success).
int swt_label_rank_fused(const void* fg, void* lbl, void* ranks, void* scratch,
                         void* flag, int N, int H, int W, int sweeps, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 24) || sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  label_rank_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)fg, (float*)lbl, (int32_t*)ranks, (float*)scratch,
      (uint8_t*)flag, H, W, sweeps);
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
