// K5: a chunk of label-flood sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/ccl_sweep.py
// (sweep_chunk, body _make_kernel), f32 labels.  Per frame of an (N, H, W)
// f32 label batch with its bool foreground: `sweeps` Jacobi sweeps of
//
//   lbl = fg ? min over the 3x3 window of lbl (out-of-frame ignored) : s
//
// where s is the sentinel (the background label; labels are at most s),
// and a per-frame u8 "changed" flag: whether any output cell differs from
// its input cell.  The slow path of label_components (ops/ccl.py) runs it
// in chunks of 4 sweeps on label and on rank floods, reading the flag to
// stop, and as a 1-sweep convergence check after K3.
//
// What bounds it: bytes, one read of the labels and the mask and one write
// of the labels (9 bytes a pixel).  One launch; a block owns a 32x64 tile
// of a frame (tile_sweep.cuh):
//
//   * a tile without foreground of its own writes the sentinel, and sets
//     the flag if any of its input cells held something else; it never
//     stages the label plane;
//   * any other tile stages the labels with a halo of `sweeps` pixels and
//     sweeps there (separable row minima, strips without foreground
//     skipped, sweep k only on cells at least k inside the staged edge,
//     stop once a sweep changes nothing), so the tile itself is exact
//     after `sweeps` sweeps.  Where the input's background holds values
//     other than the sentinel, the first sweep reads them and the
//     background is reset to the sentinel before the second.  The block
//     writes its cells, compares each with its input and ORs a block vote
//     into the frame's flag.
//
// Min is exact, so the result is bit-equal to the plain version in any
// order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_sweep.cuh"

namespace {

constexpr int kMaxChunkSweeps = 8;

__global__ void __launch_bounds__(kTileThreads)
sweep_chunk_kernel(const float* __restrict__ in_all, const uint8_t* __restrict__ fg_all,
                   float* __restrict__ out_all, uint8_t* changed, int H, int W, int tiles_x,
                   int tiles, int sweeps, float sentinel) {
  extern __shared__ float smem[];
  const Tile t = tile_of_block(H, W, tiles_x, tiles);
  const size_t P = (size_t)H * W;
  const float* in = in_all + t.n * P;
  const uint8_t* fg = fg_all + t.n * P;
  float* out = out_all + t.n * P;
  int diff = 0;

  if (!tile_has_fg(FgPlane{fg}, W, t)) {
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
      const int p = (t.ty0 + i / t.tw) * W + t.tx0 + i % t.tw;
      diff |= in[p] != sentinel;
      out[p] = sentinel;
    }
  } else {
    const Staged st = staged_planes(smem, sweeps);
    const int h = st.h, SW = st.SW;
    const bool dirty = stage(FgPlane{fg}, SeedPlane{in}, st, H, W, t, sentinel);
    bool moving;
    const float* a = sweep_staged(st, sweeps, moving, dirty);
    for (int i = threadIdx.x; i < t.th * t.tw; i += kTileThreads) {
      const int r = i / t.tw, c = i % t.tw, p = (t.ty0 + r) * W + t.tx0 + c;
      const float v = a[(r + h) * SW + c + h];
      diff |= v != in[p];
      out[p] = v;
    }
  }
  if (__syncthreads_or(diff) && threadIdx.x == 0) changed[t.n] = 1;
}

}  // namespace

extern "C" {

// Launches K5 on `stream`: a flag reset and one kernel.  in and out are
// (N, H, W) f32 and must not alias; fg is (N, H, W) u8 (0/1); changed is
// (N,) u8.  1 <= sweeps <= 8.  Returns a cudaError_t (0 on success).
int swt_sweep_chunk(const void* in, const void* fg, void* out, void* changed, int N, int H,
                    int W, int sweeps, float sentinel, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || sweeps < 1 || sweeps > kMaxChunkSweeps) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)N * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t err = tile_smem(sweep_chunk_kernel, sweeps, &smem);
  if (err == cudaSuccess) err = cudaMemsetAsync(changed, 0, N, s);
  if (err != cudaSuccess) return (int)err;
  sweep_chunk_kernel<<<(unsigned)blocks, kTileThreads, smem, s>>>(
      (const float*)in, (const uint8_t*)fg, (float*)out, (uint8_t*)changed, H, W, tiles_x,
      tiles_x * tiles_y, sweeps, sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
