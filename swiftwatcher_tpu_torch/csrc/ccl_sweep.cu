// K5: a chunk of label-flood sweeps for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/ccl_sweep.py
// (sweep_chunk, body _make_kernel), f32 labels.  Per frame of an (N, H, W)
// f32 label batch with its bool foreground: `sweeps` Jacobi sweeps of
//
//   lbl = fg ? min over the 3x3 window of lbl (out-of-frame ignored) : s
//
// where s is the sentinel (H*W, the background label).  The slow path of
// label_components (ops/ccl.py) runs it in chunks of 4 sweeps between
// convergence checks, on label and on rank floods.
//
// What bounds it: one read of the labels and the mask and one write of the
// labels per chunk (bytes).  One block owns a 32x64 output tile and stages
// the tile plus a halo of `sweeps` pixels in shared memory, then sweeps
// there: after k sweeps every staged cell at least k cells inside the
// staged edge is exact (cells nearer the edge miss neighbours that were
// not staged), so the tile itself is exact after `sweeps` sweeps.
// Out-of-frame cells are staged as background (sentinel, fg 0), which is
// the same as ignoring them.  Min is exact, so the result is bit-equal to
// the plain version in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kMaxSweeps = 8;

__global__ void __launch_bounds__(kThreads)
sweep_chunk_kernel(const float* __restrict__ in, const uint8_t* __restrict__ fg,
                   float* __restrict__ out, int H, int W, int sweeps, float sentinel) {
  extern __shared__ float smem[];
  const int SH = kTileH + 2 * sweeps, SW = kTileW + 2 * sweeps, S = SH * SW;
  float* a = smem;
  float* b = smem + S;
  uint8_t* m = reinterpret_cast<uint8_t*>(smem + 2 * S);
  const size_t frame = (size_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * kTileH - sweeps, x0 = blockIdx.x * kTileW - sweeps;

  for (int i = threadIdx.x; i < S; i += kThreads) {
    const int gy = y0 + i / SW, gx = x0 + i % SW;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t g = frame + (size_t)gy * W + gx;
    m[i] = inside ? fg[g] : 0;
    a[i] = inside ? in[g] : sentinel;
  }
  __syncthreads();

  for (int s = 0; s < sweeps; ++s) {
    for (int i = threadIdx.x; i < S; i += kThreads) {
      float v = sentinel;
      if (m[i]) {
        const int sy = i / SW, sx = i - sy * SW;
        const int ya = max(sy - 1, 0), yb = min(sy + 1, SH - 1);
        const int xa = max(sx - 1, 0), xb = min(sx + 1, SW - 1);
        for (int yy = ya; yy <= yb; ++yy)
          for (int xx = xa; xx <= xb; ++xx) v = fminf(v, a[yy * SW + xx]);
      }
      b[i] = v;
    }
    __syncthreads();
    float* t = a; a = b; b = t;
  }

  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i - ty * kTileW;
    const int gy = blockIdx.y * kTileH + ty, gx = blockIdx.x * kTileW + tx;
    if (gy < H && gx < W) out[frame + (size_t)gy * W + gx] = a[(ty + sweeps) * SW + tx + sweeps];
  }
}

}  // namespace

extern "C" {

// Launches K5 on `stream`.  in and out are (N, H, W) f32 and must not
// alias; fg is (N, H, W) u8 (0/1).  1 <= sweeps <= 8, N <= 65535.
// Returns a cudaError_t (0 on success).
int swt_sweep_chunk(const void* in, const void* fg, void* out, int N, int H, int W,
                    int sweeps, float sentinel, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || N > 65535 || sweeps < 1 || sweeps > kMaxSweeps) {
    return (int)cudaErrorInvalidValue;
  }
  const int S = (kTileH + 2 * sweeps) * (kTileW + 2 * sweeps);
  const size_t shmem = (size_t)S * (2 * sizeof(float) + 1);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
  sweep_chunk_kernel<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)in, (const uint8_t*)fg, (float*)out, H, W, sweeps, sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
