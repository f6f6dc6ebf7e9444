// K3: whole-frame label convergence for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/ccl_local.py
// (converge_frames, body _make_kernel).  Per frame of an (N, H, W) f32
// label batch with its bool foreground, until a super-sweep changes
// nothing or `max_iters` super-sweeps have run:
//
//   lbl = fg ? min over the 3x3 window of lbl (out-of-frame ignored) : s
//   -> segmented running min along each row, left to right, then right to
//      left, then along each column, top to bottom, then bottom to top;
//      a run is a stretch of foreground, and background cells keep s.
//
// A component converges in about as many super-sweeps as its geodesic has
// changes of direction, not in as many as it has pixels.  The slow path of
// label_components (ops/ccl.py) runs it on frames whose label or rank
// flood the 3x3 sweeps did not finish.
//
// What bounds it: latency.  A frame's f32 plane (373 KB at 216 x 432)
// does not fit a block's shared memory, so the TPU's whole-frame-in-VMEM
// design does not carry over.  One block of 1024 threads owns a frame and
// works on two planes in device memory (mostly served from L2), with
// __syncthreads() between steps: the 3x3 step is Jacobi (plane to plane),
// and each scan is sequential along its row or column, one thread per row
// or column, in place.  The TPU kernel scans by log-doubling; a running
// min gives the same values, since min is exact.  The frame stops at its
// own fixpoint, as on the TPU.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
converge_kernel(const float* __restrict__ in_all, const uint8_t* __restrict__ fg_all,
                float* out_all, float* scratch_all, int H, int W, int max_iters,
                float sentinel) {
  const int P = H * W;
  const size_t off = (size_t)blockIdx.x * P;
  const uint8_t* fg = fg_all + off;
  const float* src = in_all + off;
  float* out = out_all + off;
  float* scr = scratch_all + off;

  int changed = 1;
  for (int it = 0; changed && it < max_iters; ++it) {
    float* dst = src == out ? scr : out;
    // 3x3 min under fg, Jacobi
    for (int p = threadIdx.x; p < P; p += kThreads) {
      float v = sentinel;
      if (fg[p]) {
        const int y = p / W, x = p - y * W;
        const int ya = max(y - 1, 0), yb = min(y + 1, H - 1);
        const int xa = max(x - 1, 0), xb = min(x + 1, W - 1);
        for (int yy = ya; yy <= yb; ++yy)
          for (int xx = xa; xx <= xb; ++xx) v = fminf(v, src[yy * W + xx]);
      }
      dst[p] = v;
    }
    __syncthreads();
    // rows: forward then backward, one thread per row
    for (int y = threadIdx.x; y < H; y += kThreads) {
      float* row = dst + y * W;
      const uint8_t* f = fg + y * W;
      float run = sentinel;
      for (int x = 0; x < W; ++x) {
        run = f[x] ? fminf(run, row[x]) : sentinel;
        row[x] = run;
      }
      run = sentinel;
      for (int x = W - 1; x >= 0; --x) {
        run = f[x] ? fminf(run, row[x]) : sentinel;
        row[x] = run;
      }
    }
    __syncthreads();
    // columns: forward then backward, one thread per column
    for (int x = threadIdx.x; x < W; x += kThreads) {
      float run = sentinel;
      for (int y = 0; y < H; ++y) {
        const int p = y * W + x;
        run = fg[p] ? fminf(run, dst[p]) : sentinel;
        dst[p] = run;
      }
      run = sentinel;
      for (int y = H - 1; y >= 0; --y) {
        const int p = y * W + x;
        run = fg[p] ? fminf(run, dst[p]) : sentinel;
        dst[p] = run;
      }
    }
    __syncthreads();
    int diff = 0;
    for (int p = threadIdx.x; p < P; p += kThreads) diff |= dst[p] != src[p];
    changed = __syncthreads_or(diff);
    src = dst;
  }
  // the result must end in `out`
  if (src != out) {
    for (int p = threadIdx.x; p < P; p += kThreads) out[p] = src[p];
  }
}

}  // namespace

extern "C" {

// Launches K3 on `stream`: one block per frame.  in, out and scratch are
// (N, H, W) f32 and must not alias; fg is (N, H, W) u8 (0/1).  Returns a
// cudaError_t (0 on success).
int swt_converge_frames(const void* in, const void* fg, void* out, void* scratch, int N,
                        int H, int W, int max_iters, float sentinel, void* stream) {
  if (N <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 24) || max_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  converge_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (const uint8_t*)fg, (float*)out, (float*)scratch, H, W, max_iters,
      sentinel);
  return (int)cudaGetLastError();
}

}  // extern "C"
