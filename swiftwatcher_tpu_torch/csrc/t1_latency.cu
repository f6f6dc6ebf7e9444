// Latency micro-kernels for T1's bound (chip_smoke.py phase 11), not part
// of the tracker: one warp runs `steps` dependent steps of one of
//
//   0  T1b's (value, index) argmin (warp_argmin.cuh),
//   1  the same pair by a 5-step xor-butterfly over (value, index),
//   2  one shared-memory load and one ballot, the least a frame with work
//      costs T1b.
//
// `zero` is 0 at run time, so each step's input depends on the last step's
// result and the steps cannot overlap.

#include <cuda_runtime.h>

#include "warp_argmin.cuh"

namespace {

__device__ __forceinline__ void warp_argmin_butterfly(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFullWarp, v, off);
    const int i2 = __shfl_xor_sync(kFullWarp, i, off);
    if (v2 < v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
}

__global__ void __launch_bounds__(32) latency_kernel(int which, int steps, int zero, int* out) {
  __shared__ int table[256];
  const int lane = threadIdx.x;
  for (int q = lane; q < 256; q += 32) table[q] = (q * 37 + 11) & 255;
  __syncwarp();
  float v = (float)((lane * 7) & 31);
  int i = lane, x = lane;
  if (which == 2) {
    for (int s = 0; s < steps; ++s) {
      x = table[x & 255];
      x ^= (int)__ballot_sync(kFullWarp, (x >> (lane & 7)) & 1) & zero;
    }
  } else {
    for (int s = 0; s < steps; ++s) {
      float vv = __int_as_float(__float_as_int(v) + (i & zero));
      int ii = lane;
      if (which == 0)
        warp_argmin(vv, ii);
      else
        warp_argmin_butterfly(vv, ii);
      i = ii;
      x += ii;
    }
  }
  out[lane] = x + i;
}

}  // namespace

// One launch of `which`'s micro-kernel, one warp; out: 32 int32s.
extern "C" int swt_t1_latency(int which, int steps, int zero, int* out, cudaStream_t stream) {
  if (which < 0 || which > 2 || steps < 0) return (int)cudaErrorInvalidValue;
  latency_kernel<<<1, 32, 0, stream>>>(which, steps, zero, out);
  return (int)cudaGetLastError();
}
