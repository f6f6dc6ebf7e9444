// Latency micro-kernel for K7's bound (chip_smoke.py phase 19), not part
// of the solver: the least a step of K7 (csrc/refined_eigh.cu) costs.  One
// block of `threads` threads runs `steps` rounds of a shared load that
// depends on the last round's, a shared store to the other buffer and a
// barrier.  `zero` is 0 at run time, so the rounds cannot overlap.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024) rounds_kernel(int steps, int zero, int* out) {
  __shared__ int buf[2][1024];
  const int t = threadIdx.x;
  buf[0][t] = t;
  __syncthreads();
  int x = t;
  for (int s = 0; s < steps; ++s) {
    x = buf[s & 1][x] ^ zero;
    buf[(s + 1) & 1][t] = x;
    __syncthreads();
  }
  out[t] = x;
}

}  // namespace

// One launch of `steps` rounds in one block of `threads` (a multiple of 32,
// at most 1024) threads; out: `threads` int32s.
extern "C" int swt_k7_latency(int threads, int steps, int zero, void* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || steps < 0)
    return (int)cudaErrorInvalidValue;
  rounds_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(steps, zero, (int*)out);
  return (int)cudaGetLastError();
}
