// K1: fused motion post-filter for Hopper (sm_90a).
//
// Replaces the TPU kernel swiftwatcher_tpu/ops/pallas/fused_motion.py
// (fused_motion_filter, body _make_kernel).  Per frame, u8 in and u8 out:
//
//   circular 7x7 bilateral (sigma_color 15, sigma_space 1) on a
//   BORDER_REFLECT_101 pad -> threshold-to-zero -> 3x3 erosion -> 3x3
//   dilation, the last two replicating the edges of the thresholded and
//   eroded planes at the frame border.
//
// What bounds it: the 29-tap exp loop (ALU) on tiles that hold motion, and
// one read plus one write of the u8 frame (bytes) everywhere else.  The
// design keeps every intermediate out of device memory: one block owns a
// 32x64 output tile and stages the input tile plus a halo of
// radius + 2 pixels (bilateral reach + erosion + dilation) in shared
// memory, computes bilateral + threshold on the tile +-2, erosion on the
// tile +-1 and dilation on the tile.  A tile whose staged input is all at
// or below the threshold writes zeros without computing anything: the
// bilateral is a weighted mean, so it cannot exceed the staged maximum,
// threshold-to-zero then kills every pixel, and the opening of a zero
// plane is zero (the same argument as the TPU kernel's row-chunk skip).
//
// Bit-equality with the plain PyTorch chain on the card needs the same
// float operations in the same order: taps accumulate in the order of
// _bilateral_offsets, w = sw * expf((d * d) * gc), num += w * s and
// den += w with separate roundings (built with -fmad=false, no fast
// math), and rintf (half to even) for the final rounding.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 256;  // radius <= 8

struct SpaceWeights {
  float w[kMaxTaps];
};

__device__ __forceinline__ int reflect101(int k, int n) {
  if (k < 0) k = -k;
  if (k >= n) k = 2 * n - 2 - k;
  // Only staged halo cells that feed no in-frame output can land outside
  // after one reflection; clamp them to stay in bounds.
  return min(max(k, 0), n - 1);
}

__device__ __forceinline__ int clampi(int k, int n) {
  return min(max(k, 0), n - 1);
}

__global__ void __launch_bounds__(kThreads)
fused_motion_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int H, int W, int radius, SpaceWeights sw, float gauss_color,
                    float thresh) {
  extern __shared__ float smem[];
  const int halo = radius + 2;
  const int IH = kTileH + 2 * halo, IW = kTileW + 2 * halo;  // staged input
  const int BH = kTileH + 4, BW = kTileW + 4;                // thresholded
  const int EH = kTileH + 2, EW = kTileW + 2;                // eroded
  float* s_in = smem;
  float* s_thr = s_in + IH * IW;
  float* s_ero = s_thr + BH * BW;

  const int ty0 = blockIdx.y * kTileH;
  const int tx0 = blockIdx.x * kTileW;
  const size_t frame = (size_t)blockIdx.z * H * W;
  const uint8_t* src = in + frame;
  uint8_t* dst = out + frame;
  const int tid = threadIdx.x;

  int hot = 0;
  for (int k = tid; k < IH * IW; k += kThreads) {
    const int ly = k / IW, lx = k - ly * IW;
    const int gy = reflect101(ty0 - halo + ly, H);
    const int gx = reflect101(tx0 - halo + lx, W);
    const float v = (float)src[gy * W + gx];
    s_in[k] = v;
    hot |= v > thresh;
  }
  if (!__syncthreads_or(hot)) {
    for (int k = tid; k < kTileH * kTileW; k += kThreads) {
      const int gy = ty0 + k / kTileW, gx = tx0 + k % kTileW;
      if (gy < H && gx < W) dst[gy * W + gx] = 0;
    }
    return;
  }

  // bilateral + threshold on the tile +-2 (global origin ty0-2, tx0-2)
  const int r2max = radius * radius;
  for (int k = tid; k < BH * BW; k += kThreads) {
    const int ly = k / BW, lx = k - ly * BW;
    const int gy = ty0 - 2 + ly, gx = tx0 - 2 + lx;
    float t = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int cy = ly + radius, cx = lx + radius;  // index in s_in
      const float c = s_in[cy * IW + cx];
      float num = 0.f, den = 0.f;
      int tap = 0;
      for (int i = -radius; i <= radius; ++i) {
        for (int j = -radius; j <= radius; ++j) {
          if (i * i + j * j > r2max) continue;
          const float s = s_in[(cy + i) * IW + cx + j];
          const float d = s - c;
          const float w = sw.w[tap++] * expf(d * d * gauss_color);
          num = num + w * s;
          den = den + w;
        }
      }
      const float b = rintf(num / den);
      t = b > thresh ? b : 0.f;
    }
    s_thr[k] = t;
  }
  __syncthreads();

  // 3x3 erosion on the tile +-1, edge-replicating the thresholded plane
  for (int k = tid; k < EH * EW; k += kThreads) {
    const int ly = k / EW, lx = k - ly * EW;
    const int gy = ty0 - 1 + ly, gx = tx0 - 1 + lx;
    float m = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      m = 3.4e38f;
      for (int dy = -1; dy <= 1; ++dy) {
        const int yy = clampi(gy + dy, H) - (ty0 - 2);
        for (int dx = -1; dx <= 1; ++dx) {
          const int xx = clampi(gx + dx, W) - (tx0 - 2);
          m = fminf(m, s_thr[yy * BW + xx]);
        }
      }
    }
    s_ero[k] = m;
  }
  __syncthreads();

  // 3x3 dilation on the tile, edge-replicating the eroded plane
  for (int k = tid; k < kTileH * kTileW; k += kThreads) {
    const int gy = ty0 + k / kTileW, gx = tx0 + k % kTileW;
    if (gy >= H || gx >= W) continue;
    float m = 0.f;
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = clampi(gy + dy, H) - (ty0 - 1);
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = clampi(gx + dx, W) - (tx0 - 1);
        m = fmaxf(m, s_ero[yy * EW + xx]);
      }
    }
    dst[gy * W + gx] = (uint8_t)m;
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over (N, H, W) u8 frames.  `space_weights` is a
// host array of `n_taps` f32 weights in tap order.  Returns a cudaError_t
// (0 on success); argument errors return cudaErrorInvalidValue.
int swt_fused_motion(const void* in, void* out, int N, int H, int W, int radius,
                     const float* space_weights, int n_taps, float gauss_color,
                     float thresh, void* stream) {
  if (N <= 0 || H <= radius || W <= radius || radius < 1 || n_taps > kMaxTaps ||
      N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  SpaceWeights sw;
  for (int t = 0; t < n_taps; ++t) sw.w[t] = space_weights[t];
  const int halo = radius + 2;
  const size_t smem =
      sizeof(float) * ((size_t)(kTileH + 2 * halo) * (kTileW + 2 * halo) +
                       (size_t)(kTileH + 4) * (kTileW + 4) +
                       (size_t)(kTileH + 2) * (kTileW + 2));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_motion_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
  fused_motion_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, H, W, radius, sw, gauss_color, thresh);
  return (int)cudaGetLastError();
}

}  // extern "C"
