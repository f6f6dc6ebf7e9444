// One warp's least (value, index), lowest index on ties, for Hopper (sm_90a).
//
// Shared by T1b (track_scan.cu), whose every Dijkstra step and enumeration
// ends in one, and the latency micro-kernels that time it (t1_latency.cu).
// The least value is taken by __reduce_min_sync on an unsigned key that
// orders floats as `<` does, then the least index among the lanes that hold
// it by a second reduction: the pair an xor-butterfly over (value, index)
// gives, in two dependent `redux` instructions instead of five rounds of
// two shuffles.  Values must be neither NaN nor -0.0.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

// A float's bits as an unsigned key with the same order (for values that
// are neither NaN nor -0.0), and back.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// The warp's least (value, index), lowest index on ties, in every lane:
// the least key, then the least index among the lanes that hold it.
// (Taking the index by shuffle where one lane holds the least value, and
// by this second reduction only on ties, was slower on the card.)
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  const unsigned key = __reduce_min_sync(kFullWarp, order_key(v));
  i = (int)__reduce_min_sync(kFullWarp, order_key(v) == key ? (unsigned)i : 0xffffffffu);
  v = key_value(key);
}

}  // namespace
