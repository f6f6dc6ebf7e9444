// K9: stabilisation's integer-shift search (K9a) and its gather (K9b), for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: swiftwatcher_tpu/ops/stabilize.py:stabilize_window
// is plain XLA (no pallas_call), whose static slices XLA fuses on the TPU.
// Run as plain PyTorch (ops/stabilize.py:stabilize_window_reference), the
// same search is, for each of the (2J+1)^2 candidate shifts, a slice of an
// edge-padded copy cast to int32, a subtraction, an abs and an int64 sum
// over the whole batch, then (2J+1)^2 torch.where passes to build the
// output: about 3 GB of traffic a candidate at the cells' shape.
//
// For frame n of an (N, H, W) u8 batch, its u8 reference R (H, W) at
// ref + (n / T) * ref_stride (stride 0: one pose shared by every frame;
// H * W: one reference a window of T frames), and the search radius J:
//
//   K9a  sads[n, c] += sum over the block's rows y and every column x of
//          |P[y + a, x + b] - R[y, x]|,   c = a (2J + 1) + b,  a, b in [0, 2J]
//        P the frame edge-padded by J (rows and columns clamped, as
//        ops/stabilize.py:_edge_pad), into a zeroed (N, (2J+1)^2) int32
//   K9b  c* = the lowest c with the least sads[n, c];  (dy, dx) = (a - J, b - J)
//        out[n, y, x] = frame[clamp(y + dy), clamp(x + dx)];  shifts[n] = (dy, dx)
//
// Exact.  Every operation is an integer one.  A frame's SAD is at most
// H * W * 255, which the wrapper keeps below 2^31, so int32 holds it; and
// integer addition is associative, so the blocks' atomicAdds of their
// partials, in whatever order the blocks finish, give the same sum on
// every run: the plain chain's int64 sum.  So the aligned bytes and the
// shifts are the plain chain's bit for bit, ties included.
//
// What bounds it.  At the cells' shape (N = 1344 frames of 216 x 432,
// J = 3) K9a makes 49 x 1344 x 93,312 = 6.15 G absolute differences a
// batch and reads 125 MB (the frames, each band with its 2J halo rows,
// about 148 MB at 32 rows a band; the shared reference stays in L2): bound by integer throughput,
// not bytes (0.05 ms at 3.35 TB/s).  vabsdiff4 with its .add takes four
// byte lanes, their sum and the accumulation in one instruction: 1.54 G
// instructions, 0.09 ms if they retire at the SM's INT32 rate (132 SMs x 64
// lanes x 1.98 GHz); forming each shifted word of a padded row (a funnel
// shift, 6 of 7 candidates' words at J = 3) adds 0.86 G more.  K9b reads
// the frames once and writes them once: 250 MB, 0.075 ms.  Measured on the
// card at that shape (PERF.md §6): K9a 0.336 ms with vabsdiff4 against
// 1.346 ms with the bytes unpacked and summed as plain int arithmetic, and
// bands of 32 rows 0.328 ms against 0.336 (24), 0.505 (8) and 0.384 (48);
// K9b 0.169 ms.  The design:
//
//   * K9a: one block of 128 threads per (frame, band of `rows` output
//     rows); it stages the band's rows with their J halo rows above and
//     below (clamped at the frame's edges) and J halo columns each side
//     (the edge column repeated), and the reference's rows, in shared
//     memory, with 16-byte loads where the width and the pointers allow;
//   * a thread takes 4 output pixels (one 32-bit word of the staged
//     reference row) at a time and keeps all (2J+1)^2 candidate sums in
//     registers: for each of the 2J+1 padded rows it reads 3 words and
//     forms the 2J+1 shifted words by funnel shifts, each against the one
//     reference word, so every staged byte is read from shared memory once
//     per padded row and used (2J+1) times; a width that is not a multiple
//     of 4 masks its last word's columns past W on both sides;
//   * the block sums each candidate over its warps (shuffles, then a
//     shared atomic a warp) and adds it into sads[n, c] with one atomicAdd;
//   * K9b: one block of 256 threads per (frame, 8 output rows); its first
//     warp takes the argmin of the frame's sums (ties to the lowest index),
//     and the block copies the chosen slice a 32-bit word at a time (two
//     aligned loads and a funnel shift; clamped bytes at the frame's
//     edges), or a byte at a time where W % 4 or the pointers forbid
//     words.  The frame's first block writes its (dy, dx).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxJ = 4;
constexpr int kSearchThreads = 128;
constexpr int kGatherThreads = 256;
constexpr int kGatherRows = 8;  // output rows a K9b block copies
// Shared byte of a staged row's column 0: 16-byte aligned for the vector
// stores, and room for the J <= kMaxJ halo columns before it.
constexpr int kOff = 16;
// A block's shared memory without an opt-in, static and dynamic together,
// and the most K9a's static `total` takes (at J = kMaxJ).
constexpr int kSmemBytes = 48 * 1024;
constexpr int kStaticBytes = 4 * (2 * kMaxJ + 1) * (2 * kMaxJ + 1);

__device__ __forceinline__ int clamp_to(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// acc plus the sum of |x_i - y_i| over the four bytes of x and y.
__device__ __forceinline__ unsigned sad4(unsigned x, unsigned y, unsigned acc) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(acc));
  return d;
}

struct Search {
  const uint8_t* gray;  // (N, H, W)
  const uint8_t* ref;   // frame n's reference at ref + (n / T) * ref_stride
  int* sads;            // (N, (2J+1)^2), zeroed
  int T, H, W, ref_stride;
  int rows;    // output rows of a band
  int bands;   // bands of a frame: ceil(H / rows)
  int stride;  // bytes of a staged row
  bool vec;    // 16-byte loads: W % 16 == 0 and both pointers 16-byte aligned
};

// Stages the band of output rows [y0, y0 + nrows): padded rows i = 0 ..
// rows + 2J - 1 (source row clamp(y0 - J + i)) at pad + i * stride + kOff
// with their J halo columns each side, and the reference's rows at refs +
// r * stride + kOff.
template <int J>
__device__ __forceinline__ void stage_band(const Search& s, const uint8_t* src,
                                           const uint8_t* ref, int y0, int nrows, uint8_t* pad,
                                           uint8_t* refs) {
  const int np = s.rows + 2 * J;
  const int per_row = s.vec ? s.W / 16 : s.W;
  const int items = (np + nrows) * per_row;
  for (int it = threadIdx.x; it < items; it += kSearchThreads) {
    const int row = it / per_row, q = it - row * per_row;
    const uint8_t* from;
    uint8_t* to;
    if (row < np) {
      from = src + (size_t)clamp_to(y0 - J + row, s.H - 1) * s.W;
      to = pad + row * s.stride + kOff;
    } else {
      from = ref + (size_t)(y0 + row - np) * s.W;
      to = refs + (row - np) * s.stride + kOff;
    }
    if (s.vec)
      reinterpret_cast<uint4*>(to)[q] = reinterpret_cast<const uint4*>(from)[q];
    else
      to[q] = from[q];
  }
  for (int it = threadIdx.x; it < np * 2 * J; it += kSearchThreads) {
    const int row = it / (2 * J), j = it - row * (2 * J);
    const uint8_t* from = src + (size_t)clamp_to(y0 - J + row, s.H - 1) * s.W;
    uint8_t* to = pad + row * s.stride + kOff;
    if (j < J)
      to[j - J] = from[0];
    else
      to[s.W + j - J] = from[s.W - 1];
  }
}

// Adds the (2J+1)^2 candidate SADs of output word k (columns 4k .. 4k + 3)
// of staged row r into acc.  Padded column p of a staged row is at byte
// kOff - J + p = 4 kQ + kE + p, so the candidate b's word of output word k
// starts kE + b bytes into word kQ + k, within the 3 words from there
// (kE + 2J + 3 <= 11 for J <= kMaxJ).  kTail masks the bytes past W.
template <int J, bool kTail>
__device__ __forceinline__ void cell_sads(const uint8_t* pad, const uint8_t* refs, int stride,
                                          int r, int k, unsigned mask,
                                          unsigned (&acc)[(2 * J + 1) * (2 * J + 1)]) {
  constexpr int n = 2 * J + 1;
  constexpr int kE = (kOff - J) & 3, kQ = (kOff - J) >> 2;
  unsigned rw = reinterpret_cast<const unsigned*>(refs + r * stride + kOff)[k];
  if (kTail) rw &= mask;
#pragma unroll
  for (int a = 0; a < n; ++a) {
    const unsigned* p = reinterpret_cast<const unsigned*>(pad + (r + a) * stride) + kQ + k;
    const unsigned w[3] = {p[0], p[1], p[2]};
#pragma unroll
    for (int b = 0; b < n; ++b) {
      const int sb = kE + b, wi = sb >> 2, sh = sb & 3;
      unsigned v = sh == 0 ? w[wi] : __funnelshift_r(w[wi], w[wi + 1 < 3 ? wi + 1 : 2], 8 * sh);
      if (kTail) v &= mask;
      acc[a * n + b] = sad4(v, rw, acc[a * n + b]);
    }
  }
}

template <int J>
__global__ void __launch_bounds__(kSearchThreads) search_kernel(Search s) {
  constexpr int n = 2 * J + 1, kC = n * n;
  extern __shared__ uint4 smem[];
  __shared__ int total[kC];
  uint8_t* pad = reinterpret_cast<uint8_t*>(smem);
  uint8_t* refs = pad + (s.rows + 2 * J) * s.stride;
  const int frame = blockIdx.x / s.bands, band = blockIdx.x - frame * s.bands;
  const int y0 = band * s.rows, nrows = min(s.rows, s.H - y0);
  const uint8_t* src = s.gray + (size_t)frame * s.H * s.W;
  const uint8_t* ref = s.ref + (size_t)(frame / s.T) * s.ref_stride;
  if (threadIdx.x < kC) total[threadIdx.x] = 0;
  stage_band<J>(s, src, ref, y0, nrows, pad, refs);
  __syncthreads();

  unsigned acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = 0;
  const int kw = (s.W + 3) >> 2;
  const bool ragged = (s.W & 3) != 0;
  const unsigned mask = (1u << (8 * (s.W & 3))) - 1u;
  for (int cell = threadIdx.x; cell < nrows * kw; cell += kSearchThreads) {
    const int r = cell / kw, k = cell - r * kw;
    if (ragged && k == kw - 1)
      cell_sads<J, true>(pad, refs, s.stride, r, k, mask, acc);
    else
      cell_sads<J, false>(pad, refs, s.stride, r, k, 0u, acc);
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    unsigned v = acc[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) atomicAdd(&total[c], (int)v);
  }
  __syncthreads();
  if (threadIdx.x < kC) atomicAdd(s.sads + (size_t)frame * kC + threadIdx.x, total[threadIdx.x]);
}

struct Gather {
  const uint8_t* gray;  // (N, H, W)
  const int* sads;      // (N, C)
  uint8_t* out;         // (N, H, W)
  int* shifts;          // (N, 2)
  int H, W, J, C, bands;
};

template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads) gather_kernel(Gather g) {
  __shared__ int best;
  const int frame = blockIdx.x / g.bands, band = blockIdx.x - frame * g.bands;
  if (threadIdx.x < 32) {
    // the lowest index of the least sum: each lane its candidates in
    // ascending order, then the lanes' (sum, index) pairs
    const int* sf = g.sads + (size_t)frame * g.C;
    int v = INT_MAX, i = g.C;
    for (int c = threadIdx.x; c < g.C; c += 32) {
      const int x = sf[c];
      if (x < v) v = x, i = c;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ov = __shfl_down_sync(0xffffffffu, v, o);
      const int oi = __shfl_down_sync(0xffffffffu, i, o);
      if (ov < v || (ov == v && oi < i)) v = ov, i = oi;
    }
    if (threadIdx.x == 0) best = i;
  }
  __syncthreads();
  const int n = 2 * g.J + 1;
  const int dy = best / n - g.J, dx = best % n - g.J;
  if (band == 0 && threadIdx.x == 0) {
    g.shifts[2 * (size_t)frame] = dy;
    g.shifts[2 * (size_t)frame + 1] = dx;
  }
  const int y0 = band * kGatherRows, nrows = min(kGatherRows, g.H - y0);
  const uint8_t* src = g.gray + (size_t)frame * g.H * g.W;
  uint8_t* dst = g.out + (size_t)frame * g.H * g.W;
  if (kVec) {
    const int kw = g.W >> 2;
    for (int cell = threadIdx.x; cell < nrows * kw; cell += kGatherThreads) {
      const int r = cell / kw, k = cell - r * kw, y = y0 + r;
      const uint8_t* row = src + (size_t)clamp_to(y + dy, g.H - 1) * g.W;
      const int c0 = 4 * k + dx;
      unsigned w;
      if (c0 >= 0 && c0 + 3 < g.W) {
        const unsigned* rw = reinterpret_cast<const unsigned*>(row) + (c0 >> 2);
        const int sh = c0 & 3;
        w = sh ? __funnelshift_r(rw[0], rw[1], 8 * sh) : rw[0];
      } else {
        w = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) w |= (unsigned)row[clamp_to(c0 + i, g.W - 1)] << (8 * i);
      }
      reinterpret_cast<unsigned*>(dst + (size_t)y * g.W)[k] = w;
    }
  } else {
    for (int cell = threadIdx.x; cell < nrows * g.W; cell += kGatherThreads) {
      const int r = cell / g.W, x = cell - r * g.W, y = y0 + r;
      dst[(size_t)y * g.W + x] =
          src[(size_t)clamp_to(y + dy, g.H - 1) * g.W + clamp_to(x + dx, g.W - 1)];
    }
  }
}

bool aligned(const void* p, uintptr_t to) { return reinterpret_cast<uintptr_t>(p) % to == 0; }

}  // namespace

extern "C" {

// Launches K9a on `stream`.  gray is (N, H, W) u8; frame n's reference is
// the (H, W) u8 at ref + (n / T) * ref_stride; sads is a zeroed (N,
// (2J+1)^2) int32, added into.  1 <= J <= 4; `rows` output rows a block
// and `stride` bytes a staged row, (2 rows + 2J) * stride dynamic bytes
// within 48 KiB beside the static `total` (at most kStaticBytes), stride >=
// 16 + W + 12 and a multiple of 16 (ops/stabilize.py: search_layout);
// H * W * 255 < 2^31.  Returns a cudaError_t (0 on success).
int swt_stabilize_search(const void* gray, const void* ref, void* sads, int N, int T, int H,
                         int W, int J, int ref_stride, int rows, int stride, void* stream) {
  if (J < 1 || J > kMaxJ || N < 1 || T < 1 || H < 1 || W < 1 || rows < 1 ||
      stride % 16 != 0 || stride < kOff + W + 12 ||
      (size_t)(2 * rows + 2 * J) * stride > (size_t)(kSmemBytes - kStaticBytes))
    return (int)cudaErrorInvalidValue;
  const int bands = (H + rows - 1) / rows;
  const Search s{static_cast<const uint8_t*>(gray), static_cast<const uint8_t*>(ref),
                 static_cast<int*>(sads), T, H, W, ref_stride, rows, bands, stride,
                 W % 16 == 0 && aligned(gray, 16) && aligned(ref, 16)};
  const size_t smem = (size_t)(2 * rows + 2 * J) * stride;
  const dim3 grid((unsigned)N * bands);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (J) {
    case 1: search_kernel<1><<<grid, kSearchThreads, smem, st>>>(s); break;
    case 2: search_kernel<2><<<grid, kSearchThreads, smem, st>>>(s); break;
    case 3: search_kernel<3><<<grid, kSearchThreads, smem, st>>>(s); break;
    default: search_kernel<4><<<grid, kSearchThreads, smem, st>>>(s); break;
  }
  return (int)cudaGetLastError();
}

// Launches K9b on `stream`.  gray and out are (N, H, W) u8, sads the (N,
// (2J+1)^2) int32 of K9a, shifts an (N, 2) int32 output.  1 <= J <= 4.
// Returns a cudaError_t (0 on success).
int swt_stabilize_gather(const void* gray, const void* sads, void* out, void* shifts, int N,
                         int H, int W, int J, void* stream) {
  if (J < 1 || J > kMaxJ || N < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int bands = (H + kGatherRows - 1) / kGatherRows;
  const Gather g{static_cast<const uint8_t*>(gray), static_cast<const int*>(sads),
                 static_cast<uint8_t*>(out), static_cast<int*>(shifts),
                 H, W, J, (2 * J + 1) * (2 * J + 1), bands};
  const dim3 grid((unsigned)N * bands);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W % 4 == 0 && aligned(gray, 4) && aligned(out, 4))
    gather_kernel<true><<<grid, kGatherThreads, 0, st>>>(g);
  else
    gather_kernel<false><<<grid, kGatherThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"
