// K7: a batch of small symmetric eigendecompositions with Newton refinement
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's _refined_eigh
// (swiftwatcher_tpu/ops/rpca.py) is plain XLA, an eigh and two Newton
// steps with QR.  On the card the port's plain chain, torch.linalg.eigh
// and torch.linalg.qr, synchronises the card with the host (the eigh), and
// then runs as a string of tiny launches on a card with nothing else
// queued.  Every IALM trip of the solver calls it once (ops/rpca.py), so it
// drained the card in the middle of every trip.  K7 computes the same
// function in one launch for the whole batch, with no host read.
//
// Per n x n f32 matrix G of the batch (n <= 32), one block:
//
//   (a) parallel cyclic Jacobi on the lower triangle of G (what eigh
//       reads), in round-robin order: n padded to even m, m/2 disjoint
//       pairs a step, m - 1 steps a sweep; every pair of a step rotates at
//       once, A <- J^T A J, and the rotations accumulate into V.  Sweeps
//       run until the off-diagonal Frobenius norm is <= tol ||G||_F (both
//       taken on G scaled by a power of two, exactly), at most max_sweeps.
//       The eigenvalues are then sorted ascending (ties by index), with V's
//       columns;
//   (b) `steps` Newton steps of the plain chain, with its formulas:
//       R = V^T (G V), d = diag R, F = clamp(R / safe(d_j - d_i), -1/2, 1/2)
//       off the diagonal, where safe turns gaps <= 1e-12 max|d| into
//       infinity, and V <- Q of V (I + F), Q from Householder QR
//       (LAPACK's reflectors, formed backward as sorg2r does).
//
// Outputs d (the last step's diag R), V and the sweeps taken.
//
// What bounds it: latency.  The work is tiny (a sweep is ~2 m^3 flops,
// a QR ~ 4/3 n^3) and each step depends on the one before, so the design
// keeps every dependent step short: the matrix, the rotations and the
// basis live in shared memory (row stride 33, so a warp reading a column
// meets no bank conflict); each Jacobi step is one barrier (every thread
// derives the rotations of its element's two pairs itself, from the
// step's input, and writes its element of A and of V to the other
// buffer); the QR gives each column to one warp, which applies every
// reflector to it with shuffles, so the factorisation takes a barrier a
// column and forming Q takes none.
//
// Deterministic: no atomics; each sum runs in a fixed order (butterfly
// shuffles leave every lane with the same bits, since a + b == b + a),
// and every thread that needs a shared quantity (a rotation, a norm, the
// largest |d|) computes it from the same inputs in the same order.  So
// every rank of a mesh gets the same V from the same summed G.  The
// build's -fmad=false keeps every product and sum rounded on its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kS = kMaxN + 1;   // shared row stride
constexpr int kTile = kMaxN * kS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's sum (or max) of v, the same bits in every thread: the warps'
// results summed in warp order.  Every thread of the block must call it.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < n_warps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// The partner of index i in step r of the round-robin schedule on m
// (even) indices: m - 1 stays put and meets r; the rest sit on a circle,
// where (r + k) mod (m - 1) meets (r - k) mod (m - 1).
__device__ __forceinline__ int partner(int i, int r, int m) {
  const int L = m - 1;
  if (i == L) return r;
  if (i == r) return L;
  return ((2 * r - i) % L + L) % L;
}

// Column i of the step's rotation J is alpha e_i + beta e_partner; t is
// tan(theta), which the two diagonal entries of the pair need.  The pair
// (p, q), p < q, is rotated so that (J^T A J)_pq = 0 (Golub and Van Loan's
// sym.schur2 with tau = (a_qq - a_pp) / (2 a_pq), its t rewritten so that
// nothing overflows): J_pp = J_qq = c, J_pq = s, J_qp = -s.
struct Rot {
  float alpha, beta, t;
};

__device__ __forceinline__ Rot rotation(const float* A, int i, int pi) {
  const int p = min(i, pi), q = max(i, pi);
  const float apq = A[p * kS + q];
  if (apq == 0.f) return Rot{1.f, 0.f, 0.f};
  const float d = A[q * kS + q] - A[p * kS + p];
  const float two = 2.f * apq;
  const float t = copysignf(1.f, d) * two / (fabsf(d) + hypotf(d, two));
  const float c = 1.f / sqrtf(1.f + t * t);
  const float s = t * c;
  return Rot{c, i == p ? -s : s, t};
}

// The Householder reflector H = I - tau v v^T of column j of U (rows j to
// n - 1), as LAPACK's slarfg makes it, by one warp (lane i holds row i):
// v_j = 1 is implicit and v_i (i > j) overwrites U[i][j]; tau = 0 (H = I)
// where the column below the diagonal is zero.
__device__ void make_reflector(float* U, float* tau, int j, int n) {
  const int lane = threadIdx.x & 31;
  const float x = lane > j && lane < n ? U[lane * kS + j] : 0.f;
  const float xnorm = sqrtf(warp_sum(x * x));
  const float alpha = U[j * kS + j];
  if (xnorm == 0.f) {
    if (lane == 0) tau[j] = 0.f;
    return;
  }
  const float beta = -copysignf(hypotf(alpha, xnorm), alpha);
  const float scal = 1.f / (alpha - beta);
  if (lane > j && lane < n) U[lane * kS + j] = x * scal;
  if (lane == 0) tau[j] = (beta - alpha) / beta;
}

// Column k of X (rows j to n - 1) <- H_j X, by one warp: w = v^T x, then
// x -= tau v w.
__device__ __forceinline__ void apply_reflector(const float* U, const float* tau, float* X,
                                                int j, int k, int n) {
  const int lane = threadIdx.x & 31;
  const float v = lane == j ? 1.f : (lane > j && lane < n ? U[lane * kS + j] : 0.f);
  const float x = lane >= j && lane < n ? X[lane * kS + k] : 0.f;
  const float w = warp_sum(v * x);
  if (lane >= j && lane < n) X[lane * kS + k] = x - (tau[j] * v) * w;
}

// Q of the QR factorisation of U (n x n, destroyed) into Q: U is factored
// by reflectors, column k owned by warp k mod (warps); the owner of column
// j + 1 makes reflector j + 1 as soon as it has applied reflector j to its
// column, so a column costs one barrier.  Q = H_0 ... H_{n-2} is then
// formed backward from I, each warp on its own columns, with no barrier.
__device__ void householder_q(float* U, float* Q, float* tau, int n) {
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, k = e % n;
    Q[i * kS + k] = i == k ? 1.f : 0.f;
  }
  if (warp == 0 && n > 1) make_reflector(U, tau, 0, n);
  __syncthreads();
  for (int j = 0; j + 1 < n; ++j) {
    for (int k = j + 1 + (warp - (j + 1) % n_warps + n_warps) % n_warps; k < n; k += n_warps) {
      apply_reflector(U, tau, U, j, k, n);
      if (k == j + 1 && k + 1 < n) {
        __syncwarp();
        make_reflector(U, tau, k, n);
      }
    }
    __syncthreads();
  }
  for (int k = warp; k < n; k += n_warps)
    for (int j = min(k, n - 2); j >= 0; --j) apply_reflector(U, tau, Q, j, k, n);
  __syncthreads();
}

// Up to 1024 threads: an element of the padded m x m matrix each.
__global__ void __launch_bounds__(1024)
refined_eigh_kernel(const float* __restrict__ g_all, float* __restrict__ d_all,
                    float* __restrict__ v_all, int* __restrict__ sweeps_all, int n, int steps,
                    float tol, int max_sweeps) {
  __shared__ float G[kTile], A0[kTile], A1[kTile], V0[kTile], V1[kTile];
  __shared__ float red[32], tau[kMaxN], dv[kMaxN];
  __shared__ int rank[kMaxN];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = n + (n & 1);
  const bool in_m = tid < m * m, in_n = tid < n * n;
  const int i = in_m ? tid / m : 0, j = in_m ? tid % m : 0;   // Jacobi's element
  const int ri = in_n ? tid / n : 0, rj = in_n ? tid % n : 0; // the n x n element
  const float* g = g_all + (size_t)b * n * n;

  // A: the lower triangle of G mirrored, zero-padded to m x m; V = I.
  float a = 0.f;
  if (in_m) {
    if (i < n && j < n) a = g[max(i, j) * n + min(i, j)];
    A0[i * kS + j] = a;
    V0[i * kS + j] = i == j ? 1.f : 0.f;
  }
  if (in_n) G[ri * kS + rj] = g[ri * n + rj];
  // ||G||_F and the off-diagonal norm on A scaled by 2^-e, e the exponent
  // of max|A|: exact, and no square overflows.
  const float amax = block_reduce<true>(fabsf(a), red);
  int e = 0;
  if (amax > 0.f) frexpf(amax, &e);
  const float scale = ldexpf(1.f, -e);
  const float norm = sqrtf(block_reduce<false>((a * scale) * (a * scale), red));

  float* A = A0;
  float* An = A1;
  float* V = V0;
  float* Vn = V1;
  int sweeps = 0;
  for (;;) {
    const float o = in_m && i != j ? A[i * kS + j] * scale : 0.f;
    const float off = sqrtf(block_reduce<false>(o * o, red));
    if (off <= tol * norm || sweeps >= max_sweeps) break;
    for (int r = 0; r < m - 1; ++r) {
      if (in_m) {
        const int pi = partner(i, r, m), pj = partner(j, r, m);
        const Rot ri_ = rotation(A, i, pi), rj_ = rotation(A, j, pj);
        float out;
        if (i == j) {
          const float apq = A[min(i, pi) * kS + max(i, pi)];
          out = i < pi ? A[i * kS + i] - ri_.t * apq : A[i * kS + i] + ri_.t * apq;
        } else if (j == pi) {
          out = 0.f;
        } else {
          // symmetric in (i, j) bit for bit: the swapped element sums the
          // same four products in the same pairing
          out = ((ri_.alpha * rj_.alpha) * A[i * kS + j] +
                 (ri_.beta * rj_.beta) * A[pi * kS + pj]) +
                ((ri_.alpha * rj_.beta) * A[i * kS + pj] +
                 (ri_.beta * rj_.alpha) * A[pi * kS + j]);
        }
        An[i * kS + j] = out;
        Vn[i * kS + j] = rj_.alpha * V[i * kS + j] + rj_.beta * V[i * kS + pj];
      }
      __syncthreads();
      float* sw = A; A = An; An = sw;
      sw = V; V = Vn; Vn = sw;
    }
    ++sweeps;
  }

  // ascending eigenvalues, ties by index; V's columns with them
  if (tid < n) {
    const float di = A[tid * kS + tid];
    int r = 0;
    for (int k = 0; k < n; ++k) {
      const float dk = A[k * kS + k];
      r += dk < di || (dk == di && k < tid);
    }
    rank[tid] = r;
    dv[r] = di;
  }
  __syncthreads();
  if (in_n) Vn[ri * kS + rank[rj]] = V[ri * kS + rj];
  __syncthreads();
  V = Vn;

  // Newton steps: W = G V into A0, R = V^T W into A1, I + F into A0,
  // V (I + F) into A1, its Q into V.
  const float tiny = 1.17549435e-38f;   // f32's smallest normal
  for (int s = 0; s < steps; ++s) {
    if (in_n) {
      float w = 0.f;
      for (int k = 0; k < n; ++k) w += G[ri * kS + k] * V[k * kS + rj];
      A0[ri * kS + rj] = w;
    }
    __syncthreads();
    if (in_n) {
      float r = 0.f;
      for (int k = 0; k < n; ++k) r += V[k * kS + ri] * A0[k * kS + rj];
      A1[ri * kS + rj] = r;
    }
    __syncthreads();
    float dmax = 0.f;
    for (int k = 0; k < n; ++k) dmax = fmaxf(dmax, fabsf(A1[k * kS + k]));
    const float dscale = dmax + tiny;
    if (in_n) {
      float f = 1.f;
      if (ri != rj) {
        const float diff = A1[rj * kS + rj] - A1[ri * kS + ri];
        const float safe = fabsf(diff) > 1e-12f * dscale ? diff : INFINITY;
        f = fminf(fmaxf(A1[ri * kS + rj] / safe, -0.5f), 0.5f);
      }
      A0[ri * kS + rj] = f;
      if (ri == rj) dv[ri] = A1[ri * kS + ri];
    }
    __syncthreads();
    if (in_n) {
      float u = 0.f;
      for (int k = 0; k < n; ++k) u += V[ri * kS + k] * A0[k * kS + rj];
      A1[ri * kS + rj] = u;
    }
    __syncthreads();
    householder_q(A1, V, tau, n);
  }

  if (in_n) v_all[(size_t)b * n * n + ri * n + rj] = V[ri * kS + rj];
  if (tid < n) d_all[(size_t)b * n + tid] = dv[tid];
  if (tid == 0) sweeps_all[b] = sweeps;
}

}  // namespace

extern "C" {

// Launches K7 on `stream`: g is (B, n, n) f32, symmetric (the Jacobi
// sweeps read its lower triangle, the Newton steps all of it); d is (B, n)
// f32, v is (B, n, n) f32 (eigenvectors in columns), sweeps is (B,) int32.
// 1 <= n <= 32, 1 <= B <= 2^31 - 1, steps >= 0, max_sweeps >= 0.  Returns a
// cudaError_t (0 on success).
int swt_refined_eigh(const void* g, void* d, void* v, void* sweeps, int B, int n, int steps,
                     float tol, int max_sweeps, void* stream) {
  if (B < 1 || n < 1 || n > kMaxN || steps < 0 || max_sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const int m = n + (n & 1);
  const int threads = ((m * m + 31) / 32) * 32;
  refined_eigh_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (float*)d, (float*)v, (int*)sweeps, n, steps, tol, max_sweeps);
  return (int)cudaGetLastError();
}

}  // extern "C"
