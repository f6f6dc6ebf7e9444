// T1: the device tracker's per-batch scan (swiftwatcher_tpu_torch/pipeline/
// tracking_device.py:track_window).
//
// Replaces swiftwatcher_tpu/pipeline/tracking_jax.py:410 `track_window`, a
// lax.scan with no Pallas kernel behind it: per frame, a 2K x 2K cost matrix,
// an enumeration or Jonker-Volgenant LAP, the ROI event test with its
// cumsum-ranked append, and track linking, with the empty-frame fast path and
// inactive (no-op) frames.  Its plain version is tracking_device.py:
// track_window_reference; the two agree bit for bit.
//
// What bounds it: latency along the frame chain.  Each frame depends on the
// state the one before left, a few hundred bytes a frame; inside a frame the
// LAP is a sequence of Dijkstra steps, each a block-wide argmin.  Neither the
// bytes nor the operations come near the card's rates.
//
// Design: one launch per batch, ONE block of 64 threads (K <= 32) or 128
// (K <= 64), so the barriers along the chain are what it pays for.  Thread j
// owns slot j and column j of the cost matrix (its shortest path,
// predecessor, visited flag and column dual stay in registers).  The state
// lives in shared memory in two buffers, read from one and written to the
// other, so linking needs no barrier; the frame's segments, the match block
// and the LAP's row duals live there too.  Filler, diagonal and padding
// cells are computed from the validity flags, so only the K x K match block
// is stored, and only its valid pairs are evaluated.  A frame with work pays
// four barriers plus the LAP's: one Dijkstra step is one relaxation per
// thread and one block argmin (warp shuffles and one barrier), and one JV
// row two more.  The enumeration's patterns are packed 3 bits a row into
// one int, kept in shared memory when they fit (n <= 5).  The next frame's
// segments are loaded into registers while this frame is solved.
//
// Exactness: every argmin takes the lowest index on ties (as jnp/torch
// argmin do), and every float expression keeps the plain version's
// operations and order (the build uses -fmad=false and no fast math): the
// reduced cost is ((min_val + cost) - u_i) - v_j, the duals are updated in
// scipy's order, and an enumeration score is summed over its matched
// (p, c) in row-major order.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 64;
constexpr int kMaxThreads = 128;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSharedPatterns = 1546;  // the n = 5 table
constexpr unsigned kNoColumn = 7u;        // a pattern row left unmatched

struct Consts {
  float dist_knee, angle_knee, clamp, deg, nonmatch, filler, w_offset, big;
};

struct State {
  float cy[kMaxK], cx[kMaxK], fcy[kMaxK], fcx[kMaxK];
  int hist[kMaxK], valid[kMaxK];
  int fn;
};

struct Shared {
  State st[2];  // the state before and after the frame, by turns
  // this frame's slots
  float f_cy[kMaxK], f_cx[kMaxK];
  int f_valid[kMaxK];
  // match block, M x M with M = K (LAP) or n_enum (enumeration weights)
  float match[kMaxK * kMaxK];
  // LAP over the 2K rows and columns
  float u[2 * kMaxK], shortest[2 * kMaxK];
  int rv[2 * kMaxK], SR[2 * kMaxK], pred[2 * kMaxK];
  int row4col[2 * kMaxK], col4row[2 * kMaxK];
  int patterns[kMaxSharedPatterns];
  // reductions
  float red_v[2][kMaxWarps];
  int red_i[2][kMaxWarps];
  int flags[kMaxWarps], warp_total[kMaxWarps];
};

__device__ __forceinline__ void take_min(float& v, int& i, float v2, int i2) {
  if (v2 < v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// The block's least (value, index), lowest index on ties, in every thread.
// Every thread calls it; `parity` alternates the partials' buffer, so one
// barrier a call suffices.
__device__ __forceinline__ void block_argmin(float& v, int& i, Shared& sm, int& parity) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(kFull, v, off);
    const int i2 = __shfl_down_sync(kFull, i, off);
    take_min(v, i, v2, i2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    sm.red_v[parity][warp] = v;
    sm.red_i[parity][warp] = i;
  }
  __syncthreads();
  v = sm.red_v[parity][0];
  i = sm.red_i[parity][0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) take_min(v, i, sm.red_v[parity][w], sm.red_i[parity][w]);
  parity ^= 1;
}

// 0.5 * 2^min(dist - knee, clamp) + 0.5 * angle cost between previous slot
// p of `S` and a current slot (cy, cx) (tracking_device.py:_match_block).
__device__ __forceinline__ float match_cost(const State& S, int p, float cy, float cx,
                                            const Consts& c) {
  const float dy = S.cy[p] - cy;
  const float dx = S.cx[p] - cx;
  const float d = sqrtf(dy * dy + dx * dx);
  const float d_cost = exp2f(fminf(d - c.dist_knee, c.clamp));
  float a_cost = 1.0f;
  if (S.hist[p] > 0) {
    const float old_angle = c.deg * atan2f(S.fcy[p] - S.cy[p], -(S.fcx[p] - S.cx[p]));
    float diff = fabsf(c.deg * atan2f(dy, -dx) - old_angle);
    diff = fminf(diff, 360.0f - diff);
    a_cost = exp2f(fminf(diff - c.angle_knee, c.clamp));
  }
  return 0.5f * d_cost + 0.5f * a_cost;
}

// Cell (i, j) of the padded 2K x 2K cost matrix (tracking_device.py:_cost_matrix).
__device__ __forceinline__ float cost_at(const Shared& sm, int K, int i, int j, const Consts& c) {
  const bool ri = sm.rv[i], rj = sm.rv[j];
  if (i == j) return ri ? c.nonmatch : 0.0f;
  if (!(ri && rj)) return c.big;
  if (i < K && j >= K) return sm.match[i * K + (j - K)];
  return c.filler;
}

__device__ __forceinline__ unsigned pattern_column(unsigned code, int p) {
  return (code >> (3 * p)) & 7u;
}

__global__ void track_scan_kernel(
    const float* st_cy, const float* st_cx, const bool* st_valid, const int* st_hist,
    const float* st_fcy, const float* st_fcx, const int* st_fn,
    const unsigned char* roi, int Hm, int Wm,
    const float* cys, const float* cxs, const bool* valids, const int* fns,
    const bool* active, int T, int K,
    const int* gpatterns, int n_pats, int n_enum, Consts c,
    float* o_cy, float* o_cx, bool* o_valid, int* o_hist, float* o_fcy, float* o_fcx,
    int* o_fn, float* e_fcy, float* e_fcx, float* e_lcy, float* e_lcx, int* e_fn,
    int* e_count, bool* e_overflow, int cap) {
  __shared__ Shared sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NT = blockDim.x, NW = NT >> 5, N = 2 * K;
  int parity = 0, cur = 0;
  if (tid < K) {
    State& S = sm.st[0];
    S.cy[tid] = st_cy[tid];
    S.cx[tid] = st_cx[tid];
    S.valid[tid] = st_valid[tid];
    S.hist[tid] = st_hist[tid];
    S.fcy[tid] = st_fcy[tid];
    S.fcx[tid] = st_fcx[tid];
  }
  if (tid == 0) sm.st[0].fn = st_fn[0];
  if (tid < N) sm.SR[tid] = 0;
  const bool shared_patterns = n_pats <= kMaxSharedPatterns;
  if (shared_patterns)
    for (int q = tid; q < n_pats; q += NT) sm.patterns[q] = gpatterns[q];
  const int* patterns = shared_patterns ? sm.patterns : gpatterns;
  int count = 0;          // the event buffer's count and overflow flag,
  bool overflow = false;  // the same in every thread

  // frame t + 1's inputs, loaded while frame t is solved
  float nx_cy = 0.0f, nx_cx = 0.0f;
  int nx_valid = 0, nx_fn = 0;
  bool nx_act = false;
  if (T > 0) {
    if (tid < K) {
      nx_cy = cys[tid];
      nx_cx = cxs[tid];
      nx_valid = valids[tid];
    }
    nx_fn = fns[0];
    nx_act = active[0];
  }

  for (int t = 0; t < T; ++t) {
    const int fn = nx_fn;
    const bool act = nx_act;
    if (tid < K) {
      sm.f_cy[tid] = nx_cy;
      sm.f_cx[tid] = nx_cx;
      sm.f_valid[tid] = nx_valid;
    }
    if (t + 1 < T) {
      if (tid < K) {
        nx_cy = cys[(t + 1) * K + tid];
        nx_cx = cxs[(t + 1) * K + tid];
        nx_valid = valids[(t + 1) * K + tid];
      }
      nx_fn = fns[t + 1];
      nx_act = active[t + 1];
    }
    __syncthreads();
    if (!act) continue;  // batch padding: no change at all
    const State& S = sm.st[cur];
    State& Nx = sm.st[cur ^ 1];

    // is there work (a live track or a segment), and does it all lie in
    // the first n_enum slots (n_enum is 0 unless 0 < track_enum_lap < K)?
    const bool live = tid < K && (S.valid[tid] || sm.f_valid[tid]);
    const unsigned any_live = __ballot_sync(kFull, live);
    const unsigned far_live = __ballot_sync(kFull, live && tid >= n_enum);
    if (lane == 0) sm.flags[warp] = (any_live != 0u) | ((far_live != 0u) << 1);
    __syncthreads();
    int flags = 0;
    for (int w = 0; w < NW; ++w) flags |= sm.flags[w];

    if (!(flags & 1)) {  // empty-frame fast path: reset the state to the frame
      if (tid < K) {
        Nx.cy[tid] = sm.f_cy[tid];
        Nx.cx[tid] = sm.f_cx[tid];
        Nx.valid[tid] = sm.f_valid[tid];
        Nx.hist[tid] = 0;
        Nx.fcy[tid] = 0.0f;
        Nx.fcx[tid] = 0.0f;
      }
      if (tid == 0) Nx.fn = fn;
      cur ^= 1;
      continue;
    }

    const bool use_enum = n_enum > 0 && !(flags & 2);
    const int M = use_enum ? n_enum : K;
    for (int q = tid; q < M * M; q += NT) {
      const int p = q / M, cc = q - p * M;
      float m = c.big;
      if (S.valid[p] && sm.f_valid[cc]) {
        m = match_cost(S, p, sm.f_cy[cc], sm.f_cx[cc], c);
        if (use_enum) m = m + c.w_offset;
      }
      sm.match[q] = m;
    }
    float v_j = 0.0f;  // column tid's dual
    if (!use_enum && tid < N) {
      const int r = tid < K ? S.valid[tid] : sm.f_valid[tid - K];
      sm.rv[tid] = r;
      sm.row4col[tid] = r ? -1 : tid;  // padding rows sit on their diagonal
      sm.col4row[tid] = r ? -1 : tid;
      sm.u[tid] = 0.0f;
    }
    __syncthreads();

    // prev_match: the current slot matched to previous slot tid (-1 if
    // none); curr_from: the previous slot linked to current slot tid
    int prev_match = -1, curr_from = -1;
    if (use_enum) {
      // every partial matching of the first n slots; the first least score wins
      const int n = n_enum;
      float best = CUDART_INF_F;
      int best_q = 0x7fffffff;
      for (int q = tid; q < n_pats; q += NT) {
        const unsigned code = patterns[q];
        float s = 0.0f;
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          if (p < n) {
            const unsigned col = pattern_column(code, p);
            if (col != kNoColumn) s = s + sm.match[p * n + col];
          }
        }
        if (s < best) {
          best = s;
          best_q = q;
        }
      }
      block_argmin(best, best_q, sm, parity);
      const unsigned code = patterns[best_q];
      if (tid < n) {
        const unsigned col = pattern_column(code, tid);
        prev_match = col == kNoColumn ? -1 : (int)col;
      }
      for (int p = 0; p < n; ++p)
        if (pattern_column(code, p) == (unsigned)tid) curr_from = p;
    } else {
      // Jonker-Volgenant over the valid rows in ascending order
      for (int row = 0; row < N; ++row) {
        if (!sm.rv[row]) continue;
        const int stamp = t * N + row + 1;  // marks the rows this row's search visits
        bool sc = false;
        float sh = CUDART_INF_F;
        int pr = row, i = row, jstar = 0;
        float min_val = 0.0f;
        while (true) {
          if (tid == 0) sm.SR[i] = stamp;
          const float ui = sm.u[i];
          if (tid < N && !sc) {
            const float r = min_val + cost_at(sm, K, i, tid, c) - ui - v_j;
            if (r < sh) {
              sh = r;
              pr = i;
            }
          }
          float mv = (tid < N && !sc) ? sh : CUDART_INF_F;
          int mj = tid;
          block_argmin(mv, mj, sm, parity);
          min_val = mv;
          jstar = mj;
          if (tid == jstar) sc = true;
          const int nxt = sm.row4col[jstar];
          if (nxt < 0) break;  // the sink: the first unassigned column popped
          i = nxt;
        }
        const int my_col = tid < N ? sm.col4row[tid] : 0;
        if (tid < N) {
          sm.shortest[tid] = sh;
          sm.pred[tid] = pr;
        }
        __syncthreads();
        // dual updates in scipy's order, then (thread 0) the augmenting path
        if (tid < N) {
          if (tid == row)
            sm.u[tid] = sm.u[tid] + min_val;
          else if (sm.SR[tid] == stamp)
            sm.u[tid] = sm.u[tid] + min_val - sm.shortest[my_col];
          if (sc) v_j = v_j - (min_val - sh);
        }
        if (tid == 0) {
          int j = jstar;
          while (true) {
            const int ip = sm.pred[j];
            sm.row4col[j] = ip;
            const int jp = sm.col4row[ip];
            sm.col4row[ip] = j;
            j = jp;
            if (ip == row) break;
          }
        }
        __syncthreads();
      }
      if (tid < K) {
        const int mc = sm.col4row[tid] - K;
        if (S.valid[tid] && mc >= 0 && sm.f_valid[mc]) prev_match = mc;
        const int r = sm.row4col[K + tid];
        if (sm.f_valid[tid] && r < K && S.valid[r]) curr_from = r;
      }
    }

    // events: previous slots that disappeared inside the ROI with history,
    // appended at count + their rank in ascending slot order
    bool is_ev = false;
    if (tid < K && S.valid[tid] && prev_match < 0 && S.hist[tid] >= 1) {
      const int iy = min(max((int)S.cy[tid], 0), Hm - 1);
      const int ix = min(max((int)S.cx[tid], 0), Wm - 1);
      is_ev = roi[iy * Wm + ix] == 255;
    }
    const unsigned ballot = __ballot_sync(kFull, is_ev);
    if (lane == 0) sm.warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n_ev = 0;
    for (int w = 0; w < NW; ++w) {
      const int x = sm.warp_total[w];
      if (w < warp) before += x;
      n_ev += x;
    }
    if (is_ev) {
      const int pos = count + before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < cap) {
        const bool h = S.hist[tid] > 0;
        e_fcy[pos] = h ? S.fcy[tid] : S.cy[tid];
        e_fcx[pos] = h ? S.fcx[tid] : S.cx[tid];
        e_lcy[pos] = S.cy[tid];
        e_lcx[pos] = S.cx[tid];
        e_fn[pos] = S.fn;
      }
    }
    overflow = overflow || count + n_ev > cap;
    count = min(count + n_ev, cap);

    // link: the new state from this frame's slots, into the other buffer
    if (tid < K) {
      int new_hist = 0;
      float new_fcy = 0.0f, new_fcx = 0.0f;
      if (curr_from >= 0 && sm.f_valid[tid]) {
        const int p = curr_from, hp = S.hist[p];
        new_hist = hp + 1;
        new_fcy = hp > 0 ? S.fcy[p] : S.cy[p];
        new_fcx = hp > 0 ? S.fcx[p] : S.cx[p];
      }
      Nx.cy[tid] = sm.f_cy[tid];
      Nx.cx[tid] = sm.f_cx[tid];
      Nx.valid[tid] = sm.f_valid[tid];
      Nx.hist[tid] = new_hist;
      Nx.fcy[tid] = new_fcy;
      Nx.fcx[tid] = new_fcx;
    }
    if (tid == 0) Nx.fn = fn;
    cur ^= 1;
    // the next frame's first barrier orders these writes before any read
  }

  __syncthreads();
  const State& S = sm.st[cur];
  if (tid < K) {
    o_cy[tid] = S.cy[tid];
    o_cx[tid] = S.cx[tid];
    o_valid[tid] = S.valid[tid] != 0;
    o_hist[tid] = S.hist[tid];
    o_fcy[tid] = S.fcy[tid];
    o_fcx[tid] = S.fcx[tid];
  }
  if (tid == 0) {
    *o_fn = S.fn;
    *e_count = count;
    *e_overflow = overflow;
  }
}

}  // namespace

// One batch's scan: state in (st_*), T frames of (K,) slots, the new state
// (o_*) and the events (e_*, `cap` slots, zeroed by the caller).  n_enum is
// the enumeration threshold (0 = JV only) and patterns its n_pats partial
// matchings, each packed 3 bits a row (7 = unmatched).  Returns the
// launch's cudaError_t.
extern "C" int swt_track_scan(
    const float* st_cy, const float* st_cx, const bool* st_valid, const int* st_hist,
    const float* st_fcy, const float* st_fcx, const int* st_fn,
    const unsigned char* roi, int Hm, int Wm,
    const float* cys, const float* cxs, const bool* valids, const int* fns,
    const bool* active, int T, int K,
    const int* patterns, int n_pats, int n_enum,
    float dist_knee, float angle_knee, float clamp, float deg, float nonmatch,
    float filler, float w_offset, float big,
    float* o_cy, float* o_cx, bool* o_valid, int* o_hist, float* o_fcy, float* o_fcx,
    int* o_fn, float* e_fcy, float* e_fcx, float* e_lcy, float* e_lcx, int* e_fn,
    int* e_count, bool* e_overflow, int cap, cudaStream_t stream) {
  if (K < 1 || K > kMaxK || T < 0 || n_enum < 0 || n_enum > 6 || n_enum >= K ||
      Hm < 1 || Wm < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{dist_knee, angle_knee, clamp, deg, nonmatch, filler, w_offset, big};
  const int threads = 2 * K <= 64 ? 64 : kMaxThreads;
  track_scan_kernel<<<1, threads, 0, stream>>>(
      st_cy, st_cx, st_valid, st_hist, st_fcy, st_fcx, st_fn, roi, Hm, Wm, cys, cxs, valids,
      fns, active, T, K, patterns, n_pats, n_enum, c, o_cy, o_cx, o_valid, o_hist, o_fcy, o_fcx,
      o_fn, e_fcy, e_fcx, e_lcy, e_lcx, e_fn, e_count, e_overflow, cap);
  return (int)cudaGetLastError();
}
