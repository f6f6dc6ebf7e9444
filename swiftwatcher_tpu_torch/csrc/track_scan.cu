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
// What bounds it: latency along the frame chain.  Each frame's matching
// depends on the track histories the frame before left, and inside a frame
// the LAP is a sequence of Dijkstra steps, each a warp-wide argmin that the
// next step waits for.  Neither the bytes nor the operations come near the
// card's rates: the least time is (frames with work) x (one staged load and
// one ballot) + (Dijkstra steps + enumeration argmins) x (one dependent
// argmin).
//
// Design: two kernels a batch.  Most of a frame's work is not on the chain:
// linking copies the frame's own slots into the state, so the state's
// positions and validity at frame t are the slots of the last active frame
// before t (the incoming state before the first), and only the histories
// (hist, first_cy, first_cx) depend on earlier matchings.
//
//  T1a (track_prologue_kernel), one block a frame, all frames at once: each
//  frame's record (RecordLayout) holds its previous slots' positions, their
//  ROI flags, the K x K distance terms 2^min(|d| - knee, clamp) and current
//  angles deg * atan2(dy, -dx), the frame's kind (inactive, empty, fits the
//  enumeration, needs JV), both validity masks, and the next frame with
//  work.  The transcendentals of the match block are all here.
//
//  T1b (track_chain_kernel), ONE warp, no __syncthreads: it visits only
//  frames with work, jumping over inactive and empty ones (an empty frame
//  resets the state to itself, so a stretch of them is the reset of its last
//  active frame), and one lane has the bulk copy engine bring the next work
//  frame's record into shared memory (cp.async.bulk on an mbarrier) while
//  the warp solves this one.  Lane l owns LAP columns and rows l + 32 k (the
//  kernel is built for 1-4 of them a lane, so K = 24 does no work for a
//  third or fourth): their shortest path, predecessor, open flag, dual v_j
//  and the row that holds them stay in registers; the histories, row duals
//  and assignments live in shared memory behind __syncwarp.  Per frame it
//  computes only what depends on the chain: one atan2 per row with history
//  (its old angle) and the angle term 2^min(diff - knee, clamp) of those
//  rows' cells, four rows' cells overlapping.  A Dijkstra step relaxes the
//  lane's columns with selects (no branch) and takes one warp argmin
//  (warp_argmin.cuh: two __reduce_min_sync, at about a third of an
//  xor-butterfly's latency; t1_latency.cu times both); the next row and
//  its dual come from the winning lane by shuffle.  The enumeration scores a
//  compile-time number of patterns a lane (the table padded to a multiple
//  of 32 with patterns that score +inf).  Lane 0 walks the augmenting path.
//
//  What remains is the chain itself: on dense frames T1b spends most of
//  its time in Dijkstra steps, each a dependent sequence of one shared
//  load, the relaxation, two reductions and two shuffles
//  (tools/time_kernels.py --t1-split gives the split).
//
// Exactness: every argmin takes the lowest index on ties (as jnp/torch
// argmin do), and every float expression keeps the plain version's
// operations and order (the build uses -fmad=false and no fast math): the
// reduced cost is ((min_val + cost) - u_i) - v_j, the duals are updated in
// scipy's order, and an enumeration score is summed over its rows in
// order, an unmatched row adding 0 as in the plain version.  No value that
// reaches a comparison is -0.0 or NaN (all start at +0 or a positive cost
// and only add and subtract), so the integer key orders them as float `<`
// does.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "warp_argmin.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 64;
constexpr int kMaxSlots = kMaxK / 32;     // slots a lane owns
constexpr unsigned kNoColumn = 7u;        // a pattern row left unmatched
constexpr unsigned kPadColumn = 6u;       // padding patterns: row 0 here scores +inf
// Rows of 32 that the padded pattern table of n fills (tracking_device.py:
// _pattern_table has 2, 7, 34, 209, 1546 and 13327 patterns for n = 1..6).
__host__ __device__ constexpr int pattern_rounds(int n) {
  return n == 1 ? 1 : n == 2 ? 1 : n == 3 ? 2 : n == 4 ? 7 : n == 5 ? 49 : n == 6 ? 417 : 0;
}
constexpr int kPrologueThreads = 128;

enum Kind { kInactive = 0, kEmpty = 1, kEnum = 2, kJv = 3 };

// Per-launch counts, and (built with -DT1_SPLIT) T1b's cycles per phase.
enum Stat {
  kWorkFrames, kEnumFrames, kJvFrames, kJvRows, kSteps, kEmptyFrames, kInactiveFrames, kEvents,
  kCycTop, kCycMatch, kCycEnum, kCycJv, kCycJvRows, kCycEvents, kCycLink, kCycTotal, kNumStats
};
#ifdef T1_SPLIT
#define STAMP(slot)                                    \
  do {                                                 \
    const long long now_ = clock64();                  \
    if (lane == 0) cyc[slot - kCycTop] += now_ - t_;   \
    t_ = now_;                                         \
  } while (0)
#else
#define STAMP(slot) \
  do {              \
  } while (0)
#endif

struct Consts {
  float dist_knee, angle_knee, clamp, deg, nonmatch, filler, w_offset, big;
};

// One frame's record, in 32-bit words; tracking_device.py:_record_words
// and track_prologue read the same layout.
struct RecordLayout {
  int K;
  static constexpr int kHeader = 8;  // kind, next, src, prev_fn, prev mask, valid mask
  __host__ __device__ int pcy() const { return kHeader; }
  __host__ __device__ int pcx() const { return kHeader + K; }
  __host__ __device__ int roi() const { return kHeader + 2 * K; }  // K bytes
  __host__ __device__ int dist() const { return roi() + (K + 3) / 4; }
  __host__ __device__ int angle() const { return dist() + K * K; }
  __host__ __device__ int words() const { return (angle() + K * K + 3) / 4 * 4; }
};

// T1b's dynamic shared memory, in 32-bit words.
struct ChainLayout {
  int K, R, n_shared_patterns;
  // two mbarriers (4 words), then the two record buffers
  __host__ __device__ int rec(int b) const { return 4 + b * R; }
  __host__ __device__ int match() const { return rec(2); }
  __host__ __device__ int u() const { return match() + K * K; }
  __host__ __device__ int shortest() const { return u() + 2 * K; }
  __host__ __device__ int pred() const { return shortest() + 2 * K; }
  __host__ __device__ int row4col() const { return pred() + 2 * K; }
  __host__ __device__ int col4row() const { return row4col() + 2 * K; }
  __host__ __device__ int hist(int b) const { return col4row() + 2 * K + b * K; }
  __host__ __device__ int fcy(int b) const { return hist(2) + b * K; }
  __host__ __device__ int fcx(int b) const { return fcy(2) + b * K; }
  __host__ __device__ int old_angle() const { return fcx(2); }
  __host__ __device__ int weights() const { return old_angle() + K; }  // n x 8, n <= 6
  __host__ __device__ int patterns() const { return weights() + 48; }
  __host__ __device__ int words() const { return patterns() + n_shared_patterns; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One lane copies `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory with the bulk copy engine; the
// mbarrier completes when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  // the warp's reads of the buffer's last contents come before the copy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Wait until the mbarrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ unsigned pattern_column(unsigned code, int p) {
  return (code >> (3 * p)) & 7u;
}

__device__ __forceinline__ bool bit(uint64_t mask, int i) { return (mask >> i) & 1u; }

// T1a: frame t's record (see RecordLayout), one block per frame.
__global__ void __launch_bounds__(kPrologueThreads) track_prologue_kernel(
    const float* st_cy, const float* st_cx, const bool* st_valid, const int* st_fn,
    const unsigned char* roi, int Hm, int Wm,
    const float* cys, const float* cxs, const bool* valids, const int* fns,
    const bool* active, int T, int K, int n_enum, Consts c, int* records,
    long long* stats) {
  __shared__ float s_pcy[kMaxK], s_pcx[kMaxK], s_cy[kMaxK], s_cx[kMaxK];
  __shared__ int s_src;
  const int t = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const RecordLayout L{K};
  int* rec = records + (size_t)t * L.words();
  float* frec = reinterpret_cast<float*>(rec);

  // src: the last active frame before t (-1: the incoming state)
  if (tid == 0) s_src = -1;
  __syncthreads();
  for (int base = t - 1; base >= 0; base -= kPrologueThreads) {
    const int f = base - tid;
    const bool a = f >= 0 && active[f];
    if (a) atomicMax(&s_src, f);
    if (__syncthreads_or(a)) break;
  }
  const int src = s_src;
  const float* pcy = src >= 0 ? cys + (size_t)src * K : st_cy;
  const float* pcx = src >= 0 ? cxs + (size_t)src * K : st_cx;
  for (int p = tid; p < K; p += kPrologueThreads) {
    const float y = pcy[p], x = pcx[p];
    s_pcy[p] = y;
    s_pcx[p] = x;
    s_cy[p] = cys[(size_t)t * K + p];
    s_cx[p] = cxs[(size_t)t * K + p];
    frec[L.pcy() + p] = y;
    frec[L.pcx() + p] = x;
    const int iy = min(max((int)y, 0), Hm - 1);
    const int ix = min(max((int)x, 0), Wm - 1);
    reinterpret_cast<unsigned char*>(rec + L.roi())[p] = roi[iy * Wm + ix] == 255;
  }
  __syncthreads();

  // the match block's chain-free terms, in _match_block's operations
  for (int q = tid; q < K * K; q += kPrologueThreads) {
    const int p = q / K, cc = q - p * K;
    const float dy = s_pcy[p] - s_cy[cc];
    const float dx = s_pcx[p] - s_cx[cc];
    const float d = sqrtf(dy * dy + dx * dx);
    frec[L.dist() + q] = exp2f(fminf(d - c.dist_knee, c.clamp));
    frec[L.angle() + q] = c.deg * atan2f(dy, -dx);
  }

  if (tid >= 32) return;
  // warp 0: masks, kind, and the next frame with work
  const bool* pv_src = src >= 0 ? valids + (size_t)src * K : st_valid;
  const bool* cv_src = valids + (size_t)t * K;
  uint64_t pv = 0, cv = 0;
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s) {
    const int p = lane + 32 * s;
    pv |= (uint64_t)__ballot_sync(kFull, p < K && pv_src[p]) << (32 * s);
    cv |= (uint64_t)__ballot_sync(kFull, p < K && cv_src[p]) << (32 * s);
  }
  const bool act = active[t];
  const uint64_t live = pv | cv;
  const int kind = !act ? kInactive
                   : live == 0 ? kEmpty
                   : (n_enum > 0 && (live >> n_enum) == 0) ? kEnum
                                                           : kJv;
  // frame f > t has work if it is active and it or the last active frame
  // before it has a valid slot; `carry` is that frame's flag for the frames
  // after t until an active one
  bool carry = act ? cv != 0 : pv != 0;
  int next = T;
  for (int base = t + 1; base < T; base += 32) {
    const int f = base + lane;
    bool a = false, any = false;
    if (f < T) {
      a = active[f];
      const bool* v = valids + (size_t)f * K;
#pragma unroll 8
      for (int k = 0; k < K; ++k) any |= v[k];
    }
    const unsigned am = __ballot_sync(kFull, a), vm = __ballot_sync(kFull, any);
    const unsigned below = am & ((1u << lane) - 1u);
    const bool prev_any = below ? (vm >> (31 - __clz(below))) & 1u : carry;
    const unsigned wm = __ballot_sync(kFull, a && (any || prev_any));
    if (wm) {
      next = base + __ffs(wm) - 1;
      break;
    }
    if (am) carry = (vm >> (31 - __clz(am))) & 1u;
  }
  if (lane == 0) {
    rec[0] = kind;
    rec[1] = next;
    rec[2] = src;
    rec[3] = src >= 0 ? fns[src] : st_fn[0];
    rec[4] = (int)(uint32_t)pv;
    rec[5] = (int)(uint32_t)(pv >> 32);
    rec[6] = (int)(uint32_t)cv;
    rec[7] = (int)(uint32_t)(cv >> 32);
    // after the last record: the last active frame (-1 if none)
    if (t == T - 1) records[(size_t)T * L.words()] = act ? t : src;
    if (stats && kind == kEmpty) atomicAdd((unsigned long long*)&stats[kEmptyFrames], 1ull);
    if (stats && kind == kInactive) atomicAdd((unsigned long long*)&stats[kInactiveFrames], 1ull);
  }
}

// The enumeration's least (score, pattern) in this lane, over patterns
// lane, lane + 32, ... of the padded table: a score is the sum over the N
// rows, in row order, of w(p, col), col 7 (row left unmatched) adding 0.
template <int N, bool kSharedPatterns>
__device__ __forceinline__ void enumerate(const int* pats, const float* wgt, int lane,
                                          float& best, int& best_q) {
#pragma unroll 8
  for (int m = 0; m < pattern_rounds(N); ++m) {
    const int q = lane + 32 * m;
    const unsigned code = kSharedPatterns ? (unsigned)pats[q] : (unsigned)__ldg(pats + q);
    float s = 0.0f;
#pragma unroll
    for (int p = 0; p < N; ++p) s = s + wgt[p * 8 + pattern_column(code, p)];
    const bool better = s < best;
    best = better ? s : best;
    best_q = better ? q : best_q;
  }
}

// T1b: the frame chain in one warp; lane l owns LAP columns (and rows)
// l + 32 k, k < NC = ceil(2K / 32), and slots l + 32 s, s < NS.
template <int NC>
__global__ void __launch_bounds__(32, 1) track_chain_kernel(
    const int* records, int T, int K,
    const float* st_cy, const float* st_cx, const bool* st_valid, const int* st_hist,
    const float* st_fcy, const float* st_fcx, const int* st_fn,
    const float* cys, const float* cxs, const bool* valids, const int* fns,
    const int* gpatterns, int n_pats, int n_enum, Consts c,
    float* o_cy, float* o_cx, bool* o_valid, int* o_hist, float* o_fcy, float* o_fcx,
    int* o_fn, float* e_fcy, float* e_fcx, float* e_lcy, float* e_lcx, int* e_fn,
    int* e_count, bool* e_overflow, int cap, long long* stats) {
  constexpr int NS = (NC + 1) / 2;
  extern __shared__ __align__(16) int smem[];
  const int lane = threadIdx.x, N = 2 * K;
  const RecordLayout RL{K};
  const int R = RL.words();
  const ChainLayout CL{K, R, n_enum <= 5 ? n_pats : 0};
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // one mbarrier per record buffer
  float* fsm = reinterpret_cast<float*>(smem);
  float* match = fsm + CL.match();
  float* u = fsm + CL.u();
  float* shortest = fsm + CL.shortest();
  int* pred = smem + CL.pred();
  int* row4col = smem + CL.row4col();
  int* col4row = smem + CL.col4row();
  float* old_angle = fsm + CL.old_angle();
  float* wgt = fsm + CL.weights();
  const float big = c.big, filler = c.filler, nonmatch = c.nonmatch;
  long long cnt[kCycTop] = {0}, cyc[kNumStats - kCycTop] = {0};
  const long long t_start = clock64();
  long long t_ = t_start;

  for (int p = lane; p < K; p += 32) {
    smem[CL.hist(0) + p] = st_hist[p];
    fsm[CL.fcy(0) + p] = st_fcy[p];
    fsm[CL.fcx(0) + p] = st_fcx[p];
  }
  if (n_enum <= 5)
    for (int q = lane; q < n_pats; q += 32) smem[CL.patterns() + q] = gpatterns[q];
  if (lane == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    fence_mbar_init();
  }
  __syncwarp();

  // the first frame with work
  int w = T;
  if (T > 0) w = records[0] >= kEnum ? 0 : records[1];
  if (w < T && lane == 0)
    bulk_load(smem + CL.rec(0), records + (size_t)w * R, 4u * R, &bars[0]);
  int buf = 0, cur = 0, last_work = -1, count = 0;
  unsigned phases = 0;  // bit b: the parity the next wait on buffer b waits for
  bool overflow = false;

  while (w < T) {
    mbar_wait(&bars[buf], (phases >> buf) & 1u);
    phases ^= 1u << buf;
    const int* rec = smem + CL.rec(buf);
    const float* frec = fsm + CL.rec(buf);
    const int kind = rec[0], wn = rec[1], prev_fn = rec[3];
    const uint64_t pv = (uint32_t)rec[4] | ((uint64_t)(uint32_t)rec[5] << 32);
    const uint64_t cv = (uint32_t)rec[6] | ((uint64_t)(uint32_t)rec[7] << 32);
    if (wn < T && lane == 0)  // every lane left the other buffer at the last frame's end
      bulk_load(smem + CL.rec(buf ^ 1), records + (size_t)wn * R, 4u * R, &bars[buf ^ 1]);
    const float* pcy = frec + RL.pcy();
    const float* pcx = frec + RL.pcx();
    const unsigned char* in_roi = reinterpret_cast<const unsigned char*>(rec + RL.roi());
    const float* dist = frec + RL.dist();
    const float* angle = frec + RL.angle();
    const int* H = smem + CL.hist(cur);
    const float* FY = fsm + CL.fcy(cur);
    const float* FX = fsm + CL.fcx(cur);
    cnt[kWorkFrames]++;

    STAMP(kCycTop);

    // the old angle of a row with history (0 without): the one atan2 on
    // the chain
    auto row_angle = [&](int p) {
      return H[p] > 0 ? c.deg * atan2f(FY[p] - pcy[p], -(FX[p] - pcx[p])) : 0.0f;
    };
    // match cell (p, cc), q = p * K + cc (tracking_device.py:_match_block),
    // without a branch, so that the cells a lane computes overlap
    auto cell = [&](int p, int q, float old) {
      float diff = fabsf(angle[q] - old);
      diff = fminf(diff, 360.0f - diff);
      const float a_cost = exp2f(fminf(diff - c.angle_knee, c.clamp));
      return 0.5f * dist[q] + 0.5f * (H[p] > 0 ? a_cost : 1.0f);
    };

    // prev_match[s]: the current slot matched to previous slot lane + 32 s
    // (-1 if none); curr_from[s]: the previous slot linked to current slot
    // lane + 32 s
    int prev_match[NS], curr_from[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) prev_match[s] = curr_from[s] = -1;
    if (kind == kEnum) {
      // weights w(p, col) at p * 8 + col; column 7, a row left unmatched,
      // adds 0 (as the plain version's terms do); (0, 6) is +inf, the
      // padding patterns' column
      const int n = n_enum;
      for (int q = lane; q < 8 * n; q += 32) {
        const int p = q >> 3, cc = q & 7;
        const float m = cell(p, cc < n ? p * K + cc : 0, row_angle(p)) + c.w_offset;
        wgt[q] = q == (int)kPadColumn ? CUDART_INF_F
                 : cc >= n            ? 0.0f
                 : bit(pv, p) && bit(cv, cc) ? m
                                             : big;
      }
      __syncwarp();
      STAMP(kCycMatch);
      // every partial matching of the first n slots; the first least score wins
      float best = CUDART_INF_F;
      int best_q = lane;
      const int* spat = smem + CL.patterns();
      switch (n) {
        case 1: enumerate<1, true>(spat, wgt, lane, best, best_q); break;
        case 2: enumerate<2, true>(spat, wgt, lane, best, best_q); break;
        case 3: enumerate<3, true>(spat, wgt, lane, best, best_q); break;
        case 4: enumerate<4, true>(spat, wgt, lane, best, best_q); break;
        case 5: enumerate<5, true>(spat, wgt, lane, best, best_q); break;
        default: enumerate<6, false>(gpatterns, wgt, lane, best, best_q); break;
      }
      warp_argmin(best, best_q);
      const unsigned code = n <= 5 ? (unsigned)spat[best_q] : (unsigned)__ldg(gpatterns + best_q);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int j = lane + 32 * s;
        if (j < n) {
          const unsigned col = pattern_column(code, j);
          prev_match[s] = col == kNoColumn ? -1 : (int)col;
        }
        for (int p = 0; p < n; ++p)
          if (pattern_column(code, p) == (unsigned)j) curr_from[s] = p;
      }
      cnt[kEnumFrames]++;
      STAMP(kCycEnum);
    } else {
      // Jonker-Volgenant over the valid rows in ascending order.  Row or
      // column i < K is previous slot i, K + cc current slot cc; padding
      // rows sit on their diagonal.
      auto valid_at = [&](int i) { return i < K ? bit(pv, i) : bit(cv, i - K); };
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (lane + 32 * s < K) old_angle[lane + 32 * s] = row_angle(lane + 32 * s);
      float v[NC];
      bool col_valid[NC], is_cur[NC];
      int moff[NC];
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int j = lane + 32 * k;
        v[k] = 0.0f;
        col_valid[k] = j < N && valid_at(j);
        is_cur[k] = j >= K && j < N;
        moff[k] = is_cur[k] ? j - K : 0;
        if (j < N) {
          row4col[j] = col_valid[k] ? -1 : j;
          col4row[j] = col_valid[k] ? -1 : j;
          u[j] = 0.0f;
        }
      }
      __syncwarp();  // the old angles
      // the match block's valid cells, lane l computing current slots l
      // and l + 32, four valid rows at a time with every load before any
      // store, so that their chains overlap
      for (uint64_t rows = pv; rows;) {
        int p[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          p[d] = rows ? __ffsll((long long)rows) - 1 : -1;
          rows &= rows - 1;
        }
        float m[4][NS];
        bool ok[4][NS];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int cc = lane + 32 * s;
            ok[d][s] = (p[d] >= 0) & (cc < K) & bit(cv, cc & 63);
            const int pp = ok[d][s] ? p[d] : 0;
            m[d][s] = cell(pp, ok[d][s] ? pp * K + cc : 0, old_angle[pp]);
          }
        }
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int s = 0; s < NS; ++s)
            if (ok[d][s]) match[p[d] * K + lane + 32 * s] = m[d][s];
      }
      __syncwarp();
      STAMP(kCycMatch);
      for (int half = 0; half < 2; ++half) {
        for (uint64_t rows = half ? cv : pv; rows; rows &= rows - 1) {
          const int row = half * K + __ffsll((long long)rows) - 1;
          // per owned column: shortest path, predecessor, still open (not
          // scanned), and the row that holds it with that row's validity
          // (bit 8) and dual: fixed while this row searches, so a step
          // takes them from the winning lane by shuffle
          float sh[NC], u_hold[NC];
          int pr[NC], hold[NC];
          bool open[NC], seen[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int j = lane + 32 * k;
            sh[k] = CUDART_INF_F;
            pr[k] = row;
            open[k] = j < N;
            seen[k] = false;
            const int r = j < N ? row4col[j] : -1;
            hold[k] = r < 0 ? -1 : r | ((int)valid_at(r) << 8);
            u_hold[k] = u[r < 0 ? 0 : r];
          }
          float min_val = 0.0f, ui = u[row];
          int i = row, jstar = 0;
          bool ri = true;
          while (true) {
            const bool i_prev = i < K;
            const float* mrow = match + (i_prev ? i : 0) * K;
            float bv = CUDART_INF_F, bu = u_hold[0];
            int bj = lane, bh = hold[0];
#pragma unroll
            for (int k = 0; k < NC; ++k) {
              const int j = lane + 32 * k;
              seen[k] = seen[k] || j == i;
              const float m = mrow[moff[k]];
              float cost = i_prev && is_cur[k] ? m : filler;
              cost = ri && col_valid[k] ? cost : big;
              cost = j == i ? (ri ? nonmatch : 0.0f) : cost;
              const float r = min_val + cost - ui - v[k];
              const bool relax = open[k] && r < sh[k];
              sh[k] = relax ? r : sh[k];
              pr[k] = relax ? i : pr[k];
              const bool better = open[k] && sh[k] < bv;
              bv = better ? sh[k] : bv;
              bj = better ? j : bj;
              bh = better ? hold[k] : bh;
              bu = better ? u_hold[k] : bu;
            }
            warp_argmin(bv, bj);
            // the lane that owns column bj held it, and what rides with it
            const int nxt = __shfl_sync(kFull, bh, bj & 31);
            ui = __shfl_sync(kFull, bu, bj & 31);
            cnt[kSteps]++;
            min_val = bv;
            jstar = bj;
#pragma unroll
            for (int k = 0; k < NC; ++k) open[k] = open[k] && lane + 32 * k != jstar;
            if (nxt < 0) break;  // the sink: the first unassigned column popped
            i = nxt & 0xff;
            ri = nxt >> 8;
          }
          STAMP(kCycJv);
          // each visited row's column, read before lane 0's augmenting
          // path rewrites the assignment
          int held[NC];
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int j = lane + 32 * k;
            if (j < N) {
              shortest[j] = sh[k];
              pred[j] = pr[k];
            }
            held[k] = seen[k] && j != row ? col4row[j] : 0;
          }
          __syncwarp();
          // dual updates in scipy's order, then (lane 0) the augmenting path
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const int j = lane + 32 * k;
            if (j == row)
              u[j] = u[j] + min_val;
            else if (seen[k])
              u[j] = u[j] + min_val - shortest[held[k]];
            if (j < N && !open[k]) v[k] = v[k] - (min_val - sh[k]);
          }
          if (lane == 0) {
            int j = jstar;
            while (true) {
              const int ip = pred[j];
              row4col[j] = ip;
              const int jp = col4row[ip];
              col4row[ip] = j;
              j = jp;
              if (ip == row) break;
            }
          }
          __syncwarp();
          cnt[kJvRows]++;
          STAMP(kCycJvRows);
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int p = lane + 32 * s;
        if (p < K) {
          const int mc = col4row[p] - K;
          if (bit(pv, p) && mc >= 0 && bit(cv, mc)) prev_match[s] = mc;
          const int r = row4col[K + p];
          if (bit(cv, p) && r < K && bit(pv, r)) curr_from[s] = r;
        }
      }
      cnt[kJvFrames]++;
      STAMP(kCycJv);
    }

    // events: previous slots that disappeared inside the ROI with history,
    // appended at count + their rank in ascending slot order
    int n_ev = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int p = lane + 32 * s;
      const bool is_ev = p < K && bit(pv, p) && prev_match[s] < 0 && H[p] >= 1 && in_roi[p];
      const unsigned ballot = __ballot_sync(kFull, is_ev);
      if (is_ev) {
        const int pos = count + n_ev + __popc(ballot & ((1u << lane) - 1u));
        if (pos < cap) {
          const bool h = H[p] > 0;
          e_fcy[pos] = h ? FY[p] : pcy[p];
          e_fcx[pos] = h ? FX[p] : pcx[p];
          e_lcy[pos] = pcy[p];
          e_lcx[pos] = pcx[p];
          e_fn[pos] = prev_fn;
        }
      }
      n_ev += __popc(ballot);
    }
    overflow = overflow || count + n_ev > cap;
    count = min(count + n_ev, cap);
    cnt[kEvents] += n_ev;
    STAMP(kCycEvents);

    // link: the new histories from this frame's matching, into the other
    // buffer (positions and validity are the next record's)
    int* Hn = smem + CL.hist(cur ^ 1);
    float* FYn = fsm + CL.fcy(cur ^ 1);
    float* FXn = fsm + CL.fcx(cur ^ 1);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int cc = lane + 32 * s;
      if (cc < K) {
        int new_hist = 0;
        float new_fcy = 0.0f, new_fcx = 0.0f;
        if (curr_from[s] >= 0 && bit(cv, cc)) {
          const int p = curr_from[s], hp = H[p];
          new_hist = hp + 1;
          new_fcy = hp > 0 ? FY[p] : pcy[p];
          new_fcx = hp > 0 ? FX[p] : pcx[p];
        }
        Hn[cc] = new_hist;
        FYn[cc] = new_fcy;
        FXn[cc] = new_fcx;
      }
    }
    cur ^= 1;
    buf ^= 1;
    last_work = w;
    w = wn;
    __syncwarp();  // before the next frame reads these and refills this record's buffer
    STAMP(kCycLink);
  }

  // the state after the last active frame: its slots, and the histories
  // the chain left if it was a frame with work (an empty one resets them)
  const int last = T > 0 ? records[(size_t)T * R] : -1;
  const bool chain = last == last_work;
  for (int p = lane; p < K; p += 32) {
    o_cy[p] = last >= 0 ? cys[(size_t)last * K + p] : st_cy[p];
    o_cx[p] = last >= 0 ? cxs[(size_t)last * K + p] : st_cx[p];
    o_valid[p] = last >= 0 ? valids[(size_t)last * K + p] : st_valid[p];
    o_hist[p] = chain ? smem[CL.hist(cur) + p] : 0;
    o_fcy[p] = chain ? fsm[CL.fcy(cur) + p] : 0.0f;
    o_fcx[p] = chain ? fsm[CL.fcx(cur) + p] : 0.0f;
  }
  if (lane == 0) {
    *o_fn = last >= 0 ? fns[last] : st_fn[0];
    *e_count = count;
    *e_overflow = overflow;
    if (stats) {
      cyc[kCycTotal - kCycTop] = clock64() - t_start;
      for (int q = 0; q < kCycTop; ++q)
        if (q != kEmptyFrames && q != kInactiveFrames) stats[q] = cnt[q];
      for (int q = kCycTop; q < kNumStats; ++q) stats[q] = cyc[q - kCycTop];
    }
  }
}

}  // namespace

// One batch's scan: state in (st_*), T frames of (K,) slots, the new state
// (o_*) and the events (e_*, `cap` slots, zeroed by the caller).  n_enum is
// the enumeration threshold (0 = JV only) and patterns its n_pats partial
// matchings, each packed 3 bits a row (7 = unmatched).  `records` is
// scratch of T * _record_words(K) + 4 int32s, 16-byte aligned.  With
// prologue_only, only T1a runs (the records are the result).  `stats`
// (kNumStats int64s, zeroed, or null) receives the counts.  `*launched`
// (host memory) is raised by one for each kernel launched.  Returns the
// first launch's cudaError_t that is not cudaSuccess.
extern "C" int swt_track_scan(
    const float* st_cy, const float* st_cx, const bool* st_valid, const int* st_hist,
    const float* st_fcy, const float* st_fcx, const int* st_fn,
    const unsigned char* roi, int Hm, int Wm,
    const float* cys, const float* cxs, const bool* valids, const int* fns,
    const bool* active, int T, int K,
    const int* patterns, int n_pats, int n_enum,
    float dist_knee, float angle_knee, float clamp, float deg, float nonmatch,
    float filler, float w_offset, float big, int* records, int prologue_only,
    float* o_cy, float* o_cx, bool* o_valid, int* o_hist, float* o_fcy, float* o_fcx,
    int* o_fn, float* e_fcy, float* e_fcx, float* e_lcy, float* e_lcx, int* e_fn,
    int* e_count, bool* e_overflow, int cap, long long* stats, int* launched,
    cudaStream_t stream) {
  if (K < 1 || K > kMaxK || T < 0 || n_enum < 0 || n_enum > 6 || n_enum >= K ||
      (n_enum > 0 && n_pats != 32 * pattern_rounds(n_enum)) || Hm < 1 || Wm < 1 ||
      (reinterpret_cast<uintptr_t>(records) & 15))
    return (int)cudaErrorInvalidValue;
  const Consts c{dist_knee, angle_knee, clamp, deg, nonmatch, filler, w_offset, big};
  if (T > 0) {
    track_prologue_kernel<<<T, kPrologueThreads, 0, stream>>>(
        st_cy, st_cx, st_valid, st_fn, roi, Hm, Wm, cys, cxs, valids, fns, active, T, K,
        n_enum, c, records, stats);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  if (prologue_only) return (int)cudaSuccess;
  const RecordLayout RL{K};
  const ChainLayout CL{K, RL.words(), n_enum <= 5 ? n_pats : 0};
  const size_t smem = (size_t)CL.words() * sizeof(int);
  const int nc = (2 * K + 31) / 32;
  auto chain = nc == 1 ? track_chain_kernel<1> : nc == 2 ? track_chain_kernel<2>
             : nc == 3 ? track_chain_kernel<3> : track_chain_kernel<4>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(chain, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  chain<<<1, 32, smem, stream>>>(
      records, T, K, st_cy, st_cx, st_valid, st_hist, st_fcy, st_fcx, st_fn, cys, cxs, valids,
      fns, patterns, n_pats, n_enum, c, o_cy, o_cx, o_valid, o_hist, o_fcy, o_fcx, o_fn,
      e_fcy, e_fcx, e_lcy, e_lcx, e_fn, e_count, e_overflow, cap, stats);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}
