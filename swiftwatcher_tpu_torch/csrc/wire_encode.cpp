// Host encoders of the wire codec (io/wirecodec.py), off the GIL.
//
// The port's copy of the delta4 and delta6 encoders of native/framepump.cpp,
// in a library of their own: that file links libjpeg, which a host may lack,
// and these need nothing but the C++ standard library.  The output is
// byte for byte that of the numpy encoders in io/wirecodec.py.
//
// Build: g++ -O3 -march=native -shared -fPIC wire_encode.cpp -o libwire_encode.so -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// delta4 wire-codec encoder (io/wirecodec.py's hot loop, off the GIL).
//
// gray: (n, p) uint8 frames, flattened window batch.  Residual stream is
// r[f] = gray[f + p] - gray[f] (uint8 wraparound) for f in [0, (n-1)*p);
// nibble = min((r + 7) mod 256, 15), escapes (nibble 15) carry r in a sparse
// (index, value) side stream.  Byte k of `packed` holds nibbles 2k | 2k+1<<4
// — bit-identical to the numpy encoder, threads partitioned on byte ranges
// so frame boundaries need no alignment.
// Returns the escape count, or -1 when it exceeds escape_cap (caller ships
// the batch raw).  esc_idx is padded with m = (n-1)*p (out-of-range =>
// dropped by the device scatter).
// ---------------------------------------------------------------------------
int64_t swt_encode_delta4(const uint8_t* gray, int64_t n, int64_t p,
                          uint8_t* packed, int32_t* esc_idx, uint8_t* esc_val,
                          int64_t escape_cap, int n_threads) {
  const int64_t m = (n - 1) * p;          // residual count
  if (m <= 0) return -1;
  const int64_t n_bytes = (m + 1) / 2;
  n_threads = std::max(1, std::min<int>(n_threads, 16));
  const int64_t per = (n_bytes + n_threads - 1) / n_threads;

  std::vector<std::vector<int32_t>> t_idx(n_threads);
  std::vector<std::vector<uint8_t>> t_val(n_threads);
  auto work = [&](int t) {
    const int64_t lo = t * per, hi = std::min(n_bytes, lo + per);
    auto& idx = t_idx[t];
    auto& val = t_val[t];
    for (int64_t k = lo; k < hi; ++k) {
      uint8_t nib[2] = {0, 0};
      for (int half = 0; half < 2; ++half) {
        const int64_t f = 2 * k + half;
        if (f >= m) break;                 // odd-m pad nibble stays 0
        const uint8_t r =
            static_cast<uint8_t>(gray[f + p] - gray[f]);  // wraparound
        const uint8_t biased = static_cast<uint8_t>(r + 7);
        if (biased > 14) {
          nib[half] = 15;
          idx.push_back(static_cast<int32_t>(f));
          val.push_back(r);
        } else {
          nib[half] = biased;
        }
      }
      packed[k] = static_cast<uint8_t>(nib[0] | (nib[1] << 4));
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(work, t);
    for (auto& th : pool) th.join();
  }

  int64_t total = 0;
  for (auto& v : t_idx) total += static_cast<int64_t>(v.size());
  if (total > escape_cap) return -1;
  int64_t at = 0;                          // threads cover ascending ranges,
  for (int t = 0; t < n_threads; ++t) {    // so concatenation keeps the
    for (size_t i = 0; i < t_idx[t].size(); ++i) {  // numpy row-major order
      esc_idx[at] = t_idx[t][i];
      esc_val[at] = t_val[t][i];
      ++at;
    }
  }
  for (int64_t i = total; i < escape_cap; ++i) {
    esc_idx[i] = static_cast<int32_t>(m);
    esc_val[i] = 0;
  }
  return total;
}

// ---------------------------------------------------------------------------
// delta6 encoder (wire codec v2) — threaded C twin of
// io/wirecodec.py:encode_delta6, bit-identical.
//
// gray: n contiguous frames of p uint8 pixels.  Chooses the cheaper of two
// predictors unless force_mode >= 0 (0 = per-pixel rounded batch mean,
// 1 = previous frame), emits 3 base-6 digits per level-1 byte (escape = 5),
// a dense nibble stream for escaped residuals in [-7, 7] (nibble 15 =
// level-3 escape), and a sparse (flat index, byte) level-3 stream.
// Returns 0 on success; -1 on level-3 overflow (caller ships raw);
// -2 when (n1+1)/2 exceeds lvl2_cap.  n1/n3 counts come back via out-params.
int swt_encode_delta6(const uint8_t* gray, int64_t n, int64_t p,
                      int force_mode, uint8_t* mode_out, uint8_t* bg,
                      uint8_t* lvl1, uint8_t* lvl2, int64_t lvl2_cap,
                      int64_t* n1_out, int32_t* esc_idx, uint8_t* esc_val,
                      int64_t escape_cap, int64_t* n3_out, int n_threads) {
  if (n <= 0 || p <= 0) return -1;
  const int64_t m = n * p;
  const int64_t pp3 = (p + 2) / 3;
  n_threads = std::max(1, std::min<int>(n_threads, 16));

  // Phase 1 (pixel stripes): batch-mean background + per-mode escape-byte
  // costs (cost = n1 + 10*n3, the numpy twin's formula).
  const int64_t stripe = (p + n_threads - 1) / n_threads;
  std::vector<int64_t> c_mean(n_threads, 0), c_prev(n_threads, 0);
  auto phase1 = [&](int t) {
    const int64_t lo = t * stripe, hi = std::min(p, lo + stripe);
    if (lo >= hi) return;
    std::vector<uint32_t> acc(hi - lo, 0);
    for (int64_t f = 0; f < n; ++f) {
      const uint8_t* x = gray + f * p;
      for (int64_t i = lo; i < hi; ++i) acc[i - lo] += x[i];
    }
    for (int64_t i = lo; i < hi; ++i)
      bg[i] = static_cast<uint8_t>((acc[i - lo] + n / 2) / n);
    int64_t cm = 0, cp = 0;
    for (int64_t f = 0; f < n; ++f) {
      const uint8_t* x = gray + f * p;
      const uint8_t* xm1 = x - p;
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t rm = static_cast<uint8_t>(x[i] - bg[i]);
        if (static_cast<uint8_t>(rm + 2) > 4) {
          cm += (static_cast<uint8_t>(rm + 7) > 14) ? 11 : 1;
        }
        if (f > 0) {
          const uint8_t rp = static_cast<uint8_t>(x[i] - xm1[i]);
          if (static_cast<uint8_t>(rp + 2) > 4) {
            cp += (static_cast<uint8_t>(rp + 7) > 14) ? 11 : 1;
          }
        }
      }
    }
    c_mean[t] = cm;
    c_prev[t] = cp;
  };
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(phase1, t);
    for (auto& th : pool) th.join();
  }
  int64_t cost_mean = 0, cost_prev = 0;
  for (int t = 0; t < n_threads; ++t) {
    cost_mean += c_mean[t];
    cost_prev += c_prev[t];
  }
  const int mode =
      force_mode >= 0 ? force_mode : (cost_mean <= cost_prev ? 0 : 1);
  *mode_out = static_cast<uint8_t>(mode);
  if (mode == 1) std::memcpy(bg, gray, p);  // predictor base = frame 0

  // Phase 2 (frame stripes): level-1 bytes + per-frame escape vectors.
  std::vector<std::vector<uint8_t>> t_nib(n);
  std::vector<std::vector<int64_t>> t_bigidx(n);
  std::vector<std::vector<uint8_t>> t_bigval(n);
  const int64_t fper = (n + n_threads - 1) / n_threads;
  auto phase2 = [&](int t) {
    const int64_t flo = t * fper, fhi = std::min(n, flo + fper);
    for (int64_t f = flo; f < fhi; ++f) {
      const uint8_t* x = gray + f * p;
      const uint8_t* pred = (mode == 1) ? (f ? x - p : nullptr) : bg;
      uint8_t* out = lvl1 + f * pp3;
      auto& nib = t_nib[f];
      auto& bidx = t_bigidx[f];
      auto& bval = t_bigval[f];
      for (int64_t i = 0; i < pp3; ++i) {
        uint8_t d[3] = {0, 0, 0};
        const int64_t base = 3 * i;
        const int64_t jmax = std::min<int64_t>(3, p - base);
        for (int64_t j = 0; j < jmax; ++j) {
          const int64_t px = base + j;
          const uint8_t r =
              pred ? static_cast<uint8_t>(x[px] - pred[px]) : 0;
          const uint8_t tt = static_cast<uint8_t>(r + 2);
          if (tt <= 4) {
            d[j] = tt;
          } else {
            d[j] = 5;
            const uint8_t u = static_cast<uint8_t>(r + 7);
            if (u <= 14) {
              nib.push_back(u);
            } else {
              nib.push_back(15);
              bidx.push_back(f * p + px);
              bval.push_back(r);
            }
          }
        }
        out[i] = static_cast<uint8_t>(d[0] + 6 * d[1] + 36 * d[2]);
      }
    }
  };
  {
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(phase2, t);
    for (auto& th : pool) th.join();
  }

  // Serial merge in frame order == the numpy twin's flattened stream order.
  int64_t n1 = 0, n3 = 0;
  for (int64_t f = 0; f < n; ++f) {
    n1 += static_cast<int64_t>(t_nib[f].size());
    n3 += static_cast<int64_t>(t_bigidx[f].size());
  }
  if (n3 > escape_cap) return -1;
  if ((n1 + 1) / 2 > lvl2_cap) return -2;
  int64_t k = 0;
  uint8_t pending = 0;
  for (int64_t f = 0; f < n; ++f) {
    for (uint8_t u : t_nib[f]) {
      if (k % 2 == 0) {
        pending = u;
      } else {
        lvl2[k / 2] = static_cast<uint8_t>(pending | (u << 4));
      }
      ++k;
    }
  }
  if (k % 2) lvl2[k / 2] = pending;  // odd-count pad nibble stays 0
  int64_t at = 0;
  for (int64_t f = 0; f < n; ++f) {
    for (size_t i = 0; i < t_bigidx[f].size(); ++i) {
      esc_idx[at] = static_cast<int32_t>(t_bigidx[f][i]);
      esc_val[at] = t_bigval[f][i];
      ++at;
    }
  }
  for (int64_t i = n3; i < escape_cap; ++i) {
    esc_idx[i] = static_cast<int32_t>(m);
    esc_val[i] = 0;
  }
  *n1_out = n1;
  *n3_out = n3;
  return 0;
}

}  // extern "C"
