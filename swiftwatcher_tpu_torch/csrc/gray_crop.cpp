// Host gray crop of whole BGR frames (io/prefetch.py's frames mode), off
// the GIL.
//
// The port's copy of gray_crop_one of native/framepump.cpp, in a library of
// its own: that file links libjpeg, which a host may lack, and this needs
// nothing but the C++ standard library.  Each output pixel is OpenCV's
// shift-15 BGR2GRAY, bit-equal to ops/color.py:bgr_to_gray_host:
//
//   Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15
//
// Build: g++ -O3 -march=native -shared -fPIC gray_crop.cpp -o libgray_crop.so -lpthread

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Rows ahead of the one being grayed whose bytes are prefetched.  Each row
// of a 1080p frame starts on a page of its own, so without it every row
// pays the walk and the misses of its first cache lines in turn.
constexpr int kAhead = 8;

void prefetch_row(const uint8_t* row, int n_bytes) {
  for (int k = 0; k < n_bytes; k += 64) __builtin_prefetch(row + k);
}

// Rows y1..y2-1, columns x1..x2-1 of one frame whose rows lie row_stride
// bytes apart (pixels packed B, G, R) into out, (y2-y1) x (x2-x1).
void gray_crop_one(const uint8_t* __restrict frame, int64_t row_stride, int y1, int y2,
                   int x1, int x2, uint8_t* __restrict out) {
  const int cw = x2 - x1;
  const uint8_t* first = frame + y1 * row_stride + static_cast<int64_t>(x1) * 3;
  for (int y = y1; y < std::min(y2, y1 + kAhead); ++y)
    prefetch_row(first + (y - y1) * row_stride, 3 * cw);
  for (int y = y1; y < y2; ++y) {
    const uint8_t* row = frame + y * row_stride + static_cast<int64_t>(x1) * 3;
    if (y + kAhead < y2) prefetch_row(row + kAhead * row_stride, 3 * cw);
    uint8_t* orow = out + static_cast<int64_t>(y - y1) * cw;
    for (int x = 0; x < cw; ++x) {
      const int b = row[3 * x + 0];
      const int g = row[3 * x + 1];
      const int r = row[3 * x + 2];
      orow[x] = static_cast<uint8_t>((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15);
    }
  }
}

}  // namespace

extern "C" {

// n frames, each at its own address with its own row stride, cropped to the
// same region into out, n consecutive (y2-y1) x (x2-x1) planes.  Frames are
// split into n_threads contiguous runs, one thread each; the result does not
// depend on n_threads.  The caller checks that the crop lies inside every
// frame.
void swt_gray_crop_frames(const uint8_t* const* frames, const int64_t* row_strides, int n,
                          int y1, int y2, int x1, int x2, uint8_t* out, int n_threads) {
  const int64_t ostride = static_cast<int64_t>(y2 - y1) * (x2 - x1);
  auto work = [=](int lo, int hi) {
    for (int i = lo; i < hi; ++i)
      gray_crop_one(frames[i], row_strides[i], y1, y2, x1, x2, out + i * ostride);
  };
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int per = (n + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; ++t) {
    const int lo = t * per, hi = std::min(n, lo + per);
    if (lo < hi) pool.emplace_back(work, lo, hi);
  }
  work(0, std::min(n, per));
  for (auto& th : pool) th.join();
}

}  // extern "C"
