// Batch image preparation on std::threads (counterpart of the JAX
// package's native/ait_loader.cpp), bound with ctypes by
// ait_tpu_torch/native.py and built with g++ by ops/_build.py.
//
// The caller decodes the images (the loader's `imread`) and hands over a
// table of pointers to HxWx3 uint8 RGB arrays; every function here spreads
// the batch's items over threads that hold no interpreter lock.
//
// The pixels are the port's numpy path's, bit for bit
// (ait_tpu_torch/data/transforms.py), which is cv2.resize(INTER_LINEAR):
//   * per axis, the source position (d + 0.5) * scale - 0.5 in double,
//     rounded to float32, split at its floor (`_taps`); the column pass
//     moves a tap past either edge onto the edge pixel with weight 1, the
//     row pass keeps its weights and clamps the rows it reads;
//   * 11-bit fixed-point weights, rint(w * 2048) half to even (`_fixed`);
//   * the column pass sums in int32, the row pass rounds as OpenCV's
//     vector code does: (row >> 4) * w >> 16 per tap, then (t + 2) >> 2;
//   * an exact 2x downscale is OpenCV's area mode, the mean of each 2x2
//     block, (sum + 2) >> 2, a block cut by an odd edge rint(sum / count)
//     (`_box2`); a resize to the same size is a copy.
// This needs IEEE float32 arithmetic with no contraction into FMA: the
// build passes -ffp-contract=off and no -ffast-math or -march=native.
//
// Targets: flip, shortest-side scale to `target_size` capped to the canvas
// (dims lrint(side * scale), half to even as Python's round), top-left on
// the canvas filled with `fill`, optionally emitted straight in the
// space-to-depth layout [H/2, W/2, 12] (channel dy*6 + dx*3 + c).
// Queries: crop (the caller passes the crop's rows and columns, already
// resolved as Python slices resolve them), center-pad square with zeros,
// resize to query_size, flip.
//
// Each function returns the number of items it could not make (a resize to
// an empty size); their status entry is 1.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

constexpr int kCoefBits = 11;
constexpr float kCoefScale = float(1 << kCoefBits);

struct Taps {
  std::vector<int> s0, s1, a0, a1;
};

// transforms.py::_taps (uint8: the position rounded to float32) + _fixed
void make_taps(int dst_n, int src_n, double scale, bool clamp_weight,
               Taps* t) {
  t->s0.resize(dst_n);
  t->s1.resize(dst_n);
  t->a0.resize(dst_n);
  t->a1.resize(dst_n);
  for (int d = 0; d < dst_n; ++d) {
    const double fd = (double(d) + 0.5) * scale - 0.5;
    const float ff = float(fd);
    int64_t s = int64_t(std::floor(ff));
    float fr = ff - float(s);
    if (clamp_weight) {
      if (s < 0 || s >= src_n - 1) fr = 0.0f;
      s = std::min<int64_t>(std::max<int64_t>(s, 0), src_n - 1);
    }
    t->s0[d] = int(std::min<int64_t>(std::max<int64_t>(s, 0), src_n - 1));
    t->s1[d] = int(std::min<int64_t>(std::max<int64_t>(s + 1, 0), src_n - 1));
    const float w0 = 1.0f - fr;
    t->a0[d] = int(std::lrintf(w0 * kCoefScale));
    t->a1[d] = int(std::lrintf(fr * kCoefScale));
  }
}

// transforms.py::_box2 for uint8
void box2(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      for (int c = 0; c < 3; ++c) {
        int acc = 0, cnt = 0;
        for (int dy = 0; dy < 2; ++dy) {
          const int sy = 2 * y + dy;
          if (sy >= h) continue;
          for (int dx = 0; dx < 2; ++dx) {
            const int sx = 2 * x + dx;
            if (sx >= w) continue;
            acc += src[(size_t(sy) * w + sx) * 3 + c];
            ++cnt;
          }
        }
        int v;
        if (cnt == 4) {
          v = (acc + 2) >> 2;
        } else {  // rint(acc / cnt), half to even (cnt is 1 or 2)
          v = acc / cnt;
          const int rem = acc - v * cnt;
          if (2 * rem > cnt || (2 * rem == cnt && (v & 1))) ++v;
        }
        dst[(size_t(y) * ow + x) * 3 + c] = uint8_t(v);
      }
    }
  }
}

// transforms.py::resize_linear for an HxWx3 uint8 image to oh x ow;
// inv_x, inv_y are its `inv_x`, `inv_y` (the scale is their inverse)
void resize(const uint8_t* src, int h, int w, uint8_t* dst, int oh, int ow,
            double inv_x, double inv_y) {
  if (oh == h && ow == w) {
    std::memcpy(dst, src, size_t(h) * w * 3);
    return;
  }
  const double scale_x = 1.0 / inv_x, scale_y = 1.0 / inv_y;
  if (scale_x == 2.0 && scale_y == 2.0) {
    box2(src, h, w, dst, oh, ow);
    return;
  }
  Taps cx, ry;
  make_taps(ow, w, scale_x, true, &cx);
  make_taps(oh, h, scale_y, false, &ry);
  // the column pass of the two source rows an output row reads, already
  // shifted down 4 bits: slot 0 holds row r0, slot 1 row r1
  std::vector<int32_t> rows[2];
  int cached[2] = {-1, -1};
  rows[0].resize(size_t(ow) * 3);
  rows[1].resize(size_t(ow) * 3);
  auto column_pass = [&](int r, int32_t* out) {
    const uint8_t* srow = src + size_t(r) * w * 3;
    for (int x = 0; x < ow; ++x) {
      const uint8_t* p0 = srow + size_t(cx.s0[x]) * 3;
      const uint8_t* p1 = srow + size_t(cx.s1[x]) * 3;
      const int32_t a0 = cx.a0[x], a1 = cx.a1[x];
      for (int c = 0; c < 3; ++c)
        out[x * 3 + c] = (int32_t(p0[c]) * a0 + int32_t(p1[c]) * a1) >> 4;
    }
  };
  for (int y = 0; y < oh; ++y) {
    const int r0 = ry.s0[y], r1 = ry.s1[y];
    if (cached[0] != r0) {
      if (cached[1] == r0) {
        std::swap(rows[0], rows[1]);
        std::swap(cached[0], cached[1]);
      } else {
        column_pass(r0, rows[0].data());
        cached[0] = r0;
      }
    }
    if (cached[1] != r1) {
      column_pass(r1, rows[1].data());
      cached[1] = r1;
    }
    const int32_t* h0 = rows[0].data();
    const int32_t* h1 = rows[1].data();
    const int32_t b0 = ry.a0[y], b1 = ry.a1[y];
    uint8_t* drow = dst + size_t(y) * ow * 3;
    for (int i = 0; i < ow * 3; ++i) {
      int32_t v = ((h0[i] * b0) >> 16) + ((h1[i] * b1) >> 16);
      v = (v + 2) >> 2;
      drow[i] = uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

void hflip(const uint8_t* src, int h, int w, uint8_t* dst) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + size_t(y) * w * 3;
    uint8_t* d = dst + size_t(y) * w * 3;
    for (int x = 0; x < w; ++x)
      std::memcpy(d + size_t(x) * 3, s + size_t(w - 1 - x) * 3, 3);
  }
}

void parallel_for(int n, int n_threads, const std::function<void(int)>& fn) {
  const int nt = std::max(1, std::min(n_threads, n));
  if (nt <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
    });
  for (auto& th : threads) th.join();
}

// [h, w, 3] (rows of pitch w) -> canvas [ch, cw, 3] or its space-to-depth
// form [ch/2, cw/2, 12], padded with fill
void place(const uint8_t* im, int h, int w, const uint8_t* fill, int ch,
           int cw, bool s2d, uint8_t* canvas) {
  const int vh = std::min(h, ch), vw = std::min(w, cw);
  if (s2d) {
    const int oh = ch / 2, ow = cw / 2;
    for (int y = 0; y < oh; ++y) {
      uint8_t* drow = canvas + size_t(y) * ow * 12;
      for (int x = 0; x < ow; ++x) {
        uint8_t* px = drow + size_t(x) * 12;
        for (int dy = 0; dy < 2; ++dy) {
          const int sy = 2 * y + dy;
          for (int dx = 0; dx < 2; ++dx) {
            const int sx = 2 * x + dx;
            const uint8_t* sp = (sy < vh && sx < vw)
                                    ? im + (size_t(sy) * w + sx) * 3
                                    : fill;
            std::memcpy(px + dy * 6 + dx * 3, sp, 3);
          }
        }
      }
    }
    return;
  }
  for (int y = 0; y < ch; ++y) {
    uint8_t* row = canvas + size_t(y) * cw * 3;
    int x = 0;
    if (y < vh) {
      std::memcpy(row, im + size_t(y) * w * 3, size_t(vw) * 3);
      x = vw;
    }
    for (; x < cw; ++x) std::memcpy(row + size_t(x) * 3, fill, 3);
  }
}

}  // namespace

extern "C" {

// Targets.  images[n]: HxWx3 uint8 arrays of sizes hw[n][2]; flip[n];
// canvas (ch, cw); fill[3].  out: n canvases [ch, cw, 3], or with s2d
// [ch/2, cw/2, 12]; out_info: n rows (scaled h, scaled w, scale) f32;
// out_scale: n scales in f64; status: n entries, 1 where an item failed.
int ail_prep_targets(int64_t n, const uint8_t* const* images,
                     const int32_t* hw, const uint8_t* flip,
                     int32_t target_size, int32_t canvas_h, int32_t canvas_w,
                     const uint8_t* fill, int32_t s2d, uint8_t* out,
                     float* out_info, double* out_scale, uint8_t* status,
                     int32_t n_threads) {
  std::atomic<int> failed(0);
  const size_t canvas_bytes = size_t(canvas_h) * canvas_w * 3;  // either form
  parallel_for(int(n), n_threads, [&](int i) {
    const int h = hw[2 * i], w = hw[2 * i + 1];
    // transforms.py::prep_image: the shortest side to target_size, capped
    // to fit the canvas
    double scale = double(target_size) / double(std::min(h, w));
    scale = std::min(scale, std::min(double(canvas_h) / double(h),
                                     double(canvas_w) / double(w)));
    const int oh = int(std::lrint(double(h) * scale));
    const int ow = int(std::lrint(double(w) * scale));
    uint8_t* canvas = out + size_t(i) * canvas_bytes;
    if (oh <= 0 || ow <= 0) {
      std::memset(canvas, 0, canvas_bytes);
      out_info[3 * i] = out_info[3 * i + 1] = out_info[3 * i + 2] = 0.0f;
      out_scale[i] = 0.0;
      status[i] = 1;
      failed.fetch_add(1);
      return;
    }
    const uint8_t* src = images[i];
    std::vector<uint8_t> flipped;
    if (flip[i]) {
      flipped.resize(size_t(h) * w * 3);
      hflip(src, h, w, flipped.data());
      src = flipped.data();
    }
    std::vector<uint8_t> resized(size_t(oh) * ow * 3);
    resize(src, h, w, resized.data(), oh, ow, scale, scale);
    place(resized.data(), oh, ow, fill, canvas_h, canvas_w, s2d != 0, canvas);
    out_info[3 * i] = float(oh);
    out_info[3 * i + 1] = float(ow);
    out_info[3 * i + 2] = float(scale);
    out_scale[i] = scale;
    status[i] = 0;
  });
  return failed.load();
}

// Queries.  images[n] of sizes hw[n][2]; crop[n][4] = (y0, y1, x0, x1),
// the rows and columns of the cut as Python slices resolve them (empty
// when y1 <= y0 or x1 <= x0: a 1x1 zero crop); flip[n].  out: n
// [query_size, query_size, 3]; status as above.
int ail_prep_queries(int64_t n, const uint8_t* const* images,
                     const int32_t* hw, const int32_t* crop,
                     const uint8_t* flip, int32_t query_size, uint8_t* out,
                     uint8_t* status, int32_t n_threads) {
  const size_t q_bytes = size_t(query_size) * query_size * 3;
  parallel_for(int(n), n_threads, [&](int i) {
    const int w = hw[2 * i + 1];
    const int y0 = crop[4 * i], y1 = crop[4 * i + 1];
    const int x0 = crop[4 * i + 2], x1 = crop[4 * i + 3];
    int ch = y1 - y0, cw = x1 - x0;
    std::vector<uint8_t> cut;
    if (ch <= 0 || cw <= 0) {  // transforms.py::crop_query's 1x1 zeros
      ch = cw = 1;
      cut.assign(3, 0);
    } else {
      cut.resize(size_t(ch) * cw * 3);
      for (int y = 0; y < ch; ++y)
        std::memcpy(cut.data() + size_t(y) * cw * 3,
                    images[i] + (size_t(y0 + y) * w + x0) * 3,
                    size_t(cw) * 3);
    }
    // center-pad square (crop_query's integer arithmetic)
    const int m = std::max(ch, cw);
    const int cty = ch / 2, ctx = cw / 2;
    const int xs0 = std::max(0, ctx - m / 2), xs1 = std::min(ctx + m / 2, cw);
    const int ys0 = std::max(0, cty - m / 2), ys1 = std::min(cty + m / 2, ch);
    std::vector<uint8_t> sq(size_t(m) * m * 3, 0);
    const int oy = m / 2 - (cty - ys0), ox = m / 2 - (ctx - xs0);
    for (int y = ys0; y < ys1; ++y)
      std::memcpy(sq.data() + (size_t(oy + y - ys0) * m + ox) * 3,
                  cut.data() + (size_t(y) * cw + xs0) * 3,
                  size_t(xs1 - xs0) * 3);
    uint8_t* dst = out + size_t(i) * q_bytes;
    const double inv = double(query_size) / double(m);
    if (flip[i]) {
      std::vector<uint8_t> q(q_bytes);
      resize(sq.data(), m, m, q.data(), query_size, query_size, inv, inv);
      hflip(q.data(), query_size, query_size, dst);
    } else {
      resize(sq.data(), m, m, dst, query_size, query_size, inv, inv);
    }
    status[i] = 0;
  });
  return 0;
}

// Space-to-depth: [n, h, w, 3] -> [n, h/2, w/2, 12], channel dy*6 + dx*3
// + c (transforms.py::space_to_depth); h and w even.
int ail_space_to_depth(int64_t n, int32_t h, int32_t w, const uint8_t* src,
                       uint8_t* dst, int32_t n_threads) {
  const int oh = h / 2, ow = w / 2;
  parallel_for(int(n), n_threads, [&](int i) {
    const uint8_t* s = src + size_t(i) * h * w * 3;
    uint8_t* d = dst + size_t(i) * oh * ow * 12;
    for (int y = 0; y < oh; ++y) {
      const uint8_t* r0 = s + size_t(2 * y) * w * 3;
      const uint8_t* r1 = r0 + size_t(w) * 3;
      uint8_t* drow = d + size_t(y) * ow * 12;
      for (int x = 0; x < ow; ++x) {
        std::memcpy(drow + size_t(x) * 12, r0 + size_t(2 * x) * 3, 6);
        std::memcpy(drow + size_t(x) * 12 + 6, r1 + size_t(2 * x) * 3, 6);
      }
    }
  });
  return 0;
}

}  // extern "C"
