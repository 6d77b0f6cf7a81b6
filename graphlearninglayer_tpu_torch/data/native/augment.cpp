// Native (C++) batch image-augmentation backend for the host data pipeline.
//
// Implements the reference transform stack (reference config/augmentations.py:
// 14-op RandAugment + always-applied random Cutout; rotation / flip / padded
// random crop; ToTensor+Normalize) with bit-exact PIL semantics per op —
// verified against PIL in tests/test_native_aug.py:
//   * affine/rotate: nearest sample at output pixel centers (x+0.5, y+0.5),
//     truncation (floor) to source pixel, zero fill out of bounds;
//   * enhance blends (brightness/color/contrast/sharpness): truncation toward
//     zero of deg + (img - deg) * v;
//   * L conversion: (R*19595 + G*38470 + B*7471 + 0x8000) >> 16;
//   * contrast mean: round-half-up of the L mean;
//   * SMOOTH filter (sharpness degenerate): round-half-up, borders copied;
//   * autocontrast: per-channel linear LUT with truncation;
//   * equalize: PIL step formula (sum minus last NONZERO bin, over 255),
//     clamped at 255;
//   * solarize: float threshold, invert at >= threshold;
//   * posterize: bit mask;
//   * cutout: PIL ImageDraw.rectangle INCLUSIVE coordinates, gray fill
//     (125, 123, 114) / 125.
//
// The per-image parameter sampling (op choice, magnitudes, sign flips)
// deliberately uses its own PCG32 stream — parity with the PIL path is
// per-op deterministic, not per-stream (numpy Generator streams are not
// reproducible in C).  Given identical seeds, the native pipeline itself is
// fully deterministic.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libgllaug.so augment.cpp
// -lpthread (see ../native.py, which builds on demand into build/native/
// and falls back to PIL).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// RNG: PCG32 (deterministic per seed; independent of numpy streams)

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(0) {
    next();  // warm up from splitmix-style init
    state += 0x853c49e6748fea9bULL + seed * 0x9e3779b97f4a7c15ULL;
    next();
  }
  uint32_t next() {
    uint64_t old = state;
    state = old * 6364136223846793005ULL + 1442695040888963407ULL;
    uint32_t xorshifted = (uint32_t)(((old >> 18u) ^ old) >> 27u);
    uint32_t rot = (uint32_t)(old >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((-rot) & 31));
  }
  double uniform() { return (next() >> 8) * (1.0 / 16777216.0); }  // [0,1)
  int randint(int n) { return (int)(uniform() * n); }              // [0,n)
};

// ---------------------------------------------------------------------------
// Core ops on HWC uint8 images (c = 1 or 3)

inline int lum(int r, int g, int b) {
  return (r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16;
}

// out(x,y) = in(floor(a(x+.5)+b(y+.5)+c0), floor(d(x+.5)+e(y+.5)+f0)), 0-fill
void affine_nearest(const uint8_t* in, uint8_t* out, int h, int w, int c,
                    double a, double b, double c0, double d, double e,
                    double f0) {
  for (int y = 0; y < h; ++y) {
    double yc = y + 0.5;
    for (int x = 0; x < w; ++x) {
      double xc = x + 0.5;
      int ix = (int)std::floor(a * xc + b * yc + c0);
      int iy = (int)std::floor(d * xc + e * yc + f0);
      uint8_t* o = out + ((size_t)y * w + x) * c;
      if (ix >= 0 && ix < w && iy >= 0 && iy < h) {
        const uint8_t* s = in + ((size_t)iy * w + ix) * c;
        for (int ch = 0; ch < c; ++ch) o[ch] = s[ch];
      } else {
        for (int ch = 0; ch < c; ++ch) o[ch] = 0;
      }
    }
  }
}

// PIL Image.rotate(angle): CCW, nearest, center (w/2, h/2), zero fill.
void rotate_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
                double angle_deg) {
  double ang = -angle_deg * M_PI / 180.0;
  double cs = std::cos(ang), sn = std::sin(ang);
  double cx = w / 2.0, cy = h / 2.0;
  double a = cs, b = sn, d = -sn, e = cs;
  double c0 = cx - a * cx - b * cy;
  double f0 = cy - d * cx - e * cy;
  affine_nearest(in, out, h, w, c, a, b, c0, d, e, f0);
}

void mirror_img(const uint8_t* in, uint8_t* out, int h, int w, int c) {
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint8_t* s = in + ((size_t)y * w + (w - 1 - x)) * c;
      uint8_t* o = out + ((size_t)y * w + x) * c;
      for (int ch = 0; ch < c; ++ch) o[ch] = s[ch];
    }
}

// numpy-style pad (constant-0 or reflect-no-edge-repeat) + crop back to
// (h, w) at offset (i, j), i,j in [0, 2*pad].
void pad_crop(const uint8_t* in, uint8_t* out, int h, int w, int c, int pad,
              int reflect, int i, int j) {
  for (int y = 0; y < h; ++y) {
    int sy = y + i - pad;
    if (reflect) {
      if (sy < 0) sy = -sy;
      if (sy >= h) sy = 2 * h - 2 - sy;
    }
    for (int x = 0; x < w; ++x) {
      int sx = x + j - pad;
      if (reflect) {
        if (sx < 0) sx = -sx;
        if (sx >= w) sx = 2 * w - 2 - sx;
      }
      uint8_t* o = out + ((size_t)y * w + x) * c;
      if (sy >= 0 && sy < h && sx >= 0 && sx < w) {
        const uint8_t* s = in + ((size_t)sy * w + sx) * c;
        for (int ch = 0; ch < c; ++ch) o[ch] = s[ch];
      } else {
        for (int ch = 0; ch < c; ++ch) o[ch] = 0;
      }
    }
  }
}

void apply_lut(const uint8_t* in, uint8_t* out, size_t npix, int c,
               const uint8_t lut[3][256]) {
  for (size_t p = 0; p < npix; ++p)
    for (int ch = 0; ch < c; ++ch)
      out[p * c + ch] = lut[ch][in[p * c + ch]];
}

void autocontrast_img(const uint8_t* in, uint8_t* out, int h, int w, int c) {
  size_t npix = (size_t)h * w;
  uint8_t lut[3][256];
  for (int ch = 0; ch < c; ++ch) {
    int hist[256] = {0};
    for (size_t p = 0; p < npix; ++p) hist[in[p * c + ch]]++;
    int lo = 0, hi = 255;
    while (lo < 256 && hist[lo] == 0) lo++;
    while (hi >= 0 && hist[hi] == 0) hi--;
    if (hi <= lo) {
      for (int v = 0; v < 256; ++v) lut[ch][v] = (uint8_t)v;
    } else {
      double scale = 255.0 / (hi - lo);
      double offset = -lo * scale;
      for (int v = 0; v < 256; ++v) {
        int ix = (int)(v * scale + offset);  // PIL truncates
        lut[ch][v] = (uint8_t)std::clamp(ix, 0, 255);
      }
    }
  }
  apply_lut(in, out, npix, c, lut);
}

void equalize_img(const uint8_t* in, uint8_t* out, int h, int w, int c) {
  size_t npix = (size_t)h * w;
  uint8_t lut[3][256];
  for (int ch = 0; ch < c; ++ch) {
    int64_t hist[256] = {0};
    for (size_t p = 0; p < npix; ++p) hist[in[p * c + ch]]++;
    int64_t total = (int64_t)npix, last_nz = 0;
    int nz = 0;
    for (int v = 0; v < 256; ++v)
      if (hist[v]) { last_nz = hist[v]; nz++; }
    int64_t step = (nz <= 1) ? 0 : (total - last_nz) / 255;
    if (step == 0) {
      for (int v = 0; v < 256; ++v) lut[ch][v] = (uint8_t)v;
    } else {
      int64_t nacc = step / 2;
      for (int v = 0; v < 256; ++v) {
        lut[ch][v] = (uint8_t)std::min<int64_t>(nacc / step, 255);
        nacc += hist[v];
      }
    }
  }
  apply_lut(in, out, npix, c, lut);
}

void solarize_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
                  double threshold) {
  size_t npix = (size_t)h * w;
  uint8_t lut[3][256];
  for (int v = 0; v < 256; ++v) {
    uint8_t r = (v < threshold) ? (uint8_t)v : (uint8_t)(255 - v);
    lut[0][v] = lut[1][v] = lut[2][v] = r;
  }
  apply_lut(in, out, npix, c, lut);
}

void posterize_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
                   int bits) {
  uint8_t mask = (uint8_t)(0xFF & ~((1 << (8 - bits)) - 1));
  size_t nb = (size_t)h * w * c;
  for (size_t p = 0; p < nb; ++p) out[p] = in[p] & mask;
}

// blend: out = (int)(deg + (img - deg) * v)  — PIL truncation
inline uint8_t blend1(double deg, double img, double v) {
  double r = deg + (img - deg) * v;
  int i = (int)r;
  return (uint8_t)std::clamp(i, 0, 255);
}

void brightness_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
                    double v) {
  size_t nb = (size_t)h * w * c;
  uint8_t lut[256];
  for (int p = 0; p < 256; ++p) lut[p] = blend1(0.0, p, v);
  for (size_t p = 0; p < nb; ++p) out[p] = lut[in[p]];
}

void color_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
               double v) {
  size_t npix = (size_t)h * w;
  if (c == 1) {  // degenerate = L = identity on grayscale
    std::memcpy(out, in, npix);
    return;
  }
  for (size_t p = 0; p < npix; ++p) {
    const uint8_t* s = in + p * 3;
    double deg = lum(s[0], s[1], s[2]);
    uint8_t* o = out + p * 3;
    for (int ch = 0; ch < 3; ++ch) o[ch] = blend1(deg, s[ch], v);
  }
}

void contrast_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
                  double v) {
  size_t npix = (size_t)h * w;
  double sum = 0;
  if (c == 3)
    for (size_t p = 0; p < npix; ++p)
      sum += lum(in[p * 3], in[p * 3 + 1], in[p * 3 + 2]);
  else
    for (size_t p = 0; p < npix; ++p) sum += in[p];
  int mean = (int)(sum / (double)npix + 0.5);
  uint8_t lut[256];
  for (int p = 0; p < 256; ++p) lut[p] = blend1(mean, p, v);
  size_t nb = npix * c;
  for (size_t p = 0; p < nb; ++p) out[p] = lut[in[p]];
}

void sharpness_img(const uint8_t* in, uint8_t* out, int h, int w, int c,
                   double v) {
  // degenerate = ImageFilter.SMOOTH: 3x3 [1 1 1; 1 5 1; 1 1 1]/13,
  // round-half-up, border pixels copied from the input.
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      for (int ch = 0; ch < c; ++ch) {
        size_t idx = ((size_t)y * w + x) * c + ch;
        double deg;
        if (y == 0 || y == h - 1 || x == 0 || x == w - 1) {
          deg = in[idx];
        } else {
          int acc = 0;
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              int wgt = (dy == 0 && dx == 0) ? 5 : 1;
              acc += wgt * in[((size_t)(y + dy) * w + (x + dx)) * c + ch];
            }
          deg = std::floor(acc / 13.0 + 0.5);
          deg = std::clamp(deg, 0.0, 255.0);
        }
        out[idx] = blend1(deg, in[idx], v);
      }
}

// PIL ImageDraw.rectangle((x0, y0, x1, y1)) fills INCLUSIVE of both corners.
void cutout_rect(uint8_t* img, int h, int w, int c, int x0, int y0, int x1,
                 int y1) {
  const uint8_t fill3[3] = {125, 123, 114};
  x0 = std::max(x0, 0); y0 = std::max(y0, 0);
  x1 = std::min(x1, w - 1); y1 = std::min(y1, h - 1);
  for (int y = y0; y <= y1; ++y)
    for (int x = x0; x <= x1; ++x) {
      uint8_t* o = img + ((size_t)y * w + x) * c;
      if (c == 3) { o[0] = fill3[0]; o[1] = fill3[1]; o[2] = fill3[2]; }
      else o[0] = 125;
    }
}

// The transform's cutout: a gray square of side frac * w centered at
// (r1 * w, r2 * h), its corners truncated toward zero (augment.py:117).
void cutout(uint8_t* img, int h, int w, int c, double frac, double r1,
            double r2) {
  if (frac <= 0) return;
  double v = frac * w;
  double x0 = std::max(0.0, r1 * w - v / 2.0);
  double y0 = std::max(0.0, r2 * h - v / 2.0);
  cutout_rect(img, h, w, c, (int)x0, (int)y0,
              (int)std::min((double)w, x0 + v),
              (int)std::min((double)h, y0 + v));
}

// ---------------------------------------------------------------------------
// RandAugment op dispatch (ids match data/augment.py _AUGMENT_LIST order,
// reference config/augmentations.py:155-174)

enum OpId {
  OP_AUTOCONTRAST = 0, OP_BRIGHTNESS, OP_COLOR, OP_CONTRAST, OP_EQUALIZE,
  OP_IDENTITY, OP_POSTERIZE, OP_ROTATE, OP_SHARPNESS, OP_SHEAR_X, OP_SHEAR_Y,
  OP_SOLARIZE, OP_TRANSLATE_X, OP_TRANSLATE_Y, NUM_OPS
};

const double OP_LO[NUM_OPS] = {0, 0.05, 0.05, 0.05, 0, 0, 4, 0,  0.05,
                               0, 0,    0,    0,    0};
const double OP_HI[NUM_OPS] = {1, 0.95, 0.95, 0.95, 1, 1, 8, 30, 0.95,
                               0.3, 0.3, 256, 0.3, 0.3};

void apply_op(const uint8_t* in, uint8_t* out, int h, int w, int c, int op,
              double v, int sign) {
  double sv = sign ? -v : v;
  switch (op) {
    case OP_AUTOCONTRAST: autocontrast_img(in, out, h, w, c); break;
    case OP_BRIGHTNESS:   brightness_img(in, out, h, w, c, v); break;
    case OP_COLOR:        color_img(in, out, h, w, c, v); break;
    case OP_CONTRAST:     contrast_img(in, out, h, w, c, v); break;
    case OP_EQUALIZE:     equalize_img(in, out, h, w, c); break;
    case OP_IDENTITY:     std::memcpy(out, in, (size_t)h * w * c); break;
    case OP_POSTERIZE:    posterize_img(in, out, h, w, c,
                                        std::max(1, (int)v)); break;
    case OP_ROTATE:       rotate_img(in, out, h, w, c, sv); break;
    case OP_SHARPNESS:    sharpness_img(in, out, h, w, c, v); break;
    case OP_SHEAR_X:
      affine_nearest(in, out, h, w, c, 1, sv, 0, 0, 1, 0); break;
    case OP_SHEAR_Y:
      affine_nearest(in, out, h, w, c, 1, 0, 0, sv, 1, 0); break;
    case OP_SOLARIZE:     solarize_img(in, out, h, w, c, v); break;
    case OP_TRANSLATE_X:
      affine_nearest(in, out, h, w, c, 1, 0, sv * w, 0, 1, 0); break;
    case OP_TRANSLATE_Y:
      affine_nearest(in, out, h, w, c, 1, 0, 0, 0, 1, sv * h); break;
    default:              std::memcpy(out, in, (size_t)h * w * c); break;
  }
}

// signs flip with probability 1/2 for the geometric ops (augment.py:43-64)
inline bool op_has_sign(int op) {
  return op == OP_ROTATE || op == OP_SHEAR_X || op == OP_SHEAR_Y ||
         op == OP_TRANSLATE_X || op == OP_TRANSLATE_Y;
}

// Full per-image transform: [rotate] -> [flip] -> pad+crop ->
// RandAugment(rand_n) -> cutout  (data/augment.py Transform.__call__)
void augment_one(const uint8_t* in, uint8_t* out, int h, int w, int c,
                 uint64_t seed, int rand_n, int rotation, int flip, int pad,
                 int pad_reflect, uint8_t* bufa, uint8_t* bufb) {
  Rng rng(seed);
  const uint8_t* cur = in;
  uint8_t* nxt = bufa;
  auto swapbuf = [&](uint8_t* produced) {
    cur = produced;
    nxt = (produced == bufa) ? bufb : bufa;
  };

  if (rotation > 0) {
    double ang = (rng.uniform() * 2.0 - 1.0) * rotation;
    rotate_img(cur, nxt, h, w, c, ang);
    swapbuf(nxt);
  }
  if (flip && rng.uniform() < 0.5) {
    mirror_img(cur, nxt, h, w, c);
    swapbuf(nxt);
  }
  if (pad > 0) {
    int i = rng.randint(2 * pad + 1);
    int j = rng.randint(2 * pad + 1);
    pad_crop(cur, nxt, h, w, c, pad, pad_reflect, i, j);
    swapbuf(nxt);
  }
  for (int t = 0; t < rand_n; ++t) {
    int op = rng.randint(NUM_OPS);
    double v = rng.uniform() * (OP_HI[op] - OP_LO[op]) + OP_LO[op];
    int sign = op_has_sign(op) && (rng.uniform() > 0.5);
    apply_op(cur, nxt, h, w, c, op, v, sign);
    swapbuf(nxt);
  }
  // always-applied random cutout, frac ~ U(0, 0.5) (augment.py:117)
  std::memcpy(out, cur, (size_t)h * w * c);
  double frac = rng.uniform() * 0.5;
  if (frac > 0) {
    double r1 = rng.uniform();
    double r2 = rng.uniform();
    cutout(out, h, w, c, frac, r1, r2);
  }
}

void run_threads(int n, int threads, const std::function<void(int, int)>& fn) {
  int t = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  int chunk = (n + t - 1) / t;
  for (int i = 0; i < t; ++i) {
    int lo = i * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI

extern "C" {

void gll_apply_op(const uint8_t* in, uint8_t* out, int h, int w, int c,
                  int op, double v, int sign) {
  apply_op(in, out, h, w, c, op, v, sign);
}

void gll_rotate(const uint8_t* in, uint8_t* out, int h, int w, int c,
                double deg) {
  rotate_img(in, out, h, w, c, deg);
}

void gll_mirror(const uint8_t* in, uint8_t* out, int h, int w, int c) {
  mirror_img(in, out, h, w, c);
}

void gll_pad_crop(const uint8_t* in, uint8_t* out, int h, int w, int c,
                  int pad, int reflect, int i, int j) {
  pad_crop(in, out, h, w, c, pad, reflect, i, j);
}

void gll_cutout(uint8_t* img, int h, int w, int c, double frac, double r1,
                double r2) {
  cutout(img, h, w, c, frac, r1, r2);
}

// Batch augmentation, multithreaded over images.
// in/out: (n, h, w, c) uint8; seeds: (n,) uint64.
void gll_augment_batch(const uint8_t* in, uint8_t* out, int n, int h, int w,
                       int c, const uint64_t* seeds, int rand_n, int rotation,
                       int flip, int pad, int pad_reflect, int threads) {
  size_t img_bytes = (size_t)h * w * c;
  run_threads(n, threads, [&](int lo, int hi) {
    std::vector<uint8_t> bufa(img_bytes), bufb(img_bytes);
    for (int i = lo; i < hi; ++i)
      augment_one(in + i * img_bytes, out + i * img_bytes, h, w, c, seeds[i],
                  rand_n, rotation, flip, pad, pad_reflect, bufa.data(),
                  bufb.data());
  });
}

// uint8 NHWC -> float32 normalized: (x/255 - mean[ch]) / std[ch]
void gll_normalize_batch(const uint8_t* in, float* out, int64_t npix, int c,
                         const float* mean, const float* stdv, int threads) {
  float scale[4], bias[4];
  for (int ch = 0; ch < c; ++ch) {
    scale[ch] = 1.0f / (255.0f * stdv[ch]);
    bias[ch] = -mean[ch] / stdv[ch];
  }
  run_threads((int)std::min<int64_t>(npix, 1 << 30), threads,
              [&](int lo, int hi) {
    // partition by pixel (npix assumed < 2^31 per call; loaders chunk)
    for (int64_t p = lo; p < hi; ++p)
      for (int ch = 0; ch < c; ++ch)
        out[p * c + ch] = in[p * c + ch] * scale[ch] + bias[ch];
  });
}

}  // extern "C"
