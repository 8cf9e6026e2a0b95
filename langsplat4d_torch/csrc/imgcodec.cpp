// The port's host image codec: the counterpart of the JAX package's
// native/imgcodec.cpp (libpng and libjpeg decode, PIL's resample) for a host
// that has neither libpng, libjpeg nor PIL. Plain C++17 and the standard
// library; bound with ctypes by data/codec.py, which releases the
// interpreter lock for each call.
//
// Three parts, each with a numpy twin that gives the same bytes:
// 1. PNG: the scanline filters of 8-bit grey, grey + alpha, RGB and RGBA
//    rows (None, Sub, Up, Average, Paeth). The inflate stays in Python's
//    zlib, which releases the lock too. Twin: data/png.py unfilter_rows.
// 2. PIL's resample (Pillow's Resample.c): box, bilinear, bicubic (a =
//    -0.5) and lanczos3, the support scaled by the downscale factor, the
//    coefficients rounded to int32 fixed point (22 fraction bits), a
//    horizontal then a vertical pass on uint8, each pass skipped where its
//    size does not change; grey + alpha and RGBA are resampled
//    premultiplied ("La", "RGBa"), as Image.resize does. Twin:
//    data/resample.py.
// 3. Baseline JPEG (T.81 sequential Huffman, 8-bit, 1 or 3 components,
//    4:4:4, 4:2:2 or 4:2:0, restart intervals, interleaved or not): the
//    inverse DCT of libjpeg's jidctint.c (islow), the fancy upsampling of
//    jdsample.c and the fixed-point YCbCr -> RGB of jdcolor.c, so that it
//    gives libjpeg's bytes. Progressive, arithmetic-coded, lossless,
//    12-bit and 4-component files are refused with a code. Twin:
//    data/jpeg.py decode_jpeg.
//
// The row-independent work (the resample's passes, the inverse DCT, the
// upsampling and colour conversion, the float conversion) runs on up to 16
// threads over rows; the PNG filters and the Huffman decode are sequential
// by nature (each row or symbol depends on the one before).
//
// Build: c++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// (data/codec.py; no contraction, so the resample's double weights round as
// Pillow's and the twin's do).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

template <typename F>
void parallel_rows(int64_t n, F&& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int threads = (int)std::max(1u, std::min<unsigned>(hw, 16));
  if (n < 64 || threads == 1) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

// ---------------------------------------------------------------------------
// 2. PIL's resample

double filt_box(double x) { return (x > -0.5 && x <= 0.5) ? 1.0 : 0.0; }
double filt_bilinear(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}
double filt_bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}
double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return std::sin(x) / x;
}
double filt_lanczos(double x) {
  if (-3.0 <= x && x < 3.0) return sinc(x) * sinc(x / 3);
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

bool get_filter(int id, Filter* f) {
  switch (id) {
    case 0: *f = {filt_box, 0.5}; return true;
    case 1: *f = {filt_bilinear, 1.0}; return true;
    case 2: *f = {filt_bicubic, 2.0}; return true;
    case 3: *f = {filt_lanczos, 3.0}; return true;
    default: return false;
  }
}

constexpr int PREC = 32 - 8 - 2;  // Resample.c's PRECISION_BITS

// Pillow's precompute_coeffs and normalize_coeffs_8bpc for one axis:
// bounds[2 x] = (first source index, taps), kk[x * ksize + i] the taps.
int make_coeffs(int in_size, int out_size, const Filter& flt,
                std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double scale = (double)in_size / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = flt.support * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  std::vector<double> k((size_t)ksize);
  kk.assign((size_t)out_size * ksize, 0);
  bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double w = flt.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
      kk[(size_t)xx * ksize + x] =
          (int32_t)(k[x] < 0 ? -0.5 + k[x] * (1 << PREC)
                             : 0.5 + k[x] * (1 << PREC));
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << PREC << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> PREC);
}

// one pass along rows (horizontal) of [h, w, c] -> [h, ow, c]
void resample_horizontal(const uint8_t* in, int w, int h, int c, int ow,
                         const Filter& flt, uint8_t* out) {
  std::vector<int> b;
  std::vector<int32_t> kk;
  int ksize = make_coeffs(w, ow, flt, b, kk);
  parallel_rows(h, [&](int64_t lo, int64_t hi) {
    for (int64_t y = lo; y < hi; ++y) {
      const uint8_t* src = in + y * (int64_t)w * c;
      uint8_t* dst = out + y * (int64_t)ow * c;
      for (int xx = 0; xx < ow; ++xx) {
        int xmin = b[xx * 2], n = b[xx * 2 + 1];
        const int32_t* k = &kk[(size_t)xx * ksize];
        for (int ch = 0; ch < c; ++ch) {
          int32_t ss = 1 << (PREC - 1);
          for (int x = 0; x < n; ++x)
            ss += src[(int64_t)(x + xmin) * c + ch] * k[x];
          dst[(int64_t)xx * c + ch] = clip8(ss);
        }
      }
    }
  });
}

// one pass along columns (vertical) of [h, w, c] -> [oh, w, c]
void resample_vertical(const uint8_t* in, int w, int h, int c, int oh,
                       const Filter& flt, uint8_t* out) {
  std::vector<int> b;
  std::vector<int32_t> kk;
  int ksize = make_coeffs(h, oh, flt, b, kk);
  int64_t row = (int64_t)w * c;
  parallel_rows(oh, [&](int64_t lo, int64_t hi) {
    std::vector<int32_t> acc((size_t)row);
    for (int64_t yy = lo; yy < hi; ++yy) {
      int ymin = b[yy * 2], n = b[yy * 2 + 1];
      const int32_t* k = &kk[(size_t)yy * ksize];
      std::fill(acc.begin(), acc.end(), 1 << (PREC - 1));
      for (int y = 0; y < n; ++y) {
        const uint8_t* src = in + (int64_t)(ymin + y) * row;
        int32_t ky = k[y];
        for (int64_t i = 0; i < row; ++i) acc[i] += src[i] * ky;
      }
      uint8_t* dst = out + yy * row;
      for (int64_t i = 0; i < row; ++i) dst[i] = clip8(acc[i]);
    }
  });
}

// ---------------------------------------------------------------------------
// 3. Baseline JPEG

enum JpegError {
  JPEG_OK = 0,
  JPEG_CORRUPT = 1,
  JPEG_PROGRESSIVE = 2,
  JPEG_ARITHMETIC = 3,
  JPEG_PRECISION = 4,
  JPEG_COMPONENTS = 5,
  JPEG_SAMPLING = 6,
  JPEG_LOSSLESS = 7,
};

// zigzag position -> natural index; 16 more entries of 63 absorb the
// overrun of a corrupt run length, as libjpeg's jpeg_natural_order does
const int NATURAL[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  // canonical decode (T.81 F.2.2.3): per code length 1-16
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
  // 9-bit lookahead: length << 8 | symbol, 0 where the code is longer
  uint16_t look[512];
};

bool build_huffman(const uint8_t* counts, const uint8_t* symbols, int n,
                   Huffman* t) {
  int code = 0, k = 0;
  std::memset(t->look, 0, sizeof(t->look));
  for (int len = 1; len <= 16; ++len) {
    t->valoff[len] = k - code;
    for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
      if (code >= (1 << len)) return false;  // more codes than fit
      if (len <= 9) {
        int shift = 9 - len;
        for (int j = 0; j < (1 << shift); ++j)
          t->look[(code << shift) | j] = (uint16_t)(len << 8 | symbols[k]);
      }
    }
    t->maxcode[len] = counts[len - 1] ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  if (k != n || n > 256) return false;
  std::memcpy(t->vals, symbols, n);
  t->present = true;
  return true;
}

struct BitReader {
  const uint8_t* d;
  int64_t n, pos;  // next byte to read
  uint64_t buf = 0;
  int bits = 0;
  bool marker = false;  // hit a marker: zeros from here (libjpeg's rule)

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!marker && pos < n) {
        byte = d[pos];
        if (byte == 0xFF) {
          int64_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;  // fill bytes
          if (p < n && d[p] == 0x00) {
            pos = p + 1;
          } else {
            marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return (uint32_t)(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    bits -= k;
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  // drop the bits left in the current byte and the restart marker after
  // them; the scan goes on at the next entropy-coded byte
  void restart() {
    buf = 0;
    bits = 0;
    marker = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 &&
                            d[pos + 1] <= 0xD7))
      ++pos;
    if (pos + 1 < n) pos += 2;
  }
};

inline int decode_symbol(BitReader& br, const Huffman& t) {
  uint32_t v = br.peek(16);
  uint16_t e = t.look[v >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  for (int len = 10; len <= 16; ++len) {
    int32_t code = (int32_t)(v >> (16 - len));
    if (code <= t.maxcode[len]) {
      br.skip(len);
      return t.vals[code + t.valoff[len]];
    }
  }
  return -1;
}

inline int extend(int v, int t) {
  return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;   // downsampled width and height (libjpeg's)
  int bw = 0, bh = 0;   // blocks allocated (whole MCUs)
  std::vector<int16_t> coef;
};

struct Jpeg {
  int width = 0, height = 0, precision = 8;
  int hmax = 1, vmax = 1;
  int restart = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  bool sof = false;
};

inline uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }

// checks the frame's components and, with `alloc`, sizes their planes
int setup_components(Jpeg& j, bool alloc) {
  int nc = (int)j.comps.size();
  if (j.precision != 8) return JPEG_PRECISION;
  if (nc != 1 && nc != 3) return JPEG_COMPONENTS;
  if (j.width <= 0 || j.height <= 0) return JPEG_CORRUPT;
  if (nc == 1) {
    j.comps[0].h = j.comps[0].v = 1;
  }
  j.hmax = j.vmax = 1;
  for (auto& c : j.comps) {
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return JPEG_CORRUPT;
    j.hmax = std::max(j.hmax, c.h);
    j.vmax = std::max(j.vmax, c.v);
  }
  for (auto& c : j.comps) {
    if (j.hmax % c.h || j.vmax % c.v) return JPEG_SAMPLING;
    int rx = j.hmax / c.h, ry = j.vmax / c.v;
    if (!((rx == 1 && ry == 1) || (rx == 2 && ry == 1) ||
          (rx == 2 && ry == 2)))
      return JPEG_SAMPLING;
  }
  if (!alloc) return JPEG_OK;
  int mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  int mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (auto& c : j.comps) {
    c.dw = (int)(((int64_t)j.width * c.h + j.hmax - 1) / j.hmax);
    c.dh = (int)(((int64_t)j.height * c.v + j.vmax - 1) / j.vmax);
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
  }
  return JPEG_OK;
}

int decode_block(BitReader& br, const Huffman& dct, const Huffman& act,
                 int* pred, int16_t* blk) {
  int t = decode_symbol(br, dct);
  if (t < 0 || t > 16) return JPEG_CORRUPT;
  int diff = t ? extend((int)br.get(t), t) : 0;
  *pred += diff;
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64; ++k) {
    int rs = decode_symbol(br, act);
    if (rs < 0) return JPEG_CORRUPT;
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[NATURAL[k]] = (int16_t)extend((int)br.get(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return JPEG_OK;
}

// One scan: `sc` indexes the scan's components, with their table choices.
int decode_scan(Jpeg& j, const uint8_t* d, int64_t n, int64_t* pos,
                const std::vector<int>& sc, const std::vector<int>& td,
                const std::vector<int>& ta) {
  for (size_t i = 0; i < sc.size(); ++i)
    if (!j.dc[td[i]].present || !j.ac[ta[i]].present ||
        !j.qt_present[j.comps[sc[i]].tq])
      return JPEG_CORRUPT;
  BitReader br{d, n, *pos};
  std::vector<int> pred(sc.size(), 0);
  int64_t units_x, units_y;
  if (sc.size() == 1) {
    const Component& c = j.comps[sc[0]];
    units_x = (c.dw + 7) / 8;
    units_y = (c.dh + 7) / 8;
  } else {
    units_x = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
    units_y = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  }
  int64_t total = units_x * units_y;
  for (int64_t u = 0; u < total; ++u) {
    if (j.restart && u && u % j.restart == 0) {
      br.restart();
      std::fill(pred.begin(), pred.end(), 0);
    }
    int64_t ux = u % units_x, uy = u / units_x;
    for (size_t i = 0; i < sc.size(); ++i) {
      Component& c = j.comps[sc[i]];
      int hh = sc.size() == 1 ? 1 : c.h, vv = sc.size() == 1 ? 1 : c.v;
      for (int by = 0; by < vv; ++by)
        for (int bx = 0; bx < hh; ++bx) {
          int64_t row = uy * vv + by, col = ux * hh + bx;
          int16_t* blk = &c.coef[((size_t)row * c.bw + col) * 64];
          int rc = decode_block(br, j.dc[td[i]], j.ac[ta[i]], &pred[i], blk);
          if (rc) return rc;
        }
    }
  }
  // the entropy-coded data ends at the next marker that is not a restart
  int64_t p = br.pos;
  while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0x00 &&
                        !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)))
    ++p;
  *pos = p;
  return JPEG_OK;
}

int parse_jpeg(const uint8_t* d, int64_t n, Jpeg& j, bool header_only) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return JPEG_CORRUPT;
  int64_t pos = 2;
  bool scanned = false;
  while (true) {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return scanned ? JPEG_OK : JPEG_CORRUPT;
    int m = d[pos++];
    if (m == 0xD9) return scanned ? JPEG_OK : JPEG_CORRUPT;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (pos + 2 > n) return JPEG_CORRUPT;
    int64_t len = be16(d + pos);
    if (len < 2 || pos + len > n) return JPEG_CORRUPT;
    const uint8_t* s = d + pos + 2;
    int64_t sl = len - 2;
    pos += len;
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
      return JPEG_PROGRESSIVE;
    if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
      return JPEG_LOSSLESS;
    if (m == 0xC9 || m == 0xCC || m == 0xCD) return JPEG_ARITHMETIC;
    if (m == 0xC5) return JPEG_LOSSLESS;  // hierarchical
    if (m == 0xC0 || m == 0xC1) {
      if (sl < 6 || j.sof) return JPEG_CORRUPT;
      j.precision = s[0];
      j.height = (int)be16(s + 1);
      j.width = (int)be16(s + 3);
      int nc = s[5];
      if (sl < 6 + 3 * nc) return JPEG_CORRUPT;
      for (int i = 0; i < nc; ++i) {
        Component c;
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i] & 3;
        j.comps.push_back(c);
      }
      j.sof = true;
      int rc = setup_components(j, !header_only);
      if (rc || header_only) return rc;
    } else if (m == 0xC4) {
      int64_t p = 0;
      while (p < sl) {
        if (p + 17 > sl) return JPEG_CORRUPT;
        int cls = s[p] >> 4, th = s[p] & 3;
        int cnt = 0;
        for (int i = 0; i < 16; ++i) cnt += s[p + 1 + i];
        if (cls > 1 || p + 17 + cnt > sl) return JPEG_CORRUPT;
        Huffman& t = cls ? j.ac[th] : j.dc[th];
        if (!build_huffman(s + p + 1, s + p + 17, cnt, &t))
          return JPEG_CORRUPT;
        p += 17 + cnt;
      }
    } else if (m == 0xDB) {
      int64_t p = 0;
      while (p < sl) {
        int pq = s[p] >> 4, tq = s[p] & 3;
        int need = pq ? 128 : 64;
        if (pq > 1 || p + 1 + need > sl) return JPEG_CORRUPT;
        for (int k = 0; k < 64; ++k)
          j.qt[tq][NATURAL[k]] =
              pq ? (uint16_t)be16(s + p + 1 + 2 * k) : s[p + 1 + k];
        j.qt_present[tq] = true;
        p += 1 + need;
      }
    } else if (m == 0xDD) {
      if (sl < 2) return JPEG_CORRUPT;
      j.restart = (int)be16(s);
    } else if (m == 0xE0) {
      if (sl >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) j.jfif = true;
    } else if (m == 0xEE) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        j.adobe = true;
        j.adobe_transform = s[11];
      }
    } else if (m == 0xDA) {
      if (!j.sof || sl < 1) return JPEG_CORRUPT;
      int ns = s[0];
      if (ns < 1 || ns > 4 || sl < 1 + 2 * ns + 3) return JPEG_CORRUPT;
      std::vector<int> sc, td, ta;
      for (int i = 0; i < ns; ++i) {
        int cid = s[1 + 2 * i];
        int k = -1;
        for (size_t c = 0; c < j.comps.size(); ++c)
          if (j.comps[c].id == cid) k = (int)c;
        if (k < 0) return JPEG_CORRUPT;
        sc.push_back(k);
        td.push_back(s[2 + 2 * i] >> 4 & 3);
        ta.push_back(s[2 + 2 * i] & 3);
      }
      int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah_al = s[3 + 2 * ns];
      if (ss != 0 || se != 63 || ah_al != 0) return JPEG_CORRUPT;
      int rc = decode_scan(j, d, n, &pos, sc, td, ta);
      if (rc) return rc;
      scanned = true;
    }
  }
}

// jidctint.c's jpeg_idct_islow on one block, into `out` with row stride
// `stride`
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}
// the post-IDCT range limit: the value masked to 10 bits, read as signed,
// plus 128, clamped to 0-255 (libjpeg's sample_range_limit table)
inline uint8_t range_limit(int64_t x) {
  int v = (int)(x & 1023);
  if (v >= 512) v -= 1024;
  v += 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// One 8-point pass of jpeg_idct_islow on x[0..7] (x[k] the k-th
// frequency, dequantized and, in the second pass, already scaled by the
// first): the eight outputs before their final descale.
inline void idct_1d(const int64_t* x, int64_t* o) {
  int64_t z1 = (x[2] + x[6]) * FIX_0_541196100;
  int64_t t2 = z1 + x[6] * (-FIX_1_847759065);
  int64_t t3 = z1 + x[2] * FIX_0_765366865;
  int64_t t0 = (x[0] + x[4]) * (1 << CONST_BITS);
  int64_t t1 = (x[0] - x[4]) * (1 << CONST_BITS);
  int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
  t0 = x[7];
  t1 = x[5];
  t2 = x[3];
  t3 = x[1];
  z1 = t0 + t3;
  int64_t z2 = t1 + t2, z3 = t0 + t2, z4 = t1 + t3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  t0 = t0 * FIX_0_298631336;
  t1 = t1 * FIX_2_053119869;
  t2 = t2 * FIX_3_072711026;
  t3 = t3 * FIX_1_501321110;
  z1 = z1 * (-FIX_0_899976223);
  z2 = z2 * (-FIX_2_562915447);
  z3 = z3 * (-FIX_1_961570560) + z5;
  z4 = z4 * (-FIX_0_390180644) + z5;
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;
  o[0] = t10 + t3;
  o[7] = t10 - t3;
  o[1] = t11 + t2;
  o[6] = t11 - t2;
  o[2] = t12 + t1;
  o[5] = t12 - t1;
  o[3] = t13 + t0;
  o[4] = t13 - t0;
}

// jidctint.c's jpeg_idct_islow on one block (natural order), into `out`
// with row stride `stride`: columns, descaled to PASS1_BITS, then rows
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int64_t stride) {
  int64_t ws[64], x[8], o[8];
  for (int c = 0; c < 8; ++c) {
    for (int k = 0; k < 8; ++k) x[k] = (int64_t)in[8 * k + c] * q[8 * k + c];
    idct_1d(x, o);
    for (int k = 0; k < 8; ++k)
      ws[8 * k + c] = descale(o[k], CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; ++r) {
    idct_1d(ws + 8 * r, o);
    for (int k = 0; k < 8; ++k)
      out[r * stride + k] =
          range_limit(descale(o[k], CONST_BITS + PASS1_BITS + 3));
  }
}

// jdsample.c: one output row of a component at the image's width, from its
// plane (`dw` x `dh` samples, row stride `stride`), upsampled by (rx, ry)
void upsample_row(const uint8_t* plane, int64_t stride, int dw, int dh,
                  int rx, int ry, int y, int width, int* out) {
  if (rx == 1 && ry == 1) {
    const uint8_t* p = plane + (int64_t)y * stride;
    for (int x = 0; x < width; ++x) out[x] = p[x];
    return;
  }
  int r = y / ry;
  const uint8_t* p0 = plane + (int64_t)r * stride;
  if (dw <= 2) {  // too narrow for the fancy filters: box replication
    for (int x = 0; x < width; ++x) out[x] = p0[x / rx];
    return;
  }
  std::vector<int> row(2 * (size_t)dw);
  if (ry == 1) {  // h2v1_fancy_upsample
    int* o = row.data();
    int v = p0[0];
    *o++ = v;
    *o++ = (v * 3 + p0[1] + 2) >> 2;
    for (int c = 1; c < dw - 1; ++c) {
      v = p0[c] * 3;
      *o++ = (v + p0[c - 1] + 1) >> 2;
      *o++ = (v + p0[c + 1] + 2) >> 2;
    }
    v = p0[dw - 1];
    *o++ = (v * 3 + p0[dw - 2] + 1) >> 2;
    *o++ = v;
  } else {  // h2v2_fancy_upsample: the nearer row 3/4, the other 1/4
    int r1 = (y % 2 == 0) ? std::max(r - 1, 0) : std::min(r + 1, dh - 1);
    const uint8_t* p1 = plane + (int64_t)r1 * stride;
    int* o = row.data();
    int this_s = p0[0] * 3 + p1[0], next_s = p0[1] * 3 + p1[1], last_s;
    *o++ = (this_s * 4 + 8) >> 4;
    *o++ = (this_s * 3 + next_s + 7) >> 4;
    last_s = this_s;
    this_s = next_s;
    for (int c = 2; c < dw; ++c) {
      next_s = p0[c] * 3 + p1[c];
      *o++ = (this_s * 3 + last_s + 8) >> 4;
      *o++ = (this_s * 3 + next_s + 7) >> 4;
      last_s = this_s;
      this_s = next_s;
    }
    *o++ = (this_s * 3 + last_s + 8) >> 4;
    *o++ = (this_s * 4 + 7) >> 4;
  }
  for (int x = 0; x < width; ++x) out[x] = row[x];
}

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

int jpeg_output(Jpeg& j, uint8_t* out) {
  int nc = (int)j.comps.size();
  std::vector<std::vector<uint8_t>> planes(nc);
  for (int ci = 0; ci < nc; ++ci) {
    Component& c = j.comps[ci];
    if (!j.qt_present[c.tq]) return JPEG_CORRUPT;
    planes[ci].assign((size_t)c.bw * 8 * c.bh * 8, 0);
    int64_t stride = (int64_t)c.bw * 8;
    const uint16_t* q = j.qt[c.tq];
    parallel_rows(c.bh, [&](int64_t lo, int64_t hi) {
      for (int64_t by = lo; by < hi; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], q,
                     planes[ci].data() + by * 8 * stride + bx * 8, stride);
    });
  }
  bool rgb = false;
  if (nc == 3) {
    if (j.jfif) rgb = false;
    else if (j.adobe) rgb = j.adobe_transform == 0;
    else rgb = j.comps[0].id == 82 && j.comps[1].id == 71 &&
               j.comps[2].id == 66;
  }
  const int W = j.width;
  // jdcolor.c's tables (SCALEBITS 16)
  const int64_t ONE_HALF = 1 << 15;
  auto fix = [](double x) { return (int64_t)(x * 65536 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int64_t x = i - 128;
    cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
    cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  parallel_rows(j.height, [&](int64_t lo, int64_t hi) {
    std::vector<int> rows((size_t)nc * W);
    for (int64_t y = lo; y < hi; ++y) {
      for (int ci = 0; ci < nc; ++ci) {
        const Component& c = j.comps[ci];
        upsample_row(planes[ci].data(), (int64_t)c.bw * 8, c.dw, c.dh,
                     j.hmax / c.h, j.vmax / c.v, (int)y, W,
                     rows.data() + (size_t)ci * W);
      }
      uint8_t* o = out + y * (int64_t)W * nc;
      if (nc == 1) {
        for (int x = 0; x < W; ++x) o[x] = (uint8_t)rows[x];
      } else if (rgb) {
        for (int x = 0; x < W; ++x)
          for (int ci = 0; ci < 3; ++ci)
            o[3 * x + ci] = (uint8_t)rows[(size_t)ci * W + x];
      } else {
        const int* yy = rows.data();
        const int* cb = yy + W;
        const int* cr = cb + W;
        for (int x = 0; x < W; ++x) {
          int Y = yy[x];
          o[3 * x] = clamp255(Y + cr_r[cr[x]]);
          o[3 * x + 1] =
              clamp255(Y + (int)((cb_g[cb[x]] + cr_g[cr[x]]) >> 16));
          o[3 * x + 2] = clamp255(Y + cb_b[cb[x]]);
        }
      }
    }
  });
  return JPEG_OK;
}

}  // namespace

extern "C" {

// PNG: undo the scanline filters of `h` rows, each a filter byte and
// w * c bytes, into `out` [h, w * c]. Returns 0, or 1 + the index of the
// first row with an unknown filter.
int ls4d_png_unfilter(const uint8_t* raw, int w, int h, int c,
                      uint8_t* out) {
  const int64_t stride = (int64_t)w * c;
  std::vector<uint8_t> zero((size_t)stride, 0);
  for (int y = 0; y < h; ++y) {
    const uint8_t* line = raw + (int64_t)y * (stride + 1);
    int ft = line[0];
    ++line;
    const uint8_t* prev = y ? out + (int64_t)(y - 1) * stride : zero.data();
    uint8_t* cur = out + (int64_t)y * stride;
    switch (ft) {
      case 0:
        std::memcpy(cur, line, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] + (i >= c ? cur[i - c] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] + prev[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = (uint8_t)(line[i] +
                             (((i >= c ? cur[i - c] : 0) + prev[i]) >> 1));
        break;
      case 4:
        // the first pixel's predictor is the byte above (a = c = 0)
        for (int64_t i = 0; i < std::min<int64_t>(c, stride); ++i)
          cur[i] = (uint8_t)(line[i] + prev[i]);
        for (int64_t i = c; i < stride; ++i) {
          int a = cur[i - c], b = prev[i], cc = prev[i - c];
          int pa = std::abs(b - cc), pb = std::abs(a - cc),
              pc = std::abs(a + b - 2 * cc);
          // branch-free choice (the choice follows the image's content, so
          // a branch mispredicts about half the time)
          int ma = -(int)((pa <= pb) & (pa <= pc)), mb = -(int)(pb <= pc);
          int pred = (a & ma) | (~ma & ((b & mb) | (~mb & cc)));
          cur[i] = (uint8_t)(line[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

// JPEG: the frame's width, height and components. Returns a JpegError.
int ls4d_jpeg_info(const uint8_t* data, int64_t n, int* w, int* h, int* c) {
  Jpeg j;
  int rc = parse_jpeg(data, n, j, true);
  if (rc) return rc;
  if (!j.sof) return JPEG_CORRUPT;
  *w = j.width;
  *h = j.height;
  *c = (int)j.comps.size();
  return JPEG_OK;
}

// JPEG: decode into `out` [h, w, c] uint8 (RGB for 3 components). Returns a
// JpegError.
int ls4d_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out) {
  Jpeg j;
  int rc = parse_jpeg(data, n, j, false);
  if (rc) return rc;
  if (!j.sof) return JPEG_CORRUPT;
  return jpeg_output(j, out);
}

// PIL's resample of `in` [h, w, c] uint8 to `out` [oh, ow, c] with filter
// 0 box, 1 bilinear, 2 bicubic, 3 lanczos. c = 2 and c = 4 are resampled
// premultiplied by their last channel (alpha). Returns 0, or 1 for an
// unknown filter or size.
int ls4d_resample(const uint8_t* in, int w, int h, int c, int ow, int oh,
                  int filter, uint8_t* out) {
  Filter flt;
  if (!get_filter(filter, &flt) || w < 1 || h < 1 || ow < 1 || oh < 1 ||
      c < 1 || c > 4)
    return 1;
  const int64_t n_in = (int64_t)w * h;
  if (ow == w && oh == h) {
    std::memcpy(out, in, (size_t)(n_in * c));
    return 0;
  }
  const bool alpha = c == 2 || c == 4;
  std::vector<uint8_t> src;
  const uint8_t* cur = in;
  if (alpha) {  // Convert.c rgbA2rgba / lA2la: MULDIV255
    src.assign(in, in + n_in * c);
    parallel_rows(n_in, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        uint8_t* px = src.data() + i * c;
        uint32_t a = px[c - 1];
        for (int ch = 0; ch < c - 1; ++ch) {
          uint32_t t = px[ch] * a + 128;
          px[ch] = (uint8_t)(((t >> 8) + t) >> 8);
        }
      }
    });
    cur = src.data();
  }
  std::vector<uint8_t> mid;
  int cw = w;
  if (ow != w) {
    bool last = oh == h;
    uint8_t* dst = out;
    if (!last) {
      mid.resize((size_t)h * ow * c);
      dst = mid.data();
    }
    resample_horizontal(cur, w, h, c, ow, flt, dst);
    cur = dst;
    cw = ow;
  }
  if (oh != h) resample_vertical(cur, cw, h, c, oh, flt, out);
  if (alpha) {  // Convert.c rgba2rgbA / la2lA: truncating division
    const int64_t n_out = (int64_t)ow * oh;
    parallel_rows(n_out, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        uint8_t* px = out + i * c;
        uint32_t a = px[c - 1];
        if (a == 255 || a == 0) continue;
        for (int ch = 0; ch < c - 1; ++ch)
          px[ch] = (uint8_t)std::min<uint32_t>(255u, 255u * px[ch] / a);
      }
    });
  }
  return 0;
}

// [n, c] uint8 pixels -> [c, n] float32, k / 255 (the JAX package's
// k / 255.0f).
void ls4d_chw_f32(const uint8_t* in, int64_t n, int c, float* out) {
  parallel_rows(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      for (int ch = 0; ch < c; ++ch)
        out[ch * n + i] = in[i * c + ch] / 255.0f;
  });
}

}  // extern "C"
