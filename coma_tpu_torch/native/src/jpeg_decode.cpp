// Huffman entropy decoding of one JPEG scan into quantised DCT coefficients,
// and the reconstruction of the pixels from them.
//
// The native half of coma_tpu_torch/utils/jpeg.py: the Python side parses the
// markers, removes byte stuffing, splits the scan's data at its restart
// markers and holds the coefficient arrays. jpeg_decode_scan decodes a scan
// into them, as libjpeg's jdhuff.c (sequential) and jdphuff.c (progressive:
// DC first and refine, AC first and refine with end-of-band runs) do; its
// result equals the plain Python decoder's (utils/jpeg.py:_entropy_python)
// coefficient for coefficient. Reading past the end of a segment yields zero
// bits, as libjpeg fills its bit buffer with zeros at a marker.
// jpeg_reconstruct then does what utils/jpeg.py:reconstruct does in numpy
// (libjpeg's jidctint.c islow IDCT and range limit, jdsample.c's upsampling,
// jdcolor.c's YCbCr -> RGB), in the same integer arithmetic, so the pixels
// are equal too.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 jpeg_decode.cpp (native/__init__.py
// does it at first use).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zig-zag index -> natural (row-major) index; 16 extra entries keep a corrupt
// run from writing outside the block (libjpeg's jpeg_natural_order does so too)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kTableBytes = 1 + 16 + 256;   // present, counts of lengths 1..16, values

enum Status { kOk = 0, kBadCode = 1, kNoTable = 2, kFewSegments = 3, kBadTable = 4 };

// A 16-bit lookahead table: entry (length << 8) | symbol, 0 where no code
// starts with those bits.
struct Table {
  std::vector<uint16_t> lookup;
  bool build(const uint8_t* spec) {
    if (!spec[0]) return false;
    lookup.assign(1 << 16, 0);
    const uint8_t* counts = spec + 1;
    const uint8_t* values = spec + 17;
    uint32_t code = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (k >= 256 || code >= (1u << len)) return false;
        uint32_t first = code << (16 - len), n = 1u << (16 - len);
        for (uint32_t j = 0; j < n; ++j)
          lookup[first + j] = static_cast<uint16_t>((len << 8) | values[k]);
      }
      code <<= 1;
    }
    return true;
  }
};

struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;
  int nbits = 0;

  void reset(const uint8_t* begin, const uint8_t* stop) {
    p = begin;
    end = stop;
    acc = 0;
    nbits = 0;
  }
  void fill() {
    while (nbits <= 56) {
      uint64_t byte = p < end ? *p++ : 0;
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    uint32_t v = static_cast<uint32_t>(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int symbol(const Table& t) {
    if (nbits < 16) fill();
    uint16_t e = t.lookup[acc >> 48];
    if (!e) return -1;
    int len = e >> 8;
    acc <<= len;
    nbits -= len;
    return e & 0xFF;
  }
};

inline int extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1 : static_cast<int>(v);
}

struct Scan {
  int ss, se, ah, al;
  bool progressive;
  int eobrun = 0;
};

// One block of a scan; false on a code that no table entry starts.
bool decode_block(BitReader& br, const Table* dc, const Table* ac, int16_t* block, int& pred,
                  Scan& sc) {
  if (!sc.progressive) {
    int s = br.symbol(*dc);
    if (s < 0) return false;
    pred += s ? extend(br.get(s), s) : 0;
    block[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.symbol(*ac);
      if (rs < 0) return false;
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        block[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }
  if (sc.ss == 0) {                       // DC scans
    if (sc.ah == 0) {
      int s = br.symbol(*dc);
      if (s < 0) return false;
      pred += s ? extend(br.get(s), s) : 0;
      block[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred) << sc.al));
    } else if (br.get(1)) {
      block[0] = static_cast<int16_t>(block[0] | (1 << sc.al));
    }
    return true;
  }
  if (sc.ah == 0) {                       // AC first
    if (sc.eobrun > 0) {
      --sc.eobrun;
      return true;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = br.symbol(*ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(br.get(s), s);
        block[kNatural[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << sc.al));
      } else if (r == 15) {
        k += 15;
      } else {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        --sc.eobrun;
        break;
      }
    }
    return true;
  }
  // AC refine
  const int p1 = 1 << sc.al, m1 = -(1 << sc.al);
  int k = sc.ss;
  auto correct = [&](int16_t* c) {
    if (br.get(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
  };
  if (sc.eobrun == 0) {
    for (; k <= sc.se; ++k) {
      int rs = br.symbol(*ac);
      if (rs < 0) return false;
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = br.get(1) ? p1 : m1;   // a newly nonzero coefficient has size 1
      } else if (r != 15) {
        sc.eobrun = 1 << r;
        if (r) sc.eobrun += br.get(r);
        break;
      }
      do {
        int16_t* c = block + kNatural[k];
        if (*c != 0) {
          correct(c);
        } else if (--r < 0) {
          break;
        }
        ++k;
      } while (k <= sc.se);
      if (s) block[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (sc.eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int16_t* c = block + kNatural[k];
      if (*c != 0) correct(c);
    }
    --sc.eobrun;
  }
  return true;
}

}  // namespace

extern "C" {

// Decodes one scan. ``data`` holds the scan's segments (one per restart
// interval, stuffing removed) back to back; segment i is
// data[seg_start[i]:seg_start[i + 1]]. ``comp`` holds, per component of the
// scan, 7 int32: h, v, blocks per row of its coefficient array, coded blocks
// per row and column (a non-interleaved scan's extent), DC table, AC table
// (indices into ``tables``: 0-3 DC, 4-7 AC, each kTableBytes). ``coef[i]``
// is component i's (rows, blocks per row, 64) int16 array in natural order.
// Returns a Status.
int jpeg_decode_scan(const uint8_t* data, const int64_t* seg_start, int n_segments,
                     int mcus_x, int mcus_y, int restart_interval, int n_comps,
                     const int32_t* comp, int16_t* const* coef, const uint8_t* tables,
                     int ss, int se, int ah, int al, int progressive) {
  Table dc[4], ac[4];
  bool dc_ok[4] = {false, false, false, false}, ac_ok[4] = {false, false, false, false};
  Scan sc{ss, se, ah, al, progressive != 0};
  bool need_dc = !sc.progressive || (ss == 0 && ah == 0);
  bool need_ac = !sc.progressive || ss > 0;
  for (int i = 0; i < n_comps; ++i) {
    int d = comp[i * 7 + 5], a = comp[i * 7 + 6];
    if (need_dc && !dc_ok[d]) {
      if (!tables[d * kTableBytes]) return kNoTable;
      if (!dc[d].build(tables + d * kTableBytes)) return kBadTable;
      dc_ok[d] = true;
    }
    if (need_ac && !ac_ok[a]) {
      if (!tables[(4 + a) * kTableBytes]) return kNoTable;
      if (!ac[a].build(tables + (4 + a) * kTableBytes)) return kBadTable;
      ac_ok[a] = true;
    }
  }
  // the blocks of each MCU: (component, block offset in its array)
  std::vector<std::pair<int, int64_t>> units;
  int64_t n_mcus;
  int per_mcu;
  if (n_comps == 1) {
    int64_t bw = comp[2], cw = comp[3], ch = comp[4];
    n_mcus = cw * ch;
    per_mcu = 1;
    units.reserve(n_mcus);
    for (int64_t y = 0; y < ch; ++y)
      for (int64_t x = 0; x < cw; ++x) units.emplace_back(0, (y * bw + x) * 64);
  } else {
    n_mcus = static_cast<int64_t>(mcus_x) * mcus_y;
    per_mcu = 0;
    for (int i = 0; i < n_comps; ++i) per_mcu += comp[i * 7] * comp[i * 7 + 1];
    units.reserve(n_mcus * per_mcu);
    for (int64_t my = 0; my < mcus_y; ++my)
      for (int64_t mx = 0; mx < mcus_x; ++mx)
        for (int i = 0; i < n_comps; ++i) {
          int64_t h = comp[i * 7], v = comp[i * 7 + 1], bw = comp[i * 7 + 2];
          for (int64_t y = 0; y < v; ++y)
            for (int64_t x = 0; x < h; ++x)
              units.emplace_back(i, ((my * v + y) * bw + mx * h + x) * 64);
        }
  }
  int64_t per_segment = restart_interval > 0 ? restart_interval : n_mcus;
  int64_t needed = n_mcus ? (n_mcus + per_segment - 1) / per_segment : 0;
  if (n_segments < needed) return kFewSegments;
  BitReader br;
  int pred[4];
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (m % per_segment == 0) {
      int64_t s = m / per_segment;
      br.reset(data + seg_start[s], data + seg_start[s + 1]);
      std::memset(pred, 0, sizeof(pred));
      sc.eobrun = 0;
    }
    for (int b = 0; b < per_mcu; ++b) {
      const auto& u = units[m * per_mcu + b];
      int i = u.first;
      const Table* d = need_dc ? &dc[comp[i * 7 + 5]] : nullptr;
      const Table* a = need_ac ? &ac[comp[i * 7 + 6]] : nullptr;
      if (!decode_block(br, d, a, coef[i] + u.second, pred[i], sc)) return kBadCode;
    }
  }
  return kOk;
}

}  // extern "C"

// Reconstruction -----------------------------------------------------------

namespace {

constexpr int64_t kFix(double x, int bits) { return static_cast<int64_t>(x * (1LL << bits) + 0.5); }

const int64_t F0298 = kFix(0.298631336, 13), F0390 = kFix(0.390180644, 13),
              F0541 = kFix(0.541196100, 13), F0765 = kFix(0.765366865, 13),
              F0899 = kFix(0.899976223, 13), F1175 = kFix(1.175875602, 13),
              F1501 = kFix(1.501321110, 13), F1847 = kFix(1.847759065, 13),
              F1961 = kFix(1.961570560, 13), F2053 = kFix(2.053119869, 13),
              F2562 = kFix(2.562915447, 13), F3072 = kFix(3.072711026, 13);

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// One pass of jpeg_idct_islow over 8 values d[0], d[step], ..., d[7 step].
void idct_1d(const int64_t* d, int step, int64_t* out, int ostep, bool final) {
  int64_t z2 = d[2 * step], z3 = d[6 * step];
  int64_t z1 = (z2 + z3) * F0541;
  int64_t tmp2 = z1 + z3 * (-F1847), tmp3 = z1 + z2 * F0765;
  int64_t tmp0 = (d[0] + d[4 * step]) * (int64_t{1} << 13);
  int64_t tmp1 = (d[0] - d[4 * step]) * (int64_t{1} << 13);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = d[7 * step];
  tmp1 = d[5 * step];
  tmp2 = d[3 * step];
  tmp3 = d[step];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
  tmp0 *= F0298;
  tmp1 *= F2053;
  tmp2 *= F3072;
  tmp3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * (-F1961) + z5;
  z4 = z4 * (-F0390) + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  int shift = final ? 13 + 2 + 3 : 13 - 2;
  out[0] = descale(tmp10 + tmp3, shift);
  out[ostep] = descale(tmp11 + tmp2, shift);
  out[2 * ostep] = descale(tmp12 + tmp1, shift);
  out[3 * ostep] = descale(tmp13 + tmp0, shift);
  out[4 * ostep] = descale(tmp13 - tmp0, shift);
  out[5 * ostep] = descale(tmp12 - tmp1, shift);
  out[6 * ostep] = descale(tmp11 - tmp2, shift);
  out[7 * ostep] = descale(tmp10 - tmp3, shift);
}

// IDCT_range_limit indexed by x & 1023 (x the centred output)
inline uint8_t range_limit(int64_t x) {
  int v = static_cast<int>(x & 1023);
  return static_cast<uint8_t>(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
}

// One component's samples (rows x cols) from its coefficients.
std::vector<uint8_t> component_samples(const int16_t* coef, int64_t blocks_per_row, int rows,
                                       int cols, const int64_t* quant) {
  std::vector<uint8_t> out(static_cast<size_t>(rows) * cols);
  int nby = (rows + 7) / 8, nbx = (cols + 7) / 8;
  int64_t d[64], ws[64], px[64];
  for (int by = 0; by < nby; ++by)
    for (int bx = 0; bx < nbx; ++bx) {
      const int16_t* c = coef + (by * blocks_per_row + bx) * 64;
      for (int k = 0; k < 64; ++k) d[k] = static_cast<int64_t>(c[k]) * quant[k];
      for (int col = 0; col < 8; ++col) idct_1d(d + col, 8, ws + col, 8, false);
      for (int row = 0; row < 8; ++row) idct_1d(ws + row * 8, 1, px + row * 8, 1, true);
      for (int r = 0; r < 8 && by * 8 + r < rows; ++r)
        for (int x = 0; x < 8 && bx * 8 + x < cols; ++x)
          out[static_cast<size_t>(by * 8 + r) * cols + bx * 8 + x] = range_limit(px[r * 8 + x]);
    }
  return out;
}

// libjpeg's upsampling of a (rows x cols) component to H x W: fancy h2v1 or
// h2v2 where the component is wider than 2 samples, else replication.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& c, int rows, int cols, int rh, int rv,
                              int H, int W) {
  if (rh == 1 && rv == 1) return c;
  std::vector<uint8_t> out(static_cast<size_t>(H) * W);
  auto at = [&](int y, int x) -> int { return c[static_cast<size_t>(y) * cols + x]; };
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out.data() + static_cast<size_t>(y) * W;
    int i = y / rv;
    if (cols <= 2) {
      for (int x = 0; x < W; ++x) o[x] = static_cast<uint8_t>(at(i, x / 2));
      continue;
    }
    for (int j = 0; j < cols; ++j) {
      int jl = j > 0 ? j - 1 : 0, jr = j + 1 < cols ? j + 1 : cols - 1;
      int left, right;
      if (rv == 1) {
        int s = 3 * at(i, j);
        left = (s + at(i, jl) + 1) >> 2;
        right = (s + at(i, jr) + 2) >> 2;
      } else {
        int other = (y % 2 == 0) ? (i > 0 ? i - 1 : 0) : (i + 1 < rows ? i + 1 : rows - 1);
        int s = 3 * at(i, j) + at(other, j);
        int sl = 3 * at(i, jl) + at(other, jl), sr = 3 * at(i, jr) + at(other, jr);
        left = (3 * s + sl + 8) >> 4;
        right = (3 * s + sr + 7) >> 4;
      }
      if (2 * j < W) o[2 * j] = static_cast<uint8_t>(left);
      if (2 * j + 1 < W) o[2 * j + 1] = static_cast<uint8_t>(right);
    }
  }
  return out;
}

inline uint8_t clip255(int64_t x) { return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x); }

}  // namespace

extern "C" {

// The pixels of a decoded frame. ``comp`` holds, per component, 5 int32:
// horizontal and vertical upsampling ratio (1 or 2), blocks per row of its
// coefficient array, and its rows and columns of samples (libjpeg's
// downsampled_height and downsampled_width); ``quant`` its (64,) int64 table
// in natural order. ``colour``: 0 one gray plane, 1 YCbCr -> RGB, 2 RGB.
// ``out`` is (H, W, n_comps) uint8 (n_comps 1 or 3).
void jpeg_reconstruct(int H, int W, int n_comps, const int32_t* comp,
                      const int16_t* const* coef, const int64_t* quant, int colour,
                      uint8_t* out) {
  std::vector<std::vector<uint8_t>> planes;
  for (int i = 0; i < n_comps; ++i) {
    const int32_t* p = comp + i * 5;
    planes.push_back(upsample(component_samples(coef[i], p[2], p[3], p[4], quant + i * 64),
                              p[3], p[4], p[0], p[1], H, W));
  }
  const size_t n = static_cast<size_t>(H) * W;
  if (colour == 0) {
    std::memcpy(out, planes[0].data(), n);
    return;
  }
  const int64_t half = int64_t{1} << 15;
  const int64_t cr_r = kFix(1.40200, 16), cb_g = kFix(0.34414, 16), cr_g = kFix(0.71414, 16),
                cb_b = kFix(1.77200, 16);
  for (size_t k = 0; k < n; ++k) {
    int64_t y = planes[0][k], cb = planes[1][k], cr = planes[2][k];
    if (colour == 2) {
      out[3 * k] = static_cast<uint8_t>(y);
      out[3 * k + 1] = static_cast<uint8_t>(cb);
      out[3 * k + 2] = static_cast<uint8_t>(cr);
      continue;
    }
    cb -= 128;
    cr -= 128;
    out[3 * k] = clip255(y + ((cr_r * cr + half) >> 16));
    out[3 * k + 1] = clip255(y + ((-cb_g * cb + half - cr_g * cr) >> 16));
    out[3 * k + 2] = clip255(y + ((cb_b * cb + half) >> 16));
  }
}

}  // extern "C"
